// Dense C[M,N] = A[M,K] . B[K,N], fp32 accumulation, cast to the output type.
//
// Replaces the TPU kernel repro/kernels/tiled_matmul.py::tiled_matmul_kernel
// (driven by tiled_matmul_pallas).  There the grid walks K sequentially and
// carries the sum in VMEM scratch; here a block loops over K itself and
// keeps the sum in registers.
//
// Bound on an H100 at the SUMMA panel shape (32768 x 256) . (256 x 32768)
// in fp32: A and B read once and C written once are 4.4 GB, 1.30 ms at
// 3.35 TB/s, against the function's 5.5e11 FLOP, 0.56 ms at the bf16
// tensor cores' 989 TFLOP/s: bound by bytes, by writing C.  The split's
// three bf16 products (split_gemm.cuh) take 1.67 ms at that peak.
//
// Design (block_rows.cuh on split_gemm.cuh): the products run on the bf16
// tensor cores as split-bf16 wgmma (fp32 operands as hi + lo, three
// products; bf16 ones as they are), a producer warpgroup streaming B's
// k-slabs, split, into a swizzled shared-memory ring, two consumer
// warpgroups building A's fragments in registers.  A is one block row of
// all M rows: a work item is two consecutive 64-row units of A (rows
// 128 i .. 128 i + 127) by one 256-column tile of C, computed on the card
// from the item's index, with no work list.  One persistent block a
// multiprocessor walks the items in groups of kColGroup column tiles, so
// the blocks in flight share B's column tiles and A's rows from L2.  A
// and B are read through their row strides (SUMMA hands over a column
// slice of its shard), and every edge of M, N and K is masked.  A K past
// 2048 is summed in parts where C is fp32 (block_rows.cuh).
#include "block_rows.cuh"
#include "dtypes.cuh"

namespace repro_torch {
namespace {

namespace br = block_rows;

constexpr int kColGroup = 16;  // column tiles a pair runs over in a row

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(split_gemm::kThreads, 1)
    tiled_matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                        TOut* __restrict__ c,
                        const __grid_constant__ br::Params p) {
  br::run<TIn, TOut, kColGroup>(a, b, c, p);
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* a, const void* b, void* c, int64_t m,
                   int64_t n, int64_t k, int64_t lda, int64_t ldb,
                   cudaStream_t stream) {
  const br::Params p = br::make_params(
      a, b, nullptr, c, m, n, lda, ldb, m, k, 1, 1, false,
      static_cast<int>(sizeof(TIn)), static_cast<int>(sizeof(TOut)));
  return br::launch<TIn, TOut>(tiled_matmul_kernel<TIn, TOut>, a, b, c, p,
                               stream);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// C (M x N, contiguous) = A (M x K, row stride lda) . B (K x N, row stride
// ldb).  Returns the cudaError_t of the launch (0 on success).
extern "C" int tiled_matmul_launch(const void* a, const void* b, void* c,
                                   int64_t m, int64_t n, int64_t k,
                                   int64_t lda, int64_t ldb, int in_dtype,
                                   int out_dtype, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32) {
    return launch<float, float>(a, b, c, m, n, k, lda, ldb, s);
  } else if (in_dtype == kFloat32 && out_dtype == kBFloat16) {
    return launch<float, __nv_bfloat16>(a, b, c, m, n, k, lda, ldb, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kFloat32) {
    return launch<__nv_bfloat16, float>(a, b, c, m, n, k, lda, ldb, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, lda, ldb,
                                                 s);
  }
  return cudaErrorInvalidValue;
}

// Message of a cudaError_t returned by a launcher of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
