// Dense C[M,N] = A[M,K] . B[K,N], fp32 accumulation, cast to the output type.
//
// Replaces the TPU kernel repro/kernels/tiled_matmul.py::tiled_matmul_kernel
// (driven by tiled_matmul_pallas).  There the grid walks K sequentially and
// carries the sum in VMEM scratch; here every block owns one 64 x 64 output
// tile and loops over K itself (tile.cuh), so blocks share nothing.
//
// Bound on an H100: at the SUMMA panel shape (32768 x 256) . (256 x 32768)
// in fp32 the work is 5.5e11 FMA-FLOP against 4.4 GB of operands and
// output, so it is compute-bound on the 67 TFLOP/s of fp32 FMA.  This simple
// design leaves on the table: tensor cores (bf16 could run on wgmma), TMA
// and a multi-stage pipeline to hide load latency (loads and FMAs alternate
// behind __syncthreads here), larger per-thread tiles to cut shared-memory
// traffic per FMA, and vectorised global loads.
#include "tile.cuh"

namespace repro_torch {
namespace {

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    tiled_matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                        TOut* __restrict__ c, int64_t m, int64_t n, int64_t k,
                        int64_t lda, int64_t ldb) {
  __shared__ TileSmem sm;
  float acc[4][4] = {};
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTileM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  accumulate_tile(a, lda, b, ldb, row0, m, col0, n, 0, k, sm, acc);
  store_tile(c, n, row0, m, col0, n, acc);
}

template <typename TIn, typename TOut>
void launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
            int64_t k, int64_t lda, int64_t ldb, dim3 grid,
            cudaStream_t stream) {
  tiled_matmul_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), m, n, k, lda, ldb);
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
  const int64_t tiles_m = (m + kTileM - 1) / kTileM;
  const int64_t tiles_n = (n + kTileN - 1) / kTileN;
  if (tiles_m > 65535 || tiles_n > 2147483647LL) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 grid(static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(tiles_m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32) {
    launch<float, float>(a, b, c, m, n, k, lda, ldb, grid, s);
  } else if (in_dtype == kFloat32 && out_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(a, b, c, m, n, k, lda, ldb, grid, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(a, b, c, m, n, k, lda, ldb, grid, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, lda, ldb, grid, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Message of a cudaError_t returned by a launcher of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
