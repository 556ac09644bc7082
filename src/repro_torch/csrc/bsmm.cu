// Block-sparse C[M,N] = A[M,K] . B[K,N] where A's live blocks are given by
// a padded CSR column map, fp32 accumulation, cast to the output type.
//
// Replaces the TPU kernel repro/kernels/bsmm.py::bsmm_kernel (driven by
// bsmm_pallas).  A is dense-stored in (bm x bk) blocks; cols is an int32
// map of padded lists of block columns, -1 after the live ones: either
// (M/bm, S), one list a block row (A's live blocks, as the TPU kernel's
// map), or (M/bm, T, S), T = ceil(N / 256), one list a block row and
// 256-column tile of C (A's live blocks whose (bk x 256) block of B is
// live too: the blocks of B a list leaves out are never read, and
// multiplying them would add exact zeros).  The TPU kernel gets cols
// through scalar prefetch and walks S as a sequential grid axis; here
// each block reads its item's list itself and walks it until the first
// entry that is not a block column of A (-1, or one at or past K/bk,
// which is never read), summing the listed (bm x bk) . (bk x 256-column
// tile) products in registers.  Only listed blocks are loaded and
// multiplied; an item with an empty list stores zeros.
//
// Bound on an H100 at the SUMMA shapes (bm = bk = 256, N = 32768, A and B
// at block fill 0.3: 4900 live blocks of A, 188,312 live block triples):
// over A's map alone the function's 2 bm bk N FLOP a live block of A,
// 2.1e13, take 21.4 ms at the bf16 tensor cores' 989 TFLOP/s; over the
// lists a tile, the useful 2 bm bk 256 a live triple, 6.32e12, take
// 6.4 ms, against 6.9 GB of live operand blocks and C written once
// (2.0 ms at 3.35 TB/s): bound by operations.  The split's three bf16
// products (split_gemm.cuh) take three times that: 19.2 ms (64 ms over
// A's map alone).
//
// Design (block_rows.cuh on split_gemm.cuh): the dense kernel's
// (tiled_matmul.cu) split-bf16 wgmma engine, where a work item is two
// 64-row units of one block row (bm < 64: one unit, the second consumer
// idling; a bm that is no multiple of 64 leaves a short unit) by a
// 256-column tile of C.  Producer and consumers walk the item's list in
// the map's order, ceil(bk / 32) k-slabs a block (k past the block
// zero-filled), so the item's sum runs over a k of up to S bk in one sum
// (in parts of K = 2048 where C is fp32: block_rows.cuh).  The column
// tiles go in groups of kColGroup = 2: the pairs in flight share the
// group's B rows, and the two blocks on one pair share the blocks of A
// their lists both hold.  Load balance is left to the persistent walk:
// longer lists give longer items, spread over 32768 items on the main
// path.
#include "block_rows.cuh"
#include "dtypes.cuh"

namespace repro_torch {
namespace {

namespace br = block_rows;

constexpr int kColGroup = 2;  // column tiles a pair runs over in a row

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(split_gemm::kThreads, 1)
    bsmm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                TOut* __restrict__ c, const __grid_constant__ br::Params p) {
  br::run<TIn, TOut, kColGroup>(a, b, c, p);
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* a, const void* b, const int* cols, void* c,
                   int64_t m, int64_t n, int64_t lda, int64_t ldb,
                   int s_steps, int k_blocks, int bm, int bk,
                   bool tile_lists, cudaStream_t stream) {
  const br::Params p = br::make_params(
      a, b, cols, c, m, n, lda, ldb, bm, bk, s_steps, k_blocks, tile_lists,
      static_cast<int>(sizeof(TIn)), static_cast<int>(sizeof(TOut)));
  return br::launch<TIn, TOut>(bsmm_kernel<TIn, TOut>, a, b, c, p, stream);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// C (M x N, contiguous) = blocks of A (M x K, row stride lda) named by cols
// (int32, contiguous: M/bm x S, or with tile_lists M/bm x ceil(N/256) x S)
// . B (K x N, row stride ldb), where A has k_blocks block columns.  M must
// be a multiple of bm; each list's walk ends at its first entry outside
// [0, k_blocks).  Returns the cudaError_t of the launch (0 on success).
extern "C" int bsmm_launch(const void* a, const void* b, const void* cols,
                           void* c, int64_t m, int64_t n, int64_t lda,
                           int64_t ldb, int s_steps, int k_blocks, int bm,
                           int bk, int tile_lists, int in_dtype,
                           int out_dtype, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (bm <= 0 || bk <= 0 || m % bm || s_steps < 0) {
    return cudaErrorInvalidValue;
  }
  const int* cmap = static_cast<const int*>(cols);
  const bool t = tile_lists != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32) {
    return launch<float, float>(a, b, cmap, c, m, n, lda, ldb, s_steps,
                                k_blocks, bm, bk, t, s);
  } else if (in_dtype == kFloat32 && out_dtype == kBFloat16) {
    return launch<float, __nv_bfloat16>(a, b, cmap, c, m, n, lda, ldb,
                                        s_steps, k_blocks, bm, bk, t, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kFloat32) {
    return launch<__nv_bfloat16, float>(a, b, cmap, c, m, n, lda, ldb,
                                        s_steps, k_blocks, bm, bk, t, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, cmap, c, m, n, lda,
                                                ldb, s_steps, k_blocks, bm,
                                                bk, t, s);
  }
  return cudaErrorInvalidValue;
}
