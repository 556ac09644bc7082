// Block-sparse C[M,N] = A[M,K] . B[K,N] where A's live blocks are given by
// a padded CSR column map, fp32 accumulation, cast to the output type.
//
// Replaces the TPU kernel repro/kernels/bsmm.py::bsmm_kernel (driven by
// bsmm_pallas).  A is dense-stored in (bm x bk) blocks; cols is an
// (M/bm, S) int32 map whose row i lists the live block columns of block
// row i, padded with -1.  The TPU kernel gets cols through scalar prefetch
// and walks S as a sequential grid axis; here each thread block owns one
// 64-row sub-tile of one block row and one 64-column tile of C, reads its
// row of cols itself and walks it until the first entry that is not a block
// column of A (-1, or one at or past K/bk, which is never read).  Only live
// (bm x bk) . (bk x N-tile) products are loaded and multiplied; a block row
// with no live block writes zeros.
//
// Bound on an H100: FLOPs follow the live blocks (2 bm bk N per live block),
// which at the SUMMA shapes (bm = bk = 256, N = 32768, block fill 0.3) is
// compute-bound on the 67 TFLOP/s of fp32 FMA, like the dense kernel.  The
// simple design leaves on the table what tiled_matmul.cu lists, plus
// load balance: block rows with more live blocks run longer and nothing
// redistributes their work.
#include "tile.cuh"

namespace repro_torch {
namespace {

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    bsmm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                const int* __restrict__ cols, TOut* __restrict__ c, int64_t m,
                int64_t n, int64_t lda, int64_t ldb, int s_steps,
                int k_blocks, int bm, int bk, int sub_tiles) {
  __shared__ TileSmem sm;
  float acc[4][4] = {};
  const int64_t block_row = blockIdx.y / sub_tiles;
  const int sub = blockIdx.y % sub_tiles;
  const int64_t row0 = block_row * bm + static_cast<int64_t>(sub) * kTileM;
  const int64_t block_end = (block_row + 1) * bm;
  const int64_t row_end = block_end < m ? block_end : m;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  const int* row_cols = cols + block_row * s_steps;
  for (int s = 0; s < s_steps; ++s) {
    const int kk = row_cols[s];  // the same for every thread of the block
    if (kk < 0 || kk >= k_blocks) break;
    const int64_t k0 = static_cast<int64_t>(kk) * bk;
    accumulate_tile(a, lda, b, ldb, row0, row_end, col0, n, k0, k0 + bk, sm,
                    acc);
  }
  store_tile(c, n, row0, row_end, col0, n, acc);
}

template <typename TIn, typename TOut>
void launch(const void* a, const void* b, const int* cols, void* c, int64_t m,
            int64_t n, int64_t lda, int64_t ldb, int s_steps, int k_blocks,
            int bm, int bk, int sub_tiles, dim3 grid, cudaStream_t stream) {
  bsmm_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), cols,
      static_cast<TOut*>(c), m, n, lda, ldb, s_steps, k_blocks, bm, bk,
      sub_tiles);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// C (M x N, contiguous) = blocks of A (M x K, row stride lda) named by cols
// (M/bm x S int32, contiguous) . B (K x N, row stride ldb), where A has
// k_blocks block columns.  M must be a multiple of bm; each row's walk ends
// at its first entry outside [0, k_blocks).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bsmm_launch(const void* a, const void* b, const void* cols,
                           void* c, int64_t m, int64_t n, int64_t lda,
                           int64_t ldb, int s_steps, int k_blocks, int bm,
                           int bk, int in_dtype, int out_dtype, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (bm <= 0 || bk <= 0 || m % bm) return cudaErrorInvalidValue;
  const int sub_tiles = (bm + kTileM - 1) / kTileM;
  const int64_t tiles_m = (m / bm) * sub_tiles;
  const int64_t tiles_n = (n + kTileN - 1) / kTileN;
  if (tiles_m > 65535 || tiles_n > 2147483647LL) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 grid(static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(tiles_m));
  const int* cmap = static_cast<const int*>(cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32) {
    launch<float, float>(a, b, cmap, c, m, n, lda, ldb, s_steps, k_blocks, bm,
                         bk, sub_tiles, grid, s);
  } else if (in_dtype == kFloat32 && out_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(a, b, cmap, c, m, n, lda, ldb, s_steps,
                                 k_blocks, bm, bk, sub_tiles, grid, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(a, b, cmap, c, m, n, lda, ldb, s_steps,
                                 k_blocks, bm, bk, sub_tiles, grid, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, cmap, c, m, n, lda, ldb,
                                         s_steps, k_blocks, bm, bk, sub_tiles,
                                         grid, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
