// Grouped GEMM: y[tile] = x[tile] . W[tile_expert[tile]] over bt-row token
// tiles, fp32 accumulation, cast to the output type.
//
// Replaces the TPU kernel repro/kernels/grouped_gemm.py::grouped_gemm_kernel
// (driven by grouped_gemm_pallas).  Tokens arrive sorted so that every
// bt-row tile of x belongs to one expert; tile_expert[t] names it.  The TPU
// kernel scalar-prefetches tile_expert so W's BlockSpec chases it and walks
// K as a sequential grid axis with a VMEM accumulator; here each thread
// block owns one 64-row sub-tile of one token tile and one 64-column tile
// of y, reads its tile's expert itself and loops over D inside the block
// (tile.cuh).  A token tile shorter than 64 rows (bt = 8, 16, 24 on the
// rank-sparse route) gets a block of its own whose rows past the tile load
// as zero and are never stored, so no block mixes two experts.  W is taken
// through an expert stride and a row stride, so the experts may be the
// K-panels of one row-major B without a copy.
//
// Bound on an H100: on the rank-sparse main path (bt = r_pad = 64, D = 256,
// F = 32768) each token row costs 2 D F FLOP against 4 (D + F) bytes, so
// the kernel is compute-bound on the 67 TFLOP/s of fp32 FMA, like
// tiled_matmul.cu, and leaves on the table what that file lists.  Tiles
// shorter than 64 rows also waste the block's unused rows of FMA.
#include "tile.cuh"

namespace repro_torch {
namespace {

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                        const int* __restrict__ tile_expert,
                        TOut* __restrict__ y, int64_t t, int64_t f,
                        int64_t d, int64_t ldx, int64_t w_expert_stride,
                        int64_t ldw, int bt, int n_experts, int sub_tiles,
                        int64_t tiles_n) {
  __shared__ TileSmem sm;
  float acc[4][4] = {};
  // one flat grid: the column tile varies fastest, as in the 2-D kernels
  const int64_t bid = blockIdx.x;
  const int64_t col0 = (bid % tiles_n) * kTileN;
  const int64_t row_tile = bid / tiles_n;
  const int64_t tile = row_tile / sub_tiles;
  const int sub = static_cast<int>(row_tile % sub_tiles);
  const int64_t row0 = tile * bt + static_cast<int64_t>(sub) * kTileM;
  const int64_t tile_end_ = (tile + 1) * bt;
  const int64_t row_end = tile_end_ < t ? tile_end_ : t;
  const int e = tile_expert[tile];  // the same for every thread of the block
  // an expert outside [0, n_experts) is never read: its rows store zero
  if (e >= 0 && e < n_experts) {
    accumulate_tile(x, ldx, w + static_cast<int64_t>(e) * w_expert_stride,
                    ldw, row0, row_end, col0, f, 0, d, sm, acc);
  }
  store_tile(y, f, row0, row_end, col0, f, acc);
}

template <typename TIn, typename TOut>
void launch(const void* x, const void* w, const int* te, void* y, int64_t t,
            int64_t f, int64_t d, int64_t ldx, int64_t sw, int64_t ldw,
            int bt, int n_experts, int sub_tiles, int64_t tiles_n,
            int64_t blocks, cudaStream_t stream) {
  grouped_gemm_kernel<TIn, TOut>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const TIn*>(x), static_cast<const TIn*>(w), te,
          static_cast<TOut*>(y), t, f, d, ldx, sw, ldw, bt, n_experts,
          sub_tiles, tiles_n);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// y (T x F, contiguous) = per bt-row tile t of x (T x D, row stride ldx):
// x[tile] . W[tile_expert[tile]], where expert e's (D x F) weight starts at
// w + e * w_expert_stride with row stride ldw.  T must be a multiple of bt;
// tile_expert is a contiguous int32 array of T / bt entries.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int grouped_gemm_launch(const void* x, const void* w,
                                   const void* tile_expert, void* y,
                                   int64_t t, int64_t f, int64_t d,
                                   int64_t ldx, int64_t w_expert_stride,
                                   int64_t ldw, int bt, int n_experts,
                                   int in_dtype, int out_dtype,
                                   void* stream) {
  if (t <= 0 || f <= 0) return cudaSuccess;
  if (bt <= 0 || t % bt) return cudaErrorInvalidValue;
  const int sub_tiles = (bt + kTileM - 1) / kTileM;
  const int64_t tiles_m = (t / bt) * sub_tiles;
  const int64_t tiles_n = (f + kTileN - 1) / kTileN;
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32) {
    launch<float, float>(x, w, te, y, t, f, d, ldx, w_expert_stride, ldw, bt,
                         n_experts, sub_tiles, tiles_n, blocks, s);
  } else if (in_dtype == kFloat32 && out_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(x, w, te, y, t, f, d, ldx, w_expert_stride,
                                 ldw, bt, n_experts, sub_tiles, tiles_n,
                                 blocks, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(x, w, te, y, t, f, d, ldx, w_expert_stride,
                                 ldw, bt, n_experts, sub_tiles, tiles_n,
                                 blocks, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, te, y, t, f, d, ldx,
                                         w_expert_stride, ldw, bt, n_experts,
                                         sub_tiles, tiles_n, blocks, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
