// Grouped GEMM: y[tile] = x[tile] . W[tile_expert[tile]] over bt-row token
// tiles, fp32 accumulation, cast to the output type.
//
// Replaces the TPU kernel repro/kernels/grouped_gemm.py::grouped_gemm_kernel
// (driven by grouped_gemm_pallas).  Tokens arrive sorted so that every
// bt-row tile of x belongs to one expert; tile_expert[t] names it.  The TPU
// kernel scalar-prefetches tile_expert so W's BlockSpec chases it and walks
// K as a sequential grid axis with a VMEM accumulator; here a block reads
// its expert itself and loops over D inside the block.  W is taken through
// an expert stride and a row stride, so the experts may be the K-panels of
// one row-major B without a copy.
//
// Bound on an H100 at the rank-sparse main path (T = 65536 tokens, D =
// 256, F = 32768, 128 experts, bt = 64, fp32): 4 (T D + E D F + T F) =
// 12.9 GB of operands at 3.35 TB/s is 3.85 ms, and the three bf16 products
// of the split (split_gemm.cuh) are 3.3e12 FLOP, 3.34 ms at 989 TFLOP/s:
// bound by bytes.  The earlier design of this file (64 x 64 tiles on fp32
// FMA) had a floor of 16.4 ms at the FMA units' 67 TFLOP/s and
// took 46.4 ms, more than torch.bmm over the same work.
//
// Design (split_gemm.cuh): the products run on the bf16 tensor cores as
// split-bf16 wgmma (fp32 operands as hi + lo, three products), with a
// producer warpgroup streaming W's k-slabs, split, into a swizzled
// shared-memory ring, and two consumer warpgroups building x's fragments
// in registers.  A block owns one 256-column tile of y and two 64-row
// units of the same expert, one per consumer, so a slice of W read from
// L2 feeds 128 token rows (a unit is a 64-row sub-tile of a token tile; a
// tile shorter than 64 rows, bt = 8, 16, 24, is one unit of bt rows; a
// longer one, bt = 128, is several).  The pairing is built on the host
// (kernels/grouped_gemm.py::tile_pairs): units grouped by expert, taken
// two at a time; an expert's odd unit out has a block whose second
// consumer idles.  On the main path each expert owns 8 tiles of a launch,
// so a 256 x 256 slice of W is read by 4 blocks, not 8.
//
// Work order: a work item is a pair and a column tile.  Items walk the
// column tiles in groups of kColGroup; inside a group, the pairs (ordered
// by expert) come one after another, each over the group's column tiles.
// One persistent block a multiprocessor takes items blockIdx.x, +
// gridDim.x, ..., so the blocks in flight work on neighbouring items:
// they share their units' x rows and, pair after pair of one expert, the
// same slices of W, which then come from L2.  A block's producer runs
// into its next item's slabs while the consumers store the last tile.
#include "split_gemm.cuh"
#include "dtypes.cuh"

namespace repro_torch {
namespace {

namespace sg = split_gemm;

constexpr int kColGroup = 16;  // column tiles a pair runs over in a row

struct GroupedParams {
  const int* tile_expert;
  const int* pairs;  // (n_pairs, 2) first rows of two units, -1 for none
  int64_t f, d, ldx, w_expert_stride, ldw;
  int64_t n_pairs, col_tiles;
  int bt, n_experts;
  int vec_x, vec_w, pairs_y;
};

// The work item `item` of a launch: its pair of units and column tile
// (header note), its expert and its count of k-slabs (0 for an expert
// outside [0, n_experts), which is never read: its rows store zero).
struct Item {
  int row_a, row_b;
  int64_t col0;
  int e, n_slabs;
};

__device__ __forceinline__ Item item_at(const GroupedParams& p,
                                        int64_t item) {
  const int64_t per_group = p.n_pairs * kColGroup;
  const int64_t group = item / per_group;
  const int64_t rem = item % per_group;
  const int64_t left = p.col_tiles - group * kColGroup;
  const int64_t cols_here = left < kColGroup ? left : kColGroup;
  const int64_t pair = rem / cols_here;
  Item it;
  it.col0 = (group * kColGroup + rem % cols_here) * sg::kCols;
  it.row_a = p.pairs[2 * pair];
  it.row_b = p.pairs[2 * pair + 1];
  it.e = p.tile_expert[it.row_a / p.bt];  // the same for both units
  it.n_slabs = it.e >= 0 && it.e < p.n_experts
                   ? static_cast<int>((p.d + sg::kSlabK - 1) / sg::kSlabK)
                   : 0;
  return it;
}

// The slices of W a block's producer streams: those of its items
// blockIdx.x, + gridDim.x, ..., in order, skipping items with no slabs.
template <typename T>
struct ExpertSlices {
  const GroupedParams* p;
  const T* w;
  int64_t i;

  __device__ __forceinline__ bool next(sg::TileB<T>& t) {
    const int64_t n_items = p->n_pairs * p->col_tiles;
    for (; i < n_items; i += gridDim.x) {
      const Item it = item_at(*p, i);
      if (it.n_slabs == 0) continue;
      t = sg::TileB<T>{w + static_cast<int64_t>(it.e) * p->w_expert_stride,
                       p->ldw, 0, p->d, it.col0, p->f, it.n_slabs};
      i += gridDim.x;
      return true;
    }
    return false;
  }
};

// A persistent block walks the items blockIdx.x, + gridDim.x, ...: its
// producer runs ahead into the next item's slabs while the consumers
// store the last one's tile.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(sg::kThreads, 1)
    grouped_gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                        TOut* __restrict__ y,
                        const __grid_constant__ GroupedParams p) {
  extern __shared__ uint8_t gg_smem[];
  __shared__ __align__(8) uint64_t bars[2 * sg::kStages];
  const uint32_t ring = (hopper::smem_u32(gg_smem) + 1023u) & ~1023u;
  const uint32_t staging = ring + sg::kStages * sg::kStageBytes;
  const uint32_t full_bar = hopper::smem_u32(bars);  // stage st at + 8 st
  const uint32_t empty_bar = full_bar + 8 * sg::kStages;
  if (threadIdx.x == 0) {
    for (int st = 0; st < sg::kStages; ++st) {
      hopper::mbar_init(full_bar + 8 * st, 128);
      hopper::mbar_init(empty_bar + 8 * st, 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int64_t n_items = p.n_pairs * p.col_tiles;
  const int wg = threadIdx.x / 128;  // 0 the producer, 1 and 2 consumers
  if (wg == 0) {
    hopper::reg_dealloc<sg::kProducerRegs>();
    sg::produce<TIn>(ExpertSlices<TIn>{&p, w, blockIdx.x}, p.vec_w != 0,
                     ring, staging, full_bar, empty_bar);
  } else {
    uint32_t it0 = 0;  // the ring's slabs so far
    hopper::reg_alloc<sg::kConsumerRegs>();
    for (int64_t i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it = item_at(p, i);
      const int row0 = wg == 1 ? it.row_a : it.row_b;
      if (row0 < 0) {  // an expert's odd unit out: this consumer idles
        sg::release(it.n_slabs, it0, full_bar, empty_bar);
      } else {
        const int64_t tile_end =
            (static_cast<int64_t>(row0) / p.bt + 1) * p.bt;
        const int rows = static_cast<int>(
            tile_end - row0 < sg::kRows ? tile_end - row0 : sg::kRows);
        float acc[sg::kCols / 2];
        sg::consume(x + static_cast<int64_t>(row0) * p.ldx, p.ldx, rows, 0,
                    p.d, p.vec_x != 0, it.n_slabs, it0, ring, full_bar,
                    empty_bar, acc);
        sg::store(y + static_cast<int64_t>(row0) * p.f, p.f, rows, it.col0,
                  p.f, p.pairs_y != 0, acc);
      }
      it0 += it.n_slabs;
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, void* y,
                   const GroupedParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel<TIn, TOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sg::kSmemBytes);
  if (err != cudaSuccess) return err;
  // one persistent block a multiprocessor (none holds two: 168 registers
  // a thread)
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t items = p.n_pairs * p.col_tiles;
  const int64_t blocks = items < sms ? items : sms;
  grouped_gemm_kernel<TIn, TOut>
      <<<static_cast<unsigned>(blocks), sg::kThreads, sg::kSmemBytes,
         stream>>>(static_cast<const TIn*>(x), static_cast<const TIn*>(w),
                   static_cast<TOut*>(y), p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// y (T x F, contiguous) = per bt-row tile t of x (T x D, row stride ldx):
// x[tile] . W[tile_expert[tile]], where expert e's (D x F) weight starts at
// w + e * w_expert_stride with row stride ldw.  T must be a multiple of bt
// and below 2^31; tile_expert is a contiguous int32 array of T / bt
// entries; pairs a contiguous int32 (n_pairs, 2) array of the first rows
// of 64-row units (kernels/grouped_gemm.py::tile_pairs), two units of one
// expert per entry or the second -1, covering every unit once.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int grouped_gemm_launch(const void* x, const void* w,
                                   const void* tile_expert,
                                   const void* pairs, void* y, int64_t t,
                                   int64_t f, int64_t d, int64_t ldx,
                                   int64_t w_expert_stride, int64_t ldw,
                                   int bt, int n_experts, int64_t n_pairs,
                                   int in_dtype, int out_dtype,
                                   void* stream) {
  if (t <= 0 || f <= 0) return cudaSuccess;
  if (bt <= 0 || t % bt || t > INT32_MAX || n_pairs <= 0) {
    return cudaErrorInvalidValue;
  }
  GroupedParams p{};
  p.tile_expert = static_cast<const int*>(tile_expert);
  p.pairs = static_cast<const int*>(pairs);
  p.f = f;
  p.d = d;
  p.ldx = ldx;
  p.w_expert_stride = w_expert_stride;
  p.ldw = ldw;
  p.n_pairs = n_pairs;
  p.col_tiles = (f + sg::kCols - 1) / sg::kCols;
  p.bt = bt;
  p.n_experts = n_experts;
  // 16-byte loads of W's 8-column chunks, 8- (fp32) or 4-byte (bf16)
  // loads of x's column pairs, and paired stores of y, where the
  // addresses allow them
  const int64_t in_size = in_dtype == kFloat32 ? 4 : 2;
  const int64_t w_vec = 16 / in_size;  // elements of a 16-byte vector
  p.vec_w = aligned(w, 16) && ldw % w_vec == 0 &&
            (n_experts == 1 || w_expert_stride % w_vec == 0);
  p.vec_x = aligned(x, 2 * in_size) && ldx % 2 == 0 && d % 2 == 0;
  p.pairs_y = aligned(y, out_dtype == kFloat32 ? 8 : 4) && f % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32) {
    return launch<float, float>(x, w, y, p, s);
  } else if (in_dtype == kFloat32 && out_dtype == kBFloat16) {
    return launch<float, __nv_bfloat16>(x, w, y, p, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kFloat32) {
    return launch<__nv_bfloat16, float>(x, w, y, p, s);
  } else if (in_dtype == kBFloat16 && out_dtype == kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, p, s);
  }
  return cudaErrorInvalidValue;
}
