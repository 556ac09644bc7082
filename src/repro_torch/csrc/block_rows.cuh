// The persistent kernel body of the dense (tiled_matmul.cu) and the
// block-sparse (bsmm.cu) products on the split-bf16 engine
// (split_gemm.cuh):
//
//   C (m x n, contiguous) = A (m x k, row stride lda) . B (k x n, row
//   stride ldb), over the live blocks of each block row of A.
//
// A's rows fall into block rows of bm rows; the dense product is one
// block row of all m rows.  Block row i's live k-ranges are
// [kk bk, kk bk + bk) for the entries kk of its list in a padded column
// map `cols` (int32, each list s_steps long), read up to the first entry
// outside [0, k_blocks); the dense product has no map and one range
// [0, k).  The map holds one list a block row ((m / bm) x s_steps, A's
// live blocks, the same for every column tile) or one list a block row
// and 256-column tile ((m / bm) x col_tiles x s_steps, A's live blocks
// whose (bk x 256) block of B is live too): an item reads its list at
// block_row cols_row + tile cols_tile, with cols_tile 0 for the first
// kind.  A block row is cut into 64-row units (the last one shorter
// where bm is not a multiple of 64), and its units into pairs (0, 1),
// (2, 3), ...; a pair without a second unit leaves its second consumer
// idle, releasing the slabs it does not read.  Rows, columns and k past
// the shape load as zero and are never stored.
//
// Work item: a pair x one 256-column tile of C.  Both consumers of a
// block multiply their unit by the same slabs of B, which the producer
// streams once, split, for the pair: a slab of B read from L2 feeds 128
// rows.  Items walk the column tiles in groups of kColGroup; inside a
// group the pairs come one after another, each over the group's column
// tiles.  One persistent block a multiprocessor takes the items
// blockIdx.x, + gridDim.x, ...  Where kColGroup divides gridDim.x, the
// kColGroup blocks that start on one pair's items take one pair in every
// round: with one list a block row they walk the same rows of A over the
// same k-ranges, item for item of equal length, so they tend to keep
// pace and read A from L2 after the first of them; with a list a tile
// they walk the blocks each tile's B keeps, and share those of A that
// both lists hold.  The group's slices of B serve every pair in flight.
// An item whose list is empty (a block row with no live block, or no
// live block of B under the tile) stores zeros.
//
// Long sums.  The tensor cores' fp32 accumulation loses more than an
// fp32 add at every wgmma step, so the error of one accumulator grows
// faster than the reference's hold (atol 1e-4 sqrt(K)): on an H100 a
// 52-block row (K = 13312) put the worst element at 0.89-0.94 of the
// hold, against 0.14-0.20 at K <= 1280.  So where C is fp32 the
// accumulator takes kSumSlabs slabs at a time of those the item's list
// walks, and C keeps the running sum, each part added to it in fp32 by
// the thread that computed it: that row then sits at 0.23.  A bf16 C
// keeps one accumulator (its own rounding is far coarser than the loss).
#pragma once

#include "split_gemm.cuh"

namespace repro_torch {
namespace block_rows {

namespace sg = split_gemm;

// Slabs summed in the wgmma accumulator before an fp32 C takes the sum
// (K = 2048; header note).
constexpr int kSumSlabs = 64;

struct Params {
  const int* cols;  // the column map (header note); null: the dense product
  // entries between two block rows' lists and between two column tiles'
  // lists of one block row (0: one list a block row)
  int64_t cols_row, cols_tile;
  int64_t m, n, lda, ldb;
  int64_t bm, bk;       // dense: bm = m, bk = k
  int s_steps, k_blocks;
  int64_t pairs_per_row, n_pairs, col_tiles;
  int slabs_per_block;  // ceil(bk / kSlabK)
  int vec_a, vec_b, pairs_c;
};

// Item `item` of a launch (header note): its pair's first row, the rows
// of its two units (<= 0: none), its column tile, its list of the map
// (null for dense) and its count of live blocks.
struct Item {
  int64_t row0, col0;
  int rows_a, rows_b;
  const int* cols;
  int n_live;
};

template <int kColGroup>
__device__ __forceinline__ Item item_at(const Params& p, int64_t item) {
  const int64_t per_group = p.n_pairs * kColGroup;
  const int64_t group = item / per_group;
  const int64_t rem = item % per_group;
  const int64_t left = p.col_tiles - group * kColGroup;
  const int64_t cols_here = left < kColGroup ? left : kColGroup;
  const int64_t pair = rem / cols_here;
  const int64_t block_row = pair / p.pairs_per_row;
  const int64_t first = 2 * sg::kRows * (pair % p.pairs_per_row);
  const int64_t tile = group * kColGroup + rem % cols_here;
  Item it;
  it.col0 = tile * sg::kCols;
  it.row0 = block_row * p.bm + first;
  const int64_t left_a = p.bm - first;
  const int64_t left_b = left_a - sg::kRows;
  it.rows_a = static_cast<int>(left_a < sg::kRows ? left_a : sg::kRows);
  it.rows_b = static_cast<int>(left_b < sg::kRows ? left_b : sg::kRows);
  if (p.cols == nullptr) {
    // the dense product's one range [0, k) (k = 0: nothing to multiply),
    // or an empty bsmm map (s_steps = 0), whose data may be null
    it.cols = nullptr;
    it.n_live = p.s_steps > 0 && p.slabs_per_block > 0;
  } else {
    it.cols = p.cols + block_row * p.cols_row + tile * p.cols_tile;
    int n = 0;
    while (n < p.s_steps) {
      const int kk = __ldg(it.cols + n);
      if (kk < 0 || kk >= p.k_blocks) break;
      ++n;
    }
    it.n_live = n;
  }
  return it;
}

// k0 of live block j of an item
__device__ __forceinline__ int64_t block_k0(const int* cols, int j,
                                            int64_t bk) {
  return cols == nullptr ? 0 : static_cast<int64_t>(__ldg(cols + j)) * bk;
}

// The slabs of B a block's producer streams: for its items blockIdx.x, +
// gridDim.x, ..., in order, each live block's rows over the item's
// column tile.
template <typename T, int kColGroup>
struct BlockSlices {
  const Params* p;
  const T* b;
  int64_t i;  // the next item
  Item it;    // the current item
  int j;      // its next live block

  __device__ __forceinline__ bool next(sg::TileB<T>& t) {
    const int64_t n_items = p->n_pairs * p->col_tiles;
    while (j >= it.n_live) {
      if (i >= n_items) return false;
      it = item_at<kColGroup>(*p, i);
      i += gridDim.x;
      j = 0;
    }
    const int64_t k0 = block_k0(it.cols, j++, p->bk);
    t = sg::TileB<T>{b, p->ldb, k0, k0 + p->bk, it.col0, p->n,
                     p->slabs_per_block};
    return true;
  }
};

// The same sequence as the consumers read it: the k-range of each slab,
// block after block.
struct BlockWalk {
  const int* cols;
  int64_t bk;
  int per_block;
  int j, s;  // the next slab: slab s of live block j

  __device__ __forceinline__ void next(int64_t& from, int64_t& end) {
    const int64_t k0 = block_k0(cols, j, bk);
    from = k0 + static_cast<int64_t>(s) * sg::kSlabK;
    end = k0 + bk;
    if (++s == per_block) {
      s = 0;
      ++j;
    }
  }
};

template <typename TIn, typename TOut, int kColGroup>
__device__ __forceinline__ void run(const TIn* __restrict__ a,
                                    const TIn* __restrict__ b,
                                    TOut* __restrict__ c, const Params& p) {
  extern __shared__ uint8_t br_smem[];
  __shared__ __align__(8) uint64_t bars[2 * sg::kStages];
  const uint32_t ring = (hopper::smem_u32(br_smem) + 1023u) & ~1023u;
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
    // no item yet (n_live 0): the first next() takes item blockIdx.x
    sg::produce<TIn>(BlockSlices<TIn, kColGroup>{&p, b, blockIdx.x, {}, 0},
                     p.vec_b != 0, ring, staging, full_bar, empty_bar);
  } else {
    uint32_t it0 = 0;  // the ring's slabs so far
    hopper::reg_alloc<sg::kConsumerRegs>();
    for (int64_t i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it = item_at<kColGroup>(p, i);
      const int n_slabs = it.n_live * p.slabs_per_block;
      const int rows = wg == 1 ? it.rows_a : it.rows_b;
      if (rows <= 0) {  // a pair without a second unit: this consumer idles
        sg::release(n_slabs, it0, full_bar, empty_bar);
      } else {
        const int64_t row0 = it.row0 + (wg == 1 ? 0 : sg::kRows);
        TOut* c_rows = c + row0 * p.n;
        BlockWalk walk{it.cols, p.bk, p.slabs_per_block, 0, 0};
        float acc[sg::kCols / 2];
        // an fp32 C holds the running sum: the accumulator takes
        // kSumSlabs slabs at a time (header note)
        const int part = sizeof(TOut) == 4 ? kSumSlabs
                         : n_slabs > 0     ? n_slabs
                                           : 1;
        int n0 = 0;
        do {
          const int len = n_slabs - n0 < part ? n_slabs - n0 : part;
#pragma unroll
          for (int r = 0; r < sg::kCols / 2; ++r) acc[r] = 0.f;
          sg::consume_walk(a + row0 * p.lda, p.lda, rows, walk,
                           p.vec_a != 0, len, it0 + n0, ring, full_bar,
                           empty_bar, acc);
          const bool pairs = p.pairs_c != 0;
          if constexpr (sizeof(TOut) == 4) {
            if (n0 > 0) {
              sg::store<TOut, true>(c_rows, p.n, rows, it.col0, p.n, pairs,
                                    acc);
            } else {
              sg::store(c_rows, p.n, rows, it.col0, p.n, pairs, acc);
            }
          } else {
            sg::store(c_rows, p.n, rows, it.col0, p.n, pairs, acc);
          }
          n0 += len;
        } while (n0 < n_slabs);
      }
      it0 += n_slabs;
    }
  }
}

inline bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The launch's parameters; the dense product has no map (cols null,
// bm = m, bk = k, s_steps = k_blocks = 1).  tile_lists: the map holds a
// list a block row and column tile (header note).  in_size and out_size
// are the element sizes in bytes.
inline Params make_params(const void* a, const void* b, const int* cols,
                          void* c, int64_t m, int64_t n, int64_t lda,
                          int64_t ldb, int64_t bm, int64_t bk, int s_steps,
                          int k_blocks, bool tile_lists, int in_size,
                          int out_size) {
  Params p{};
  p.cols = cols;
  p.m = m;
  p.n = n;
  p.lda = lda;
  p.ldb = ldb;
  p.bm = bm;
  p.bk = bk;
  p.s_steps = s_steps;
  p.k_blocks = k_blocks;
  p.pairs_per_row = (bm + 2 * sg::kRows - 1) / (2 * sg::kRows);
  p.n_pairs = (m / bm) * p.pairs_per_row;
  p.col_tiles = (n + sg::kCols - 1) / sg::kCols;
  p.cols_tile = tile_lists ? s_steps : 0;
  p.cols_row = tile_lists ? p.col_tiles * s_steps : s_steps;
  p.slabs_per_block = static_cast<int>((bk + sg::kSlabK - 1) / sg::kSlabK);
  // 16-byte copies of B's 8-column chunks, 8- (fp32) or 4-byte (bf16)
  // loads of A's column pairs (every range starting at an even k), and
  // paired stores of C, where the addresses allow them
  p.vec_b = aligned(b, 16) && ldb % (16 / in_size) == 0;
  p.vec_a = aligned(a, 2 * in_size) && lda % 2 == 0 && bk % 2 == 0;
  p.pairs_c = aligned(c, 2 * out_size) && n % 2 == 0;
  return p;
}

// One persistent block a multiprocessor (none holds two: 168 registers a
// thread), or one an item where there are fewer.
template <typename TIn, typename TOut>
cudaError_t launch(void (*kernel)(const TIn*, const TIn*, TOut*, Params),
                   const void* a, const void* b, void* c, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sg::kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t items = p.n_pairs * p.col_tiles;
  const int64_t blocks = items < sms ? items : sms;
  kernel<<<static_cast<unsigned>(blocks), sg::kThreads, sg::kSmemBytes,
           stream>>>(static_cast<const TIn*>(a), static_cast<const TIn*>(b),
                     static_cast<TOut*>(c), p);
  return cudaGetLastError();
}

}  // namespace block_rows
}  // namespace repro_torch
