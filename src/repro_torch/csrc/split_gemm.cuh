// A block-level product engine for Hopper (sm_90a) that keeps fp32
// accuracy on the bf16 tensor cores: C tile (64 rows per consumer x 256
// columns, fp32) = A rows . B[k, col0:col0 + 256] summed over one range
// k0:k1 (grouped_gemm.cu) or over several, one per live block of a
// block-sparse row (block_rows.cuh).
//
// Arithmetic.  An fp32 operand x is split into hi = bf16(x) and lo =
// bf16(x - hi), and A.B is accumulated in fp32 as three wgmma products,
// A_hi.B_hi + A_hi.B_lo + A_lo.B_hi: hi + lo keeps x to ~2^-17, and the
// dropped A_lo.B_lo is ~2^-18 of |a||b|, so a K = 256 product lands well
// inside the reference's fp32 hold (rtol 1e-4, atol 1e-4 sqrt(K)).
// bf16 operands are their own hi, and one product is taken.  (TF32 wgmma
// takes only K-major operands; B here is row-major, N contiguous, which
// bf16 wgmma reads in place through an MN-major descriptor.)
//
// Block shape: 384 threads, a producer warpgroup and two consumer
// warpgroups, as the bf16 flash-attention kernel.
//  - The producer streams B in k-slabs of kSlabK rows by 256 columns, in
//    two steps.  Each thread copies 8 consecutive columns of its k-rows
//    with cp.async into a staging slot, as they are in B (two 16-byte
//    copies in fp32, one in bf16, zero-filled past k1 and past the column
//    end; loaded and stored by the thread where the address forbids
//    16-byte copies), kStaging slabs ahead, with no register held while
//    they fly.  When its copies of a slab have landed, the thread reads
//    its units back, splits them and writes hi and lo as one 16-byte
//    chunk each into a ring of kStages stages.  A stage holds hi and lo in
//    the 128-byte-swizzled MN-major layout that TMA's SWIZZLE_128B gives
//    V in flash_attention.cu: four boxes of 64 columns, each kSlabK k-rows
//    of 128 bytes, 8-row atoms of 1024 bytes, the 16-byte chunk c of
//    k-row r at chunk position c ^ (r % 8).  The writes are generic-proxy
//    stores read by wgmma through the async proxy, so each producer
//    thread fences (fence.proxy.async) before it arrives on the stage's
//    "full" mbarrier (count 128).
//  - Each consumer warpgroup owns 64 rows of A.  It builds the hi and lo
//    A fragments of its rows in registers straight from A in device
//    memory (a slab's loads are issued under the products of the slab
//    before it, the next range's first slab under the last one's), issues
//    m64n256k16 wgmma with B from the stage, waits for them, and arrives
//    on the stage's "empty" mbarrier.  Producer and consumers walk the
//    same sequence of k-ranges, so their slab counts agree.
//  - 128 fp32 accumulators a consumer thread; setmaxnreg gives the
//    consumers 216 registers and the producer 72.
// Rows past A's `rows` load as zero and are never stored; so are columns
// past the column end and k past k1.
#pragma once

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace repro_torch {
namespace split_gemm {

constexpr int kRows = 64;    // rows of A per consumer warpgroup (wgmma M)
constexpr int kCols = 256;   // columns of the output tile (wgmma N)
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kSlabK = 32;   // k-rows of B per ring stage
constexpr int kStages = 4;
constexpr int kBoxCols = 64;                 // bf16 columns of a 128-byte row
constexpr int kBoxBytes = kSlabK * 128;      // one box of one part
constexpr int kPartBytes = (kCols / kBoxCols) * kBoxBytes;  // hi or lo
constexpr int kStageBytes = 2 * kPartBytes;
// B's slabs as they are in memory (fp32: 32 KB a slab), in flight
constexpr int kStaging = 2;
constexpr int kStagingBytes = kSlabK * kCols * 4;
// the ring and the staging slots, + 1 KB to align the ring to the
// 1024-byte swizzle atom
constexpr int kSmemBytes =
    kStages * kStageBytes + kStaging * kStagingBytes + 1024;
// setmaxnreg moves registers between the warpgroups of a block and never
// beyond what the block was launched with: 168 a thread, the most
// __launch_bounds__(384, 1) leaves (65536 / 384, rounded down to 8).  An
// increase the block cannot cover waits forever.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                  kThreads * kLaunchRegs,
              "setmaxnreg budget of a 384-thread block");

template <typename T>
constexpr bool kSplit = sizeof(T) == 4;  // fp32 is split, bf16 is not

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// hi = bf16(x0, x1), lo = bf16(x - hi) as bf16 pairs (x0 the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Eight columns c .. c + 7 of row `row` of B, element by element (where
// 16-byte copies are not aligned): zero past k_end and past col_end.
__device__ __forceinline__ void load8(const float* __restrict__ b,
                                      int64_t ldb, int64_t row,
                                      int64_t k_end, int64_t c,
                                      int64_t col_end, float (&v)[8]) {
  const float* src = b + row * ldb + c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = row < k_end && c + i < col_end ? __ldg(src + i) : 0.f;
  }
}

// the same for bf16 B, as four bf16 pairs
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ b,
                                      int64_t ldb, int64_t row,
                                      int64_t k_end, int64_t c,
                                      int64_t col_end, uint32_t (&v)[4]) {
  const __nv_bfloat16* src = b + row * ldb + c;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16 lo =
        row < k_end && c + 2 * i < col_end ? src[2 * i] : zero;
    const __nv_bfloat16 hi =
        row < k_end && c + 2 * i + 1 < col_end ? src[2 * i + 1] : zero;
    v[i] = bf16x2_bits(__halves2bfloat162(lo, hi));
  }
}

// Byte offset, inside one part of a stage, of the 16-byte chunk holding
// columns 8 chunk .. 8 chunk + 7 (of the 256) of k-row r.
__device__ __forceinline__ uint32_t chunk_offset(int r, int chunk) {
  return (chunk / 8) * kBoxBytes + r * 128 + (((chunk % 8) ^ (r % 8)) * 16);
}

// The ring's slabs are counted over the block's life, across the tiles a
// persistent block walks: slab `it` uses stage it % kStages in round it /
// kStages.  Round r of a stage's "full" barrier completes when the
// producer has filled it; of its "empty" barrier, when both consumers
// have released it (count 256).  The first round finds a stage empty.

// B's part of one output tile: rows k0 .. k1 - 1 (n_slabs slabs of
// kSlabK from k0, zero at or past k1) and columns col0 .. col0 + 255
// (zero at or past col_end) of a row-major B with row stride ldb.
template <typename T>
struct TileB {
  const T* b;
  int64_t ldb, k0, k1, col0, col_end;
  int n_slabs;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ld_shared_v4(uint32_t addr, uint32_t& a,
                                             uint32_t& b, uint32_t& c,
                                             uint32_t& d) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
               : "r"(addr)
               : "memory");
}

// bytes of B's row a staging unit takes: 8 columns
template <typename T>
constexpr int kUnitBytes = 8 * static_cast<int>(sizeof(T));

// This producer thread's units of slab n of tile t into a staging slot:
// k-rows r0, r0 + 4, ... (kSlabK / 4 of them), columns 8 chunk .. + 7 of
// the tile, each at r * (32 units) + chunk.  `vec`: 16-byte copies are
// aligned, and they go as cp.async, zero-filled past k1 and the column
// end; otherwise the thread loads and stores them itself.
template <typename T>
__device__ __forceinline__ void stage_slab(const TileB<T>& t, int n,
                                           bool vec, uint32_t slot,
                                           int chunk, int r0) {
  const int64_t c = t.col0 + 8 * chunk;
#pragma unroll
  for (int j = 0; j < kSlabK / 4; ++j) {
    const int r = r0 + 4 * j;
    const int64_t row = t.k0 + static_cast<int64_t>(n) * kSlabK + r;
    const uint32_t dst = slot + (r * 32 + chunk) * kUnitBytes<T>;
    if (vec) {
      constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // a copy
#pragma unroll
      for (int h = 0; h < kUnitBytes<T> / 16; ++h) {
        const int64_t left = row < t.k1 ? t.col_end - (c + kPer * h) : 0;
        const int bytes = left <= 0 ? 0
                          : left >= kPer
                              ? 16
                              : static_cast<int>(left * sizeof(T));
        const T* src = bytes ? t.b + row * t.ldb + c + kPer * h : t.b;
        cp_async16(dst + 16 * h, src, bytes);
      }
    } else if constexpr (kSplit<T>) {
      float v[8];
      load8(t.b, t.ldb, row, t.k1, c, t.col_end, v);
      uint32_t u[8];
      memcpy(u, v, sizeof(u));
      st_shared_v4(dst, u[0], u[1], u[2], u[3]);
      st_shared_v4(dst + 16, u[4], u[5], u[6], u[7]);
    } else {
      uint32_t v[4];
      load8(t.b, t.ldb, row, t.k1, c, t.col_end, v);
      st_shared_v4(dst, v[0], v[1], v[2], v[3]);
    }
  }
}

// The producer warpgroup (all 128 threads) over the block's tiles, which
// `tiles.next(TileB&)` hands out in order (false when none is left).
// Every slab of B goes twice through shared memory: into a staging slot
// as it is in B (cp.async, kStaging slabs in flight), then, once this
// thread's copies have landed, split into hi and lo in the wgmma layout,
// into ring stage it % kStages.  A thread converts the units it copied
// itself, so a copy needs no barrier but the thread's own wait.
template <typename T, typename Tiles>
__device__ __forceinline__ void produce(Tiles tiles, bool vec,
                                        uint32_t ring, uint32_t staging,
                                        uint32_t full_bar,
                                        uint32_t empty_bar) {
  const int p = threadIdx.x % 128;
  const int chunk = p % 32;  // columns 8 chunk .. + 7 of the tile
  const int r0 = p / 32;     // k-rows r0, r0 + 4, ... of the slab
  TileB<T> src;
  bool more = tiles.next(src);
  int n_src = 0;          // the next slab of `src` to copy
  uint32_t issued = 0;    // slabs copied (or being copied) so far
  // copies the sequence's next slab, if any, into `slot`; one commit
  // group either way, so the wait below counts groups, not slabs
  auto issue = [&](uint32_t slot) {
    if (more) {
      stage_slab(src, n_src, vec, staging + slot * kStagingBytes, chunk, r0);
      ++issued;
      if (++n_src == src.n_slabs) {
        n_src = 0;
        more = tiles.next(src);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStaging; ++s) issue(s);
  for (uint32_t it = 0; it < issued; ++it) {
    const uint32_t slot = it % kStaging;
    const int st = it % kStages;
    cp_async_wait<kStaging - 1>();  // slab it's copies have landed
    // round r of a stage waits for the consumers' release of round r - 1
    if (it >= kStages) {
      hopper::mbar_wait(empty_bar + 8 * st, ((it / kStages) & 1) ^ 1);
    }
    const uint32_t from = staging + slot * kStagingBytes;
    const uint32_t hi = ring + st * kStageBytes;
    const uint32_t lo = hi + kPartBytes;
#pragma unroll
    for (int j = 0; j < kSlabK / 4; ++j) {
      const int r = r0 + 4 * j;
      const uint32_t unit = from + (r * 32 + chunk) * kUnitBytes<T>;
      const uint32_t off = chunk_offset(r, chunk);
      uint32_t u[4];
      ld_shared_v4(unit, u[0], u[1], u[2], u[3]);
      if constexpr (kSplit<T>) {
        uint32_t w[4];
        ld_shared_v4(unit + 16, w[0], w[1], w[2], w[3]);
        const uint32_t x[8] = {u[0], u[1], u[2], u[3],
                               w[0], w[1], w[2], w[3]};
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split2(__uint_as_float(x[2 * i]), __uint_as_float(x[2 * i + 1]),
                 h[i], l[i]);
        }
        st_shared_v4(hi + off, h[0], h[1], h[2], h[3]);
        st_shared_v4(lo + off, l[0], l[1], l[2], l[3]);
      } else {
        st_shared_v4(hi + off, u[0], u[1], u[2], u[3]);
      }
    }
    fence_proxy_async();  // the stores, before wgmma reads them
    hopper::mbar_arrive(full_bar + 8 * st);
    issue(slot);  // this thread has read the slot: refill it
  }
}

// A's values at one k-step (16 k) for this consumer thread, in the order
// of the wgmma A fragment: rows r and r + 8 of the warpgroup's 64, columns
// k + 2 q, + 1 and k + 2 q + 8, + 9 (q = lane % 4): (r, c), (r+8, c),
// (r, c+8), (r+8, c+8), each a pair.
struct AThread {
  int64_t r;        // this thread's first row (r and r + 8)
  int q2;           // 2 (lane % 4)
  bool live0, live1;  // rows r and r + 8 inside A's rows
};

__device__ __forceinline__ AThread a_thread(int rows) {
  const int t = threadIdx.x % 128;
  AThread at;
  at.r = 16 * (t / 32) + (t % 32) / 4;
  at.q2 = 2 * (t % 4);
  at.live0 = at.r < rows;
  at.live1 = at.r + 8 < rows;
  return at;
}

// fp32 A: the 8 values of one k-step at column k (zero past k1 and past
// the rows); `vec`: 8-byte loads are aligned and k1 is even
__device__ __forceinline__ void load_a(const float* __restrict__ a,
                                       int64_t lda, const AThread& at,
                                       int64_t k, int64_t k1, bool vec,
                                       float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = (j & 1) ? at.live1 : at.live0;
    const int64_t row = at.r + 8 * (j & 1);
    const int64_t col = k + at.q2 + 8 * (j >> 1);
    const float* src = a + row * lda + col;
    if (live && vec && col + 1 < k1) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(src));
      v[2 * j] = x.x;
      v[2 * j + 1] = x.y;
    } else {
      v[2 * j] = live && col < k1 ? __ldg(src) : 0.f;
      v[2 * j + 1] = live && col + 1 < k1 ? __ldg(src + 1) : 0.f;
    }
  }
}

// bf16 A: the same values, widened to fp32 (`vec`: 4-byte loads
// aligned).  The fragment is made from them by a conversion: a fragment
// that were the loaded registers themselves would be overwritten by the
// next slab's loads while the products still read it (wgmma reads A from
// registers until the wait; ptxas forwarded a plain copy of them, and the
// sums went wrong from the second slab on).
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ a,
                                       int64_t lda, const AThread& at,
                                       int64_t k, int64_t k1, bool vec,
                                       float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = (j & 1) ? at.live1 : at.live0;
    const int64_t row = at.r + 8 * (j & 1);
    const int64_t col = k + at.q2 + 8 * (j >> 1);
    const __nv_bfloat16* src = a + row * lda + col;
    if (live && vec && col + 1 < k1) {
      const float2 x = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(src)));
      v[2 * j] = x.x;
      v[2 * j + 1] = x.y;
    } else {
      v[2 * j] = live && col < k1 ? __bfloat162float(src[0]) : 0.f;
      v[2 * j + 1] = live && col + 1 < k1 ? __bfloat162float(src[1]) : 0.f;
    }
  }
}

// The k-range of each slab a consumer multiplies, handed out in order by
// `next(k, k_end)`: slab n covers k .. k + kSlabK - 1, with k at or past
// k_end read as zero.  SlabRange is one dense range k0 .. k1 - 1.
struct SlabRange {
  int64_t k, k1;

  __device__ __forceinline__ void next(int64_t& from, int64_t& end) {
    from = k;
    end = k1;
    k += kSlabK;
  }
};

// A consumer warpgroup's loop: acc += A[0:rows, slab k-ranges] .
// B[those k, tile], over the next n_slabs k-ranges `walk` hands out (a
// later call goes on where this one stopped), B from the ring's
// slabs it0 .. it0 + n_slabs - 1 (the producer's sequence of the same
// ranges).  A points at the warpgroup's first row; `vec` as load_a's,
// for every range.  The caller zeroes acc.
template <typename T, typename Walk>
__device__ __forceinline__ void consume_walk(
    const T* __restrict__ a, int64_t lda, int rows, Walk& walk, bool vec,
    int n_slabs, uint32_t it0, uint32_t ring, uint32_t full_bar,
    uint32_t empty_bar, float (&acc)[kCols / 2]) {
  const AThread at = a_thread(rows);
  constexpr int kSteps = kSlabK / 16;  // wgmma k-steps a slab
  float cur[kSteps][8];  // A's values of a slab, fp32
  auto load_slab = [&]() {  // the walk's next slab
    int64_t k, end;
    walk.next(k, end);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      load_a(a, lda, at, k + 16 * s, end, vec, cur[s]);
    }
  };
  if (n_slabs > 0) load_slab();
  for (int n = 0; n < n_slabs; ++n) {
    const uint32_t it = it0 + n;
    const int st = it % kStages;
    uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kSplit<T>) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split2(cur[s][2 * j], cur[s][2 * j + 1], hi[s][j], lo[s][j]);
        }
      } else {  // exact: the values are bf16
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hi[s][j] = bf16x2_bits(
              __floats2bfloat162_rn(cur[s][2 * j], cur[s][2 * j + 1]));
        }
      }
    }
    hopper::mbar_wait(full_bar + 8 * st, (it / kStages) & 1);
    const uint32_t b_hi = ring + st * kStageBytes;
    const uint32_t b_lo = b_hi + kPartBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // k-step s: 16 k-rows on, two 8-row atoms; the next 64 columns are
      // the next box, kBoxBytes on
      const uint64_t d_hi =
          hopper::smem_desc(b_hi + s * 16 * 128, kBoxBytes, 1024);
      hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_hi);
      if constexpr (kSplit<T>) {
        const uint64_t d_lo =
            hopper::smem_desc(b_lo + s * 16 * 128, kBoxBytes, 1024);
        hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_lo);
        hopper::wgmma_rs_mn<kCols>(acc, lo[s], d_hi);
      }
    }
    hopper::wgmma_commit();
    // cur is free (the fragments are registers of their own): the next
    // slab's loads run under these products
    if (n + 1 < n_slabs) load_slab();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(empty_bar + 8 * st);
  }
}

// consume_walk over one dense range k0 .. k1 - 1, with acc zeroed here.
template <typename T>
__device__ __forceinline__ void consume(const T* __restrict__ a, int64_t lda,
                                        int rows, int64_t k0, int64_t k1,
                                        bool vec, int n_slabs, uint32_t it0,
                                        uint32_t ring, uint32_t full_bar,
                                        uint32_t empty_bar,
                                        float (&acc)[kCols / 2]) {
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  SlabRange range{k0, k1};
  consume_walk(a, lda, rows, range, vec, n_slabs, it0, ring, full_bar,
               empty_bar, acc);
}

template <typename TOut>
__device__ __forceinline__ TOut out_cast(float x) {
  if constexpr (sizeof(TOut) == 4) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// A consumer warpgroup with no rows in a tile still releases the tile's
// slabs it0 .. it0 + n_slabs - 1, each once it is full (so each release
// counts in its own round).
__device__ __forceinline__ void release(int n_slabs, uint32_t it0,
                                        uint32_t full_bar,
                                        uint32_t empty_bar) {
  for (int n = 0; n < n_slabs; ++n) {
    const uint32_t it = it0 + n;
    const int st = it % kStages;
    hopper::mbar_wait(full_bar + 8 * st, (it / kStages) & 1);
    hopper::mbar_arrive(empty_bar + 8 * st);
  }
}

// Columns col and col + 1 of a row of c (those below col_end) := x0, x1;
// `pairs`: two neighbouring columns may go as one store.
template <typename TOut>
__device__ __forceinline__ void put2(TOut* row, int64_t col, int64_t col_end,
                                     bool pairs, float x0, float x1) {
  if (pairs && col + 1 < col_end) {
    if constexpr (sizeof(TOut) == 4) {
      *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  } else {
    if (col < col_end) row[col] = out_cast<TOut>(x0);
    if (col + 1 < col_end) row[col + 1] = out_cast<TOut>(x1);
  }
}

// The same two columns of an fp32 row, read (zero past col_end).
__device__ __forceinline__ float2 get2(const float* row, int64_t col,
                                       int64_t col_end, bool pairs) {
  if (pairs && col + 1 < col_end) {
    return *reinterpret_cast<const float2*>(row + col);
  }
  return make_float2(col < col_end ? row[col] : 0.f,
                     col + 1 < col_end ? row[col + 1] : 0.f);
}

// Column pairs of a row whose reads are in flight together when a sum is
// added to C
constexpr int kAddBatch = 8;

// Stores this consumer thread's accumulators: rows r, r + 8 of the
// warpgroup's 64 (those below `rows`) into c (row stride ldc, pointing at
// the warpgroup's first row), columns col0 + 8 i + q2, + 1 (those below
// col_end).  `pairs`: two neighbouring columns may go as one store.
// kAdd: add them to what an fp32 c holds, kAddBatch column pairs read
// before any of them is written.
template <typename TOut, bool kAdd = false>
__device__ __forceinline__ void store(TOut* __restrict__ c, int64_t ldc,
                                      int rows, int64_t col0,
                                      int64_t col_end, bool pairs,
                                      const float (&acc)[kCols / 2]) {
  static_assert(!kAdd || sizeof(TOut) == 4, "a sum is added in fp32");
  const AThread at = a_thread(rows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? at.live1 : at.live0)) continue;
    TOut* row = c + (at.r + 8 * h) * ldc;
    if constexpr (kAdd) {
#pragma unroll
      for (int i0 = 0; i0 < kCols / 8; i0 += kAddBatch) {
        float2 was[kAddBatch];
#pragma unroll
        for (int i = 0; i < kAddBatch; ++i) {
          was[i] = get2(row, col0 + 8 * (i0 + i) + at.q2, col_end, pairs);
        }
#pragma unroll
        for (int i = 0; i < kAddBatch; ++i) {
          const int j = 4 * (i0 + i) + 2 * h;
          put2(row, col0 + 8 * (i0 + i) + at.q2, col_end, pairs,
               was[i].x + acc[j], was[i].y + acc[j + 1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i) {
        put2(row, col0 + 8 * i + at.q2, col_end, pairs, acc[4 * i + 2 * h],
             acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

}  // namespace split_gemm
}  // namespace repro_torch
