// Flash attention, forward: O = softmax(scale * Q K^T + mask) V with an
// online softmax, causal and sliding-window masks and GQA head groups; a
// query row with no live key gives 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fa_kernel
// (driven by flash_attention_pallas).  There the grid walks the key tiles
// as a sequential axis and carries the running max, sum and accumulator in
// VMEM scratch, skipping a dead tile with pl.when.  Here a block owns one
// query tile of one (batch, head) and loops over the key tiles itself, so
// blocks share nothing: it visits only the key tiles that some of its rows
// can see (causal: keys up to its last query; a window W: keys after its
// first query - W), which is the TPU kernel's skip and what makes causal
// attention about half the work and windowed attention O(S W).
//
// Two routes, chosen by the inputs' type; neither ever stands in for the
// other:
//  - bf16: fa_wgmma_kernel, on the tensor cores (below);
//  - fp32: fa_fma_kernel, fp32 FMA (never TF32, which keeps ~3 digits: the
//    reference's fp32 attention tolerance is 2e-3, and an fp32 forward of
//    the LM is held within 1e-3 of max |logit|).
// Shared conventions.  Q (B, H, Sq, Dh), K and V (B, Hkv, Sk, Dh) and O
// (B, H, Sq, Dh) are taken through (batch, head, sequence) strides with
// Dh contiguous, so the (B, S, H, Dh) -> (B, H, S, Dh) transposes of the
// attention layer need no copy.  Any Dh from 1 to 256 runs: the kernels
// are instantiated for widths 64, 128 and 256, and a launch takes the
// next of them at or above the real Dh.  Columns past the real Dh read as
// zero in Q, K and V (TMA's fill past the tensor map's Dh on the bf16
// route, a masked load on the fp32 one), which leaves Q K^T unchanged and
// gives zero columns of O, and they are never stored.  Query head h reads kv head
// (h % H) / (H / Hkv) of its batch, as the TPU kernel's kv_index does
// (groups need not be powers of two).  Query tiles run latest first, so
// under a causal mask the longest rows start first.  The running max
// starts at -1e30, not -inf, so exp(m_prev - m_new) is never NaN; a masked
// score contributes exactly 0, so a row whose keys are all masked keeps
// l = 0 and is written as 0.  Rows and keys past Sq / Sk (a ragged tail)
// read as zero, are masked and are never stored.
//
// Bound on an H100 at the LM's shape (B = 4, H = 32, Hkv = 8, S = 4096,
// Dh = 64, bf16, causal): the live work is 2.75e11 FLOP against 0.17 GB of
// Q, K, V and O, so attention is bound by operations: 0.278 ms at the
// 989 TFLOP/s of bf16 tensor cores (0.050 ms by bytes at 3.35 TB/s).
//
// The bf16 route, and what each part does about what held the earlier
// fp32-FMA design of this route to 21 TFLOP/s at that shape:
//  - Products on the FMA units (a 4.2 ms floor at 67 TFLOP/s): S = Q K^T
//    and O += P V are wgmma on the bf16 tensor cores, fp32 accumulation.
//    S is m64n64k16 with Q and K read from shared memory (K-major);
//    O is m64n{Dh}k16 with P from registers and V from shared memory
//    through a transposed (MN-major) descriptor, V being key-major with Dh
//    contiguous.
//  - Tiles staged element by element, widened to fp32 (twice the shared
//    bytes): TMA copies whole bf16 tiles.  One 4-D tensor map per operand,
//    (Dh, S, heads, batch) with the strides the wrapper passes, is built on
//    the host, so the transposed views need no copy.  A box is 64 columns
//    (128 bytes) by a tile's rows with the 128-byte swizzle wgmma reads;
//    a Dh row is 1, 2 or 4 boxes.  TMA fills zeros past Sq, Sk and Dh.
//  - Loads that do not overlap compute (each key tile between two
//    __syncthreads): warp specialisation.  One producer thread keeps a
//    ring of K/V stages full (4, 3 and 2 at Dh 64, 128, 256), arming
//    each stage's "full" mbarrier with its byte count; the consumers wait
//    on it, and arrive on the stage's "empty" barrier once their P V
//    product on it has completed, so the next tiles' copies run under
//    this one's math.
//    setmaxnreg leaves the producer warpgroup 40 registers and gives the
//    consumers 232.
//  - Within a consumer warpgroup, tile n's S = Q K^T is issued together
//    with tile n - 1's P V, so tile n's max and exponentials run while
//    the tensor cores compute P V of tile n - 1.  O is rescaled only when
//    some row of the warp has a new max.
//  - P through shared memory for every tile: the S accumulator, scaled
//    and exponentiated, is register for register the A fragment of the
//    P V wgmma (the same rows and columns), so P stays in registers.  It
//    enters P V as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi),
//    two wgmma per 16 keys: one bf16 P leaves an error of up to
//    2^-9 sum(p |v|) / l per element, which on a row with few live keys
//    and a sum that cancels (the first rows of a causal head) exceeds
//    the bf16 hold of chip_smoke.py (2^-7 |want| + 2e-2 rms(want); 1.76x
//    it at the LM's shape on an H100, variant one_bf16_p of
//    scripts/compare_flash_attention.py); hi + lo is P to ~2^-17.
//    l sums P in fp32, which hi + lo, the P that enters P V, equals to
//    that precision, so numerator and denominator use the same weights.
//  - 8-row warps re-reading the query row for every 4 columns: a block is
//    128 query rows, two consumer warpgroups of 64 that share every K/V
//    tile; Q is copied once and read by wgmma from shared memory.
//  - The softmax works in the accumulator's layout: scale * log2(e) is one
//    multiply of S, exp2 follows; a row's max and sum are shuffles among
//    the four lanes that hold it; the masks are tested only on tiles that
//    cross the diagonal, the window's edge or Sk.
// Key tiles are 64 keys at every Dh: ptxas gives the consumer code of a
// 384-thread block the 168 registers of its launch bound at Dh 64 and
// 128, and 128-key tiles (64 registers of S, 64 of P) spilled there and
// serialised the wgmma; with 64 keys a thread holds 32 of S, 32 of P and
// Dh / 2 of O.  Dh 256 keeps two consumer warpgroups: there ptxas does
// give the consumers setmaxnreg's 232, whose 128 registers of O, 32 of S
// and 32 of P it exceeds by little (some spill), the same whatever the
// number of warpgroups, and Q (64 KB) with two K/V stages (128 KB) fits
// shared memory; one warpgroup would only halve the use of each K/V
// tile.  The epilogue divides by l in fp32 and writes bf16 pairs through
// O's strides.
#include "hopper.cuh"
#include "dtypes.cuh"

#include <climits>
#include <cmath>
#include <cstring>

namespace repro_torch {
namespace {

constexpr float kFaNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32 route: one block of 256 threads owns one 64-row query tile.  Q
// (pre-scaled), one key tile and one value tile are staged in shared
// memory as fp32.  Each warp owns 8 query rows: for S = Q K^T a lane
// holds its rows' scores against keys lane, lane + 32 (float4 reads of
// padded rows, conflict-free); the row max and sum are warp shuffles; P
// goes through shared memory to P V, where a lane owns Dh / 32 contiguous
// output columns in registers.
// ---------------------------------------------------------------------------

constexpr int kFaRows = 64;                      // query rows per block
constexpr int kFaWarps = 8;
constexpr int kFaThreads = kFaWarps * 32;
constexpr int kFaRowsPerWarp = kFaRows / kFaWarps;  // 8

template <int DH>
struct FaShape {
  static constexpr int kKeys = DH == 256 ? 32 : 64;  // keys per tile
  static constexpr int kKeysPerLane = kKeys / 32;
  static constexpr int kColsPerLane = DH / 32;
  static constexpr int kLdQK = DH + 4;  // float4 rows 4 banks apart
  static constexpr int kLdP = kKeys + 4;
  static constexpr int kSmemFloats =
      kFaRows * kLdQK + kKeys * kLdQK + kKeys * DH + kFaRows * kLdP;
};

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t heads, kv_heads, sq, sk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal, has_window;
  int64_t window;
  int dh;  // the real head width, at most the kernel's DH
};

// dst[r][d] (row stride ld) = src[row0 + r][d] * mul for r < rows, zero
// for rows at or past end and for columns at or past dh; consecutive
// threads take consecutive d.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* __restrict__ src,
                                           int64_t row_stride, int64_t row0,
                                           int64_t end, int rows, int dh,
                                           float mul) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kFaThreads) {
    const int r = idx / DH;
    const int d = idx % DH;
    const int64_t gr = row0 + r;
    float x = 0.f;
    if (gr < end && d < dh) x = src[gr * row_stride + d] * mul;
    dst[r * ld + d] = x;
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const float* src, float (&dst)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + c);
      dst[c] = x.x;
      dst[c + 1] = x.y;
      dst[c + 2] = x.z;
      dst[c + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "Dh / 32 is 2, 4 or 8");
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kFaThreads)
    fa_fma_kernel(const FaParams p) {
  using S = FaShape<DH>;
  constexpr int R = kFaRowsPerWarp;
  constexpr int KPL = S::kKeysPerLane;
  constexpr int CPL = S::kColsPerLane;
  extern __shared__ float4 fa_smem[];
  float* s_q = reinterpret_cast<float*>(fa_smem);
  float* s_k = s_q + kFaRows * S::kLdQK;
  float* s_v = s_k + S::kKeys * S::kLdQK;
  float* s_p = s_v + S::kKeys * DH;

  // blockIdx.x: (batch, head); blockIdx.y: query tile, latest first, so
  // under a causal mask the longest tiles of every head start first
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t kvh = h / (p.heads / p.kv_heads);
  const int64_t q0 =
      (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kFaRows;
  const int64_t q_end = q0 + kFaRows < p.sq ? q0 + kFaRows : p.sq;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the keys some row of this tile can see
  int64_t k_lo = 0;
  int64_t k_hi = p.sk;
  if (p.causal && q_end < k_hi) k_hi = q_end;
  if (p.has_window && q0 - p.window + 1 > k_lo) k_lo = q0 - p.window + 1;
  k_lo = (k_lo / S::kKeys) * S::kKeys;

  stage_rows<DH>(s_q, S::kLdQK, q, p.q_ss, q0, p.sq, kFaRows, p.dh,
                 p.scale);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * R;
  float m[R], l[R], acc[R][CPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kFaNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }

  for (int64_t kt = k_lo; kt < k_hi; kt += S::kKeys) {
    __syncthreads();  // the previous tile's reads of s_k / s_v are done
    stage_rows<DH>(s_k, S::kLdQK, k, p.k_ss, kt, p.sk, S::kKeys, p.dh, 1.f);
    stage_rows<DH>(s_v, DH, v, p.v_ss, kt, p.sk, S::kKeys, p.dh, 1.f);
    __syncthreads();

    // scores of this warp's rows against this lane's keys
    float s[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[r][t] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        kv[t] = *reinterpret_cast<const float4*>(
            s_k + (lane + 32 * t) * S::kLdQK + d);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(s_q + (r0 + r) * S::kLdQK + d);
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          float x = s[r][t];
          x = fmaf(qv.x, kv[t].x, x);
          x = fmaf(qv.y, kv[t].y, x);
          x = fmaf(qv.z, kv[t].z, x);
          x = fmaf(qv.w, kv[t].w, x);
          s[r][t] = x;
        }
      }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t qi = q0 + r0 + r;
      bool live[KPL];
      float mx = kFaNegInf;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int64_t kj = kt + lane + 32 * t;
        live[t] = kj < p.sk && (!p.causal || kj <= qi) &&
                  (!p.has_window || qi - kj < p.window);
        if (live[t]) mx = fmaxf(mx, s[r][t]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const float pr = live[t] ? expf(s[r][t] - m_new) : 0.f;
        s_p[(r0 + r) * S::kLdP + lane + 32 * t] = pr;
        sum += pr;
      }
      l[r] = alpha * l[r] + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();  // this warp's rows of P are written

    // acc += P V over the tile's keys, four at a time
#pragma unroll 2
    for (int j = 0; j < S::kKeys; j += 4) {
      float vr[4][CPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_cols<CPL>(s_v + (j + jj) * DH + lane * CPL, vr[jj]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(s_p + (r0 + r) * S::kLdP + j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float x = acc[r][c];
          x = fmaf(pv.x, vr[0][c], x);
          x = fmaf(pv.y, vr[1][c], x);
          x = fmaf(pv.z, vr[2][c], x);
          x = fmaf(pv.w, vr[3][c], x);
          acc[r][c] = x;
        }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t qi = q0 + r0 + r;
    if (qi >= p.sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // no live key -> 0
    float* row = o + qi * p.o_ss + lane * CPL;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (lane * CPL + c < p.dh) row[c] = acc[r][c] / denom;
    }
  }
}

template <int DH>
cudaError_t launch_fma(const FaParams& p, int64_t batch_heads,
                       cudaStream_t stream) {
  constexpr size_t smem = FaShape<DH>::kSmemFloats * sizeof(float);
  const int64_t q_tiles = (p.sq + kFaRows - 1) / kFaRows;
  if (q_tiles > 65535) return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch_heads),
                  static_cast<unsigned>(q_tiles));
  fa_fma_kernel<DH><<<grid, kFaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: TMA ring of K/V tiles, wgmma, P in registers
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;  // query rows of one consumer warpgroup
constexpr int kWgConsumers = 2;
constexpr int kWgTileRows = kWgRows * kWgConsumers;   // a block's rows
constexpr int kWgThreads = 128 * (1 + kWgConsumers);  // + the producer
constexpr int kBoxCols = 64;       // bf16 columns of one swizzled box
constexpr int kBoxRowBytes = 128;  // = the swizzle span
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct WgShape {
  static constexpr int kKeys = 64;  // keys per tile (header note)
  // K/V ring depth: a stage is released only after the next tile's S is
  // computed, so two stages would leave the next copy no time to land;
  // four at Dh 64 (5.6 % faster than three at the LM's shape on an H100:
  // variant stages3_dh64 of scripts/compare_flash_attention.py), three at
  // 128, and two at 256, where shared memory holds no more
  static constexpr int kStages = DH == 64 ? 4 : DH == 128 ? 3 : 2;
  static constexpr int kBoxes = DH / kBoxCols;
  static constexpr uint32_t kQBytes = kWgTileRows * DH * 2;
  static constexpr uint32_t kKVBytes = kKeys * DH * 2;  // K or V, a stage
  // Q, the K stages, the V stages; + 1 KB to align the first to the
  // 1024-byte swizzle atom
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
};

struct WgParams {
  __nv_bfloat16* o;
  int64_t heads, kv_heads, sq, sk;
  int64_t o_sb, o_sh, o_ss;
  float scale_log2;  // scale * log2(e)
  int causal, has_window;
  int64_t window;
  int dh;  // the real head width: columns at or past it are not stored
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// Two probabilities of one row (x0 the lower column: the low half) as
// two bf16 pairs whose sum is them to ~2^-17: hi = bf16(x), lo =
// bf16(x - hi).  Adds x0 + x1 to `sum`: hi + lo, the weights that enter
// P V, equal them to that precision (summing hi + lo instead, unpacking
// lo, took 6.7 % longer at the LM's shape on an H100: variant
// l_from_hi_lo of scripts/compare_flash_attention.py).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  sum += x0 + x1;
  hi = as_u32(h);
  lo = as_u32(l);
}

// S = Q K^T of one key tile, issued (not waited for): k-steps of 16
// columns of Dh, box ks / 4 and 32 bytes a step inside it
template <int DH, int BC>
__device__ __forceinline__ void issue_qk(float (&s)[BC / 2], uint32_t q_wg,
                                         uint32_t k_st) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint32_t step = (ks % 4) * 32;
    hopper::wgmma_ss<BC>(
        s,
        hopper::smem_desc(q_wg + (ks / 4) * kWgTileRows * kBoxRowBytes + step,
                          16, 1024),
        hopper::smem_desc(k_st + (ks / 4) * BC * kBoxRowBytes + step, 16,
                          1024),
        ks > 0);
  }
}

// O += P V = hi V + lo V of one key tile, issued: k-steps of 16 keys (16
// rows of 128 bytes of each V box; the next 64 columns of Dh are the next
// box, BC rows on)
template <int DH, int BC>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&hi)[BC / 16][4],
                                         const uint32_t (&lo)[BC / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const uint64_t dv = hopper::smem_desc(v_st + kk * 16 * kBoxRowBytes,
                                          BC * kBoxRowBytes, 1024);
    hopper::wgmma_rs_mn<DH>(o, hi[kk], dv);
    hopper::wgmma_rs_mn<DH>(o, lo[kk], dv);
  }
}

// The online softmax of one tile of scores, in place.  This thread holds
// rows row0 (registers 4i, 4i+1) and row0 + 8 (4i+2, 4i+3) at columns
// kt + 8i + col and + 1.  S goes to log2 units, masked scores to -inf
// (tested only on a tile that crosses the diagonal, the window's edge or
// Sk); the running max m of the two rows takes the tile's (over the four
// lanes that hold a row), alpha is exp2(old max - new), and S becomes
// P = exp2(S - m), exactly 0 where masked.
template <int BC>
__device__ __forceinline__ void softmax_tile(float (&s)[BC / 2],
                                             const WgParams& p, int64_t kt,
                                             int64_t qw0, int64_t row0,
                                             int col, float (&m)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) s[i] *= p.scale_log2;
  const bool edge = kt + BC > p.sk || (p.causal && kt + BC - 1 > qw0) ||
                    (p.has_window && qw0 + kWgRows - 1 - kt >= p.window);
  if (edge) {
    // in 32-bit offsets from the tile: key c = kt + col + 8 (i / 4) +
    // (i & 1) against keys < sk - kt, and row0 - kt (+ 8) for the masks
    const int keys = static_cast<int>(p.sk - kt < BC ? p.sk - kt : BC);
    const int64_t w = p.has_window ? p.window : int64_t{1} << 40;
    int lo_c[2], hi_c[2];  // live keys of a row: lo_c <= c - col <= hi_c
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t d = row0 + 8 * r - kt;  // query - the tile's first key
      const int64_t last = p.causal ? (d < keys - 1 ? d : keys - 1)
                                    : keys - 1;
      const int64_t first = d - w + 1 > 0 ? d - w + 1 : 0;
      lo_c[r] = static_cast<int>((first > BC ? BC : first) - col);
      hi_c[r] = static_cast<int>((last < -1 ? -1 : last) - col);
    }
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      const int c = 8 * (i / 4) + (i & 1);
      const int r = (i >> 1) & 1;
      if (c < lo_c[r] || c > hi_c[r]) s[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BC / 2; i += 4) {
    mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);
}

// P (in s) as two bf16 parts: hi[kk] and lo[kk] are the A fragments of
// keys 16 kk .. 16 kk + 15 (registers 8 kk .. 8 kk + 7 of S); adds each
// row's P to sum
template <int BC>
__device__ __forceinline__ void split_tile(const float (&s)[BC / 2],
                                           uint32_t (&hi)[BC / 16][4],
                                           uint32_t (&lo)[BC / 16][4],
                                           float (&sum)[2]) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * kk + 2 * j;
      split_bf16(s[i], s[i + 1], hi[kk][j], lo[kk][j], sum[j & 1]);
    }
  }
}

// One row of O divided by denom, from this thread's registers: `half` 0
// takes registers 4i, 4i + 1 (the row row0), 1 takes 4i + 2, 4i + 3 (row0
// + 8), at columns 8i + col and + 1 of `dst`, the row's start.  Columns at
// or past dh are not stored; a pair goes as one bf16x2 store where the
// address allows it (an odd Dh or row stride gives odd rows).
template <int DH>
__device__ __forceinline__ void store_o_row(__nv_bfloat16* dst,
                                            const float (&o)[DH / 2],
                                            int half, float denom, int col,
                                            int dh) {
  const bool pairs = (reinterpret_cast<uintptr_t>(dst + col) & 3u) == 0;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 4) {
    const int c = col + 2 * i;
    const float x0 = o[i + 2 * half] / denom;
    const float x1 = o[i + 2 * half + 1] / denom;
    if (pairs && c + 1 < dh) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(x0, x1);
    } else {
      if (c < dh) dst[c] = __float2bfloat16_rn(x0);
      if (c + 1 < dh) dst[c + 1] = __float2bfloat16_rn(x1);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const WgParams p) {
  using S = WgShape<DH>;
  constexpr int BC = S::kKeys;
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t bars[2 * S::kStages + 1];
  // shared layout: Q as kBoxes boxes of (128 rows x 128 bytes); each stage
  // of K and of V as kBoxes boxes of (BC rows x 128 bytes)
  const uint32_t s_q = (hopper::smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + S::kQBytes;
  const uint32_t s_v = s_k + S::kStages * S::kKVBytes;
  const uint32_t full_bar = hopper::smem_u32(bars);  // stage st at + 8 st
  const uint32_t empty_bar = full_bar + 8 * S::kStages;
  const uint32_t q_bar = empty_bar + 8 * S::kStages;

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t kvh = h / (p.heads / p.kv_heads);
  const int64_t q0 =
      (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kWgTileRows;
  const int64_t q_end = q0 + kWgTileRows < p.sq ? q0 + kWgTileRows : p.sq;
  // the keys some row of this tile can see
  int64_t k_lo = 0;
  int64_t k_hi = p.sk;
  if (p.causal && q_end < k_hi) k_hi = q_end;
  if (p.has_window && q0 - p.window + 1 > k_lo) k_lo = q0 - p.window + 1;
  k_lo = (k_lo / BC) * BC;
  const int n_tiles =
      k_hi > k_lo ? static_cast<int>((k_hi - k_lo + BC - 1) / BC) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      hopper::mbar_init(full_bar + 8 * st, 1);
      hopper::mbar_init(empty_bar + 8 * st, 128 * kWgConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // 0 the producer, 1 and 2 consumers
  if (wg == 0) {
    // producer warpgroup: one thread issues every copy
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_bar, S::kQBytes);
      for (int j = 0; j < S::kBoxes; ++j) {
        hopper::tma_load_4d(s_q + j * kWgTileRows * kBoxRowBytes, &tq, q_bar,
                            j * kBoxCols, static_cast<int>(q0),
                            static_cast<int>(h), static_cast<int>(b));
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % S::kStages;
        // round r of a stage waits for the consumers' release of round
        // r - 1 (the first round finds the stage empty)
        if (n >= S::kStages) {
          hopper::mbar_wait(empty_bar + 8 * st, ((n / S::kStages) & 1) ^ 1);
        }
        const uint32_t full = full_bar + 8 * st;
        hopper::mbar_arrive_expect_tx(full, 2 * S::kKVBytes);
        const int kt = static_cast<int>(k_lo + static_cast<int64_t>(n) * BC);
        for (int j = 0; j < S::kBoxes; ++j) {
          const uint32_t box = st * S::kKVBytes + j * BC * kBoxRowBytes;
          hopper::tma_load_4d(s_k + box, &tk, full, j * kBoxCols, kt,
                              static_cast<int>(kvh), static_cast<int>(b));
          hopper::tma_load_4d(s_v + box, &tv, full, j * kBoxCols, kt,
                              static_cast<int>(kvh), static_cast<int>(b));
        }
      }
    }
  } else {
    // consumer warpgroup cw: query rows q0 + 64 cw .. + 63; this thread
    // holds rows row0 and row0 + 8, columns 8 i + col and + 1
    hopper::reg_alloc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int64_t qw0 = q0 + kWgRows * cw;
    const int64_t row0 = qw0 + 16 * (t / 32) + (t % 32) / 4;
    const int col = 2 * (t % 4);
    const uint32_t q_wg = s_q + cw * kWgRows * kBoxRowBytes;
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {kFaNegInf, kFaNegInf}, l[2] = {0.f, 0.f};
    float s[BC / 2];
    uint32_t hi[BC / 16][4], lo[BC / 16][4];
    hopper::mbar_wait(q_bar, 0);

    // Tile n's S = Q K^T is issued with tile n - 1's P V, so the softmax
    // of tile n runs while the tensor cores compute P V of tile n - 1.
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % S::kStages;
      const int prev = (n + S::kStages - 1) % S::kStages;
      hopper::mbar_wait(full_bar + 8 * st, (n / S::kStages) & 1);
      hopper::wgmma_fence();
      issue_qk<DH, BC>(s, q_wg, s_k + st * S::kKVBytes);
      hopper::wgmma_commit();
      if (n > 0) issue_pv<DH, BC>(o, hi, lo, s_v + prev * S::kKVBytes);
      hopper::wgmma_commit();  // empty for n == 0
      hopper::wgmma_wait<1>();  // S of tile n has landed
      hopper::fence_regs(s);
      float alpha[2];
      softmax_tile<BC>(s, p, k_lo + static_cast<int64_t>(n) * BC, qw0, row0,
                       col, m, alpha);
      hopper::wgmma_wait<0>();  // P V of tile n - 1 has landed
      hopper::fence_regs(o);
      if (n > 0) hopper::mbar_arrive(empty_bar + 8 * prev);
      float sum[2] = {0.f, 0.f};
      split_tile<BC>(s, hi, lo, sum);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
      // rescale O unless no row of the warp has a new max (alpha is then
      // exactly 1, as on most tiles once a row's max has settled)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    }
    if (n_tiles > 0) {  // P V of the last tile
      const int last = (n_tiles - 1) % S::kStages;
      hopper::wgmma_fence();
      issue_pv<DH, BC>(o, hi, lo, s_v + last * S::kKVBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(empty_bar + 8 * last);
    }

    // l holds this thread's columns of each row: sum over the row's lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float d0 = l[0] == 0.f ? 1.f : l[0];  // no live key -> 0
    const float d1 = l[1] == 0.f ? 1.f : l[1];
    __nv_bfloat16* o_bh = p.o + b * p.o_sb + h * p.o_sh;
    if (row0 < p.sq) {
      store_o_row<DH>(o_bh + row0 * p.o_ss, o, 0, d0, col, p.dh);
    }
    if (row0 + 8 < p.sq) {
      store_o_row<DH>(o_bh + (row0 + 8) * p.o_ss, o, 1, d1, col, p.dh);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (so the
// library does not link libcuda); null if the driver lacks it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(sym);
    }
  }
  return fn;
}

// The tensor map of one bf16 operand seen as (Dh, seq, heads, batch)
// through its strides in elements: boxes of 64 columns by `box_rows`
// rows, 128-byte swizzle, zeros outside, so a box reaching past the real
// Dh (all of it, for Dh below 64) is filled with zero columns.  A
// dimension of extent 1 is never stepped, so its stride is replaced by
// the packed one, rounded up to 16 bytes (TMA checks every stride).
// Returns false if cuTensorMapEncodeTiled refuses it.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t dh, int64_t seq,
                int64_t heads, int64_t batch, int64_t ss, int64_t sh,
                int64_t sb, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t ss_b = seq == 1 ? (dh * 2 + 15) / 16 * 16 : ss * 2;
  const int64_t sh_b = heads == 1 ? ss_b * seq : sh * 2;
  const int64_t sb_b = batch == 1 ? sh_b * heads : sb * 2;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(seq),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss_b),
                                 static_cast<cuuint64_t>(sh_b),
                                 static_cast<cuuint64_t>(sb_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor maps take the real Dh (p.dh), so TMA fills the columns
// from it up to DH with zeros
template <int DH>
cudaError_t launch_wgmma(const FaParams& p, int64_t batch,
                         int64_t batch_heads, cudaStream_t stream) {
  using S = WgShape<DH>;
  const int64_t q_tiles = (p.sq + kWgTileRows - 1) / kWgTileRows;
  if (q_tiles > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (!tensor_map(&tq, p.q, p.dh, p.sq, p.heads, batch, p.q_ss, p.q_sh,
                  p.q_sb, kWgTileRows)) {
    return cudaErrorInvalidValue;
  }
  // with no keys no tile is copied, and K, V need no map
  if (p.sk > 0 &&
      !(tensor_map(&tk, p.k, p.dh, p.sk, p.kv_heads, batch, p.k_ss, p.k_sh,
                   p.k_sb, S::kKeys) &&
        tensor_map(&tv, p.v, p.dh, p.sk, p.kv_heads, batch, p.v_ss, p.v_sh,
                   p.v_sb, S::kKeys))) {
    return cudaErrorInvalidValue;
  }
  const WgParams wp{static_cast<__nv_bfloat16*>(p.o),
                    p.heads,
                    p.kv_heads,
                    p.sq,
                    p.sk,
                    p.o_sb,
                    p.o_sh,
                    p.o_ss,
                    p.scale * kLog2e,
                    p.causal,
                    p.has_window,
                    p.window,
                    p.dh};
  const cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch_heads),
                  static_cast<unsigned>(q_tiles));
  fa_wgmma_kernel<DH><<<grid, kWgThreads, S::kSmem, stream>>>(tq, tk, tv,
                                                              wp);
  return cudaGetLastError();
}

// the real Dh (p.dh, 1 to 256) runs on the instance of the next width
// at or above it
cudaError_t launch(const FaParams& p, int64_t batch, int64_t batch_heads,
                   int dtype, cudaStream_t stream) {
  if (p.dh < 1 || p.dh > 256) return cudaErrorInvalidValue;
  const int width = p.dh <= 64 ? 64 : p.dh <= 128 ? 128 : 256;
  if (dtype == kFloat32) {
    switch (width) {
      case 64:
        return launch_fma<64>(p, batch_heads, stream);
      case 128:
        return launch_fma<128>(p, batch_heads, stream);
      default:
        return launch_fma<256>(p, batch_heads, stream);
    }
  } else if (dtype == kBFloat16) {
    switch (width) {
      case 64:
        return launch_wgmma<64>(p, batch, batch_heads, stream);
      case 128:
        return launch_wgmma<128>(p, batch, batch_heads, stream);
      default:
        return launch_wgmma<256>(p, batch, batch_heads, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// O (batch, heads, sq, head_dim) = attention of Q (batch, heads, sq,
// head_dim) over K, V (batch, kv_heads, sk, head_dim), each through its
// (batch, head, sequence) strides with head_dim (1 to 256) contiguous.  A
// window is applied when has_window is set.  fp32 runs the FMA kernel, bf16 the
// tensor-core kernel, whose operands TMA reads: their pointers 16-byte
// aligned, their strides in bytes multiples of 16.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t batch,
    int64_t heads, int64_t kv_heads, int64_t sq, int64_t sk,
    int64_t head_dim, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale,
    int causal, int has_window, int64_t window, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;
  const int64_t batch_heads = batch * heads;
  // TMA coordinates are 32-bit
  if (batch_heads > INT_MAX || sq > INT_MAX || sk > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  if (head_dim < 1 || head_dim > 256) return cudaErrorInvalidValue;
  const FaParams p{q,    k,    v,    o,    heads, kv_heads, sq,
                   sk,   q_sb, q_sh, q_ss, k_sb,  k_sh,     k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh,  o_ss,     scale,
                   causal, has_window, window, static_cast<int>(head_dim)};
  return launch(p, batch, batch_heads, dtype,
                static_cast<cudaStream_t>(stream));
}
