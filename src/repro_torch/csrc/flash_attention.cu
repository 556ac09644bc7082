// Flash attention, forward: O = softmax(scale * Q K^T + mask) V with an
// online softmax, causal and sliding-window masks and GQA head groups; a
// query row with no live key gives 0.  Inputs are read in their own type
// (fp32 or bf16), everything is computed in fp32 (FMA, never TF32), and O
// is written in the inputs' type.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fa_kernel
// (driven by flash_attention_pallas).  There the grid walks the key tiles
// as a sequential axis and carries the running max, sum and accumulator in
// VMEM scratch, skipping a dead tile with pl.when.  Here one block of 256
// threads owns one 64-row query tile of one (batch, head) and loops over
// the key tiles itself, so blocks share nothing: it visits only the key
// tiles that some of its rows can see (causal: keys up to its last query;
// a window W: keys after its first query - W), which is the TPU kernel's
// skip and what makes causal attention about half the work and windowed
// attention O(S W).  The running max starts at -1e30, not -inf, so
// exp(m_prev - m_new) is never NaN; a masked score contributes exactly 0,
// so a row whose keys are all masked keeps l = 0 and is written as 0.
//
// Layout.  Q (B, H, Sq, Dh), K and V (B, Hkv, Sk, Dh) and O (B, H, Sq, Dh)
// are taken through (batch, head, sequence) strides with Dh contiguous,
// so the (B, S, H, Dh) -> (B, H, S, Dh) transposes of the attention layer
// need no copy.  Query head h reads kv head (h % H) / (H / Hkv) of its
// batch, as the TPU kernel's kv_index does.  Q (pre-scaled), one key tile
// and one value tile are staged in shared memory as fp32.  Each warp owns
// 8 query rows: for S = Q K^T a lane holds its rows' scores against keys
// lane, lane + 32 (float4 reads of padded rows, conflict-free); the row
// max and sum are warp shuffles; P goes through shared memory to P V,
// where a lane owns Dh / 32 contiguous output columns in registers.  Rows
// and keys past Sq / Sk (a ragged tail) load as zero, are masked and are
// never stored.
//
// Bound on an H100: at the LM's shape (B = 4, H = 32, Hkv = 8, S = 4096,
// Dh = 64, bf16, causal) the live work is 2.7e11 FLOP against 0.17 GB of
// Q, K, V and O, so attention is bound by operations: 0.28 ms at the
// 989 TFLOP/s of bf16 tensor cores.  This simple kernel runs on the fp32
// FMA units (67 TFLOP/s) and stages its tiles without a pipeline, so it
// leaves on the table: tensor cores (mma.sync / wgmma on bf16), TMA with a
// multi-stage ring of K/V tiles, warp specialisation, and P kept in
// registers.
#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int kFaRows = 64;                      // query rows per block
constexpr int kFaWarps = 8;
constexpr int kFaThreads = kFaWarps * 32;
constexpr int kFaRowsPerWarp = kFaRows / kFaWarps;  // 8
constexpr float kFaNegInf = -1e30f;

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
};

// dst[r][d] (row stride ld) = src[row0 + r][d] * mul for r < rows, zero
// for rows at or past end; consecutive threads take consecutive d.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int64_t row_stride, int64_t row0,
                                           int64_t end, int rows, float mul) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kFaThreads) {
    const int r = idx / DH;
    const int d = idx % DH;
    const int64_t gr = row0 + r;
    float x = 0.f;
    if (gr < end) x = to_float(src[gr * row_stride + d]) * mul;
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

template <typename T, int DH>
__global__ void __launch_bounds__(kFaThreads)
    flash_attention_kernel(const FaParams p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the keys some row of this tile can see
  int64_t k_lo = 0;
  int64_t k_hi = p.sk;
  if (p.causal && q_end < k_hi) k_hi = q_end;
  if (p.has_window && q0 - p.window + 1 > k_lo) k_lo = q0 - p.window + 1;
  k_lo = (k_lo / S::kKeys) * S::kKeys;

  stage_rows<T, DH>(s_q, S::kLdQK, q, p.q_ss, q0, p.sq, kFaRows, p.scale);

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
    stage_rows<T, DH>(s_k, S::kLdQK, k, p.k_ss, kt, p.sk, S::kKeys, 1.f);
    stage_rows<T, DH>(s_v, DH, v, p.v_ss, kt, p.sk, S::kKeys, 1.f);
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
    T* row = o + qi * p.o_ss + lane * CPL;
#pragma unroll
    for (int c = 0; c < CPL; ++c) row[c] = from_float<T>(acc[r][c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const FaParams& p, int64_t batch_heads, int64_t q_tiles,
                   cudaStream_t stream) {
  constexpr size_t smem = FaShape<DH>::kSmemFloats * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch_heads),
                  static_cast<unsigned>(q_tiles));
  flash_attention_kernel<T, DH><<<grid, kFaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const FaParams& p, int64_t head_dim,
                      int64_t batch_heads, int64_t q_tiles,
                      cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(p, batch_heads, q_tiles, stream);
    case 128:
      return launch<T, 128>(p, batch_heads, q_tiles, stream);
    case 256:
      return launch<T, 256>(p, batch_heads, q_tiles, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// O (batch, heads, sq, head_dim) = attention of Q (batch, heads, sq,
// head_dim) over K, V (batch, kv_heads, sk, head_dim), each through its
// (batch, head, sequence) strides with head_dim contiguous.  A window is
// applied when has_window is set.  Returns the cudaError_t of the launch
// (0 on success).
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
  const int64_t q_tiles = (sq + kFaRows - 1) / kFaRows;
  if (batch_heads > 2147483647LL || q_tiles > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const FaParams p{q,    k,    v,    o,    heads, kv_heads, sq,
                   sk,   q_sb, q_sh, q_ss, k_sb,  k_sh,     k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh,  o_ss,     scale,
                   causal, has_window, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dh<float>(p, head_dim, batch_heads, q_tiles, s);
  }
  if (dtype == kBFloat16) {
    return launch_dh<__nv_bfloat16>(p, head_dim, batch_heads, q_tiles, s);
  }
  return cudaErrorInvalidValue;
}
