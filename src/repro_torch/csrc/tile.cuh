// Shared-memory tiled product of one 64x64 output tile, shared by the
// dense (tiled_matmul.cu) and block-sparse (bsmm.cu) kernels.
//
// A block of 256 threads (16 x 16) owns a 64 x 64 tile of C; each thread
// keeps a 4 x 4 sub-tile in registers and accumulates in fp32 with FMA
// (never TF32: the reference's fp32 tolerance is 1e-4).  K advances in
// steps of 16: the block stages a 64 x 16 slab of A (transposed, so a
// thread reads its 4 rows as one float4) and a 16 x 64 slab of B in shared
// memory, converting bf16 inputs to fp32 as it loads.  Rows, columns and
// K outside the given bounds load as zero and are never stored, so any
// shape and any panel of a strided operand can be multiplied in place.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks

// dtype codes shared with the Python wrappers (kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

struct __align__(16) TileSmem {
  float a[kTileK][kTileM + kPad];  // A slab, transposed: a[k][m]
  float b[kTileK][kTileN + kPad];  // B slab: b[k][n]
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc += A[row0:row_end, k0:k1] . B[k0:k1, col0:col_end] restricted to this
// block's 64 x 64 tile at (row0, col0).  A is row-major with row stride
// lda, B row-major with row stride ldb.  Every thread of the block must
// call it with the same arguments (it synchronises the block).
template <typename T>
__device__ __forceinline__ void accumulate_tile(
    const T* __restrict__ a, int64_t lda, const T* __restrict__ b,
    int64_t ldb, int64_t row0, int64_t row_end, int64_t col0,
    int64_t col_end, int64_t k0, int64_t k1, TileSmem& sm,
    float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int64_t kt = k0; kt < k1; kt += kTileK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // A slab: 64 rows x 16 k
      const int idx = tid + i * kThreads;
      const int r = idx / kTileK;
      const int kk = idx % kTileK;
      const int64_t gr = row0 + r;
      const int64_t gk = kt + kk;
      float v = 0.f;
      if (gr < row_end && gk < k1) v = to_float(a[gr * lda + gk]);
      sm.a[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B slab: 16 k x 64 columns
      const int idx = tid + i * kThreads;
      const int kk = idx / kTileN;
      const int c = idx % kTileN;
      const int64_t gk = kt + kk;
      const int64_t gc = col0 + c;
      float v = 0.f;
      if (gk < k1 && gc < col_end) v = to_float(b[gk * ldb + gc]);
      sm.b[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// Write this thread's 4 x 4 sub-tile of the (row0, col0) tile into C
// (row-major, row stride ldc), skipping rows >= row_end / cols >= col_end.
template <typename TOut>
__device__ __forceinline__ void store_tile(TOut* __restrict__ c, int64_t ldc,
                                           int64_t row0, int64_t row_end,
                                           int64_t col0, int64_t col_end,
                                           const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t cc = col0 + tx * 4 + j;
      if (cc < col_end) c[r * ldc + cc] = from_float<TOut>(acc[i][j]);
    }
  }
}

}  // namespace repro_torch
