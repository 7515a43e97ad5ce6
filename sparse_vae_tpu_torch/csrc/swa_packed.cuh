// Pieces of K5 (swa_fwd_packed.cu): the sliding-window + [CLS] attention
// forward on PACKED [B, L, H * 128] bf16 operands, one head of one 128-row
// block per CTA, 8 warps of 16 rows, every product a bf16 mma.sync
// (m16n8k16) with fp32 accumulation. (Its backward, K5b, is the Dh = 128
// packed instantiation of K2's wgmma kernels in swa_bwd.cu.)
//
// A head's slice of a packed row starts at column h * 128 (256 bytes) and
// the row stride is H * 128 bf16, so every 16-byte load of a row is
// aligned. Tiles are staged into shared memory at a row stride of 136 bf16
// (272 bytes): the 32-bit fragment loads of 8 rows x 4 words then hit 32
// distinct banks. No operand fragments stay in registers across steps: at
// Dh = 128 a 16 x 128 fp32 accumulator alone takes 64 registers per
// thread, so the A operands are read from shared memory at each step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace svt_packed {

using svt::mma16816;
using svt::packf;
using svt::slot_block;

constexpr int kBlock = 128;               // attention block == rows per CTA
constexpr int kHeadDim = 128;
constexpr int kWarps = kBlock / 16;       // 16 rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kHeadDim + 8;     // smem row stride, bf16
constexpr int kTile = kBlock * kStride;   // bf16 per staged tile
constexpr int kKSteps = kHeadDim / 16;    // mma k-steps over the head dim
constexpr int kDimTiles = kHeadDim / 8;   // mma n-tiles over the head dim

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// kBlock rows of one head into shared memory: src points at the head's
// first element of the first row, rows are row_stride bf16 apart.
__device__ __forceinline__ void stage_rows(
    const __nv_bfloat16* __restrict__ src, int row_stride,
    __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < kBlock * kHeadDim / 8; i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = i % (kHeadDim / 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * row_stride + c * 8);
  }
}

// x[16 x 8NT] = A[r0 .. r0+15] . B[c0 .. c0+8NT-1]^T over the head dim,
// A and B staged tiles.
template <int NT>
__device__ __forceinline__ void tile_dot(const __nv_bfloat16* a, int r0,
                                         const __nv_bfloat16* b, int c0,
                                         float (&x)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* pa = a + (r0 + (lane >> 2)) * kStride + 2 * (lane & 3);
  const __nv_bfloat16* pb = b + (c0 + (lane >> 2)) * kStride + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const uint32_t af[4] = {ld32(pa + ks * 16),
                            ld32(pa + 8 * kStride + ks * 16),
                            ld32(pa + ks * 16 + 8),
                            ld32(pa + 8 * kStride + ks * 16 + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t bf[2] = {ld32(pb + nt * 8 * kStride + ks * 16),
                              ld32(pb + nt * 8 * kStride + ks * 16 + 8)};
      mma16816(x[nt], af, bf);
    }
  }
}

// acc[16 x 128] += bf16(w)[16 x 8NT] . T[c0 .. c0+8NT-1][0 .. 127], with w
// in the accumulator layout of tile_dot (NT even).
template <int NT>
__device__ __forceinline__ void acc_product(const float (&w)[NT][4],
                                            const __nv_bfloat16* t, int c0,
                                            float (&acc)[kDimTiles][4]) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {packf(w[2 * kk][0], w[2 * kk][1]),
                           packf(w[2 * kk][2], w[2 * kk][3]),
                           packf(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                           packf(w[2 * kk + 1][2], w[2 * kk + 1][3])};
    const __nv_bfloat16* p = t + (c0 + kk * 16 + 2 * tq) * kStride + gq;
#pragma unroll
    for (int nt = 0; nt < kDimTiles; ++nt) {
      const __nv_bfloat16* c = p + nt * 8;
      const uint32_t b[2] = {pack2(c[0], c[kStride]),
                             pack2(c[8 * kStride], c[9 * kStride])};
      mma16816(acc[nt], a, b);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kDimTiles][4]) {
#pragma unroll
  for (int nt = 0; nt < kDimTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// A warp's 16 x 128 accumulator, each row times scale[row half], to the
// warp's rows of one head: dst points at the head's first element of the
// warp's first row, rows row_stride bf16 apart.
__device__ __forceinline__ void store_rows_bf16(
    const float (&acc)[kDimTiles][4], const float (&scale)[2],
    __nv_bfloat16* dst, int row_stride) {
  const int lane = threadIdx.x & 31;
  __nv_bfloat16* lo = dst + (size_t)(lane >> 2) * row_stride + 2 * (lane & 3);
  __nv_bfloat16* hi = lo + (size_t)8 * row_stride;
#pragma unroll
  for (int nt = 0; nt < kDimTiles; ++nt) {
    *reinterpret_cast<uint32_t*>(lo + nt * 8) =
        packf(acc[nt][0] * scale[0], acc[nt][1] * scale[0]);
    *reinterpret_cast<uint32_t*>(hi + nt * 8) =
        packf(acc[nt][2] * scale[1], acc[nt][3] * scale[1]);
  }
}

}  // namespace svt_packed
