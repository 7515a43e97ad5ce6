// The tiles shared by the sliding-window attention kernels: the forward
// (K1, K5 and K6's banded forward, csrc/swa_fwd.cu) and the backward (K2,
// K5b and K6's backward, csrc/swa_bwd.cu).
//
// A CTA is two warpgroups, each owning 64 of a 128-row block. A tile is
// D / 64 halves of [128 rows x 64 dims], 128 bytes a row, each stored by
// cp.async in the 128-byte swizzle that wgmma reads without bank conflicts
// (16-byte chunk c of row r at c ^ (r & 7)); a K-major product steps into
// the second half at dim 64, and an MN-major one takes each half as its
// own n64 product. The operands are bf16 and the sums fp32, either
// head-major [B, H, L, D] or packed [B, L, H * D] (head h at column h * D).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace svt::swa {

constexpr int kBlock = 128;   // attention block == rows per CTA
constexpr int kThreads = 256;            // two warpgroups of 64 rows
constexpr int kRowBytes = 128;           // 64 bf16 dims: one half-row
constexpr int kHalfBytes = kBlock * kRowBytes;  // [128 rows x 64 dims]
constexpr int kWgBytes = 64 * kRowBytes;  // a warpgroup's 64 rows
constexpr int kKeyChunk = 64;           // keys per forward and dq step
constexpr int kSepCls = -2;  // the slot of the broadcast [CLS] block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geometry {
  static_assert(D == 64 || D == 128, "instantiated at Dh 64 and 128");
  static constexpr int kHalves = D / 64;
  static constexpr int kTileBytes = kHalves * kHalfBytes;
  static constexpr int kTileFloats = kBlock * D;
  // The forward: Q, then two buffers of [K | V].
  static constexpr int kFwdSmem = svt::kSwizzleAlign + 5 * kTileBytes;
  // dq: Q, dO, then two buffers of [K | V].
  static constexpr int kDqSmem = svt::kSwizzleAlign + 6 * kTileBytes;
  // dk/dv: K, V, then two buffers of [Q | dO | lse | delta].
  static constexpr int kQBuf = 2 * kTileBytes + 2 * kBlock * 4;
  static constexpr int kKvSmem =
      svt::kSwizzleAlign + 2 * kTileBytes + 2 * kQBuf;
  static_assert(kQBuf % svt::kSwizzleAlign == 0,
                "buffers stay 1024-aligned");
  static_assert(kDqSmem + kBlock * 4 <= 232448 && kKvSmem <= 232448,
                "within the 227 KB a block may use");
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // CTAs per SM
  // 64^-0.5 = 1/8 is a power of two: multiplying the dq and dk sums by it
  // once is exact and equals summing the scaled terms. 128^-0.5 is not.
  static constexpr bool kScaleOnce = D == 64;
};

// Element offset of row r of head h in batch row b of a head-major
// [B, H, len, D] or packed [B, len, H * D] tensor, and the rows' stride.
template <int D, bool kPacked>
struct Layout {
  int heads;
  __device__ __forceinline__ size_t at(int b, int h, int len, int r) const {
    return kPacked ? (((size_t)b * len + r) * heads + h) * D
                   : (((size_t)b * heads + h) * len + r) * D;
  }
  __device__ __forceinline__ int stride() const {
    return kPacked ? heads * D : D;
  }
};

// Band slot -> key block (the Pallas kernels' _slot_to_block): slot 0 is
// [CLS] when included, valid only when the band does not already reach
// block 0.
__device__ __forceinline__ bool slot_block(int qb, int slot, int window,
                                           int causal, int include_cls,
                                           int num_blocks, int* kb) {
  const int left = causal ? window : (window + 1) / 2;
  const int first_band = qb - (left - 1);
  if (include_cls && slot == 0) {
    *kb = 0;
    return first_band > 0;
  }
  *kb = first_band + slot - (include_cls ? 1 : 0);
  return *kb >= 0 && *kb < num_blocks;
}

// The key block that slot `slot` of query block qb (on the key axis)
// reads, uniform over the CTA: a band block that exists and holds a valid
// key (below `length`), or, with kBroadcast, slot 0 is the broadcast [CLS]
// block (kSepCls) when it holds one (cls_len > 0). -1: nothing to do.
template <bool kBroadcast>
__device__ __forceinline__ int slot_key_block(int qb, int slot, int window,
                                              int causal, int include_cls,
                                              int num_blocks, int length,
                                              int cls_len) {
  if (kBroadcast && slot == 0) return cls_len > 0 ? kSepCls : -1;
  int kb;
  const bool valid =
      slot_block(qb, slot, window, causal, include_cls, num_blocks, &kb);
  return valid && kb * kBlock < length ? kb : -1;
}

// kBlock rows of D bf16 (rows `stride` apart from src) into shared memory
// as D / 64 swizzled halves, by cp.async (this thread's share).
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int stride, unsigned char* dst) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    svt::cp_async16(dst + (c >> 3) * kHalfBytes + r * kRowBytes +
                        (((c & 7) ^ (r & 7)) << 4),
                    src + (size_t)r * stride + c * 8);
  }
}

// x[64 x N] = A[64 rows at a] B[N rows at b]^T over the D dims, both
// tiles K-major (a and b point into the first half).
template <int D, int N>
__device__ __forceinline__ void product(float (&x)[N / 2],
                                        const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int k16 = 0; k16 < D / 16; ++k16) {
    const int off = (k16 >> 2) * kHalfBytes + 32 * (k16 & 3);
    if constexpr (N == 32)
      svt::wgmma_ss_n32(x, svt::desc_sw128(a + off), svt::desc_sw128(b + off),
                        k16);
    else
      svt::wgmma_ss_n64(x, svt::desc_sw128(a + off), svt::desc_sw128(b + off),
                        k16);
  }
}

// acc[64 x D] += bf16(w)[64 x N] T[N rows at t], w in the accumulator
// layout of `product` (w[4n + 2i + e]: row 16 warp + gq + 8i, column
// 8n + 2tq + e), which is the A register layout once packed by k16 step;
// T read MN-major, one n64 product per half.
template <int D, int N>
__device__ __forceinline__ void product_acc(float (&acc)[D / 64][32],
                                            const float (&w)[N / 2],
                                            const unsigned char* t) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    const uint32_t a[4] = {svt::packf(w[8 * kq], w[8 * kq + 1]),
                           svt::packf(w[8 * kq + 2], w[8 * kq + 3]),
                           svt::packf(w[8 * kq + 4], w[8 * kq + 5]),
                           svt::packf(w[8 * kq + 6], w[8 * kq + 7])};
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
      svt::wgmma_rs_n64_mn(
          acc[hf], a,
          svt::desc_sw128(t + hf * kHalfBytes + 16 * kq * kRowBytes));
  }
}

template <int H>
__device__ __forceinline__ void zero(float (&acc)[H][32]) {
#pragma unroll
  for (int hf = 0; hf < H; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;
}

template <int H>
__device__ __forceinline__ void fence_all(float (&acc)[H][32]) {
#pragma unroll
  for (int hf = 0; hf < H; ++hf) svt::fence_acc(acc[hf]);
}

// A warp's 16 x D slice of a warpgroup accumulator (acc[hf][4n + 2i + e]:
// row gq + 8i, column 64 hf + 8n + 2tq + e) to the rows at `rows`,
// `stride` elements apart.
template <int H>
__device__ __forceinline__ void store_bf16(const float (&acc)[H][32],
                                           __nv_bfloat16* rows, int stride) {
  const int lane = threadIdx.x & 31;
  __nv_bfloat16* lo = rows + (size_t)(lane >> 2) * stride + 2 * (lane & 3);
  __nv_bfloat16* hi = lo + (size_t)8 * stride;
#pragma unroll
  for (int hf = 0; hf < H; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(lo + 64 * hf + n * 8) =
          svt::packf(acc[hf][4 * n], acc[hf][4 * n + 1]);
      *reinterpret_cast<uint32_t*>(hi + 64 * hf + n * 8) =
          svt::packf(acc[hf][4 * n + 2], acc[hf][4 * n + 3]);
    }
}

}  // namespace svt::swa
