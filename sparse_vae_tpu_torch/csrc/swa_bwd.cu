// K2: sliding-window + [CLS] block-sparse attention, backward, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_kernels.py::_bwd_pallas (bodies
// _dq_kernel, _dkv_band_kernel, _dkv_cls_kernel; band maps _slot_to_block
// and _band_q_for_k). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/sliding_window_attention.py::
// sliding_window_attention_bwd_plain.
//
// What it computes. With q, k, v, out, do head-major [B, H, L, 64] bf16 and
// K1's fp32 lse [B, H, L], for every attended (query i, key j) pair of the
// band + [CLS] pattern (the mask of K1, csrc/swa_fwd.cu):
//   p = exp(s - lse_i) with s = q_i . k_j * scale, chosen 0 by select where
//       the mask forbids (a row with no valid key has lse -inf, and
//       exp(s + inf) * 0 would be NaN);
//   delta_i = rowsum(do_i * out_i) in fp32;
//   ds = p * (do_i . v_j - delta_i) * scale;
//   dq_i += ds k_j;  dk_j += ds q_i;  dv_j += p do_i.
// p and ds are rounded to bf16 before their products, as the Pallas
// kernel rounds them; every sum is fp32, and dq, dk, dv [B, H, L, 64] bf16
// are rounded once.
//
// The sequence-parallel form (K6's band backward): with q_off > 0, q, out
// and do hold Lq rows and k, v hold Lk = Lq + q_off * 128 extended keys,
// query block qb sitting at key block qb + q_off (K1's forward,
// csrc/swa_fwd.cu). The dq grid walks the Lq / 128 query blocks; the dk/dv
// grid walks all Lk / 128 key blocks, the halo blocks included, each over
// the local query blocks whose band holds it (_band_q_for_k with q_off);
// there is no [CLS] column. lse is the JOINT lse of the band and the
// separately attended [CLS] block and out the merged output, so p = exp(s -
// lse) is the exact partial probability and delta = rowsum(do * out) is
// the whole row's.
//
// What bounds it. Per layer the pass reads q, k, v, out, do and lse and
// writes dq, dk, dv: at [8, 8, 12800, 64] about 0.84 GB against ~0.17
// TFLOP of band + [CLS] arithmetic, ~200 FLOP per byte, under the H100's
// bf16 ridge of ~295, so the card's bound is bytes.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential grid
// becomes three launches on one stream. A CTA is two warpgroups, each
// owning 64 of the block's 128 rows, and every product is a wgmma (bf16
// in, fp32 accumulate) in steps of 32 keys or queries: S and dP
// (m64n32k16) read both operands from shared memory, K-major; dQ = dS K,
// dK = dS^T Q and dV = P^T dO (m64n64k16) take dS or P from registers,
// straight from the accumulator layout as bf16, and K, Q or dO from the
// same shared tiles read MN-major (the transposed-B form). Tiles are
// 128 x 64 bf16, one 128-byte row per token, stored by cp.async in the
// 128-byte swizzle that wgmma reads without bank conflicts; the next
// tile's loads overlap this one's products (double buffers). Beside the
// products, the per-element softmax work is what the warps issue most,
// so it is kept short: exp2 on pre-scaled logits (ex2.approx), no mask
// where a warpgroup-uniform test shows every key valid and causally
// allowed (every step off the diagonal and the ragged end), and scale (a
// power of two, 1/8) applied once to the dq and dk sums instead of to
// every ds.
//   1. dq: one CTA per (q block, head, row). delta = rowsum(do * out) for
//      its 128 rows is computed by all 256 threads (two a row) while Q, dO
//      and the first key block arrive, and written out for pass 2. Q and
//      dO stay in shared memory; the valid band slots' K and V tiles
//      stream through a double buffer: S = Q K^T, dP = dO V^T, dQ += dS K.
//   2. dk/dv: one CTA per key block, with K and V resident, over the query
//      blocks whose band holds it (the inverse band map), their Q, dO, lse
//      and delta double-buffered: S^T = K Q^T, dP^T = V dO^T,
//      dV += P^T dO, dK += dS^T Q. The same launch holds the [CLS] column:
//      key block 0 is also attended by every query block past the band's
//      left extent (98 blocks at L = 12,800); on the TPU those accumulated
//      in order in scratch, here CTAs of cls_chunk query blocks each write
//      an fp32 partial, and the band part of block 0 goes to fp32 scratch
//      instead of the output. The [CLS] CTAs come first in the grid, so
//      the longer ones start first.
//   3. reduce: 16 CTAs per (head, row) sum block 0's band part and the
//      partials in a fixed order and round once.
// Every output tile has one owner and every sum a fixed order: no atomics,
// and a second call is bit-identical. Dynamic shared memory: dq 99,328
// bytes (+ 512 static), dk/dv 101,376 (kDqSmem, kKvSmem): 2 CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using svt::cp_async16;
using svt::cp_async4;
using svt::cp_async_commit;
using svt::cp_async_wait;
using svt::desc_sw128;
using svt::ex2;
using svt::fence_acc;
using svt::fence_proxy_async;
using svt::packf;
using svt::wgmma_commit;
using svt::wgmma_fence;
using svt::wgmma_rs_n64_mn;
using svt::wgmma_ss_n32;
using svt::wgmma_ss_n64;
using svt::wgmma_wait;

constexpr int kBlock = 128;   // attention block == rows per CTA
constexpr int kHeadDim = 64;  // one 128-byte row
constexpr int kThreads = 256;           // two warpgroups of 64 rows
constexpr int kRowBytes = kHeadDim * 2;
constexpr int kTileBytes = kBlock * kRowBytes;
constexpr int kWgBytes = 64 * kRowBytes;  // a warpgroup's 64 rows
constexpr int kChunk = 32;              // queries per dk/dv step
constexpr int kKeyChunk = 64;           // keys per dq step
constexpr int kTileFloats = kBlock * kHeadDim;
// dq: Q, dO, then two buffers of [K | V].
constexpr int kDqSmem = svt::kSwizzleAlign + 6 * kTileBytes;
// dk/dv: K, V, then two buffers of [Q | dO | lse | delta].
constexpr int kQBuf = 2 * kTileBytes + 2 * kBlock * 4;
static_assert(kQBuf % svt::kSwizzleAlign == 0, "buffers stay 1024-aligned");
constexpr int kKvSmem = svt::kSwizzleAlign + 2 * kTileBytes + 2 * kQBuf;
constexpr float kLog2e = 1.4426950408889634f;

// A contiguous [kBlock, 64] bf16 tile into shared memory in the 128-byte
// swizzle (16-byte chunk c of row r at c ^ (r & 7)), by cp.async (this
// thread's share).
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          unsigned char* dst) {
  for (int i = threadIdx.x; i < kBlock * 8; i += kThreads) {
    const int r = i >> 3;
    const int c = i & 7;
    cp_async16(dst + r * kRowBytes + ((c ^ (r & 7)) << 4),
               src + r * kHeadDim + c * 8);
  }
}

// x[64 x 32] = A[64 rows at a] B[32 rows at b]^T over the 64 dims.
__device__ __forceinline__ void product_n32(float (&x)[16],
                                            const unsigned char* a,
                                            const unsigned char* b) {
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16)
    wgmma_ss_n32(x, desc_sw128(a + 32 * k16), desc_sw128(b + 32 * k16),
                 k16);
}

// x[64 x 64] = A[64 rows at a] B[64 rows at b]^T over the 64 dims.
__device__ __forceinline__ void product_n64(float (&x)[32],
                                            const unsigned char* a,
                                            const unsigned char* b) {
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16)
    wgmma_ss_n64(x, desc_sw128(a + 32 * k16), desc_sw128(b + 32 * k16),
                 k16);
}

// acc[64 x 64] += bf16(w)[64 x N] T[N rows at t], w in the accumulator
// layout of product_n32 / product_n64 (w[4n + 2i + e]: row 16 warp + gq +
// 8i, column 8n + 2tq + e), which is the A register layout once packed by
// k16 step.
template <int N>
__device__ __forceinline__ void product_acc(float (&acc)[32],
                                            const float (&w)[N / 2],
                                            const unsigned char* t) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    const uint32_t a[4] = {packf(w[8 * kq], w[8 * kq + 1]),
                           packf(w[8 * kq + 2], w[8 * kq + 3]),
                           packf(w[8 * kq + 4], w[8 * kq + 5]),
                           packf(w[8 * kq + 6], w[8 * kq + 7])};
    wgmma_rs_n64_mn(acc, a, desc_sw128(t + 16 * kq * kRowBytes));
  }
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// The products sum ds / scale; scale is a power of two (64^-0.5 = 1/8),
// so multiplying the sums by it once is exact and equals summing the
// scaled terms.
__device__ __forceinline__ void scale_acc(float (&acc)[32], float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= scale;
}

// A warp's 16 x 64 slice of a warpgroup accumulator (acc[4n + 2i + e]:
// row gq + 8i, column 8n + 2tq + e) to the rows at `rows` of a row-major
// [*, 64] output.
__device__ __forceinline__ void store_bf16(const float (&acc)[32],
                                           __nv_bfloat16* rows) {
  const int lane = threadIdx.x & 31;
  __nv_bfloat16* lo = rows + (lane >> 2) * kHeadDim + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(lo + n * 8) =
        packf(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(lo + 8 * kHeadDim + n * 8) =
        packf(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

__device__ __forceinline__ void store_f32(const float (&acc)[32],
                                          float* rows) {
  const int lane = threadIdx.x & 31;
  float* lo = rows + (lane >> 2) * kHeadDim + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(lo + n * 8) =
        make_float2(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<float2*>(lo + 8 * kHeadDim + n * 8) =
        make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
swa_dq_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ out,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const int* __restrict__ lengths,
              __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
              int num_heads, int q_len, int key_len, int window, int causal,
              int include_cls, int q_off, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = svt::align_smem(smem_raw);
  unsigned char* dos = qs + kTileBytes;
  unsigned char* kv = dos + kTileBytes;  // [2][K | V]
  __shared__ float deltas[kBlock];

  const int qb = blockIdx.x + q_off;  // the query block on the key axis
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = key_len / kBlock;
  const size_t qhead = ((size_t)b * num_heads + h) * (size_t)q_len;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)key_len;
  const int q0 = blockIdx.x * kBlock;  // local row of the block's first query
  const int qk0 = qb * kBlock;         // its position on the key axis
  const int length = lengths[b];
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // Band slots in use: the block exists and holds a valid key (uniform
  // over the CTA).
  const int slots = window + (include_cls ? 1 : 0);
  auto key_block = [&](int slot) {
    int kb;
    const bool valid = svt::slot_block(qb, slot, window, causal,
                                       include_cls, num_blocks, &kb);
    return valid && kb * kBlock < length ? kb : -1;
  };
  auto next_slot = [&](int slot) {
    while (slot < slots && key_block(slot) < 0) ++slot;
    return slot;
  };
  auto load_kv = [&](int kb, unsigned char* dst) {
    const size_t key0 = (head + (size_t)kb * kBlock) * kHeadDim;
    load_tile(k + key0, dst);
    load_tile(v + key0, dst + kTileBytes);
  };

  load_tile(q + (qhead + q0) * kHeadDim, qs);
  load_tile(dout + (qhead + q0) * kHeadDim, dos);
  int cur = next_slot(0);
  if (cur < slots) load_kv(key_block(cur), kv);
  cp_async_commit();

  {  // delta = rowsum(do * out) in fp32: two threads a row, 32 dims each.
    const int r = threadIdx.x >> 1;
    const size_t off = (qhead + q0 + r) * kHeadDim + (threadIdx.x & 1) * 32;
    const uint4* d4 = reinterpret_cast<const uint4*>(dout + off);
    const uint4* o4 = reinterpret_cast<const uint4*>(out + off);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 dv4 = d4[i], ov4 = o4[i];
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv4);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(dp[j]);
        const float2 c = __bfloat1622float2(op[j]);
        sum = fmaf(a.x, c.x, fmaf(a.y, c.y, sum));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((threadIdx.x & 1) == 0) {
      deltas[r] = sum;
      delta[qhead + q0 + r] = sum;
    }
  }

  // This thread's rows of the block: r0 and r0 + 8.
  const int r0 = 64 * wg + 16 * warp + gq;
  const int row[2] = {qk0 + r0, qk0 + r0 + 8};  // key-axis positions
  const float lse_r[2] = {lse[qhead + q0 + r0], lse[qhead + q0 + r0 + 8]};
  const float l2_r[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};
  const float sl2 = scale * kLog2e;
  const unsigned char* qa = qs + wg * kWgBytes;
  const unsigned char* da = dos + wg * kWgBytes;
  float acc[32];
  zero(acc);

  int bi = 0;
  while (cur < slots) {
    const int nxt = next_slot(cur + 1);
    if (nxt < slots) load_kv(key_block(nxt), kv + (bi ^ 1) * 2 * kTileBytes);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const float del_r[2] = {deltas[r0], deltas[r0 + 8]};

    const unsigned char* ks = kv + bi * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    const int key0 = key_block(cur) * kBlock;
    const int nkeys = min(kBlock, length - key0);
    for (int c0 = 0; c0 < nkeys; c0 += kKeyChunk) {
      // Warpgroup-uniform: every key of the step lies after every row.
      if (causal && key0 + c0 > qk0 + 64 * wg + 63) break;
      float s[32], dp[32];
      wgmma_fence();
      product_n64(s, qa, ks + c0 * kRowBytes);   // S = Q K^T
      product_n64(dp, da, vs + c0 * kRowBytes);  // dP = dO V^T
      wgmma_commit();
      // These products, and the previous step's dQ product, are done.
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      fence_acc(acc);
      // ds / scale. Warpgroup-uniform: a step with every key valid and at
      // or before every row needs no mask (its rows then have a finite
      // lse).
      const bool edge = key0 + c0 + kKeyChunk > length ||
                        (causal && key0 + c0 + kKeyChunk - 1 > qk0 + 64 * wg);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j >> 1) & 1;
        float p = ex2(fmaf(s[j], sl2, -l2_r[i]));
        if (edge) {
          const int key = key0 + c0 + 8 * (j >> 2) + 2 * tq + (j & 1);
          const bool ok = key < length && lse_r[i] != -INFINITY &&
                          (!causal || key <= row[i]);
          p = ok ? p : 0.f;
        }
        s[j] = p * (dp[j] - del_r[i]);
      }
      wgmma_fence();
      product_acc<kKeyChunk>(acc, s, ks + c0 * kRowBytes);  // dQ += dS K
      wgmma_commit();  // in flight beside the next step's S and dP
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // every warp is done with this buffer
    cur = nxt;
    bi ^= 1;
  }
  scale_acc(acc, scale);
  store_bf16(acc, dq + (qhead + q0 + 64 * wg + 16 * warp) * kHeadDim);
}

// fp32 [kBlock, kHeadDim] part `part` of the [CLS]-column scratch
// [2 (dk, dv), B, H, parts, kBlock, kHeadDim].
__device__ __forceinline__ float* scratch_part(float* scratch, int which,
                                               int batch, int b,
                                               int num_heads, int h,
                                               int parts, int part) {
  return scratch +
         ((((size_t)which * batch + b) * num_heads + h) * parts + part) *
             (size_t)kTileFloats;
}

// The dk/dv pass and the [CLS] column. blockIdx.x < cls_chunks * H * B:
// [CLS] chunk c of (h, b), key block 0 against query blocks
// left + c * cls_chunk .. (partial 1 + c); past them: key block kb of
// (h, b) against its band's query blocks.
__global__ void __launch_bounds__(kThreads, 2)
swa_dkv_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const int* __restrict__ lengths,
               __nv_bfloat16* __restrict__ dk_out,
               __nv_bfloat16* __restrict__ dv_out,
               float* __restrict__ scratch, int batch, int num_heads,
               int q_len, int key_len, int window, int causal, int q_off,
               int cls_chunk, int cls_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = svt::align_smem(smem_raw);
  unsigned char* vs = ks + kTileBytes;
  unsigned char* qbufs = vs + kTileBytes;

  const int num_q_blocks = q_len / kBlock;
  const int num_k_blocks = key_len / kBlock;
  const int cls_tasks = cls_chunks * num_heads * batch;
  const bool cls = static_cast<int>(blockIdx.x) < cls_tasks;
  int task = cls ? blockIdx.x : blockIdx.x - cls_tasks;
  const int per_head = cls ? cls_chunks : num_k_blocks;
  const int idx = task % per_head;  // [CLS] chunk or key block
  task /= per_head;
  const int h = task % num_heads;
  const int b = task / num_heads;
  const int kb = cls ? 0 : idx;
  const int k0 = kb * kBlock;
  const size_t qhead = ((size_t)b * num_heads + h) * (size_t)q_len;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)key_len;
  const int length = lengths[b];
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // The local query blocks [lo, hi) this CTA visits: the band's
  // (_band_q_for_k: local block kb + left - window + slot - q_off, its
  // key-axis block kb + left - window + slot), or a [CLS] chunk's. None
  // when no key of the block is valid.
  const int left = causal ? window : (window + 1) / 2;
  int lo, hi;
  if (cls) {
    lo = left + idx * cls_chunk;
    hi = min(num_q_blocks, lo + cls_chunk);
  } else {
    lo = max(0, kb + left - window - q_off);
    hi = min(num_q_blocks, kb + left - q_off);
  }
  if (k0 >= length) hi = lo;

  auto load_queries = [&](int qb, int which) {
    unsigned char* base = qbufs + which * kQBuf;
    float* ls = reinterpret_cast<float*>(base + 2 * kTileBytes);
    const size_t row0 = qhead + (size_t)qb * kBlock;
    load_tile(q + row0 * kHeadDim, base);
    load_tile(dout + row0 * kHeadDim, base + kTileBytes);
    if (threadIdx.x < kBlock)
      cp_async4(ls + threadIdx.x, lse + row0 + threadIdx.x);
    else
      cp_async4(ls + threadIdx.x, delta + row0 + threadIdx.x - kBlock);
  };

  load_tile(k + (head + k0) * kHeadDim, ks);
  load_tile(v + (head + k0) * kHeadDim, vs);
  if (lo < hi) load_queries(lo, 0);
  cp_async_commit();

  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  const float sl2 = scale * kLog2e;
  const int r0 = 64 * wg + 16 * warp + gq;   // this thread's key rows
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  const unsigned char* ka = ks + wg * kWgBytes;
  const unsigned char* va = vs + wg * kWgBytes;

  for (int qb = lo, bi = 0; qb < hi; ++qb, bi ^= 1) {
    if (qb + 1 < hi) load_queries(qb + 1, bi ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const unsigned char* qs = qbufs + bi * kQBuf;
    const unsigned char* dos = qs + kTileBytes;
    const float* lses = reinterpret_cast<const float*>(dos + kTileBytes);
    const float* deltas = lses + kBlock;
    const int qpos0 = (qb + q_off) * kBlock;  // key-axis position of query 0
    for (int c0 = 0; c0 < kBlock; c0 += kChunk) {
      // Warpgroup-uniform: every query of the step lies before every key.
      if (causal && qpos0 + c0 + kChunk - 1 < k0 + 64 * wg) continue;
      float s[16], dp[16];
      wgmma_fence();
      product_n32(s, ka, qs + c0 * kRowBytes);    // S^T = K Q^T
      product_n32(dp, va, dos + c0 * kRowBytes);  // dP^T = V dO^T
      wgmma_commit();
      // These products, and the previous step's dV and dK products, are
      // done.
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      fence_acc(dv);
      fence_acc(dk);
      // p and ds / scale. Warpgroup-uniform: a step with every key valid
      // and at or before every query needs no mask (its queries then have
      // a finite lse).
      const bool edge = k0 + 64 * wg + 64 > length ||
                        (causal && k0 + 64 * wg + 63 > qpos0 + c0);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = c0 + n * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(lses + col);
        const float2 d2 = *reinterpret_cast<const float2*>(deltas + col);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * n + e;
          float p = ex2(fmaf(s[j], sl2, nl[e & 1]));
          if (edge) {
            const int kk = key[e >> 1];
            const float l = (e & 1) ? l2.y : l2.x;
            const bool ok = kk < length && l != -INFINITY &&
                            (!causal || kk <= qpos0 + col + (e & 1));
            p = ok ? p : 0.f;
          }
          dp[j] = p * (dp[j] - dd[e & 1]);
          s[j] = p;
        }
      }
      wgmma_fence();
      product_acc<kChunk>(dv, s, dos + c0 * kRowBytes);  // dV += P^T dO
      product_acc<kChunk>(dk, dp, qs + c0 * kRowBytes);  // dK += dS^T Q
      wgmma_commit();  // in flight beside the next step's S^T and dP^T
    }
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    __syncthreads();  // every warp is done with this buffer
  }

  const int row0 = 64 * wg + 16 * warp;
  scale_acc(dk, scale);
  if (kb == 0 && cls_chunks > 0) {
    // Block 0's band part and the [CLS] partials meet in the reduce pass.
    const int parts = 1 + cls_chunks;
    const int part = cls ? 1 + idx : 0;
    store_f32(dk, scratch_part(scratch, 0, batch, b, num_heads, h, parts,
                               part) + row0 * kHeadDim);
    store_f32(dv, scratch_part(scratch, 1, batch, b, num_heads, h, parts,
                               part) + row0 * kHeadDim);
    return;
  }
  store_bf16(dk, dk_out + (head + k0 + row0) * kHeadDim);
  store_bf16(dv, dv_out + (head + k0 + row0) * kHeadDim);
}

// Key block 0 of every (head, row): band part + [CLS] partials, summed in
// order, rounded once. blockIdx.x: dk or dv, and which kReduceSlice-float
// slice of the block; four floats a thread.
constexpr int kReduceSlice = 4 * kThreads;
__global__ void __launch_bounds__(kThreads)
swa_cls_reduce_kernel(const float* __restrict__ scratch,
                      __nv_bfloat16* __restrict__ dk_out,
                      __nv_bfloat16* __restrict__ dv_out, int batch,
                      int num_heads, int seq_len, int cls_chunks) {
  constexpr int kSlices = kTileFloats / kReduceSlice;
  const int which = blockIdx.x / kSlices;
  const int i = (blockIdx.x % kSlices) * kReduceSlice + 4 * threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int parts = 1 + cls_chunks;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
  const float* src = scratch_part(const_cast<float*>(scratch), which, batch,
                                  b, num_heads, h, parts, 0) + i;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float4 x =
        *reinterpret_cast<const float4*>(src + (size_t)p * kTileFloats);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  __nv_bfloat16* dst = (which == 0 ? dk_out : dv_out) + head * kHeadDim + i;
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(sum.x, sum.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
      __floats2bfloat162_rn(sum.z, sum.w);
}

bool power_of_two(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

}  // namespace

extern "C" int svt_swa_bwd(const void* q, const void* k, const void* v,
                           const void* lengths, const void* lse,
                           const void* out, const void* dout, void* dq,
                           void* dk, void* dv, void* delta, void* scratch,
                           int batch, int num_heads, int q_len, int key_len,
                           int head_dim, int block_size, int window,
                           int causal, int include_cls, int q_off,
                           int cls_chunk, float scale, void* stream) {
  if (head_dim != kHeadDim || block_size != kBlock || q_len <= 0 ||
      q_len % kBlock != 0 || q_off < 0 ||
      key_len != q_len + q_off * kBlock || (include_cls && q_off) ||
      window < 1 || batch < 1 || num_heads < 1 || batch > 65535 ||
      num_heads > 65535 || cls_chunk < 1 || !power_of_two(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_blocks = q_len / kBlock;
  const int num_k_blocks = key_len / kBlock;
  const int left = causal ? window : (window + 1) / 2;
  const int cls_chunks = (include_cls && num_blocks > left)
                             ? (num_blocks - left + cls_chunk - 1) / cls_chunk
                             : 0;
  const long long kv_ctas =
      (long long)(cls_chunks + num_k_blocks) * num_heads * batch;
  if (kv_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit dq_limit, kv_limit;
  cudaError_t err = svt::raise_smem_limit(dq_limit, swa_dq_kernel, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = svt::raise_smem_limit(kv_limit, swa_dkv_kernel, kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lsep = static_cast<const float*>(lse);
  const auto* lenp = static_cast<const int*>(lengths);
  auto* deltap = static_cast<float*>(delta);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* scr = static_cast<float*>(scratch);

  swa_dq_kernel<<<dim3(num_blocks, num_heads, batch), kThreads, kDqSmem, s>>>(
      qp, kp, vp, static_cast<const __nv_bfloat16*>(out), dop, lsep, lenp,
      static_cast<__nv_bfloat16*>(dq), deltap, num_heads, q_len, key_len,
      window, causal, include_cls, q_off, scale);
  swa_dkv_kernel<<<static_cast<unsigned>(kv_ctas), kThreads, kKvSmem, s>>>(
      qp, kp, vp, dop, lsep, deltap, lenp, dkp, dvp, scr, batch, num_heads,
      q_len, key_len, window, causal, q_off, cls_chunk, cls_chunks, scale);
  if (cls_chunks > 0)  // only when q_off == 0, so q_len == key_len
    swa_cls_reduce_kernel<<<dim3(2 * kTileFloats / kReduceSlice, num_heads,
                                 batch), kThreads, 0, s>>>(
        scr, dkp, dvp, batch, num_heads, q_len, cls_chunks);
  return static_cast<int>(cudaGetLastError());
}
