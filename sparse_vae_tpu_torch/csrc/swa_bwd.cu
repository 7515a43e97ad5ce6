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
// writes dq, dk, dv: at [8, 8, 12800, 64] about 0.8 GB against ~0.15 TFLOP
// of band arithmetic, ~190 FLOP per byte, under the H100's bf16 ridge of
// ~295, so the card's bound is bytes.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential grid
// becomes four launches on one stream, each CTA 8 warps of 16 rows, every
// product a bf16 mma.sync (m16n8k16) with fp32 accumulation, in steps of
// 32 keys or queries; p and ds go from the accumulator layout straight
// into the next product's operand registers:
//   1. dq: one CTA per (q block, head, row); Q and dO stay in shared
//      memory and in each warp's registers, and for each valid band slot
//      the K and V tiles are staged: S = Q K^T, dP = dO V^T, dQ += dS K.
//      It also computes delta for its rows and writes it out.
//   2. dk/dv band: one CTA per (k block, head, row) with K and V resident,
//      looping over the `window` query blocks whose band holds this key
//      block (the inverse band map): S^T = K Q^T, dP^T = V dO^T,
//      dV += P^T dO, dK += dS^T Q.
//   3. [CLS] column: key block 0 is also attended by every query block
//      past the band's left extent (98 blocks at L = 12,800). On the TPU
//      those accumulated in order in scratch; here CTAs of CLS_CHUNK query
//      blocks each write an fp32 partial, and the band part of block 0
//      goes to fp32 scratch instead of the output.
//   4. reduce: one CTA per (head, row) sums block 0's band part and the
//      partials in a fixed order and rounds once: deterministic, no
//      atomics.
// Shared memory rows are padded to 72 bf16 so the fragment loads hit 32
// distinct banks. mma.sync rather than wgmma/TMA: simple first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;   // attention block == rows per CTA
constexpr int kHeadDim = 64;
constexpr int kWarps = kBlock / 16;     // 16 rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kHeadDim + 8;   // smem row stride, bf16
constexpr int kTile = kBlock * kStride; // bf16 per staged tile
constexpr int kChunk = 32;              // keys or queries per step
constexpr int kNt = kChunk / 8;         // mma n-tiles per step
constexpr int kTileFloats = kBlock * kHeadDim;
constexpr int kSmem = 4 * kTile * 2 + 2 * kBlock * 4;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t packf(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A contiguous [kBlock, kHeadDim] bf16 tile into shared memory at stride
// kStride.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < kBlock * kHeadDim / 8; i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = i % (kHeadDim / 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * kHeadDim + c * 8);
  }
}

// The A operand fragments of rows r0..r0+15 of a staged tile, all 64 dims.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* t, int r0,
                                          uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = t + (r0 + (lane >> 2)) * kStride + 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = ld32(p + ks * 16);
    a[ks][1] = ld32(p + 8 * kStride + ks * 16);
    a[ks][2] = ld32(p + ks * 16 + 8);
    a[ks][3] = ld32(p + 8 * kStride + ks * 16 + 8);
  }
}

// x[16 x 32] = A . T[c0 .. c0+31]^T over the 64 dims.
__device__ __forceinline__ void rows_dot(const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* t, int c0,
                                         float (&x)[kNt][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = t + (c0 + (lane >> 2)) * kStride + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const uint32_t b[2] = {ld32(p + nt * 8 * kStride + ks * 16),
                             ld32(p + nt * 8 * kStride + ks * 16 + 8)};
      mma16816(x[nt], a[ks], b);
    }
}

// acc[16 x 64] += bf16(w)[16 x 32] . T[c0 .. c0+31][0 .. 63], with w in
// the accumulator layout of rows_dot.
__device__ __forceinline__ void acc_product(const float (&w)[kNt][4],
                                            const __nv_bfloat16* t, int c0,
                                            float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kNt / 2; ++kk) {
    const uint32_t a[4] = {packf(w[2 * kk][0], w[2 * kk][1]),
                           packf(w[2 * kk][2], w[2 * kk][3]),
                           packf(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                           packf(w[2 * kk + 1][2], w[2 * kk + 1][3])};
    const __nv_bfloat16* p = t + (c0 + kk * 16 + 2 * tq) * kStride + gq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* c = p + nt * 8;
      const uint32_t b[2] = {pack2(c[0], c[kStride]),
                             pack2(c[8 * kStride], c[9 * kStride])};
      mma16816(acc[nt], a, b);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// A warp's 16 x 64 accumulator to rows r0, r0+8 (per lane group) of a
// row-major [*, 64] output.
__device__ __forceinline__ void store_bf16(const float (&acc)[8][4],
                                           __nv_bfloat16* rows) {
  const int lane = threadIdx.x & 31;
  __nv_bfloat16* lo = rows + (lane >> 2) * kHeadDim + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(lo + nt * 8) = packf(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(lo + 8 * kHeadDim + nt * 8) =
        packf(acc[nt][2], acc[nt][3]);
  }
}

__device__ __forceinline__ void store_f32(const float (&acc)[8][4],
                                          float* rows) {
  const int lane = threadIdx.x & 31;
  float* lo = rows + (lane >> 2) * kHeadDim + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(lo + nt * 8) = make_float2(acc[nt][0],
                                                          acc[nt][1]);
    *reinterpret_cast<float2*>(lo + 8 * kHeadDim + nt * 8) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Band slot -> key block (K1's _slot_to_block): slot 0 is [CLS] when
// included, valid only when the band does not already reach block 0.
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

__global__ void __launch_bounds__(kThreads)
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
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ks = dos + kTile;
  __nv_bfloat16* vs = ks + kTile;
  float* deltas = reinterpret_cast<float*>(vs + kTile);

  const int qb = blockIdx.x + q_off;  // the query block on the key axis
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = key_len / kBlock;
  const size_t qhead = ((size_t)b * num_heads + h) * (size_t)q_len;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)key_len;
  const int q0 = blockIdx.x * kBlock;  // local row of the block's first query
  const int qk0 = qb * kBlock;         // its position on the key axis
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  if (threadIdx.x < kBlock) {  // delta = rowsum(do * out) in fp32
    const size_t row = (qhead + q0 + threadIdx.x) * kHeadDim;
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + row);
    const __nv_bfloat162* o2 =
        reinterpret_cast<const __nv_bfloat162*>(out + row);
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < kHeadDim / 2; ++i) {
      const float2 a = __bfloat1622float2(d2[i]);
      const float2 c = __bfloat1622float2(o2[i]);
      sum = fmaf(a.x, c.x, fmaf(a.y, c.y, sum));
    }
    deltas[threadIdx.x] = sum;
    delta[qhead + q0 + threadIdx.x] = sum;
  }
  stage(q + (qhead + q0) * kHeadDim, qs);
  stage(dout + (qhead + q0) * kHeadDim, dos);
  __syncthreads();

  uint32_t qa[4][4], da[4][4];
  load_rows(qs, warp * 16, qa);
  load_rows(dos, warp * 16, da);
  // Key-axis positions of the lane's two rows.
  const int row[2] = {qk0 + warp * 16 + gq, qk0 + warp * 16 + gq + 8};
  const float lse_r[2] = {lse[qhead + q0 + warp * 16 + gq],
                          lse[qhead + q0 + warp * 16 + gq + 8]};
  const float del_r[2] = {deltas[warp * 16 + gq], deltas[warp * 16 + gq + 8]};
  float acc[8][4];
  zero(acc);

  const int slots = window + (include_cls ? 1 : 0);
  for (int slot = 0; slot < slots; ++slot) {
    int kb;
    const bool valid = slot_block(qb, slot, window, causal, include_cls,
                                  num_blocks, &kb);
    const int key0 = kb * kBlock;
    const int nkeys = min(kBlock, length - key0);
    if (!valid || nkeys <= 0) continue;  // uniform over the CTA

    __syncthreads();  // every warp is done with the previous tiles
    stage(k + (head + key0) * kHeadDim, ks);
    stage(v + (head + key0) * kHeadDim, vs);
    __syncthreads();

    for (int c0 = 0; c0 < nkeys; c0 += kChunk) {
      // Warp-uniform: every key of the step lies after every row.
      if (causal && key0 + c0 > qk0 + warp * 16 + 15) continue;
      float s[kNt][4], dp[kNt][4];
      rows_dot(qa, ks, c0, s);
      rows_dot(da, vs, c0, dp);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = key0 + c0 + nt * 8 + 2 * tq + (e & 1);
          const bool ok = key < length && lse_r[i] != -INFINITY &&
                          (!causal || key <= row[i]);
          const float p = ok ? expf(s[nt][e] * scale - lse_r[i]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - del_r[i]) * scale;  // ds
        }
      acc_product(s, ks, c0, acc);
    }
  }
  store_bf16(acc, dq + (qhead + q0 + warp * 16) * kHeadDim);
}

// One staged query block's contributions to a warp's 16 key rows:
// dv += P^T dO, dk += dS^T Q.
__device__ __forceinline__ void accumulate_kv(
    const uint32_t (&ka)[4][4], const uint32_t (&va)[4][4],
    const __nv_bfloat16* qs, const __nv_bfloat16* dos, const float* lses,
    const float* deltas, int q0, int key_first, int length, int causal,
    float scale, float (&dk)[8][4], float (&dv)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int key[2] = {key_first + gq, key_first + gq + 8};
  for (int c0 = 0; c0 < kBlock; c0 += kChunk) {
    // Warp-uniform: every query of the step lies before every key.
    if (causal && q0 + c0 + kChunk - 1 < key_first) continue;
    float s[kNt][4], dp[kNt][4];
    rows_dot(ka, qs, c0, s);
    rows_dot(va, dos, c0, dp);
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + 2 * tq + (e & 1);
        const int kk = key[e >> 1];
        const float l = lses[col];
        const bool ok = kk < length && l != -INFINITY &&
                        (!causal || kk <= q0 + col);
        const float p = ok ? expf(s[nt][e] * scale - l) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - deltas[col]) * scale;  // ds
        s[nt][e] = p;
      }
    acc_product(s, dos, c0, dv);
    acc_product(dp, qs, c0, dk);
  }
}

__device__ __forceinline__ void stage_queries(
    const __nv_bfloat16* q, const __nv_bfloat16* dout, const float* lse,
    const float* delta, size_t head, int q0, __nv_bfloat16* qs,
    __nv_bfloat16* dos, float* lses, float* deltas) {
  __syncthreads();  // every warp is done with the previous block
  stage(q + (head + q0) * kHeadDim, qs);
  stage(dout + (head + q0) * kHeadDim, dos);
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    lses[i] = lse[head + q0 + i];
    deltas[i] = delta[head + q0 + i];
  }
  __syncthreads();
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

struct KvSmem {
  __nv_bfloat16 *ks, *vs, *qs, *dos;
  float *lses, *deltas;
};

__device__ __forceinline__ KvSmem kv_smem(unsigned char* raw) {
  KvSmem m;
  m.ks = reinterpret_cast<__nv_bfloat16*>(raw);
  m.vs = m.ks + kTile;
  m.qs = m.vs + kTile;
  m.dos = m.qs + kTile;
  m.lses = reinterpret_cast<float*>(m.dos + kTile);
  m.deltas = m.lses + kBlock;
  return m;
}

__global__ void __launch_bounds__(kThreads)
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
               int cls_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const KvSmem m = kv_smem(smem_raw);
  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_q_blocks = q_len / kBlock;
  const size_t qhead = ((size_t)b * num_heads + h) * (size_t)q_len;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)key_len;
  const int k0 = kb * kBlock;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;

  stage(k + (head + k0) * kHeadDim, m.ks);
  stage(v + (head + k0) * kHeadDim, m.vs);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_rows(m.ks, warp * 16, ka);
  load_rows(m.vs, warp * 16, va);
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  if (k0 < length) {  // uniform: some key of this block is valid
    const int left = causal ? window : (window + 1) / 2;
    for (int slot = 0; slot < window; ++slot) {
      // _band_q_for_k: the local query block; its key-axis block is
      // qb + q_off.
      const int qb = kb + left - window + slot - q_off;
      if (qb < 0 || qb >= num_q_blocks) continue;
      stage_queries(q, dout, lse, delta, qhead, qb * kBlock, m.qs, m.dos,
                    m.lses, m.deltas);
      accumulate_kv(ka, va, m.qs, m.dos, m.lses, m.deltas,
                    (qb + q_off) * kBlock, k0 + warp * 16, length, causal,
                    scale, dk, dv);
    }
  }
  if (kb == 0 && cls_chunks > 0) {
    // Block 0's band part joins the [CLS] partials in the reduce pass.
    const int parts = 1 + cls_chunks;
    store_f32(dk, scratch_part(scratch, 0, batch, b, num_heads, h, parts, 0)
                      + warp * 16 * kHeadDim);
    store_f32(dv, scratch_part(scratch, 1, batch, b, num_heads, h, parts, 0)
                      + warp * 16 * kHeadDim);
    return;
  }
  store_bf16(dk, dk_out + (head + k0 + warp * 16) * kHeadDim);
  store_bf16(dv, dv_out + (head + k0 + warp * 16) * kHeadDim);
}

__global__ void __launch_bounds__(kThreads)
swa_dkv_cls_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ lengths,
                   float* __restrict__ scratch, int batch, int num_heads,
                   int seq_len, int window, int causal, int cls_chunk,
                   int cls_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const KvSmem m = kv_smem(smem_raw);
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = seq_len / kBlock;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;

  stage(k + head * kHeadDim, m.ks);  // key block 0
  stage(v + head * kHeadDim, m.vs);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_rows(m.ks, warp * 16, ka);
  load_rows(m.vs, warp * 16, va);
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  const int left = causal ? window : (window + 1) / 2;
  const int first = left + c * cls_chunk;
  const int last = min(num_blocks, first + cls_chunk);
  if (length > 0) {  // uniform
    for (int qb = first; qb < last; ++qb) {
      stage_queries(q, dout, lse, delta, head, qb * kBlock, m.qs, m.dos,
                    m.lses, m.deltas);
      accumulate_kv(ka, va, m.qs, m.dos, m.lses, m.deltas, qb * kBlock,
                    warp * 16, length, causal, scale, dk, dv);
    }
  }
  const int parts = 1 + cls_chunks;
  store_f32(dk, scratch_part(scratch, 0, batch, b, num_heads, h, parts,
                             1 + c) + warp * 16 * kHeadDim);
  store_f32(dv, scratch_part(scratch, 1, batch, b, num_heads, h, parts,
                             1 + c) + warp * 16 * kHeadDim);
}

// Key block 0 of every (head, row): band part + [CLS] partials, summed in
// order, rounded once.
__global__ void __launch_bounds__(kThreads)
swa_cls_reduce_kernel(const float* __restrict__ scratch,
                      __nv_bfloat16* __restrict__ dk_out,
                      __nv_bfloat16* __restrict__ dv_out, int batch,
                      int num_heads, int seq_len, int cls_chunks) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int parts = 1 + cls_chunks;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
  for (int which = 0; which < 2; ++which) {
    const float* src = scratch_part(const_cast<float*>(scratch), which,
                                    batch, b, num_heads, h, parts, 0);
    __nv_bfloat16* dst = (which == 0 ? dk_out : dv_out) + head * kHeadDim;
    for (int i = threadIdx.x; i < kTileFloats; i += kThreads) {
      float sum = 0.f;
      for (int p = 0; p < parts; ++p) sum += src[(size_t)p * kTileFloats + i];
      dst[i] = __float2bfloat16_rn(sum);
    }
  }
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
      num_heads > 65535 || cls_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_blocks = q_len / kBlock;
  const int num_k_blocks = key_len / kBlock;
  const int left = causal ? window : (window + 1) / 2;
  const int cls_chunks = (include_cls && num_blocks > left)
                             ? (num_blocks - left + cls_chunk - 1) / cls_chunk
                             : 0;
  cudaError_t err = cudaFuncSetAttribute(
      swa_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(swa_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(swa_dkv_cls_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lsep = static_cast<const float*>(lse);
  const auto* lenp = static_cast<const int*>(lengths);
  auto* deltap = static_cast<float*>(delta);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* scr = static_cast<float*>(scratch);

  swa_dq_kernel<<<dim3(num_blocks, num_heads, batch), kThreads, kSmem, s>>>(
      qp, kp, vp, op, dop, lsep, lenp, static_cast<__nv_bfloat16*>(dq),
      deltap, num_heads, q_len, key_len, window, causal, include_cls, q_off,
      scale);
  swa_dkv_kernel<<<dim3(num_k_blocks, num_heads, batch), kThreads, kSmem,
                   s>>>(
      qp, kp, vp, dop, lsep, deltap, lenp, dkp, dvp, scr, batch, num_heads,
      q_len, key_len, window, causal, q_off, cls_chunks, scale);
  if (cls_chunks > 0) {  // only when q_off == 0, so q_len == key_len
    const dim3 cgrid(cls_chunks, num_heads, batch);
    swa_dkv_cls_kernel<<<cgrid, kThreads, kSmem, s>>>(
        qp, kp, vp, dop, lsep, deltap, lenp, scr, batch, num_heads, q_len,
        window, causal, cls_chunk, cls_chunks, scale);
    swa_cls_reduce_kernel<<<dim3(num_heads, batch), kThreads, 0, s>>>(
        scr, dkp, dvp, batch, num_heads, q_len, cls_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
