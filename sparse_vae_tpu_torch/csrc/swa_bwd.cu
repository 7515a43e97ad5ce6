// K2 and K5b: sliding-window + [CLS] block-sparse attention, backward, for
// Hopper, in two layouts from one set of kernels templated on the head
// dim and the layout.
//
// Replaces sparse_vae_tpu/ops/pallas_kernels.py::_bwd_pallas (K2: bodies
// _dq_kernel, _dkv_band_kernel, _dkv_cls_kernel; band maps _slot_to_block
// and _band_q_for_k), ::_bwd_packed (K5b: bodies _dq_kernel_packed,
// _dkv_band_kernel_packed, _dkv_cls_kernel_packed, _p_and_ds_2d) and the
// [CLS] term of ::_sp_bwd (K6's backward on a banded shard). The plain
// PyTorch versions are sparse_vae_tpu_torch/ops/sliding_window_attention.py::
// sliding_window_attention_bwd_plain and
// ::sliding_window_attention_packed_bwd_plain.
//
// What it computes. q, k, v, out, do are bf16, either head-major
// [B, H, L, 64] or [B, H, L, 128] (K2, svt_swa_bwd) or packed
// [B, L, H * 128] with head h at
// column h * 128 (K5b, svt_swa_bwd_packed); lse (from K1 or K5) and delta
// are head-major [B, H, L] fp32 in both. For every attended (query i, key
// j) pair of the band + [CLS] pattern (the forward's mask):
//   p = exp(s - lse_i) with s = q_i . k_j * scale, chosen 0 by select where
//       the mask forbids (a row with no valid key has lse -inf, and
//       exp(s + inf) * 0 would be NaN);
//   delta_i = rowsum(do_i * out_i) in fp32;
//   ds = p * (do_i . v_j - delta_i) * scale;
//   dq_i += ds k_j;  dk_j += ds q_i;  dv_j += p do_i.
// p and ds are rounded to bf16 before their products, as the Pallas
// kernels round them; every sum is fp32, and dq, dk, dv (in the inputs'
// layout) are rounded once.
//
// The sequence-parallel form (K6's backward, head-major only): with
// q_off > 0, q, out and do hold Lq rows and k, v hold Lk = Lq + q_off *
// 128 extended keys, query block qb sitting at key block qb + q_off (K1's
// forward, csrc/swa_fwd.cu). The dq grid walks the Lq / 128 query blocks;
// the dk/dv grid walks all Lk / 128 key blocks, the halo blocks included,
// each over the local query blocks whose band holds it (_band_q_for_k with
// q_off). lse is the JOINT lse of the band and the broadcast [CLS] block
// and out the merged output, so p = exp(s - lse) is the exact partial
// probability and delta = rowsum(do * out) is the whole row's. On such a
// banded shard (q_off = window - 1, 0 at window 1) the broadcast [CLS]
// block (cls_k, cls_v [B, H, 128, Dh], cls_len [B] valid keys) is a slot
// with its own pointer: every local query attends it (the band never
// holds global block 0), masked by cls_len only and never causally, and
// its gradients go to dcls_k, dcls_v [B, H, 128, Dh].
//
// What bounds it. Per layer the pass reads q, k, v, out, do and lse and
// writes dq, dk, dv: at [8, 8, 12800, 64] (or [8, 12800, 4 * 128]) about
// 0.84 GB against ~0.17 TFLOP of band + [CLS] arithmetic, ~200 FLOP per
// byte, under the H100's bf16 ridge of ~295, so the card's bound is bytes.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential grid
// becomes three launches on one stream. A CTA is two warpgroups, each
// owning 64 of the block's 128 rows, and every product is a wgmma (bf16
// in, fp32 accumulate) in steps of 32 or 64 keys or queries: S and dP
// (m64n32k16, m64n64k16) read both operands from shared memory, K-major;
// dQ = dS K, dK = dS^T Q and dV = P^T dO take dS or P from registers,
// straight from the accumulator layout as bf16, and K, Q or dO from the
// same shared tiles read MN-major (the transposed-B form), one m64n64k16
// per 64 head dims, on the swizzled tiles of swa_tiles.cuh (shared with
// the forward, csrc/swa_fwd.cu). The next tile's loads
// overlap this one's products (double buffers). Beside the products, the
// per-element softmax work is what the warps issue most, so it is kept
// short: exp2 on pre-scaled logits (ex2.approx), no mask where a
// warpgroup-uniform test shows every key valid and causally allowed
// (every step off the diagonal and the ragged end), and at Dh = 64 scale
// (a power of two, 1/8) applied once to the dq and dk sums instead of to
// every ds (at Dh = 128 scale is 2^-3.5, so ds is scaled before its
// rounding, as the Pallas kernel does).
//   1. dq: one CTA per (q block, head, row). delta = rowsum(do * out) for
//      its 128 rows is computed by all 256 threads (two a row) while Q, dO
//      and the first key block arrive, and written out for pass 2. Q and
//      dO stay in shared memory; the valid slots' K and V tiles (the band,
//      and the [CLS] block from its own pointer) stream through a double
//      buffer: S = Q K^T, dP = dO V^T, dQ += dS K, 64 keys a step.
//   2. dk/dv: one CTA per key block, with K and V resident, over the query
//      blocks whose band holds it (the inverse band map), their Q, dO, lse
//      and delta double-buffered: S^T = K Q^T, dP^T = V dO^T,
//      dV += P^T dO, dK += dS^T Q, 32 queries a step. The same launch
//      holds the [CLS] column: the [CLS] block is also attended by every
//      query block past the band's left extent (key block 0: 98 query
//      blocks at L = 12,800) or by every local query block (the broadcast
//      block); on the TPU those accumulated in order in scratch, here CTAs
//      of cls_chunk query blocks each write an fp32 partial, and the band
//      part of key block 0 goes to fp32 scratch instead of the output.
//      The [CLS] CTAs come first in the grid, so the longer ones start
//      first.
//   3. reduce: D / 8 CTAs per (head, row) sum key block 0's band part and
//      the partials in a fixed order and round once into key block 0 of
//      dk, dv, or the broadcast block's partials into dcls_k, dcls_v.
// Every output tile has one owner and every sum a fixed order: no atomics,
// and a second call is bit-identical.
// Registers and shared memory. At Dh = 64 a warpgroup's dQ, or dK and dV,
// are 32 or 64 fp32 registers a thread: 2 CTAs per SM, dq 99,328 bytes of
// dynamic shared memory (+ 512 static), dk/dv 101,376. At Dh = 128 they
// are 64 and 128, beside S and dP (64 or 32): one CTA per SM
// (__launch_bounds__(256, 1)), dq 197,632 bytes (Q, dO and two [K | V]
// buffers), dk/dv 199,680 (K, V and two [Q | dO | lse | delta] buffers),
// under the 227 KB a block may opt into (Geometry, swa_tiles.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "swa_tiles.cuh"

namespace {

using namespace svt::swa;
using svt::cp_async4;
using svt::cp_async_commit;
using svt::cp_async_wait;
using svt::ex2;
using svt::fence_acc;
using svt::fence_proxy_async;
using svt::wgmma_commit;
using svt::wgmma_fence;
using svt::wgmma_wait;

constexpr int kChunk = 32;              // queries per dk/dv step

// The kernels' arguments, __grid_constant__: the kernels' lambdas capture
// them by reference, and the address of any other kernel argument is that
// of a local copy.
struct BwdParams {
  const __nv_bfloat16 *q, *k, *v, *out, *dout, *cls_k, *cls_v;
  const float* lse;
  const int *lengths, *cls_len;
  __nv_bfloat16 *dq, *dk, *dv, *dcls_k, *dcls_v;
  float *delta, *scratch;
  int batch, num_heads, q_len, key_len, window, causal, include_cls, q_off,
      cls_chunk, cls_chunks;
  float scale;
};

template <int H>
__device__ __forceinline__ void scale_acc(float (&acc)[H][32], float scale) {
#pragma unroll
  for (int hf = 0; hf < H; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hf][i] *= scale;
}

// A warp's 16 x D slice of a warpgroup accumulator (store_bf16's layout)
// in fp32 to rows of a contiguous [*, 64 H] buffer.
template <int H>
__device__ __forceinline__ void store_f32(const float (&acc)[H][32],
                                          float* rows) {
  constexpr int kStride = 64 * H;
  const int lane = threadIdx.x & 31;
  float* lo = rows + (lane >> 2) * kStride + 2 * (lane & 3);
#pragma unroll
  for (int hf = 0; hf < H; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(lo + 64 * hf + n * 8) =
          make_float2(acc[hf][4 * n], acc[hf][4 * n + 1]);
      *reinterpret_cast<float2*>(lo + 8 * kStride + 64 * hf + n * 8) =
          make_float2(acc[hf][4 * n + 2], acc[hf][4 * n + 3]);
    }
}

// kBroadcast: [CLS] is the broadcast block (cls_k, ...), not key block 0;
// a template parameter, so that the other instantiations carry none of
// its branches.
template <int D, bool kPacked, bool kBroadcast>
__global__ void __launch_bounds__(kThreads, Geometry<D>::kMinBlocks)
swa_dq_kernel(const __grid_constant__ BwdParams p) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = svt::align_smem(smem_raw);
  unsigned char* dos = qs + G::kTileBytes;
  unsigned char* kv = dos + G::kTileBytes;  // [2][K | V]
  __shared__ float deltas[kBlock];

  const Layout<D, kPacked> lay{p.num_heads};
  const int qb = blockIdx.x + p.q_off;  // the query block on the key axis
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = p.key_len / kBlock;
  const size_t stats = ((size_t)b * p.num_heads + h) * (size_t)p.q_len;
  const int q0 = blockIdx.x * kBlock;  // local row of the block's first query
  const int qk0 = qb * kBlock;         // its position on the key axis
  const int length = p.lengths[b];
  const int cls_len = kBroadcast ? p.cls_len[b] : 0;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // The slots in use (uniform over the CTA): a band block that exists and
  // holds a valid key, or the broadcast [CLS] block (slot 0 when given)
  // when it holds one. -1: nothing to do.
  const int slots = p.window + (p.include_cls ? 1 : 0);
  auto key_block = [&](int slot) {
    return slot_key_block<kBroadcast>(qb, slot, p.window, p.causal,
                                      p.include_cls, num_blocks, length,
                                      cls_len);
  };
  auto next_slot = [&](int slot) {
    while (slot < slots && key_block(slot) == -1) ++slot;
    return slot;
  };
  auto load_kv = [&](int kb, unsigned char* dst) {
    if (kBroadcast && kb == kSepCls) {
      const size_t at = ((size_t)b * p.num_heads + h) * kBlock * D;
      load_tile<D>(p.cls_k + at, D, dst);
      load_tile<D>(p.cls_v + at, D, dst + G::kTileBytes);
    } else {
      const size_t at = lay.at(b, h, p.key_len, kb * kBlock);
      load_tile<D>(p.k + at, lay.stride(), dst);
      load_tile<D>(p.v + at, lay.stride(), dst + G::kTileBytes);
    }
  };

  load_tile<D>(p.q + lay.at(b, h, p.q_len, q0), lay.stride(), qs);
  load_tile<D>(p.dout + lay.at(b, h, p.q_len, q0), lay.stride(), dos);
  int cur = next_slot(0);
  if (cur < slots) load_kv(key_block(cur), kv);
  cp_async_commit();

  {  // delta = rowsum(do * out) in fp32: two threads a row, D / 2 dims each.
    const int r = threadIdx.x >> 1;
    const size_t off =
        lay.at(b, h, p.q_len, q0 + r) + (threadIdx.x & 1) * (D / 2);
    const uint4* d4 = reinterpret_cast<const uint4*>(p.dout + off);
    const uint4* o4 = reinterpret_cast<const uint4*>(p.out + off);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
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
      p.delta[stats + q0 + r] = sum;
    }
  }

  // This thread's rows of the block: r0 and r0 + 8.
  const int r0 = 64 * wg + 16 * warp + gq;
  const int row[2] = {qk0 + r0, qk0 + r0 + 8};  // key-axis positions
  const float lse_r[2] = {p.lse[stats + q0 + r0], p.lse[stats + q0 + r0 + 8]};
  const float l2_r[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = qs + wg * kWgBytes;
  const unsigned char* da = dos + wg * kWgBytes;
  float acc[G::kHalves][32];
  zero(acc);

  int bi = 0;
  while (cur < slots) {
    const int nxt = next_slot(cur + 1);
    if (nxt < slots) load_kv(key_block(nxt), kv + (bi ^ 1) * 2 * G::kTileBytes);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const float del_r[2] = {deltas[r0], deltas[r0 + 8]};

    const unsigned char* ks = kv + bi * 2 * G::kTileBytes;
    const unsigned char* vs = ks + G::kTileBytes;
    // The broadcast [CLS] block: keys 0 .. cls_len - 1, before every query.
    const int kb = key_block(cur);
    const bool sep = kBroadcast && kb == kSepCls;
    const int key0 = sep ? 0 : kb * kBlock;
    const int klen = sep ? cls_len : length;
    const bool causal = p.causal && !sep;
    const int nkeys = min(kBlock, klen - key0);
    for (int c0 = 0; c0 < nkeys; c0 += kKeyChunk) {
      // Warpgroup-uniform: every key of the step lies after every row.
      if (causal && key0 + c0 > qk0 + 64 * wg + 63) break;
      float s[32], dp[32];
      wgmma_fence();
      product<D, kKeyChunk>(s, qa, ks + c0 * kRowBytes);   // S = Q K^T
      product<D, kKeyChunk>(dp, da, vs + c0 * kRowBytes);  // dP = dO V^T
      wgmma_commit();
      // These products, and the previous step's dQ product, are done.
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      fence_all(acc);
      // ds (/ scale at Dh 64). Warpgroup-uniform: a step with every key
      // valid and at or before every row needs no mask (its rows then have
      // a finite lse). The two forms are separate code: left to the
      // compiler, one masked loop held the Dh 64 instantiation above its
      // 128 registers (2 CTAs per SM) and spilled.
      const bool edge = key0 + c0 + kKeyChunk > klen ||
                        (causal && key0 + c0 + kKeyChunk - 1 > qk0 + 64 * wg);
      auto ds_of = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int i = (j >> 1) & 1;
          float pr = ex2(fmaf(s[j], sl2, -l2_r[i]));
          if constexpr (decltype(masked)::value) {
            const int key = key0 + c0 + 8 * (j >> 2) + 2 * tq + (j & 1);
            const bool ok = key < klen && lse_r[i] != -INFINITY &&
                            (!causal || key <= row[i]);
            pr = ok ? pr : 0.f;
          }
          s[j] = pr * (dp[j] - del_r[i]);
          if constexpr (!G::kScaleOnce) s[j] *= p.scale;
        }
      };
      if (edge)
        ds_of(std::true_type());
      else
        ds_of(std::false_type());
      wgmma_fence();
      product_acc<D, kKeyChunk>(acc, s, ks + c0 * kRowBytes);  // dQ += dS K
      wgmma_commit();  // in flight beside the next step's S and dP
    }
    wgmma_wait<0>();
    fence_all(acc);
    __syncthreads();  // every warp is done with this buffer
    cur = nxt;
    bi ^= 1;
  }
  if (G::kScaleOnce) scale_acc(acc, p.scale);
  store_bf16(acc, p.dq + lay.at(b, h, p.q_len, q0 + 64 * wg + 16 * warp),
             lay.stride());
}

// fp32 [kBlock, D] part `part` of the [CLS] scratch
// [2 (dk, dv), B, H, parts, kBlock, D].
template <int D>
__device__ __forceinline__ float* scratch_part(float* scratch, int which,
                                               int batch, int b,
                                               int num_heads, int h,
                                               int parts, int part) {
  return scratch +
         ((((size_t)which * batch + b) * num_heads + h) * parts + part) *
             (size_t)Geometry<D>::kTileFloats;
}

// The [CLS] scratch's parts: the band part of key block 0 first (not for
// the broadcast block), then one partial per chunk of query blocks.
template <bool kBroadcast>
__device__ __forceinline__ int band_parts() {
  return kBroadcast ? 0 : 1;
}

// The dk/dv pass and the [CLS] column. blockIdx.x < cls_chunks * H * B:
// [CLS] chunk c of (h, b), the [CLS] block against query blocks
// first + c * cls_chunk .. (a partial); past them: key block kb of (h, b)
// against its band's query blocks.
template <int D, bool kPacked, bool kBroadcast>
__global__ void __launch_bounds__(kThreads, Geometry<D>::kMinBlocks)
swa_dkv_kernel(const __grid_constant__ BwdParams p) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = svt::align_smem(smem_raw);
  unsigned char* vs = ks + G::kTileBytes;
  unsigned char* qbufs = vs + G::kTileBytes;

  const Layout<D, kPacked> lay{p.num_heads};
  const int num_q_blocks = p.q_len / kBlock;
  const int num_k_blocks = p.key_len / kBlock;
  const int cls_tasks = p.cls_chunks * p.num_heads * p.batch;
  const bool cls = static_cast<int>(blockIdx.x) < cls_tasks;
  int task = cls ? blockIdx.x : blockIdx.x - cls_tasks;
  const int per_head = cls ? p.cls_chunks : num_k_blocks;
  const int idx = task % per_head;  // [CLS] chunk or key block
  task /= per_head;
  const int h = task % p.num_heads;
  const int b = task / p.num_heads;
  // The broadcast [CLS] block of a banded shard: its own pointer, keys
  // 0 .. cls_len - 1, before every query.
  const bool sep = kBroadcast && cls;
  const int kb = cls ? 0 : idx;
  const int k0 = kb * kBlock;
  const size_t stats_b = ((size_t)b * p.num_heads + h) * (size_t)p.q_len;
  const int klen = sep ? p.cls_len[b] : p.lengths[b];
  const bool causal = p.causal && !sep;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;

  // The local query blocks [lo, hi) this CTA visits: the band's
  // (_band_q_for_k: local block kb + left - window + slot - q_off, its
  // key-axis block kb + left - window + slot), or a [CLS] chunk's (past
  // the band's left extent, or every local block for the broadcast
  // block). None when no key of the block is valid.
  const int left = p.causal ? p.window : (p.window + 1) / 2;
  int lo, hi;
  if (cls) {
    lo = (sep ? 0 : left) + idx * p.cls_chunk;
    hi = min(num_q_blocks, lo + p.cls_chunk);
  } else {
    lo = max(0, kb + left - p.window - p.q_off);
    hi = min(num_q_blocks, kb + left - p.q_off);
  }
  if (k0 >= klen) hi = lo;

  auto load_queries = [&](int qb, int which) {
    unsigned char* base = qbufs + which * G::kQBuf;
    float* ls = reinterpret_cast<float*>(base + 2 * G::kTileBytes);
    const size_t at = lay.at(b, h, p.q_len, qb * kBlock);
    const size_t row0 = stats_b + (size_t)qb * kBlock;
    load_tile<D>(p.q + at, lay.stride(), base);
    load_tile<D>(p.dout + at, lay.stride(), base + G::kTileBytes);
    if (threadIdx.x < kBlock)
      cp_async4(ls + threadIdx.x, p.lse + row0 + threadIdx.x);
    else
      cp_async4(ls + threadIdx.x, p.delta + row0 + threadIdx.x - kBlock);
  };

  if (sep) {
    const size_t at = ((size_t)b * p.num_heads + h) * kBlock * D;
    load_tile<D>(p.cls_k + at, D, ks);
    load_tile<D>(p.cls_v + at, D, vs);
  } else {
    const size_t at = lay.at(b, h, p.key_len, k0);
    load_tile<D>(p.k + at, lay.stride(), ks);
    load_tile<D>(p.v + at, lay.stride(), vs);
  }
  if (lo < hi) load_queries(lo, 0);
  cp_async_commit();

  float dk[G::kHalves][32], dv[G::kHalves][32];
  zero(dk);
  zero(dv);
  const float sl2 = p.scale * kLog2e;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);  // this thread's keys
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  const unsigned char* ka = ks + wg * kWgBytes;
  const unsigned char* va = vs + wg * kWgBytes;

  for (int qb = lo, bi = 0; qb < hi; ++qb, bi ^= 1) {
    if (qb + 1 < hi) load_queries(qb + 1, bi ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const unsigned char* qs = qbufs + bi * G::kQBuf;
    const unsigned char* dos = qs + G::kTileBytes;
    const float* lses = reinterpret_cast<const float*>(dos + G::kTileBytes);
    const float* deltas = lses + kBlock;
    const int qpos0 = (qb + p.q_off) * kBlock;  // key-axis position of query 0
    for (int c0 = 0; c0 < kBlock; c0 += kChunk) {
      // Warpgroup-uniform: every query of the step lies before every key.
      if (causal && qpos0 + c0 + kChunk - 1 < k0 + 64 * wg) continue;
      float s[16], dp[16];
      wgmma_fence();
      product<D, kChunk>(s, ka, qs + c0 * kRowBytes);    // S^T = K Q^T
      product<D, kChunk>(dp, va, dos + c0 * kRowBytes);  // dP^T = V dO^T
      wgmma_commit();
      // These products, and the previous step's dV and dK products, are
      // done.
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      fence_all(dv);
      fence_all(dk);
      // p and ds (/ scale at Dh 64). Warpgroup-uniform: a step with every
      // key valid and at or before every query needs no mask (its queries
      // then have a finite lse); the two forms are separate code.
      const bool edge = k0 + 64 * wg + 64 > klen ||
                        (causal && k0 + 64 * wg + 63 > qpos0 + c0);
      auto p_ds_of = [&](auto masked) {
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
            float pr = ex2(fmaf(s[j], sl2, nl[e & 1]));
            if constexpr (decltype(masked)::value) {
              const int kk = key[e >> 1];
              const float l = (e & 1) ? l2.y : l2.x;
              const bool ok = kk < klen && l != -INFINITY &&
                              (!causal || kk <= qpos0 + col + (e & 1));
              pr = ok ? pr : 0.f;
            }
            dp[j] = pr * (dp[j] - dd[e & 1]);
            if constexpr (!G::kScaleOnce) dp[j] *= p.scale;
            s[j] = pr;
          }
        }
      };
      if (edge)
        p_ds_of(std::true_type());
      else
        p_ds_of(std::false_type());
      wgmma_fence();
      product_acc<D, kChunk>(dv, s, dos + c0 * kRowBytes);  // dV += P^T dO
      product_acc<D, kChunk>(dk, dp, qs + c0 * kRowBytes);  // dK += dS^T Q
      wgmma_commit();  // in flight beside the next step's S^T and dP^T
    }
    wgmma_wait<0>();
    fence_all(dv);
    fence_all(dk);
    __syncthreads();  // every warp is done with this buffer
  }

  const int row0 = 64 * wg + 16 * warp;
  if (G::kScaleOnce) scale_acc(dk, p.scale);
  const int band = band_parts<kBroadcast>();
  if (cls || (band && kb == 0 && p.cls_chunks > 0)) {
    // The [CLS] block's partials (and, unless it is the broadcast block,
    // key block 0's band part) meet in the reduce pass.
    const int parts = band + p.cls_chunks;
    const int part = cls ? band + idx : 0;
    store_f32(dk, scratch_part<D>(p.scratch, 0, p.batch, b, p.num_heads, h,
                                  parts, part) + row0 * D);
    store_f32(dv, scratch_part<D>(p.scratch, 1, p.batch, b, p.num_heads, h,
                                  parts, part) + row0 * D);
    return;
  }
  const size_t at = lay.at(b, h, p.key_len, k0 + row0);
  store_bf16(dk, p.dk + at, lay.stride());
  store_bf16(dv, p.dv + at, lay.stride());
}

// The [CLS] block of every (head, row): key block 0's band part and the
// partials, summed in order, rounded once into key block 0 of dk, dv, or
// the broadcast block's partials into dcls_k, dcls_v [B, H, 128, D].
// blockIdx.x: dk or dv, and which kReduceSlice-float slice of the block;
// four floats a thread.
constexpr int kReduceSlice = 4 * kThreads;
template <int D, bool kPacked, bool kBroadcast>
__global__ void __launch_bounds__(kThreads)
swa_cls_reduce_kernel(const __grid_constant__ BwdParams p) {
  constexpr int kSlices = Geometry<D>::kTileFloats / kReduceSlice;
  const Layout<D, kPacked> lay{p.num_heads};
  const int which = blockIdx.x / kSlices;
  const int i = (blockIdx.x % kSlices) * kReduceSlice + 4 * threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int parts = band_parts<kBroadcast>() + p.cls_chunks;
  const float* src = scratch_part<D>(p.scratch, which, p.batch, b,
                                     p.num_heads, h, parts, 0) + i;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int part = 0; part < parts; ++part) {
    const float4 x = *reinterpret_cast<const float4*>(
        src + (size_t)part * Geometry<D>::kTileFloats);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const int r = i / D;
  const int c = i % D;
  __nv_bfloat16* dst;
  if (kBroadcast)
    dst = (which == 0 ? p.dcls_k : p.dcls_v) +
          (((size_t)b * p.num_heads + h) * kBlock + r) * D + c;
  else
    dst = (which == 0 ? p.dk : p.dv) + lay.at(b, h, p.key_len, r) + c;
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(sum.x, sum.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
      __floats2bfloat162_rn(sum.z, sum.w);
}

bool power_of_two(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

template <int D, bool kPacked, bool kBroadcast>
int launch(BwdParams p, int head_dim, int block_size, cudaStream_t s) {
  using G = Geometry<D>;
  const bool sep_cls = kBroadcast;
  if (head_dim != D || block_size != kBlock || p.q_len <= 0 ||
      p.q_len % kBlock != 0 || p.q_off < 0 ||
      p.key_len != p.q_len + p.q_off * kBlock ||
      (kPacked && (p.q_off || sep_cls)) ||
      (sep_cls && !(p.include_cls && p.cls_v && p.cls_len && p.dcls_k &&
                    p.dcls_v)) ||
      p.window < 1 || p.batch < 1 || p.num_heads < 1 || p.batch > 65535 ||
      p.num_heads > 65535 || p.cls_chunk < 1 ||
      (G::kScaleOnce && !power_of_two(p.scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_blocks = p.q_len / kBlock;
  const int left = p.causal ? p.window : (p.window + 1) / 2;
  // ops/swa_kernel.py::cls_chunks sizes the scratch from the same count.
  p.cls_chunks = 0;
  if (sep_cls)
    p.cls_chunks = (num_blocks + p.cls_chunk - 1) / p.cls_chunk;
  else if (p.include_cls && num_blocks > left)
    p.cls_chunks = (num_blocks - left + p.cls_chunk - 1) / p.cls_chunk;
  const long long kv_ctas = (long long)(p.cls_chunks + p.key_len / kBlock) *
                            p.num_heads * p.batch;
  if (kv_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit dq_limit, kv_limit;
  cudaError_t err = svt::raise_smem_limit(
      dq_limit, swa_dq_kernel<D, kPacked, kBroadcast>, G::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = svt::raise_smem_limit(
      kv_limit, swa_dkv_kernel<D, kPacked, kBroadcast>, G::kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  swa_dq_kernel<D, kPacked, kBroadcast>
      <<<dim3(num_blocks, p.num_heads, p.batch), kThreads, G::kDqSmem, s>>>(
          p);
  swa_dkv_kernel<D, kPacked, kBroadcast>
      <<<static_cast<unsigned>(kv_ctas), kThreads, G::kKvSmem, s>>>(p);
  if (p.cls_chunks > 0)
    swa_cls_reduce_kernel<D, kPacked, kBroadcast>
        <<<dim3(2 * G::kTileFloats / kReduceSlice, p.num_heads, p.batch),
           kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

using bf16p = const __nv_bfloat16*;

}  // namespace

// K2 (and K6's backward): head-major Dh 64 or 128. With cls_k not null (and
// include_cls), [CLS] is the broadcast block cls_k, cls_v, cls_len whose
// gradients go to dcls_k, dcls_v; with cls_k null, key block 0 (those five
// may then be null).
extern "C" int svt_swa_bwd(const void* q, const void* k, const void* v,
                           const void* lengths, const void* lse,
                           const void* out, const void* dout,
                           const void* cls_k, const void* cls_v,
                           const void* cls_len, void* dq, void* dk, void* dv,
                           void* dcls_k, void* dcls_v, void* delta,
                           void* scratch, int batch, int num_heads, int q_len,
                           int key_len, int head_dim, int block_size,
                           int window, int causal, int include_cls, int q_off,
                           int cls_chunk, float scale, void* stream) {
  const BwdParams p{static_cast<bf16p>(q), static_cast<bf16p>(k),
                    static_cast<bf16p>(v), static_cast<bf16p>(out),
                    static_cast<bf16p>(dout), static_cast<bf16p>(cls_k),
                    static_cast<bf16p>(cls_v), static_cast<const float*>(lse),
                    static_cast<const int*>(lengths),
                    static_cast<const int*>(cls_len),
                    static_cast<__nv_bfloat16*>(dq),
                    static_cast<__nv_bfloat16*>(dk),
                    static_cast<__nv_bfloat16*>(dv),
                    static_cast<__nv_bfloat16*>(dcls_k),
                    static_cast<__nv_bfloat16*>(dcls_v),
                    static_cast<float*>(delta), static_cast<float*>(scratch),
                    batch, num_heads, q_len, key_len, window, causal,
                    include_cls, q_off, cls_chunk, 0, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return cls_k ? launch<128, false, true>(p, head_dim, block_size, s)
                 : launch<128, false, false>(p, head_dim, block_size, s);
  return cls_k ? launch<64, false, true>(p, head_dim, block_size, s)
               : launch<64, false, false>(p, head_dim, block_size, s);
}

// K5b: packed [B, L, H * 128], one seq_len, no q_off.
extern "C" int svt_swa_bwd_packed(const void* q, const void* k, const void* v,
                                  const void* lengths, const void* lse,
                                  const void* out, const void* dout, void* dq,
                                  void* dk, void* dv, void* delta,
                                  void* scratch, int batch, int num_heads,
                                  int seq_len, int head_dim, int block_size,
                                  int window, int causal, int include_cls,
                                  int cls_chunk, float scale, void* stream) {
  const BwdParams p{static_cast<bf16p>(q), static_cast<bf16p>(k),
                    static_cast<bf16p>(v), static_cast<bf16p>(out),
                    static_cast<bf16p>(dout), nullptr, nullptr,
                    static_cast<const float*>(lse),
                    static_cast<const int*>(lengths), nullptr,
                    static_cast<__nv_bfloat16*>(dq),
                    static_cast<__nv_bfloat16*>(dk),
                    static_cast<__nv_bfloat16*>(dv), nullptr, nullptr,
                    static_cast<float*>(delta), static_cast<float*>(scratch),
                    batch, num_heads, seq_len, seq_len, window, causal,
                    include_cls, 0, cls_chunk, 0, scale};
  return launch<128, true, false>(p, head_dim, block_size,
                                  static_cast<cudaStream_t>(stream));
}
