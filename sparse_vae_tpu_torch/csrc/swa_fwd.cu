// K1, K5 and K6's banded forward: sliding-window + [CLS] block-sparse
// attention, forward, for Hopper, in two layouts from one kernel templated
// on the head dim, the layout and a broadcast [CLS] slot.
//
// Replaces sparse_vae_tpu/ops/pallas_kernels.py::
// _sliding_window_attention_fwd_pallas (K1, :152: body _fwd_kernel, band
// maps _band_left / _slot_to_block / _tile_mask),
// ::_sliding_window_attention_fwd_packed (K5, :590: body _fwd_kernel_packed)
// and the forward of ::sp_windowed_attention_pallas on a banded shard
// (K6: _sp_fwd_impl :1003, which calls the K1 kernel with q_off, and
// _cls_attend :986 with the logaddexp merge). The plain PyTorch versions
// are sparse_vae_tpu_torch/ops/sliding_window_attention.py::
// sliding_window_attention_plain (with `cls` for K6) and
// ::sliding_window_attention_packed_plain.
//
// What it computes. q, k, v are bf16, either head-major [B, H, L, 64] or
// [B, H, L, 128] (K1, svt_swa_fwd; Dh 128 for tensor parallelism's heads,
// K6 and the dense route at that width) or packed [B, L, H * 128] with
// head h at column h * 128
// (K5, svt_swa_fwd_packed), with L a multiple of the 128-token block.
// Query block qb attends the `window` key blocks of its band (causal:
// qb-window+1 .. qb; bidirectional: ceil-left / floor-right around qb)
// plus the [CLS] block 0 when the band does not already reach it. Keys at
// or past lengths[b] (the valid prefix of row b) are masked, and so are
// keys after the query when causal. Scores are fp32 q.k * scale; the
// softmax runs online in fp32, and the weights are rounded to bf16 for the
// value product, as the Pallas kernel rounds them. Outputs: out in q's
// layout, bf16, rounded once, and lse [B, H, L] fp32 (head-major in both
// layouts). A row with no valid key gives out 0 and lse -inf.
//
// The sequence-parallel form (K6, head-major only): q holds Lq rows and k,
// v hold Lk = Lq + q_off * 128 extended keys [halo | local], so query
// block qb sits at key block qb + q_off; its band slots read key blocks
// qb + q_off - window + 1 .. qb + q_off, the causal triangle compares
// positions on the key axis, and lengths[b] counts valid extended keys. On
// a banded shard (q_off = window - 1, which is 0 at window 1) the
// broadcast [CLS] block (cls_k, cls_v [B, H, 128, Dh], cls_len [B] valid
// keys) is slot 0 with its own pointer: every local query attends it,
// masked by cls_len only and never causally. The online softmax spans it
// and the band, so out and the JOINT lse of the two come from one pass:
// no merge and no fp32 intermediate in device memory. Where JAX rounds the
// band's output to bf16 before the merge, this rounds the joint output
// once.
//
// What bounds it. q, k, v are read and out written once: at [8, 8, 12800,
// 64] (or [8, 12800, 4 * 128]) that is 0.42 GB against ~0.08 TFLOP of band
// + [CLS] products, ~190 FLOP per byte, under the H100's bf16 ridge of
// ~295, so the card's bound is bytes. At the serve shape [1, 8, 512, 64]
// the call is a few microseconds of work and latency decides.
//
// Design. The dq kernel of csrc/swa_bwd.cu without its third product, on
// the same tiles (swa_tiles.cuh). One CTA per (query block, head, batch
// row): two warpgroups, each owning 64 of the block's 128 rows. The Q tile
// stays in shared memory; the valid slots' K and V tiles (the band, and
// the broadcast [CLS] block from its own pointer) stream through a
// cp.async double buffer, the next slot's loads overlapping this one's
// products. Per 64-key step and warpgroup: S = Q K^T (wgmma m64n64k16,
// both operands from shared memory, K-major), the length / causal mask
// only where a warpgroup-uniform test says a key may be invalid (the
// unmasked fast path: every step off the diagonal and the ragged end), the
// online softmax in registers on pre-scaled logits with ex2.approx (a row
// that has seen no valid key keeps max -inf and contributes nothing), then
// O += bf16(P) V with P straight from the accumulator layout into the A
// registers and V read MN-major. Steps whose keys all lie after the
// warpgroup's rows, and key blocks at or past the valid length, are
// skipped.
// Registers and shared memory. At Dh = 64 a thread holds O (32 fp32) and S
// (32): two CTAs per SM (ptxas: 127 registers, no spill) at 82,944 bytes
// of dynamic shared memory (Q and two [K | V] buffers). At Dh = 128 O is
// 64 registers: one CTA per SM (163 registers, no spill) at 164,864
// bytes. 64-key K/V buffers (Q 32 KB + 64 KB) would admit a second CTA by
// shared memory, but not by registers: built for two CTAs per SM
// (__launch_bounds__(256, 2), at most 128 registers a thread) this
// instantiation spills 156 bytes a thread to local memory in its inner
// loop, so the 128-key buffers and one CTA per SM stay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "swa_tiles.cuh"

namespace {

using namespace svt::swa;
using svt::cp_async_commit;
using svt::cp_async_wait;
using svt::ex2;
using svt::fence_acc;
using svt::fence_proxy_async;
using svt::wgmma_commit;
using svt::wgmma_fence;
using svt::wgmma_wait;

// The kernel's arguments, __grid_constant__: its lambdas capture them by
// reference, and the address of any other kernel argument is that of a
// local copy.
struct FwdParams {
  const __nv_bfloat16 *q, *k, *v, *cls_k, *cls_v;
  const int *lengths, *cls_len;
  __nv_bfloat16* out;
  float* lse;
  int batch, num_heads, q_len, key_len, window, causal, include_cls, q_off;
  float scale;
};

// kBroadcast: [CLS] is the broadcast block (cls_k, ...), not key block 0;
// a template parameter, so that the other instantiations carry none of
// its branches.
template <int D, bool kPacked, bool kBroadcast>
__global__ void __launch_bounds__(kThreads, Geometry<D>::kMinBlocks)
swa_fwd_kernel(const __grid_constant__ FwdParams p) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = svt::align_smem(smem_raw);
  unsigned char* kv = qs + G::kTileBytes;  // [2][K | V]

  const Layout<D, kPacked> lay{p.num_heads};
  const int qb = blockIdx.x + p.q_off;  // the query block on the key axis
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = p.key_len / kBlock;
  const int q0 = blockIdx.x * kBlock;  // local row of the block's first query
  const int qk0 = qb * kBlock;         // its position on the key axis
  const int length = p.lengths[b];
  const int cls_len = kBroadcast ? p.cls_len[b] : 0;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;

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
  int cur = next_slot(0);
  if (cur < slots) load_kv(key_block(cur), kv);
  cp_async_commit();

  // This thread's rows of the block: r0 and r0 + 8.
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int row[2] = {qk0 + r0, qk0 + r0 + 8};  // key-axis positions
  const int wg_first = qk0 + 64 * wg;           // the warpgroup's first row
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = qs + wg * kWgBytes;
  float o[G::kHalves][32];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // running sum

  int bi = 0;
  while (cur < slots) {
    const int nxt = next_slot(cur + 1);
    if (nxt < slots) load_kv(key_block(nxt), kv + (bi ^ 1) * 2 * G::kTileBytes);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

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
      if (causal && key0 + c0 > wg_first + 63) break;
      float s[32];
      wgmma_fence();
      product<D, kKeyChunk>(s, qa, ks + c0 * kRowBytes);  // S = Q K^T
      wgmma_commit();
      // This product, and the previous step's O product, are done.
      wgmma_wait<0>();
      fence_acc(s);
      fence_all(o);
      // Warpgroup-uniform: a step with every key valid and at or before
      // every row needs no mask; the two forms are separate code.
      const bool edge = key0 + c0 + kKeyChunk > klen ||
                        (causal && key0 + c0 + kKeyChunk - 1 > wg_first);
      float mx[2] = {-INFINITY, -INFINITY};
      auto row_max = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int i = (j >> 1) & 1;
          if constexpr (decltype(masked)::value) {
            const int key = key0 + c0 + 8 * (j >> 2) + 2 * tq + (j & 1);
            const bool ok = key < klen && (!causal || key <= row[i]);
            s[j] = ok ? s[j] : -INFINITY;
          }
          mx[i] = fmaxf(mx[i], s[j]);
        }
      };
      if (edge)
        row_max(std::true_type());
      else
        row_max(std::false_type());
      float m_use[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * sl2);
        // A row with no valid key so far keeps max -inf: ex2(-inf) = 0
        // then gives p = 0 and leaves the (zero) sums as they are.
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2(m[i] - m_use[i]);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j >> 1) & 1;
        s[j] = ex2(fmaf(s[j], sl2, -m_use[i]));
        sum[i] += s[j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[hf][j] *= alpha[(j >> 1) & 1];
      wgmma_fence();
      product_acc<D, kKeyChunk>(o, s, vs + c0 * kRowBytes);  // O += P V
      wgmma_commit();  // in flight beside the next step's S
    }
    wgmma_wait<0>();
    fence_all(o);
    __syncthreads();  // every warp is done with this buffer
    cur = nxt;
    bi ^= 1;
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[hf][j] *= inv[(j >> 1) & 1];
  store_bf16(o, p.out + lay.at(b, h, p.q_len, q0 + 64 * wg + 16 * warp),
             lay.stride());
  if (tq == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    const size_t stats = ((size_t)b * p.num_heads + h) * (size_t)p.q_len;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      p.lse[stats + q0 + r0 + 8 * i] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
  }
}

template <int D, bool kPacked, bool kBroadcast>
int launch(const FwdParams& p, int head_dim, int block_size,
           cudaStream_t s) {
  using G = Geometry<D>;
  if (head_dim != D || block_size != kBlock || p.q_len <= 0 ||
      p.q_len % kBlock != 0 || p.q_off < 0 ||
      p.key_len != p.q_len + p.q_off * kBlock || (kPacked && p.q_off) ||
      (p.include_cls && p.q_off && !kBroadcast) ||
      (kBroadcast && !(p.include_cls && p.cls_v && p.cls_len)) ||
      p.window < 1 || p.batch < 1 || p.num_heads < 1 || p.batch > 65535 ||
      p.num_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit limit;
  const cudaError_t err = svt::raise_smem_limit(
      limit, swa_fwd_kernel<D, kPacked, kBroadcast>, G::kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_fwd_kernel<D, kPacked, kBroadcast>
      <<<dim3(p.q_len / kBlock, p.num_heads, p.batch), kThreads,
         G::kFwdSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

using bf16p = const __nv_bfloat16*;

}  // namespace

extern "C" const char* svt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1 (and K6's forward): head-major Dh 64 or 128. With cls_k not null (and
// include_cls), [CLS] is the broadcast block cls_k, cls_v, cls_len; with
// cls_k null, key block 0 (those three may then be null).
extern "C" int svt_swa_fwd(const void* q, const void* k, const void* v,
                           const void* lengths, const void* cls_k,
                           const void* cls_v, const void* cls_len, void* out,
                           void* lse, int batch, int num_heads, int q_len,
                           int key_len, int head_dim, int block_size,
                           int window, int causal, int include_cls, int q_off,
                           float scale, void* stream) {
  const FwdParams p{static_cast<bf16p>(q), static_cast<bf16p>(k),
                    static_cast<bf16p>(v), static_cast<bf16p>(cls_k),
                    static_cast<bf16p>(cls_v),
                    static_cast<const int*>(lengths),
                    static_cast<const int*>(cls_len),
                    static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                    batch, num_heads, q_len, key_len, window, causal,
                    include_cls, q_off, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return cls_k ? launch<128, false, true>(p, head_dim, block_size, s)
                 : launch<128, false, false>(p, head_dim, block_size, s);
  return cls_k ? launch<64, false, true>(p, head_dim, block_size, s)
               : launch<64, false, false>(p, head_dim, block_size, s);
}

// K5: packed [B, L, H * 128], one seq_len, no q_off.
extern "C" int svt_swa_fwd_packed(const void* q, const void* k,
                                  const void* v, const void* lengths,
                                  void* out, void* lse, int batch,
                                  int num_heads, int seq_len, int head_dim,
                                  int block_size, int window, int causal,
                                  int include_cls, float scale,
                                  void* stream) {
  const FwdParams p{static_cast<bf16p>(q), static_cast<bf16p>(k),
                    static_cast<bf16p>(v), nullptr, nullptr,
                    static_cast<const int*>(lengths), nullptr,
                    static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                    batch, num_heads, seq_len, seq_len, window, causal,
                    include_cls, 0, scale};
  return launch<128, true, false>(p, head_dim, block_size,
                                  static_cast<cudaStream_t>(stream));
}
