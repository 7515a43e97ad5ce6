// K1: sliding-window + [CLS] block-sparse attention, forward, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_kernels.py::
// _sliding_window_attention_fwd_pallas (body _fwd_kernel, band maps
// _band_left / _slot_to_block / _tile_mask). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/sliding_window_attention.py::
// sliding_window_attention_plain.
//
// What it computes. q, k, v are head-major [B, H, L, 64] bf16 with L a
// multiple of the 128-token attention block. Query block qb attends the
// `window` key blocks of its band (causal: qb-window+1 .. qb; bidirectional:
// ceil-left / floor-right around qb) plus the [CLS] block 0 when the band
// does not already reach it. Keys at or past lengths[b] (the valid prefix of
// row b) are masked, and so are keys after the query when causal. Scores are
// fp32 q.k * scale; the softmax runs online in fp32, and the weights are
// rounded to bf16 for the value product, as the Pallas kernel rounds them.
// Outputs: out [B, H, L, 64] bf16 and lse [B, H, L] fp32. A row with no
// valid key gives out 0 and lse -inf.
//
// The sequence-parallel form (K6's band part, replacing
// sp_windowed_attention_pallas's calls of the same Pallas kernel with
// q_off = window - 1): q holds Lq rows and k, v hold Lk = Lq + q_off * 128
// extended keys [halo | local], so query block qb sits at key block
// qb + q_off. Its band slots read key blocks qb + q_off - window + 1 ..
// qb + q_off, the causal triangle compares positions on the key axis, and
// lengths[b] counts valid extended keys. With q_off > 0 there is no [CLS]
// slot (the caller attends the broadcast [CLS] block and merges). q_off = 0
// is the square single-device case.
//
// What bounds it. q, k, v are read and out written once: at [8, 8, 12800,
// 64] that is 0.42 GB against ~0.08 TFLOP of band products (~190 FLOP per
// byte, under the H100's bf16 ridge of ~295), so the card's bound is bytes.
// At the serve shape [1, 8, 512, 64] the call is a few microseconds of work
// and latency decides: how many CTAs run at once, and how long each one's
// chain of dependent steps is.
//
// Design. Every product is a bf16 mma.sync (m16n8k16) with fp32
// accumulation, as in K5 (swa_fwd_packed.cu). One CTA per (64-row half of
// a query block, head, batch row): 4 warps of 16 query rows, so the serve
// shape runs 64 CTAs, and the causal diagonal splits at the half block
// (the first half skips the diagonal block's last 64 keys). Each warp keeps
// its Q rows as operand fragments in registers. The CTA walks the valid
// band slots; the next slot's K and V tiles (bf16, rows padded to 72
// elements so ldmatrix's eight row reads hit distinct banks) load with
// cp.async into the other half of a double buffer while this one's are
// used. For each 32-key step: S = Q K^T, the causal / length mask, an
// online softmax with the running max and sum in registers (a row that has
// seen no valid key keeps max -inf and contributes nothing), then
// O += bf16(P) V with P passed from the accumulator layout straight into
// the operand registers and V read by ldmatrix.trans. Steps whose keys all
// lie after the warp's rows, and key blocks at or past lengths[b], are
// skipped. 72 KB of shared memory: three CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using svt::cp_async16;
using svt::ldsm_x4;
using svt::ldsm_x4_t;
using svt::mma16816;
using svt::packf;

constexpr int kBlock = 128;            // attention block (keys per slot)
constexpr int kRows = 64;              // query rows per CTA
constexpr int kHeadDim = 64;
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kHeadDim + 8;  // smem row stride, bf16
constexpr int kTile = kBlock * kStride;
constexpr int kChunk = 32;             // keys per online-softmax step
constexpr int kNt = kChunk / 8;        // mma n-tiles of a step
constexpr int kDimTiles = kHeadDim / 8;
constexpr int kSmemBytes = 2 * 2 * kTile * 2;  // K and V, double-buffered
constexpr float kLog2e = 1.4426950408889634f;

// One key block's K and V rows ([kBlock, 64] each, contiguous) into a
// buffer of padded rows, one commit group.
__device__ __forceinline__ void load_kv(const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v,
                                        __nv_bfloat16* ks,
                                        __nv_bfloat16* vs) {
  constexpr int kVec = kHeadDim / 8;
  for (int i = threadIdx.x; i < kBlock * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    cp_async16(ks + r * kStride + c, k + r * kHeadDim + c);
    cp_async16(vs + r * kStride + c, v + r * kHeadDim + c);
  }
}

__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ lengths,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int num_heads, int q_len, int key_len, int window,
               int causal, int include_cls, int q_off, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int half = blockIdx.x & 1;
  const int qb = (blockIdx.x >> 1) + q_off;  // query block on the key axis
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = key_len / kBlock;
  const size_t qhead = ((size_t)b * num_heads + h) * (size_t)q_len;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)key_len;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int l8 = lane & 7;
  const int lm = lane >> 3;

  // This warp's 16 rows: q row index and key-axis position.
  const int qrow0 = blockIdx.x * kRows + warp * 16;
  const int pos0 = qb * kBlock + half * kRows + warp * 16;
  const int pos[2] = {pos0 + gq, pos0 + gq + 8};

  uint32_t qf[kHeadDim / 16][4];
  {
    const __nv_bfloat16* p = q + (qhead + qrow0 + gq) * kHeadDim + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
      const __nv_bfloat16* c = p + ks * 16;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(c);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(c + 8 * kHeadDim);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(c + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(c + 8 * kHeadDim + 8);
    }
  }

  // _band_left / _slot_to_block: slot 0 is [CLS] (when included), the rest
  // walk the band from its leftmost block. A slot is used when its block
  // exists and holds a valid key; the test is uniform over the CTA.
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

  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};
  float acc[kDimTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDimTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float sl2 = scale * kLog2e;

  int cur = next_slot(0);
  int buf = 0;
  if (cur < slots) {
    const size_t key0 = head + (size_t)key_block(cur) * kBlock;
    load_kv(k + key0 * kHeadDim, v + key0 * kHeadDim, kv, kv + kTile);
  }
  svt::cp_async_commit();

  while (cur < slots) {
    const int nxt = next_slot(cur + 1);
    if (nxt < slots) {
      const size_t key0 = head + (size_t)key_block(nxt) * kBlock;
      __nv_bfloat16* dst = kv + (buf ^ 1) * 2 * kTile;
      load_kv(k + key0 * kHeadDim, v + key0 * kHeadDim, dst, dst + kTile);
    }
    svt::cp_async_commit();
    svt::cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* ks = kv + buf * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const int key0 = key_block(cur) * kBlock;
    const int nkeys = min(kBlock, length - key0);
    for (int c0 = 0; c0 < nkeys; c0 += kChunk) {
      // Warp-uniform: every key of the step lies after every row.
      if (causal && key0 + c0 > pos0 + 15) break;
      float s[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // B = K rows: matrices (keys 0-7 | 8-15) x (dims 0-7 | 8-15).
      const __nv_bfloat16* kr =
          ks + (c0 + 8 * (lm >> 1) + l8) * kStride + 8 * (lm & 1);
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          uint32_t t[4];
          ldsm_x4(t, kr + np * 16 * kStride + kk * 16);
          mma16816(s[2 * np], qf[kk], t);
          mma16816(s[2 * np + 1], qf[kk], t + 2);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int key = key0 + c0 + nt * 8 + 2 * tq + j;
            const bool ok = key < length && (!causal || key <= pos[i]);
            float& x = s[nt][2 * i + j];
            x = ok ? x * sl2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // A row with no valid key so far keeps max -inf: exp2(-inf) = 0
        // then gives p = 0 and leaves the (zero) sums as they are.
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[i] - m_use);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[nt][2 * i + j];
            x = exp2f(x - m_use);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int nt = 0; nt < kDimTiles; ++nt) {
          acc[nt][2 * i] *= alpha;
          acc[nt][2 * i + 1] *= alpha;
        }
      }
      // O += bf16(P) V; B = V read transposed: matrices (keys 0-7 | 8-15)
      // x (dims 0-7 | 8-15).
      const __nv_bfloat16* vr =
          vs + (c0 + 8 * (lm & 1) + l8) * kStride + 8 * (lm >> 1);
#pragma unroll
      for (int kk = 0; kk < kNt / 2; ++kk) {
        const uint32_t a[4] = {packf(s[2 * kk][0], s[2 * kk][1]),
                               packf(s[2 * kk][2], s[2 * kk][3]),
                               packf(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               packf(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kDimTiles / 2; ++dp) {
          uint32_t t[4];
          ldsm_x4_t(t, vr + kk * 16 * kStride + dp * 16);
          mma16816(acc[2 * dp], a, t);
          mma16816(acc[2 * dp + 1], a, t + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
    cur = nxt;
    buf ^= 1;
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  __nv_bfloat16* lo = out + (qhead + qrow0 + gq) * kHeadDim + 2 * tq;
  __nv_bfloat16* hi = lo + 8 * kHeadDim;
#pragma unroll
  for (int nt = 0; nt < kDimTiles; ++nt) {
    *reinterpret_cast<uint32_t*>(lo + nt * 8) =
        packf(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(hi + nt * 8) =
        packf(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
  if (tq == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse[qhead + qrow0 + gq + 8 * i] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
  }
}

}  // namespace

extern "C" const char* svt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int svt_swa_fwd(const void* q, const void* k, const void* v,
                           const void* lengths, void* out, void* lse,
                           int batch, int num_heads, int q_len, int key_len,
                           int head_dim, int block_size, int window,
                           int causal, int include_cls, int q_off,
                           float scale, void* stream) {
  if (head_dim != kHeadDim || block_size != kBlock || q_len <= 0 ||
      q_len % kBlock != 0 || q_off < 0 ||
      key_len != q_len + q_off * kBlock || (include_cls && q_off) ||
      window < 1 || batch < 1 || num_heads < 1 || batch > 65535 ||
      num_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit limit;
  const cudaError_t err =
      svt::raise_smem_limit(limit, swa_fwd_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(q_len / kRows, num_heads, batch);
  swa_fwd_kernel<<<grid, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), num_heads, q_len, key_len, window, causal,
      include_cls, q_off, scale);
  return static_cast<int>(cudaGetLastError());
}
