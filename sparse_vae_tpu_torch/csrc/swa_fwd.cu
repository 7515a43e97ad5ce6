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
// fp32 q.k * scale; the softmax runs online in fp32. Outputs: out [B, H, L,
// 64] bf16 and lse [B, H, L] fp32. A row with no valid key gives out 0 and
// lse -inf.
//
// The sequence-parallel form (K6's band part, replacing
// sp_windowed_attention_pallas's calls of the same Pallas kernel with
// q_off = window - 1): q holds Lq rows and k, v hold Lk = Lq + q_off * 128
// extended keys [halo | local], so query block qb sits at key block
// qb + q_off. Its band slots read key blocks qb + q_off - window + 1 ..
// qb + q_off, the causal triangle compares positions on the key axis, and
// lengths[b] counts valid extended keys. With q_off > 0 there is no [CLS]
// slot (the caller attends the broadcast [CLS] block and merges). q_off = 0
// is the square single-device case, unchanged.
//
// What bounds it. Each of q, k, v is read and out written once per query
// block's band: at L = 512 (serve prefill) that is ~2 MB against ~0.3
// GFLOP, and at L = 4096 the arithmetic intensity stays ~ 4 * 64 * 3 * 128
// / (4 * 64 * 2) = 192 FLOP per byte for the band work — below the 295 of
// the H100's bf16 tensor-core ridge, so the card's bound is bytes.
//
// Design. On the TPU the grid walked (batch, q block) in order with all
// heads in one step. Here blocks run in parallel and nothing carries
// between them: one CTA per (q block, head, batch row), 128 threads, one
// query row per thread. The thread keeps its q row and its 64 fp32
// accumulators in registers. For each valid band slot the CTA stages the
// 128-key K and V tiles in shared memory as fp32 (64 KB, dynamic), then
// each thread walks the keys in chunks of 16: 16 scores, one rescale of
// the accumulators by the chunk's new running max, then the p * V
// accumulation. Invalid slots and keys past the valid prefix are skipped
// at the CTA level. Plain FMA, no tensor cores: simple and right first;
// wgmma / TMA tiling is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;   // query rows per CTA == attention block
constexpr int kHeadDim = 64;
constexpr int kChunk = 16;    // keys per online-softmax step
constexpr int kTileFloats = kBlock * kHeadDim;
constexpr int kSmemBytes = 2 * kTileFloats * (int)sizeof(float);

__device__ __forceinline__ void unpack8(const uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Copy one contiguous [kBlock, kHeadDim] bf16 tile into shared memory as
// fp32; consecutive threads read consecutive 16-byte words.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          float* __restrict__ dst) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < kTileFloats / 8; i += kBlock) {
    float f[8];
    unpack8(s[i], f);
    float4* d = reinterpret_cast<float4*>(dst + 8 * i);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__global__ void __launch_bounds__(kBlock)
swa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ lengths,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int num_heads, int q_len, int key_len, int window,
               int causal, int include_cls, int q_off, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + kTileFloats;

  const int qb = blockIdx.x + q_off;  // the query block on the key axis
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = key_len / kBlock;
  // Row offsets of this (batch, head) in the [B, H, Lq] and [B, H, Lk]
  // index spaces.
  const size_t qhead = ((size_t)b * num_heads + h) * (size_t)q_len;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)key_len;
  const int qrow = blockIdx.x * kBlock + threadIdx.x;
  const int row = qb * kBlock + threadIdx.x;  // its key-axis position
  const int length = lengths[b];

  float qr[kHeadDim];
  {
    const uint4* qp =
        reinterpret_cast<const uint4*>(q + (qhead + qrow) * kHeadDim);
#pragma unroll
    for (int i = 0; i < kHeadDim / 8; ++i) unpack8(qp[i], qr + 8 * i);
  }
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // _band_left / _slot_to_block: slot 0 is [CLS] (when included), the rest
  // walk the band from its leftmost block.
  const int left = causal ? window : (window + 1) / 2;
  const int first_band = qb - (left - 1);
  const int slots = window + (include_cls ? 1 : 0);

  for (int slot = 0; slot < slots; ++slot) {
    int kb;
    bool valid;
    if (include_cls && slot == 0) {
      kb = 0;
      valid = first_band > 0;  // the band does not already reach block 0
    } else {
      kb = first_band + slot - (include_cls ? 1 : 0);
      valid = kb >= 0 && kb < num_blocks;
    }
    const int key0 = kb * kBlock;
    const int nkeys = min(kBlock, length - key0);
    if (!valid || nkeys <= 0) continue;  // uniform over the CTA

    __syncthreads();  // every thread is done with the previous tile
    load_tile(k + (head + key0) * kHeadDim, ks);
    load_tile(v + (head + key0) * kHeadDim, vs);
    __syncthreads();

    for (int j0 = 0; j0 < nkeys; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) s[c] = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 4) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float4 kk =
              *reinterpret_cast<const float4*>(ks + (j0 + c) * kHeadDim + d);
          s[c] = fmaf(qr[d], kk.x, s[c]);
          s[c] = fmaf(qr[d + 1], kk.y, s[c]);
          s[c] = fmaf(qr[d + 2], kk.z, s[c]);
          s[c] = fmaf(qr[d + 3], kk.w, s[c]);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        const bool ok = j < nkeys && (!causal || key0 + j <= row);
        s[c] = ok ? s[c] * scale : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      if (cmax == -INFINITY) continue;  // this row sees nothing here
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - m_new);  // masked keys give exactly 0
        l += p;
#pragma unroll
        for (int d = 0; d < kHeadDim; d += 4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (j0 + c) * kHeadDim + d);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  uint4* op = reinterpret_cast<uint4*>(out + (qhead + qrow) * kHeadDim);
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i) {
    uint4 packed;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 8 * i + 2 * j;
      const float a = l > 0.f ? acc[d] / l : 0.f;
      const float c = l > 0.f ? acc[d + 1] / l : 0.f;
      h2[j] = __floats2bfloat162_rn(a, c);
    }
    op[i] = packed;
  }
  lse[qhead + qrow] = l > 0.f ? m + logf(l) : -INFINITY;
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
  cudaError_t err = cudaFuncSetAttribute(
      swa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(q_len / kBlock, num_heads, batch);
  swa_fwd_kernel<<<grid, kBlock, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), num_heads, q_len, key_len, window, causal,
      include_cls, q_off, scale);
  return static_cast<int>(cudaGetLastError());
}
