// K5: sliding-window + [CLS] block-sparse attention, forward, on PACKED
// operands, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_kernels.py::
// _sliding_window_attention_fwd_packed (body _fwd_kernel_packed; band map
// _slot_to_block, mask _tile_mask). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/sliding_window_attention.py::
// sliding_window_attention_packed_plain.
//
// What it computes. q, k, v are the projections' own [B, L, H * 128] bf16
// layout, read in place (head h at column h * 128), so no head-major
// transpose is paid at the boundary. For every query row i and key j of the
// band of `window` blocks (ending at the diagonal when causal) plus the
// [CLS] block 0, with j < lengths[b] and, when causal, j <= i:
// out_i = softmax_j(q_i . k_j * scale) v_j, written packed like q, and
// lse_i, written head-major [B, H, L] fp32 (-inf, with out 0, for a row
// that sees no valid key). Scores, softmax and sums are fp32; the weights
// are rounded to bf16 for the value product, as the Pallas kernel rounds
// them.
//
// What bounds it. At [8, 12800, 4 * 128] the call reads q, k, v and writes
// out (0.42 GB) and does ~0.07 TFLOP of band products: ~160 FLOP per byte,
// under the H100's bf16 ridge of ~295, so the card's bound is bytes.
//
// Design. One CTA per (query block, head, batch row), 8 warps of 16 query
// rows. For each valid band slot the CTA stages that key block's K and V
// tiles in shared memory; each warp walks them 32 keys at a time:
// S = Q K^T (mma.sync), the causal / length mask, an online softmax with
// the running max and sum in registers (a row that has seen no valid key
// keeps max -inf and contributes nothing), then O += bf16(P) V with P
// passed from the accumulator layout straight into the operand registers.
// Steps whose keys all lie after the warp's rows are skipped. 104 KB of
// shared memory (Q, K, V tiles). mma.sync rather than wgmma/TMA: simple
// first.

#include "swa_packed.cuh"

namespace {

using namespace svt_packed;

constexpr int kChunk = 32;         // keys per step
constexpr int kNt = kChunk / 8;
constexpr int kSmem = 3 * kTile * 2;

__global__ void __launch_bounds__(kThreads)
swa_fwd_packed_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int num_heads, int seq_len,
                      int window, int causal, int include_cls, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile;
  __nv_bfloat16* vs = ks + kTile;

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = seq_len / kBlock;
  const int hd = num_heads * kHeadDim;            // packed row stride
  const size_t rows = (size_t)b * seq_len;        // batch row's first row
  const size_t col = (size_t)h * kHeadDim;        // head's first column
  const int q0 = qb * kBlock;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  stage_rows(q + (rows + q0) * hd + col, hd, qs);

  const int row[2] = {q0 + warp * 16 + gq, q0 + warp * 16 + gq + 8};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kDimTiles][4];
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
    stage_rows(k + (rows + key0) * hd + col, hd, ks);
    stage_rows(v + (rows + key0) * hd + col, hd, vs);
    __syncthreads();

    for (int c0 = 0; c0 < nkeys; c0 += kChunk) {
      // Warp-uniform: every key of the step lies after every row.
      if (causal && key0 + c0 > q0 + warp * 16 + 15) continue;
      float s[kNt][4];
      tile_dot<kNt>(qs, warp * 16, ks, c0, s);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int key = key0 + c0 + nt * 8 + 2 * tq + j;
            const bool ok = key < length && (!causal || key <= row[i]);
            float& x = s[nt][2 * i + j];
            x = ok ? x * scale : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // A row with no valid key so far keeps max -inf: exp(-inf) = 0
        // then gives p = 0 and leaves the (zero) sums as they are.
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = expf(m[i] - m_use);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[nt][2 * i + j];
            x = expf(x - m_use);
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
      acc_product<kNt>(s, vs, c0, acc);
    }
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  store_rows_bf16(acc, inv, out + (rows + q0 + warp * 16) * hd + col, hd);
  if (tq == 0) {
    const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse[head + row[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

}  // namespace

extern "C" int svt_swa_fwd_packed(const void* q, const void* k,
                                  const void* v, const void* lengths,
                                  void* out, void* lse, int batch,
                                  int num_heads, int seq_len, int head_dim,
                                  int block_size, int window, int causal,
                                  int include_cls, float scale,
                                  void* stream) {
  if (head_dim != kHeadDim || block_size != kBlock || seq_len <= 0 ||
      seq_len % kBlock != 0 || window < 1 || batch < 1 || num_heads < 1 ||
      batch > 65535 || num_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      swa_fwd_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(seq_len / kBlock, num_heads, batch);
  swa_fwd_packed_kernel<<<grid, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), num_heads,
      seq_len, window, causal, include_cls, scale);
  return static_cast<int>(cudaGetLastError());
}
