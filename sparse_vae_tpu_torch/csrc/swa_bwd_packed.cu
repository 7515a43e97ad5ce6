// K5b: sliding-window + [CLS] block-sparse attention, backward, on PACKED
// operands, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_kernels.py::_bwd_packed (bodies
// _dq_kernel_packed, _dkv_band_kernel_packed, _dkv_cls_kernel_packed; band
// maps _slot_to_block and _band_q_for_k). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/sliding_window_attention.py::
// sliding_window_attention_packed_bwd_plain.
//
// What it computes. q, k, v, out, do are packed [B, L, H * 128] bf16 (head
// h at column h * 128); lse is K5's head-major [B, H, L] fp32. For every
// attended (query i, key j) pair of the band + [CLS] pattern (K5's mask):
//   p = exp(s - lse_i) with s = q_i . k_j * scale, chosen 0 by select where
//       the mask forbids (a row with no valid key has lse -inf);
//   delta_i = rowsum over the head of do_i * out_i, fp32, head-major;
//   ds = p * (do_i . v_j - delta_i) * scale;
//   dq_i += ds k_j;  dk_j += ds q_i;  dv_j += p do_i.
// p and ds are rounded to bf16 before their products, as the Pallas kernel
// rounds them; every sum is fp32, and dq, dk, dv come out packed bf16,
// rounded once.
//
// What bounds it. It reads q, k, v, out, do and lse and writes dq, dk, dv:
// at [8, 12800, 4 * 128] about 0.84 GB against ~0.17 TFLOP of band
// arithmetic, ~200 FLOP per byte, under the bf16 ridge of ~295: bytes.
//
// Design: K2's four launches (csrc/swa_bwd.cu) on the packed layout at
// Dh = 128, each CTA 8 warps of 16 rows:
//   1. dq: one CTA per (q block, head, row); it first computes delta for
//      its rows (one warp per row, coalesced) and writes it out, then for
//      each valid band slot stages K and V: S = Q K^T, dP = dO V^T,
//      dQ += dS K in steps of 32 keys.
//   2. dk/dv band: one CTA per (k block, head, row) with K and V staged,
//      over the `window` query blocks whose band holds this key block:
//      S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q in steps of
//      16 queries.
//   3. [CLS] column: CTAs of CLS_CHUNK query blocks past the band's left
//      extent each write an fp32 partial for key block 0, whose band part
//      pass 2 also writes to fp32 scratch;
//   4. reduce: one CTA per (head, row) sums block 0's parts in a fixed
//      order and rounds once: deterministic, no atomics.
// Registers. At Dh = 128 a warp's 16 x 128 fp32 accumulator is 64
// registers per thread, and pass 2 and 3 hold two (dk, dv); K2's design of
// keeping the A operands (q/do or k/v rows) in registers besides would
// need ~230 and spill, so every operand is read from shared memory at each
// step, and the dk/dv passes step 16 queries at a time (s and dp 8
// registers each). 137 KB of shared memory per CTA (four tiles and the
// row statistics), above the 48 KB default, so each kernel raises its
// dynamic shared memory limit before launch.

#include "swa_packed.cuh"

namespace {

using namespace svt_packed;

constexpr int kChunkQ = 32;        // keys per step of the dq pass
constexpr int kChunkKv = 16;       // queries per step of the dk/dv passes
constexpr int kSmem = 4 * kTile * 2 + 2 * kBlock * 4;

__global__ void __launch_bounds__(kThreads)
swa_dq_packed_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ out,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ dq,
                     float* __restrict__ delta, int num_heads, int seq_len,
                     int window, int causal, int include_cls, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ks = dos + kTile;
  __nv_bfloat16* vs = ks + kTile;
  float* deltas = reinterpret_cast<float*>(vs + kTile);

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = seq_len / kBlock;
  const int hd = num_heads * kHeadDim;
  const size_t rows = (size_t)b * seq_len;
  const size_t col = (size_t)h * kHeadDim;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
  const int q0 = qb * kBlock;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // delta = rowsum(do * out) over the head, fp32: one warp per row, four
  // values per lane.
  for (int r = warp; r < kBlock; r += kWarps) {
    const size_t at = (rows + q0 + r) * hd + col + 4 * lane;
    const uint2 d4 = *reinterpret_cast<const uint2*>(dout + at);
    const uint2 o4 = *reinterpret_cast<const uint2*>(out + at);
    const float2 d01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&d4.x));
    const float2 d23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&d4.y));
    const float2 o01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&o4.x));
    const float2 o23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&o4.y));
    float sum = d01.x * o01.x + d01.y * o01.y + d23.x * o23.x +
                d23.y * o23.y;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      deltas[r] = sum;
      delta[head + q0 + r] = sum;
    }
  }
  stage_rows(q + (rows + q0) * hd + col, hd, qs);
  stage_rows(dout + (rows + q0) * hd + col, hd, dos);
  __syncthreads();

  const int row[2] = {q0 + warp * 16 + gq, q0 + warp * 16 + gq + 8};
  const float lse_r[2] = {lse[head + row[0]], lse[head + row[1]]};
  const float del_r[2] = {deltas[warp * 16 + gq], deltas[warp * 16 + gq + 8]};
  float acc[kDimTiles][4];
  zero(acc);

  constexpr int kNt = kChunkQ / 8;
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

    for (int c0 = 0; c0 < nkeys; c0 += kChunkQ) {
      // Warp-uniform: every key of the step lies after every row.
      if (causal && key0 + c0 > q0 + warp * 16 + 15) continue;
      float s[kNt][4], dp[kNt][4];
      tile_dot<kNt>(qs, warp * 16, ks, c0, s);
      tile_dot<kNt>(dos, warp * 16, vs, c0, dp);
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
      acc_product<kNt>(s, ks, c0, acc);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16(acc, one, dq + (rows + q0 + warp * 16) * hd + col, hd);
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

// Query block q0's rows of one head (q, do packed; lse, delta head-major)
// into shared memory.
__device__ __forceinline__ void stage_queries(
    const __nv_bfloat16* q, const __nv_bfloat16* dout, const float* lse,
    const float* delta, size_t rows, size_t col, int hd, size_t head, int q0,
    const KvSmem& m) {
  __syncthreads();  // every warp is done with the previous block
  stage_rows(q + (rows + q0) * hd + col, hd, m.qs);
  stage_rows(dout + (rows + q0) * hd + col, hd, m.dos);
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    m.lses[i] = lse[head + q0 + i];
    m.deltas[i] = delta[head + q0 + i];
  }
  __syncthreads();
}

// One staged query block's contributions to a warp's 16 key rows:
// dv += P^T dO, dk += dS^T Q.
__device__ __forceinline__ void accumulate_kv(
    const KvSmem& m, int q0, int key_first, int length, int causal,
    float scale, float (&dk)[kDimTiles][4], float (&dv)[kDimTiles][4]) {
  constexpr int kNt = kChunkKv / 8;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int r0 = key_first % kBlock;
  const int key[2] = {key_first + gq, key_first + gq + 8};
  for (int c0 = 0; c0 < kBlock; c0 += kChunkKv) {
    // Warp-uniform: every query of the step lies before every key.
    if (causal && q0 + c0 + kChunkKv - 1 < key_first) continue;
    float s[kNt][4], dp[kNt][4];
    tile_dot<kNt>(m.ks, r0, m.qs, c0, s);
    tile_dot<kNt>(m.vs, r0, m.dos, c0, dp);
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + nt * 8 + 2 * tq + (e & 1);
        const int kk = key[e >> 1];
        const float l = m.lses[c];
        const bool ok = kk < length && l != -INFINITY &&
                        (!causal || kk <= q0 + c);
        const float p = ok ? expf(s[nt][e] * scale - l) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - m.deltas[c]) * scale;  // ds
        s[nt][e] = p;
      }
    acc_product<kNt>(s, m.dos, c0, dv);
    acc_product<kNt>(dp, m.qs, c0, dk);
  }
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

__global__ void __launch_bounds__(kThreads)
swa_dkv_packed_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ dk_out,
                      __nv_bfloat16* __restrict__ dv_out,
                      float* __restrict__ scratch, int batch, int num_heads,
                      int seq_len, int window, int causal, int cls_chunks,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const KvSmem m = kv_smem(smem_raw);
  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = seq_len / kBlock;
  const int hd = num_heads * kHeadDim;
  const size_t rows = (size_t)b * seq_len;
  const size_t col = (size_t)h * kHeadDim;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
  const int k0 = kb * kBlock;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;

  stage_rows(k + (rows + k0) * hd + col, hd, m.ks);
  stage_rows(v + (rows + k0) * hd + col, hd, m.vs);
  float dk[kDimTiles][4], dv[kDimTiles][4];
  zero(dk);
  zero(dv);

  if (k0 < length) {  // uniform: some key of this block is valid
    const int left = causal ? window : (window + 1) / 2;
    for (int slot = 0; slot < window; ++slot) {
      const int qb = kb + left - window + slot;  // _band_q_for_k
      if (qb < 0 || qb >= num_blocks) continue;
      stage_queries(q, dout, lse, delta, rows, col, hd, head, qb * kBlock,
                    m);
      accumulate_kv(m, qb * kBlock, k0 + warp * 16, length, causal, scale,
                    dk, dv);
    }
  }
  if (kb == 0 && cls_chunks > 0) {
    // Block 0's band part joins the [CLS] partials in the reduce pass.
    const int parts = 1 + cls_chunks;
    store_rows_f32(dk, scratch_part(scratch, 0, batch, b, num_heads, h,
                                    parts, 0) + warp * 16 * kHeadDim);
    store_rows_f32(dv, scratch_part(scratch, 1, batch, b, num_heads, h,
                                    parts, 0) + warp * 16 * kHeadDim);
    return;
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16(dk, one, dk_out + (rows + k0 + warp * 16) * hd + col, hd);
  store_rows_bf16(dv, one, dv_out + (rows + k0 + warp * 16) * hd + col, hd);
}

__global__ void __launch_bounds__(kThreads)
swa_dkv_cls_packed_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ lengths,
                          float* __restrict__ scratch, int batch,
                          int num_heads, int seq_len, int window, int causal,
                          int cls_chunk, int cls_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const KvSmem m = kv_smem(smem_raw);
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_blocks = seq_len / kBlock;
  const int hd = num_heads * kHeadDim;
  const size_t rows = (size_t)b * seq_len;
  const size_t col = (size_t)h * kHeadDim;
  const size_t head = ((size_t)b * num_heads + h) * (size_t)seq_len;
  const int length = lengths[b];
  const int warp = threadIdx.x >> 5;

  stage_rows(k + rows * hd + col, hd, m.ks);  // key block 0
  stage_rows(v + rows * hd + col, hd, m.vs);
  float dk[kDimTiles][4], dv[kDimTiles][4];
  zero(dk);
  zero(dv);

  const int left = causal ? window : (window + 1) / 2;
  const int first = left + c * cls_chunk;
  const int last = min(num_blocks, first + cls_chunk);
  if (length > 0) {  // uniform
    for (int qb = first; qb < last; ++qb) {
      stage_queries(q, dout, lse, delta, rows, col, hd, head, qb * kBlock,
                    m);
      accumulate_kv(m, qb * kBlock, warp * 16, length, causal, scale, dk,
                    dv);
    }
  }
  const int parts = 1 + cls_chunks;
  store_rows_f32(dk, scratch_part(scratch, 0, batch, b, num_heads, h, parts,
                                  1 + c) + warp * 16 * kHeadDim);
  store_rows_f32(dv, scratch_part(scratch, 1, batch, b, num_heads, h, parts,
                                  1 + c) + warp * 16 * kHeadDim);
}

// Key block 0 of every (head, row): band part + [CLS] partials, summed in
// order, rounded once, written packed.
__global__ void __launch_bounds__(kThreads)
swa_cls_reduce_packed_kernel(const float* __restrict__ scratch,
                             __nv_bfloat16* __restrict__ dk_out,
                             __nv_bfloat16* __restrict__ dv_out, int batch,
                             int num_heads, int seq_len, int cls_chunks) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int parts = 1 + cls_chunks;
  const int hd = num_heads * kHeadDim;
  const size_t base = (size_t)b * seq_len * hd + (size_t)h * kHeadDim;
  for (int which = 0; which < 2; ++which) {
    const float* src = scratch_part(const_cast<float*>(scratch), which,
                                    batch, b, num_heads, h, parts, 0);
    __nv_bfloat16* dst = (which == 0 ? dk_out : dv_out) + base;
    for (int i = threadIdx.x; i < kTileFloats; i += kThreads) {
      float sum = 0.f;
      for (int p = 0; p < parts; ++p) sum += src[(size_t)p * kTileFloats + i];
      dst[(size_t)(i / kHeadDim) * hd + i % kHeadDim] =
          __float2bfloat16_rn(sum);
    }
  }
}

}  // namespace

extern "C" int svt_swa_bwd_packed(const void* q, const void* k, const void* v,
                                  const void* lengths, const void* lse,
                                  const void* out, const void* dout, void* dq,
                                  void* dk, void* dv, void* delta,
                                  void* scratch, int batch, int num_heads,
                                  int seq_len, int head_dim, int block_size,
                                  int window, int causal, int include_cls,
                                  int cls_chunk, float scale, void* stream) {
  if (head_dim != kHeadDim || block_size != kBlock || seq_len <= 0 ||
      seq_len % kBlock != 0 || window < 1 || batch < 1 || num_heads < 1 ||
      batch > 65535 || num_heads > 65535 || cls_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_blocks = seq_len / kBlock;
  const int left = causal ? window : (window + 1) / 2;
  const int cls_chunks = (include_cls && num_blocks > left)
                             ? (num_blocks - left + cls_chunk - 1) / cls_chunk
                             : 0;
  const void* kernels[] = {reinterpret_cast<const void*>(swa_dq_packed_kernel),
                           reinterpret_cast<const void*>(swa_dkv_packed_kernel),
                           reinterpret_cast<const void*>(
                               swa_dkv_cls_packed_kernel)};
  for (const void* fn : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

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

  const dim3 grid(num_blocks, num_heads, batch);
  swa_dq_packed_kernel<<<grid, kThreads, kSmem, s>>>(
      qp, kp, vp, op, dop, lsep, lenp, static_cast<__nv_bfloat16*>(dq),
      deltap, num_heads, seq_len, window, causal, include_cls, scale);
  swa_dkv_packed_kernel<<<grid, kThreads, kSmem, s>>>(
      qp, kp, vp, dop, lsep, deltap, lenp, dkp, dvp, scr, batch, num_heads,
      seq_len, window, causal, cls_chunks, scale);
  if (cls_chunks > 0) {
    const dim3 cgrid(cls_chunks, num_heads, batch);
    swa_dkv_cls_packed_kernel<<<cgrid, kThreads, kSmem, s>>>(
        qp, kp, vp, dop, lsep, deltap, lenp, scr, batch, num_heads, seq_len,
        window, causal, cls_chunk, cls_chunks, scale);
    swa_cls_reduce_packed_kernel<<<dim3(num_heads, batch), kThreads, 0, s>>>(
        scr, dkp, dvp, batch, num_heads, seq_len, cls_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
