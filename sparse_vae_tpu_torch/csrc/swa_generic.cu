// The generic sliding-window + [CLS] block-sparse attention pair, forward
// and backward, for every shape inside the JAX package's kernel gates that
// the tuned instantiations of csrc/swa_fwd.cu and csrc/swa_bwd.cu do not
// take: any head dim Dh % 8 == 0 up to 512 and any block that is a
// multiple of 128, in the head-major [B, H, L, Dh] or the packed
// [B, L, H * Dh] layout (one entry, given each operand's row, head and
// batch strides).
//
// Replaces, at those shapes, sparse_vae_tpu/ops/pallas_kernels.py::
// _sliding_window_attention_fwd_pallas (K1, :152) and ::_bwd_pallas (K2,
// :337), ::_sliding_window_attention_fwd_packed (K5, :590) and
// ::_bwd_packed (K5b, :788), and the banded branch of
// ::sp_windowed_attention_pallas (K6, :1031: the band kernels with q_off
// and the broadcast [CLS] block), as well as the dense causal route of
// ops/attention.py (a causal band of L / block blocks, no [CLS]). The
// plain PyTorch versions are sparse_vae_tpu_torch/ops/
// sliding_window_attention.py::sliding_window_attention_plain and
// ::sliding_window_attention_bwd_plain (with `q_off` and `cls`).
//
// What it computes. Query block qb (on the key axis: local block i sits at
// key block i + q_off) attends the `window` key blocks of its band
// (causal: qb - window + 1 .. qb; bidirectional: the ceil-left /
// floor-right split, qb - (left - 1) .. qb + window - left with left =
// (window + 1) / 2), clipped to the key blocks that exist, plus key block
// 0 as the [CLS] slot when include_cls and the band does not already reach
// it, or else, given cls_k / cls_v / cls_len, the broadcast [CLS] block of
// a banded shard (masked by cls_len only, never causally). Keys at or past
// lengths[b] are masked, and keys after the query when causal. Scores are
// fp32 q.k * scale, the softmax runs online in fp32, and the weights are
// rounded to bf16 for the value product as the Pallas kernel rounds them;
// out is written in q's layout, bf16, rounded once, and lse [B, H, Lq]
// fp32 head-major. A row with no valid key gives out 0 and lse -inf. The
// backward recomputes p = exp(s - lse) (chosen 0 by select where the mask
// forbids), delta = rowsum(do * out) in fp32, ds = p (dp - delta) scale,
// and dq += ds k, dk += ds q, dv += p do with p and ds rounded to bf16
// before their products; dq, dk, dv (and dcls_k, dcls_v) are rounded once.
//
// What bounds it. At the slice's shape, the Dh = 256 Transformer-VAE of
// bench.py --heads 2 at [8, 12800, 2 * 256], the forward reads q, k, v
// and writes out (0.21 GB) against ~0.16 TFLOP of band + [CLS] products:
// ~750 FLOP per byte, past the H100's bf16 ridge of ~295, so the card's
// bound is its tensor-core rate; the backward likewise. This pair is the
// simple, right first version: mma.sync m16n8k16 (bf16 in, fp32
// accumulate), not wgmma, single-buffered cp.async tiles, so it sits well
// above that bound.
//
// Design. 128 threads (4 warps) a CTA, each warp owning 16 rows of a
// 64-row tile; a 64-row tile lies inside one block since blocks are
// multiples of 128. Dh is padded with zeros to Dp, a multiple of 16, in
// shared memory (rows Dp + 8 elements apart: ldmatrix reads them without
// bank conflicts). A block of r * 128 keys is walked in sub-tiles.
//   forward: one CTA per (64-query tile, column chunk of out, head, batch
//     row). Q stays in shared memory; K (all Dp dims) and V (the chunk's
//     dims) come in 64-key sub-tiles: S = Q K^T, mask, online softmax,
//     O += bf16(P) V with P passed from the accumulator registers as the
//     A operand. The output accumulator is 16 x kDV fp32 a warp, so a
//     head wider than 256 is cut into column chunks, each CTA recomputing
//     S (Dh 512: two chunks); chunk 0 writes lse.
//   delta: one warp per row, rowsum(do * out) in a fixed order.
//   dq: one CTA per (64-query tile, dq column chunk, head, row): Q and dO
//     resident, K and V in 32-key sub-tiles: S, dP = dO V^T, dS,
//     dQ += dS K.
//   dk/dv: one CTA per (64-key tile, column chunk of dk and dv, head,
//     row), K and V resident, over the query blocks whose band holds the
//     key block (the inverse band map) or, for key block 0 with the [CLS]
//     slot and for the broadcast block, every query block, in 32-query
//     sub-tiles: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q.
//     Those long [CLS] CTAs come first in the grid, so they start first.
// Every output element has one owner and every sum one order: no atomics,
// and a second call is bit-identical.
// Registers and shared memory (dynamic; the ptxas lines of the build give
// registers and spills): forward Q + K at Dp and V at kDV, 64 rows each,
// 166,912 bytes at Dp 512; dq and dk/dv 192 rows at Dp (+ 256 bytes of
// lse and delta), 199,936 bytes at Dp 512; at Dp 256, 101,376.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using svt::cp_async16;
using svt::cp_async_commit;
using svt::cp_async_wait;
using svt::ex2;
using svt::packf;
using svt::smem_u32;

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 64;       // query rows (forward, dq) or key rows (dk/dv)
constexpr int kFwdKeys = 64;    // keys per forward step
constexpr int kStep = 32;       // keys per dq step, queries per dk/dv step
constexpr int kMaxDim = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The kernels' arguments, __grid_constant__. Strides are in elements:
// q, out, do and dq share q's; k, v, dk and dv share k's; the broadcast
// block cls_k, cls_v, dcls_k, dcls_v is head-major [B, H, block, Dh].
struct Params {
  const bf16 *q, *k, *v, *out, *dout, *cls_k, *cls_v;
  const float* lse_in;
  const int *lengths, *cls_len;
  bf16 *o, *dq, *dk, *dv, *dcls_k, *dcls_v;
  float *lse, *delta;
  int q_row, q_head, q_batch, k_row, k_head, k_batch;
  int batch, heads, q_len, key_len, dim, dim_pad, block, window, causal,
      include_cls, q_off;
  float scale;
};

__device__ __forceinline__ size_t q_at(const Params& p, int b, int h, int r) {
  return (size_t)b * p.q_batch + (size_t)h * p.q_head + (size_t)r * p.q_row;
}
__device__ __forceinline__ size_t k_at(const Params& p, int b, int h, int r) {
  return (size_t)b * p.k_batch + (size_t)h * p.k_head + (size_t)r * p.k_row;
}
__device__ __forceinline__ size_t cls_at(const Params& p, int b, int h,
                                         int r) {
  return (((size_t)b * p.heads + h) * p.block + r) * p.dim;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, not transposed (lanes 8m ..
// 8m + 7 give matrix m's row addresses).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  svt::ldsm_x4_t(r, smem_u32(p));
}

// This lane's address for the A fragment of rows row0 .. row0 + 15 and
// columns col0 .. col0 + 15 of a row-major tile `ld` elements a row.
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld,
                                              int row0, int col0) {
  const int lane = threadIdx.x & 31;
  return tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + col0 +
         8 * (lane >> 4);
}
// B fragments of two n8 tiles (rows n0 .. n0 + 15 of a row-major tile
// hold the n index, columns k0 .. k0 + 15 the k index): r[0], r[1] for
// n0 .. n0 + 7 and r[2], r[3] for n0 + 8 .. n0 + 15.
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int ld,
                                              int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
         8 * ((lane >> 3) & 1);
}
// The same two n8 tiles from a tile whose rows hold the k index and
// columns the n index (read transposed).
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int ld,
                                               int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 +
         8 * (lane >> 4);
}

// `rows` rows of `cols` bf16 (rows `stride` elements apart from src) into
// shared memory `ld` elements a row by cp.async; columns at or past
// `valid` are zero (the head dim's padding).
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t stride, int rows, int cols,
                                          int valid) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    bf16* d = dst + r * ld + c;
    if (c < valid)
      cp_async16(d, src + r * stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The key blocks query block qb (on the key axis) attends: the band
// [*lo, *hi] clipped to the num_kb blocks, and *cls0 when key block 0 is
// attended apart as the [CLS] slot (the band does not reach it).
__device__ __forceinline__ void band_of(const Params& p, int qb, int num_kb,
                                        int* lo, int* hi, bool* cls0) {
  const int left = p.causal ? p.window : (p.window + 1) / 2;
  const int first = qb - (left - 1);
  *lo = max(first, 0);
  *hi = min(first + p.window - 1, num_kb - 1);
  *cls0 = p.include_cls && first > 0;
}

// The key segments of a query block, in order: the broadcast block (sep),
// then key block 0 as the [CLS] slot, then the band.
struct Segments {
  int lo, hi, count;
  bool cls0, broadcast;
  __device__ __forceinline__ Segments(const Params& p, int qb) {
    band_of(p, qb, p.key_len / p.block, &lo, &hi, &cls0);
    broadcast = p.cls_k != nullptr;
    count = (broadcast ? 1 : 0) + (cls0 ? 1 : 0) + max(hi - lo + 1, 0);
  }
  // Key block of segment i, or -1 for the broadcast block.
  __device__ __forceinline__ int block(int i) const {
    if (broadcast) {
      if (i == 0) return -1;
      --i;
    }
    if (cls0) {
      if (i == 0) return 0;
      --i;
    }
    return lo + i;
  }
};

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// acc[16 x kDV] += bf16(w)[16 x kK] T[kK rows at t0 .. of t, columns
// c0 ..]: w in the accumulator layout (w[j][e]: row g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1)), which packs into the A registers by k16
// step; T read transposed. Column pairs past `width` are not read.
template <int kDV, int kK>
__device__ __forceinline__ void product_acc(float (&acc)[kDV / 8][4],
                                            const float (&w)[kK / 8][4],
                                            const bf16* t, int ld, int c0,
                                            int width) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    const uint32_t a[4] = {packf(w[2 * kk][0], w[2 * kk][1]),
                           packf(w[2 * kk][2], w[2 * kk][3]),
                           packf(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                           packf(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
    for (int nn = 0; nn < kDV / 16; ++nn) {
      if (c0 + 16 * nn >= width) break;
      uint32_t b[4];
      ldsm_x4_t(b, bt_addr(t, ld, 16 * kk, c0 + 16 * nn));
      mma(acc[2 * nn], a, b[0], b[1]);
      mma(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// x[16 x kN] += A[16 rows at row0 of a] B[kN rows of b]^T over dp dims.
template <int kN>
__device__ __forceinline__ void product(float (&x)[kN / 8][4], const bf16* a,
                                        int row0, const bf16* b, int ld,
                                        int dp) {
  const bf16* pa = a_addr(a, ld, row0, 0);
  for (int kk = 0; kk < dp / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, pa + 16 * kk);
#pragma unroll
    for (int nn = 0; nn < kN / 16; ++nn) {
      uint32_t bf[4];
      ldsm_x4(bf, b_addr(b, ld, 16 * nn, 16 * kk));
      mma(x[2 * nn], af, bf[0], bf[1]);
      mma(x[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// A warp's 16 x kDV accumulator rows (times inv[i] for row g + 8 i), the
// columns below dim, in bf16 to the rows at `rows` (`stride` apart),
// column c0 on.
template <int kDV>
__device__ __forceinline__ void store_rows(const float (&acc)[kDV / 8][4],
                                           const float (&inv)[2], bf16* rows,
                                           size_t stride, int c0, int dim) {
  const int lane = threadIdx.x & 31;
  bf16* lo = rows + (size_t)(lane >> 2) * stride + c0 + 2 * (lane & 3);
  bf16* hi = lo + 8 * stride;
#pragma unroll
  for (int j = 0; j < kDV / 8; ++j) {
    if (c0 + 8 * j >= dim) break;
    *reinterpret_cast<uint32_t*>(lo + 8 * j) =
        packf(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(hi + 8 * j) =
        packf(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
}

template <int kDV>
__global__ void __launch_bounds__(kThreads)
swa_generic_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = p.dim_pad;
  const int ld = dp + 8;
  constexpr int ldv = kDV + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * ld;
  bf16* vs = ks + kFwdKeys * ld;

  const int chunks = (dp + kDV - 1) / kDV;
  const int chunk = blockIdx.y % chunks;
  const int h = blockIdx.y / chunks;
  const int b = blockIdx.z;
  const int c0 = chunk * kDV;
  const int r0 = blockIdx.x * kRows;        // local row of the first query
  const int qk0 = r0 + p.q_off * p.block;   // its position on the key axis
  const int length = p.lengths[b];
  const int cls_len = p.cls_k ? p.cls_len[b] : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int row[2] = {qk0 + 16 * warp + (lane >> 2),
                      qk0 + 16 * warp + (lane >> 2) + 8};

  load_rows(qs, ld, p.q + q_at(p, b, h, r0), p.q_row, kRows, dp, p.dim);
  cp_async_commit();

  const Segments seg(p, qk0 / p.block);
  const float sl2 = p.scale * kLog2e;
  float o[kDV / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // running sum

  for (int si = 0; si < seg.count; ++si) {
    const int kb = seg.block(si);
    const bool sep = kb < 0;
    const bf16* kbase = sep ? p.cls_k + cls_at(p, b, h, 0)
                            : p.k + k_at(p, b, h, kb * p.block);
    const bf16* vbase = sep ? p.cls_v + cls_at(p, b, h, 0)
                            : p.v + k_at(p, b, h, kb * p.block);
    const size_t stride = sep ? p.dim : p.k_row;
    const int key_first = sep ? 0 : kb * p.block;
    const int klen = sep ? cls_len : length;
    const bool causal = p.causal && !sep;
    for (int sub = 0; sub < p.block; sub += kFwdKeys) {
      const int key0 = key_first + sub;
      // CTA-uniform: every key of the step is masked for every row.
      if (key0 >= klen || (causal && key0 > qk0 + kRows - 1)) break;
      __syncthreads();  // every warp is done with the previous step
      load_rows(ks, ld, kbase + sub * stride, stride, kFwdKeys, dp, p.dim);
      load_rows(vs, ldv, vbase + sub * stride + c0, stride, kFwdKeys, kDV,
                p.dim - c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      float s[kFwdKeys / 8][4];
      zero(s);
      product<kFwdKeys>(s, qs, 16 * warp, ks, ld, dp);  // S = Q K^T
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = key0 + 8 * j + 2 * tq + (e & 1);
          const bool ok = key < klen && (!causal || key <= row[i]);
          s[j][e] = ok ? s[j][e] * sl2 : -INFINITY;
          mx[i] = fmaxf(mx[i], s[j][e]);
        }
      float m_use[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // A row with no valid key so far keeps max -inf: ex2(-inf) = 0
        // gives p = 0 and leaves its (zero) sums as they are.
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2(m[i] - m_use[i]);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - m_use[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int j = 0; j < kDV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      product_acc<kDV, kFwdKeys>(o, s, vs, ldv, 0, kDV);  // O += P V
    }
  }
  cp_async_wait<0>();

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  store_rows<kDV>(o, inv, p.o + q_at(p, b, h, r0 + 16 * warp), p.q_row, c0,
                  p.dim);
  if (chunk == 0 && tq == 0) {
    const size_t stats = ((size_t)b * p.heads + h) * (size_t)p.q_len + r0 +
                         16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      p.lse[stats + 8 * i] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
  }
}

// delta = rowsum(do * out) in fp32, one warp a row, lanes over 8-dim
// chunks, then a fixed butterfly: head-major [B, H, Lq].
__global__ void __launch_bounds__(256)
swa_generic_delta_kernel(const __grid_constant__ Params p) {
  const long long id = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (id >= (long long)p.batch * p.heads * p.q_len) return;
  const int r = (int)(id % p.q_len);
  const int bh = (int)(id / p.q_len);
  const size_t at = q_at(p, bh / p.heads, bh % p.heads, r);
  float acc = 0.f;
  for (int c = 8 * lane; c < p.dim; c += 256) {
    const uint4 x = *reinterpret_cast<const uint4*>(p.out + at + c);
    const uint4 y = *reinterpret_cast<const uint4*>(p.dout + at + c);
    const bf16* xs = reinterpret_cast<const bf16*>(&x);
    const bf16* ys = reinterpret_cast<const bf16*>(&y);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc = fmaf(__bfloat162float(xs[e]), __bfloat162float(ys[e]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[id] = acc;
}

template <int kDV>
__global__ void __launch_bounds__(kThreads)
swa_generic_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = p.dim_pad;
  const int ld = dp + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRows * ld;
  bf16* ks = dos + kRows * ld;
  bf16* vs = ks + kStep * ld;

  const int chunks = (dp + kDV - 1) / kDV;
  const int chunk = blockIdx.y % chunks;
  const int h = blockIdx.y / chunks;
  const int b = blockIdx.z;
  const int c0 = chunk * kDV;
  const int r0 = blockIdx.x * kRows;
  const int qk0 = r0 + p.q_off * p.block;
  const int length = p.lengths[b];
  const int cls_len = p.cls_k ? p.cls_len[b] : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int row[2] = {qk0 + 16 * warp + (lane >> 2),
                      qk0 + 16 * warp + (lane >> 2) + 8};

  load_rows(qs, ld, p.q + q_at(p, b, h, r0), p.q_row, kRows, dp, p.dim);
  load_rows(dos, ld, p.dout + q_at(p, b, h, r0), p.q_row, kRows, dp, p.dim);
  cp_async_commit();
  const size_t stats = ((size_t)b * p.heads + h) * (size_t)p.q_len + r0 +
                       16 * warp + (lane >> 2);
  const float lse2[2] = {p.lse_in[stats] * kLog2e,
                         p.lse_in[stats + 8] * kLog2e};
  const float delta[2] = {p.delta[stats], p.delta[stats + 8]};

  const Segments seg(p, qk0 / p.block);
  const float sl2 = p.scale * kLog2e;
  float acc[kDV / 8][4];
  zero(acc);
  for (int si = 0; si < seg.count; ++si) {
    const int kb = seg.block(si);
    const bool sep = kb < 0;
    const bf16* kbase = sep ? p.cls_k + cls_at(p, b, h, 0)
                            : p.k + k_at(p, b, h, kb * p.block);
    const bf16* vbase = sep ? p.cls_v + cls_at(p, b, h, 0)
                            : p.v + k_at(p, b, h, kb * p.block);
    const size_t stride = sep ? p.dim : p.k_row;
    const int key_first = sep ? 0 : kb * p.block;
    const int klen = sep ? cls_len : length;
    const bool causal = p.causal && !sep;
    for (int sub = 0; sub < p.block; sub += kStep) {
      const int key0 = key_first + sub;
      if (key0 >= klen || (causal && key0 > qk0 + kRows - 1)) break;
      __syncthreads();
      load_rows(ks, ld, kbase + sub * stride, stride, kStep, dp, p.dim);
      load_rows(vs, ld, vbase + sub * stride, stride, kStep, dp, p.dim);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      float s[kStep / 8][4], dpv[kStep / 8][4];
      zero(s);
      zero(dpv);
      product<kStep>(s, qs, 16 * warp, ks, ld, dp);     // S = Q K^T
      product<kStep>(dpv, dos, 16 * warp, vs, ld, dp);  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = key0 + 8 * j + 2 * tq + (e & 1);
          const bool ok = key < klen && (!causal || key <= row[i]);
          const float pr = ok ? ex2(s[j][e] * sl2 - lse2[i]) : 0.f;
          s[j][e] = pr * (dpv[j][e] - delta[i]) * p.scale;  // dS
        }
      product_acc<kDV, kStep>(acc, s, ks, ld, c0, dp);  // dQ += dS K
    }
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<kDV>(acc, one, p.dq + q_at(p, b, h, r0 + 16 * warp), p.q_row,
                  c0, p.dim);
}

template <int kDV>
__global__ void __launch_bounds__(kThreads)
swa_generic_dkv_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = p.dim_pad;
  const int ld = dp + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kRows * ld;
  bf16* qs = vs + kRows * ld;
  bf16* dos = qs + kStep * ld;
  float* lse_s = reinterpret_cast<float*>(dos + kStep * ld);
  float* delta_s = lse_s + kStep;

  const int chunks = (dp + kDV - 1) / kDV;
  const int chunk = blockIdx.y % chunks;
  const int h = blockIdx.y / chunks;
  const int b = blockIdx.z;
  const int c0 = chunk * kDV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  // The broadcast block's key tiles first, then the key axis's.
  const int cls_tiles = p.cls_k ? p.block / kRows : 0;
  const bool sep = (int)blockIdx.x < cls_tiles;
  const int kt0 = (sep ? blockIdx.x : blockIdx.x - cls_tiles) * kRows;
  const int klen = sep ? p.cls_len[b] : p.lengths[b];
  const bool causal = p.causal && !sep;
  const int num_qb = p.q_len / p.block;
  int i_lo = 0, i_hi = num_qb - 1;  // local query blocks attending the tile
  const int kb = kt0 / p.block;
  if (!sep && !(kb == 0 && p.include_cls)) {
    const int left = p.causal ? p.window : (p.window + 1) / 2;
    i_lo = max(kb - (p.window - left) - p.q_off, 0);
    i_hi = min(kb + left - 1 - p.q_off, num_qb - 1);
  }
  const int key[2] = {kt0 + 16 * warp + (lane >> 2),
                      kt0 + 16 * warp + (lane >> 2) + 8};

  float dk[kDV / 8][4], dv[kDV / 8][4];
  zero(dk);
  zero(dv);
  if (kt0 < klen) {
    const bf16* kbase = sep ? p.cls_k + cls_at(p, b, h, kt0)
                            : p.k + k_at(p, b, h, kt0);
    const bf16* vbase = sep ? p.cls_v + cls_at(p, b, h, kt0)
                            : p.v + k_at(p, b, h, kt0);
    const size_t stride = sep ? p.dim : p.k_row;
    load_rows(ks, ld, kbase, stride, kRows, dp, p.dim);
    load_rows(vs, ld, vbase, stride, kRows, dp, p.dim);
    cp_async_commit();
    const float sl2 = p.scale * kLog2e;
    const size_t stats = ((size_t)b * p.heads + h) * (size_t)p.q_len;
    for (int i = i_lo; i <= i_hi; ++i)
      for (int sub = 0; sub < p.block; sub += kStep) {
        const int r0 = i * p.block + sub;       // local query row
        const int qk0 = r0 + p.q_off * p.block;  // on the key axis
        // CTA-uniform: every query of the step is before every key.
        if (causal && qk0 + kStep - 1 < kt0) continue;
        __syncthreads();
        load_rows(qs, ld, p.q + q_at(p, b, h, r0), p.q_row, kStep, dp,
                  p.dim);
        load_rows(dos, ld, p.dout + q_at(p, b, h, r0), p.q_row, kStep, dp,
                  p.dim);
        if (threadIdx.x < kStep)
          lse_s[threadIdx.x] = p.lse_in[stats + r0 + threadIdx.x] * kLog2e;
        else if (threadIdx.x < 2 * kStep)
          delta_s[threadIdx.x - kStep] =
              p.delta[stats + r0 + threadIdx.x - kStep];
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        float s[kStep / 8][4], dpv[kStep / 8][4];
        zero(s);
        zero(dpv);
        product<kStep>(s, ks, 16 * warp, qs, ld, dp);     // S^T = K Q^T
        product<kStep>(dpv, vs, 16 * warp, dos, ld, dp);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tq + (e & 1);
            const int k = key[e >> 1];
            const bool ok = k < klen && (!causal || k <= qk0 + col);
            const float pr = ok ? ex2(s[j][e] * sl2 - lse_s[col]) : 0.f;
            s[j][e] = pr;
            dpv[j][e] = pr * (dpv[j][e] - delta_s[col]) * p.scale;  // dS^T
          }
        product_acc<kDV, kStep>(dv, s, dos, ld, c0, dp);    // dV += P^T dO
        product_acc<kDV, kStep>(dk, dpv, qs, ld, c0, dp);   // dK += dS^T Q
      }
    cp_async_wait<0>();
  }
  const float one[2] = {1.f, 1.f};
  const int r = kt0 + 16 * warp;
  if (sep) {
    store_rows<kDV>(dk, one, p.dcls_k + cls_at(p, b, h, r), p.dim, c0, p.dim);
    store_rows<kDV>(dv, one, p.dcls_v + cls_at(p, b, h, r), p.dim, c0, p.dim);
  } else {
    store_rows<kDV>(dk, one, p.dk + k_at(p, b, h, r), p.k_row, c0, p.dim);
    store_rows<kDV>(dv, one, p.dv + k_at(p, b, h, r), p.k_row, c0, p.dim);
  }
}

// Output columns a CTA holds: the smallest of 64, 128, 256 that covers the
// padded head dim, at most `widest`.
int chunk_width(int dim_pad, int widest) {
  const int w = dim_pad <= 64 ? 64 : dim_pad <= 128 ? 128 : 256;
  return w < widest ? w : widest;
}

int fwd_smem(int dim_pad, int dv) {
  return (2 * kRows * (dim_pad + 8) + kFwdKeys * (dv + 8)) * 2;
}
int bwd_smem(int dim_pad) {
  return 2 * (kRows + kStep) * (dim_pad + 8) * 2 + 2 * kStep * 4;
}

// Widest forward and dq chunk, widest dk/dv chunk (two accumulators).
constexpr int kFwdWidest = 256;
constexpr int kDkvWidest = 128;

int check(const Params& p) {
  const long long tiles = (long long)p.key_len / kRows + p.block / kRows;
  if (p.dim < 8 || p.dim > kMaxDim || p.dim % 8 != 0 || p.block < 128 ||
      p.block % 128 != 0 || p.q_len <= 0 || p.q_len % p.block != 0 ||
      p.q_off < 0 || p.key_len != p.q_len + p.q_off * p.block ||
      (p.include_cls && (p.q_off || p.cls_k)) ||
      (p.cls_k && !(p.cls_v && p.cls_len)) || p.window < 1 ||
      p.batch < 1 || p.heads < 1 || p.batch > 65535 ||
      p.heads * ((p.dim_pad + 63) / 64) > 65535 || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int kDV>
int launch_fwd(const Params& p, cudaStream_t s) {
  static svt::SmemLimit limit;
  cudaError_t err = svt::raise_smem_limit(
      limit, swa_generic_fwd_kernel<kDV>, fwd_smem(kMaxDim, kDV));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (p.dim_pad + kDV - 1) / kDV;
  swa_generic_fwd_kernel<kDV>
      <<<dim3(p.q_len / kRows, p.heads * chunks, p.batch), kThreads,
         fwd_smem(p.dim_pad, kDV), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kDV>
int launch_dq(const Params& p, cudaStream_t s) {
  static svt::SmemLimit limit;
  cudaError_t err = svt::raise_smem_limit(
      limit, swa_generic_dq_kernel<kDV>, bwd_smem(kMaxDim));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (p.dim_pad + kDV - 1) / kDV;
  swa_generic_dq_kernel<kDV>
      <<<dim3(p.q_len / kRows, p.heads * chunks, p.batch), kThreads,
         bwd_smem(p.dim_pad), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kDV>
int launch_dkv(const Params& p, cudaStream_t s) {
  static svt::SmemLimit limit;
  cudaError_t err = svt::raise_smem_limit(
      limit, swa_generic_dkv_kernel<kDV>, bwd_smem(kMaxDim));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (p.dim_pad + kDV - 1) / kDV;
  const int tiles = p.key_len / kRows + (p.cls_k ? p.block / kRows : 0);
  swa_generic_dkv_kernel<kDV>
      <<<dim3(tiles, p.heads * chunks, p.batch), kThreads,
         bwd_smem(p.dim_pad), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

using cbf16p = const bf16*;

Params make_params(const void* q, const void* k, const void* v,
                   const void* lengths, const void* cls_k, const void* cls_v,
                   const void* cls_len, int q_row, int q_head, int q_batch,
                   int k_row, int k_head, int k_batch, int batch, int heads,
                   int q_len, int key_len, int head_dim, int block_size,
                   int window, int causal, int include_cls, int q_off,
                   float scale) {
  Params p{};
  p.q = static_cast<cbf16p>(q);
  p.k = static_cast<cbf16p>(k);
  p.v = static_cast<cbf16p>(v);
  p.cls_k = static_cast<cbf16p>(cls_k);
  p.cls_v = static_cast<cbf16p>(cls_v);
  p.lengths = static_cast<const int*>(lengths);
  p.cls_len = static_cast<const int*>(cls_len);
  p.q_row = q_row;
  p.q_head = q_head;
  p.q_batch = q_batch;
  p.k_row = k_row;
  p.k_head = k_head;
  p.k_batch = k_batch;
  p.batch = batch;
  p.heads = heads;
  p.q_len = q_len;
  p.key_len = key_len;
  p.dim = head_dim;
  p.dim_pad = (head_dim + 15) / 16 * 16;
  p.block = block_size;
  p.window = window;
  p.causal = causal;
  p.include_cls = include_cls;
  p.q_off = q_off;
  p.scale = scale;
  return p;
}

}  // namespace

// The generic forward, either layout: q/out at q's strides (row, head,
// batch), k/v at k's; with cls_k not null (include_cls 0), the broadcast
// [CLS] block cls_k, cls_v [B, H, block, Dh] of cls_len[b] valid keys;
// lse [B, H, q_len] fp32.
extern "C" int svt_swa_generic_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* cls_k, const void* cls_v, const void* cls_len, void* out,
    void* lse, int q_row, int q_head, int q_batch, int k_row, int k_head,
    int k_batch, int batch, int num_heads, int q_len, int key_len,
    int head_dim, int block_size, int window, int causal, int include_cls,
    int q_off, float scale, void* stream) {
  Params p = make_params(q, k, v, lengths, cls_k, cls_v, cls_len, q_row,
                         q_head, q_batch, k_row, k_head, k_batch, batch,
                         num_heads, q_len, key_len, head_dim, block_size,
                         window, causal, include_cls, q_off, scale);
  p.o = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  if (const int err = check(p)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_width(p.dim_pad, kFwdWidest)) {
    case 64: return launch_fwd<64>(p, s);
    case 128: return launch_fwd<128>(p, s);
    default: return launch_fwd<256>(p, s);
  }
}

// The generic backward: dq (q's strides), dk, dv (k's), and with cls_k
// not null dcls_k, dcls_v [B, H, block, Dh]; delta [B, H, q_len] fp32
// scratch. Four launches on the stream: delta, dq, dk/dv.
extern "C" int svt_swa_generic_bwd(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* lse, const void* out, const void* dout, const void* cls_k,
    const void* cls_v, const void* cls_len, void* dq, void* dk, void* dv,
    void* dcls_k, void* dcls_v, void* delta, int q_row, int q_head,
    int q_batch, int k_row, int k_head, int k_batch, int batch,
    int num_heads, int q_len, int key_len, int head_dim, int block_size,
    int window, int causal, int include_cls, int q_off, float scale,
    void* stream) {
  Params p = make_params(q, k, v, lengths, cls_k, cls_v, cls_len, q_row,
                         q_head, q_batch, k_row, k_head, k_batch, batch,
                         num_heads, q_len, key_len, head_dim, block_size,
                         window, causal, include_cls, q_off, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.out = static_cast<cbf16p>(out);
  p.dout = static_cast<cbf16p>(dout);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dcls_k = static_cast<bf16*>(dcls_k);
  p.dcls_v = static_cast<bf16*>(dcls_v);
  p.delta = static_cast<float*>(delta);
  if (const int err = check(p)) return err;
  if (p.cls_k && !(p.dcls_k && p.dcls_v))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)p.batch * p.heads * p.q_len;
  swa_generic_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p);
  int err;
  switch (chunk_width(p.dim_pad, kFwdWidest)) {
    case 64: err = launch_dq<64>(p, s); break;
    case 128: err = launch_dq<128>(p, s); break;
    default: err = launch_dq<256>(p, s); break;
  }
  if (err) return err;
  switch (chunk_width(p.dim_pad, kDkvWidest)) {
    case 64: return launch_dkv<64>(p, s);
    default: return launch_dkv<128>(p, s);
  }
}
