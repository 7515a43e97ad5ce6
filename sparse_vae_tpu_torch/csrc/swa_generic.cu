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
// What bounds it. Count each input read once and each output written
// once. At the slice's shape, the Dh = 256 Transformer-VAE of bench.py
// --heads 2 at [8, 12800, 2 * 256], the forward reads q, k, v and writes
// out: 4 x 104.9 MB = 0.42 GB, against ~67 GFLOP of band + [CLS]
// products (65.5 M attended pairs a head x 256 dims x 4): ~160 FLOP per
// byte, under the H100's bf16 ridge of ~295, so both directions are
// bound by bytes (0.125 ms forward, 0.251 backward at 3.35 TB/s). What
// holds a kernel above that is latency and issue: each 64-key step is a
// chain of product, wait, softmax, product, and warpgroups that meet at
// a barrier every stage leave the tensor cores idle during each other's
// softmax; at Dh 32 a step is only two k16 slices of S, so the per-step
// and per-stage overheads are the whole cost and occupancy (two CTAs an
// SM) hides them best.
//
// Design at Dh <= 256 (the Hopper kernels, `*_wg_kernel`): the tiles and
// products of K1/K2 (csrc/swa_fwd.cu, csrc/swa_bwd.cu), generalised to
// any padded width (Tile<kH>). Dh is padded with zeros to Dp, a multiple
// of 16; a tile of R rows is ceil(Dp / 64) blocks of [R rows x 64 dims],
// 128-byte rows in the 128-byte swizzle (16-byte chunk c of row r at
// c ^ (r & 7)), or at Dp <= 32 (kH 0, the narrow format) one block of
// [R rows x 32 dims], 64-byte rows in the 64-byte swizzle. Every product
// is a wgmma (bf16 in, fp32 accumulate): S-like products read both
// operands from shared memory, K-major, over Dp / 16 k16 slices; the
// value and gradient products take P or dS from registers (the
// accumulator layout packed to bf16) and read V, K, Q or dO MN-major, one
// m64n64k16 (narrow: m64n32k16) per block of output columns (columns
// past Dh are computed and not stored). A CTA is two consumer
// warpgroups (256 threads); tiles stream through a ring of two stages.
// Where Dh fills whole 64-dim blocks (Dh 64, 128, 192, 256), the
// forward's K and V stages, and from Dh 128 dq's, come by TMA: a
// producer (one warp; from Dh 192, and in dq, a warpgroup that gives its
// registers to the consumers by setmaxnreg: 24 against 240, since a
// ninth warp alone would cap every thread at 168) issues the boxes, each
// stage's arrival counted on an mbarrier and its slot released on
// another, so the consumer warpgroups never meet at a barrier and one's
// softmax runs beside the other's products. Elsewhere
// every thread's cp.async fills the ring (ring_walk), with the zero
// padding, and the next stage's copies are in flight beside this one's
// products.
//   forward: one CTA per 128-query tile, the band's unit (blocks are
//     multiples of 128), each warpgroup owning 64 rows; Q resident; K and
//     V in stages of 128 keys (Dp <= 128) or 64: S = Q K^T in 64-key
//     steps (32 at kH 1), the online softmax in registers (mask only
//     where a warpgroup-uniform test says a key may be invalid; O
//     rescaled only where some row's max moved), O += bf16(P) V.
//   dq: the same shape with Q and dO resident and delta = rowsum(do *
//     out) computed while they arrive (written for dk/dv): S, dP = dO V^T,
//     dQ += dS K; stages of 128, 64 or (Dp 256) 32 keys, steps of 64
//     keys at kH 2 and 32 elsewhere (S and dP sit side by side).
//   dk/dv: K and V resident, over 64-query stages of Q, dO, lse and
//     delta, in 64-query steps (32 at kH 0 and 1). From
//     kH 1 a CTA holds 64 keys and its warpgroups split the work:
//     warpgroup 0 computes S^T = K Q^T, P, and owns dV += P^T dO;
//     warpgroup 1 computes dP^T = V dO^T, takes P (fp32) from warpgroup
//     0 through shared memory behind a named barrier, and owns dK +=
//     dS^T Q: each product is computed once, and each accumulator is
//     64 x Dp fp32 (128 registers a thread at Dh 256). In the narrow
//     format a CTA holds 128 keys and each warpgroup computes all four
//     products for its 64, as K2 does (the accumulators are 16 registers
//     each). The [CLS] column is split as K2 splits it: key block 0
//     (include_cls) is attended by every query block past the band's
//     left extent, and the broadcast block by every local one; CTAs of
//     cls_chunk query blocks (ops/swa_kernel.py::CLS_CHUNK) each write an
//     fp32 partial, and key block 0's band CTAs write theirs to the same
//     scratch. The [CLS] CTAs come first in the grid, the longest first.
//   reduce: sums key block 0's band part and the partials in a fixed
//     order and rounds once into dk, dv (or dcls_k, dcls_v).
// On the dense causal route (a causal band over every block) the
// forward and dq grids run the last query tiles, the longest rows,
// first; the dk/dv grid runs the first key tiles, the longest columns,
// first.
// Registers and shared memory (dynamic; the build's ptxas lines give
// registers and spills, none at Dh <= 256): the forward 41,984 bytes at
// kH 0, 82,944 at kH 1 (two CTAs an SM), 164,864, 148,480 and 197,632 at
// kH 2-4; dq 50,176, 99,328 and 197,632 from kH 2 (+ 512 static); dk/dv
// 35,840, 68,608 and up to 216,064 at kH 4.
//
// Design at 256 < Dh <= 512 (the first version's mma.sync kernels, kept
// for those heads: `swa_generic_fwd_kernel`, `_delta_kernel`,
// `_dq_kernel`, `_dkv_kernel`, no `_wg`): 128 threads (4 warps) a CTA,
// each warp owning 16 rows of a 64-row tile; mma.sync m16n8k16 over
// single-buffered cp.async tiles, rows Dp + 8 elements apart (ldmatrix
// reads them without bank conflicts); a block of r * 128 keys is walked
// in sub-tiles.
//   forward: one CTA per (64-query tile, column chunk of out, head, batch
//     row). Q stays in shared memory; K (all Dp dims) and V (the chunk's
//     dims) come in 64-key sub-tiles: S = Q K^T, mask, online softmax,
//     O += bf16(P) V with P passed from the accumulator registers as the
//     A operand. The output accumulator is 16 x kDV fp32 a warp, so a
//     head wider than 256 is cut into column chunks of 256, each CTA
//     recomputing S (Dh 512: two chunks); chunk 0 writes lse.
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
//   Shared memory: forward Q + K at Dp and V at kDV, 64 rows each,
//   166,912 bytes at Dp 512; dq and dk/dv 192 rows at Dp (+ 256 bytes of
//   lse and delta), 199,936 bytes at Dp 512.
// Every output element has one owner and every sum one order: no atomics,
// and a second call is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
  float *lse, *delta, *scratch;
  int q_row, q_head, q_batch, k_row, k_head, k_batch;
  int batch, heads, q_len, key_len, dim, dim_pad, block, window, causal,
      include_cls, q_off, cls_chunk, cls_chunks;
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

// ---- The Hopper kernels (Dh <= 256) ----------------------------------

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kTileRows = 128;   // query rows of a forward or dq CTA
constexpr int kKeyRows = 64;     // key rows of a warpgroup in dk/dv
constexpr int kQStep = 64;       // queries per dk/dv stage
// Named barriers 1 and 2: P of a dk/dv stage's first and second step is
// in shared memory; 3: the forward's two consumer warpgroups (without its
// producer warp).
constexpr int kPBar = 1;
constexpr int kConsumers = 3;

// 64-byte swizzle descriptor of a K-major (or, for an MN-major operand of
// n32, its k-rows) tile of 64-byte rows, 8-row groups 512 bytes apart: the
// narrow format's. The tile starts 512-aligned; a k16 step within a row
// adds 32 bytes.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A in registers (the mma.sync A
// layout) and B MN-major: its 16 k-rows of 64 bytes in the 64-byte
// swizzle.
__device__ __forceinline__ void wgmma_rs_n32_mn(float (&d)[16],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SVT_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : SVT_ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The tile format at kH. kH 1..4 (Dp up to 64 kH): kH blocks of 64 dims,
// 128-byte rows in the 128-byte swizzle (16-byte chunk c of row r at
// c ^ (r % 8)), one n64 accumulator block (32 floats a thread) per 64
// output columns. kH 0 (Dp up to 32, the narrow format): one block of 32
// dims, 64-byte rows in the 64-byte swizzle (chunk c at c ^ (r / 2 % 4)),
// an n32 accumulator (16 floats a thread): half the shared memory and the
// registers of kH 1, and no products over columns past Dh's 32.
template <int kH>
struct Tile {
  static_assert(kH >= 0 && kH <= 4, "Dp up to 256");
  static constexpr bool kNarrow = kH == 0;
  static constexpr int kRowB = kNarrow ? 64 : 128;  // bytes a block row
  static constexpr int kBlocks = kNarrow ? 1 : kH;  // column blocks
  static constexpr int kChunks = kRowB / 16;        // 16-byte chunks a row
  static constexpr int kCols = kRowB / 2;           // dims a block
  static constexpr int kAcc = kCols / 2;  // accumulator floats a thread
  __device__ static __forceinline__ uint64_t desc(const void* p) {
    if constexpr (kNarrow)
      return desc_sw64(p);
    else
      return svt::desc_sw128(p);
  }
  // Where chunk c of row r lies within its row.
  __device__ static __forceinline__ int swizzle(int r, int c) {
    return kNarrow ? c ^ ((r >> 1) & 3) : c ^ (r & 7);
  }
};

// Stage sizes and shared memory of the Hopper kernels at kH. Each pass
// streams its tiles through a ring of two stages; at kH 0 and 1 two CTAs
// share an SM (128 registers a thread), above one.
template <int kH>
struct Shape {
  using T = Tile<kH>;
  static constexpr int kQHalf = kTileRows * T::kRowB;  // a block of Q
  // Keys per forward stage and per S step: at kH 1 the steps are 32 keys,
  // so that S fits beside O.
  static constexpr int kFwdKeys = kH <= 2 ? 128 : 64;
  static constexpr int kFwdStep = kH == 1 ? 32 : 64;
  // dq likewise (S and dP side by side).
  static constexpr int kDqKeys = kH <= 2 ? 128 : kH == 3 ? 64 : 32;
  static constexpr int kDqStep = kH == 2 ? 64 : 32;
  // dk/dv: kCtaKeys keys a CTA, kKvStep queries a step of a stage. kSplit: the warpgroups share 64 keys, one computing P and dV,
  // the other dS and dK (each accumulator 64 x Dp); otherwise (the narrow
  // format) each owns 64 of 128 keys and computes both, as K2 does, with
  // no P passed between them.
  static constexpr bool kSplit = kH != 0;
  static constexpr int kCtaKeys = kSplit ? kKeyRows : 2 * kKeyRows;
  static constexpr int kKvStep = kH <= 1 ? 32 : 64;
  static constexpr int kStages = 2;
  // The forward: Q, then the [K | V] stages.
  static constexpr int kFwdStage = 2 * T::kBlocks * kFwdKeys * T::kRowB;
  static constexpr int kFwdSmem =
      svt::kSwizzleAlign + T::kBlocks * kQHalf + kStages * kFwdStage;
  // dq: Q, dO, then the [K | V] stages.
  static constexpr int kDqStage = 2 * T::kBlocks * kDqKeys * T::kRowB;
  static constexpr int kDqSmem =
      svt::kSwizzleAlign + 2 * T::kBlocks * kQHalf + kStages * kDqStage;
  // dk/dv: K, V, the [Q | dO | lse, delta] stages, P (kSplit).
  static constexpr int kKvHalf = kCtaKeys * T::kRowB;  // a block of K, V
  static constexpr int kStepHalf = kQStep * T::kRowB;  // of Q, dO
  static constexpr int kQStage =
      2 * T::kBlocks * kStepHalf + svt::kSwizzleAlign;
  static constexpr int kKvSmem =
      svt::kSwizzleAlign + 2 * T::kBlocks * kKvHalf + kStages * kQStage +
      (kSplit ? kKeyRows * kQStep * 4 : 0);
  static_assert(kFwdSmem <= 232448 && kDqSmem + kTileRows * 4 <= 232448 &&
                    kKvSmem <= 232448,
                "within the 227 KB a block may use");
  // CTAs per SM: two where the accumulators are 32 registers a thread or
  // fewer.
  static constexpr int kMinBlocks = kH <= 1 ? 2 : 1;
  // Two CTAs of an SM's 233,472 bytes, each less the 1,024 reserved.
  static constexpr int kTwoCtas = 233472 / 2 - 1024;
  static_assert(kMinBlocks == 1 ||
                    (kFwdSmem <= kTwoCtas && kKvSmem <= kTwoCtas &&
                     kDqSmem + kTileRows * 4 <= kTwoCtas),
                "two CTAs per SM");
};

// kRows rows of the head's dims (rows `stride` elements apart from src)
// into a tile of kRows-row blocks at dst in the format of Tile<kH>; this
// thread's share of the CTA's copies. Chunks from dim up to dim_pad are
// zero (the K-major products read them); chunks past dim_pad are never
// written (only output columns that are not stored read them).
template <int kRows, int kH>
__device__ __forceinline__ void load_swz(unsigned char* dst, const bf16* src,
                                         size_t stride, int dim,
                                         int dim_pad) {
  using T = Tile<kH>;
  constexpr int kChunks = T::kBlocks * T::kChunks;  // a row at most
  static_assert(kRows * kChunks % kWgThreads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (8 * c >= dim_pad) continue;
    unsigned char* d = dst + (c / T::kChunks) * (kRows * T::kRowB) +
                       r * T::kRowB +
                       (T::swizzle(r, c % T::kChunks) << 4);
    if (8 * c < dim)
      cp_async16(d, src + r * stride + 8 * c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Walks a CTA's live stages (next(j): the first live stage at or after
// j; `stages` past the last) through a ring of kStages buffers of
// `stage_bytes` at `ring`: load(j, buffer) issues stage j's cp.async
// copies, kStages - 1 live stages ahead of compute(j, buffer), which must
// finish its products. Copies issued before the call (a resident tile)
// complete with the first stage's.
template <int kStages, typename Next, typename Load, typename Compute>
__device__ __forceinline__ void ring_walk(int stages, unsigned char* ring,
                                          int stage_bytes, Next next,
                                          Load load, Compute compute) {
  int ld = next(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld < stages) {
      load(ld, ring + s * stage_bytes);
      ld = next(ld + 1);
    }
    cp_async_commit();
  }
  int slot = 0;
  int ld_slot = kStages - 1;
  for (int cur = next(0); cur < stages; cur = next(cur + 1)) {
    if (ld < stages) {
      load(ld, ring + ld_slot * stage_bytes);
      ld = next(ld + 1);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // stage cur has landed
    svt::fence_proxy_async();
    __syncthreads();
    compute(cur, ring + slot * stage_bytes);
    __syncthreads();  // every warp is done with this buffer
    slot = slot + 1 == kStages ? 0 : slot + 1;
    ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
  }
  cp_async_wait<0>();
}

// x[64 x N] = A[64 rows at a] B[N rows at b]^T over dim_pad dims, both
// K-major tiles of Tile<kH>, their blocks a_half and b_half bytes apart.
template <int kH, int N>
__device__ __forceinline__ void product_k(float (&x)[N / 2],
                                          const unsigned char* a, int a_half,
                                          const unsigned char* b, int b_half,
                                          int dim_pad) {
  using T = Tile<kH>;
  for (int k16 = 0; k16 < dim_pad / 16; ++k16) {
    const int hf = k16 * 16 / T::kCols;
    const int col = 32 * k16 % T::kRowB;
    const uint64_t da = T::desc(a + hf * a_half + col);
    const uint64_t db = T::desc(b + hf * b_half + col);
    if constexpr (N == 32)
      svt::wgmma_ss_n32(x, da, db, k16);
    else
      svt::wgmma_ss_n64(x, da, db, k16);
  }
}

// The accumulator of a warpgroup's 64 rows and Tile<kH>'s columns:
// acc[hf][4n + 2i + e] is row 16 warp + gq + 8i, column kCols hf + 8n +
// 2tq + e.
template <int kH>
using Acc = float[Tile<kH>::kBlocks][Tile<kH>::kAcc];

// acc += bf16(w)[64 x N] M[N rows at t], w in the accumulator layout of
// product_k (w[4n + 2i + e]: row 16 warp + gq + 8i, column 8n + 2tq + e),
// which packs into the A registers by k16 step; M MN-major in Tile<kH>'s
// format, its blocks t_half bytes apart, one n64 (n32) product a block.
template <int kH, int N>
__device__ __forceinline__ void product_mn(Acc<kH>& acc,
                                           const float (&w)[N / 2],
                                           const unsigned char* t,
                                           int t_half) {
  using T = Tile<kH>;
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    const uint32_t a[4] = {packf(w[8 * kq], w[8 * kq + 1]),
                           packf(w[8 * kq + 2], w[8 * kq + 3]),
                           packf(w[8 * kq + 4], w[8 * kq + 5]),
                           packf(w[8 * kq + 6], w[8 * kq + 7])};
#pragma unroll
    for (int hf = 0; hf < T::kBlocks; ++hf) {
      const uint64_t db = T::desc(t + hf * t_half + 16 * kq * T::kRowB);
      if constexpr (T::kNarrow)
        wgmma_rs_n32_mn(acc[hf], a, db);
      else
        svt::wgmma_rs_n64_mn(acc[hf], a, db);
    }
  }
}

// The helpers below take an accumulator as float[B][A]: B blocks of 2A
// columns (an Acc<kH>).
template <int B, int A>
__device__ __forceinline__ void zero_acc(float (&acc)[B][A]) {
#pragma unroll
  for (int hf = 0; hf < B; ++hf)
#pragma unroll
    for (int i = 0; i < A; ++i) acc[hf][i] = 0.f;
}

template <int B, int A>
__device__ __forceinline__ void fence_all(float (&acc)[B][A]) {
#pragma unroll
  for (int hf = 0; hf < B; ++hf) svt::fence_acc(acc[hf]);
}

// A warp's 16 rows of a warpgroup accumulator (row gq + 8i), times
// inv[i], the columns below dim, in bf16 to the rows at `rows`, `stride`
// elements apart.
template <int B, int A>
__device__ __forceinline__ void store_acc(const float (&acc)[B][A],
                                          const float (&inv)[2], bf16* rows,
                                          size_t stride, int dim) {
  const int lane = threadIdx.x & 31;
  bf16* lo = rows + (size_t)(lane >> 2) * stride + 2 * (lane & 3);
  bf16* hi = lo + 8 * stride;
#pragma unroll
  for (int hf = 0; hf < B; ++hf)
#pragma unroll
    for (int n = 0; n < A / 4; ++n) {
      const int c = 2 * A * hf + 8 * n;
      if (c >= dim) break;
      *reinterpret_cast<uint32_t*>(lo + c) =
          packf(acc[hf][4 * n] * inv[0], acc[hf][4 * n + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(hi + c) =
          packf(acc[hf][4 * n + 2] * inv[1], acc[hf][4 * n + 3] * inv[1]);
    }
}

// The same in fp32, to rows `dim` floats apart.
template <int B, int A>
__device__ __forceinline__ void store_acc_f32(const float (&acc)[B][A],
                                              float* rows, int dim) {
  const int lane = threadIdx.x & 31;
  float* lo = rows + (size_t)(lane >> 2) * dim + 2 * (lane & 3);
  float* hi = lo + 8 * (size_t)dim;
#pragma unroll
  for (int hf = 0; hf < B; ++hf)
#pragma unroll
    for (int n = 0; n < A / 4; ++n) {
      const int c = 2 * A * hf + 8 * n;
      if (c >= dim) break;
      *reinterpret_cast<float2*>(lo + c) =
          make_float2(acc[hf][4 * n], acc[hf][4 * n + 1]);
      *reinterpret_cast<float2*>(hi + c) =
          make_float2(acc[hf][4 * n + 2], acc[hf][4 * n + 3]);
    }
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A 128-query tile of the forward or dq grid, ordered as the grid runs
// it: (head, row) fastest, then the tile; under a causal band the last
// tiles (the longest rows on the dense causal route) first.
struct QueryTile {
  int h, b, r0, qk0;
  __device__ __forceinline__ explicit QueryTile(const Params& p) {
    const int hb = blockIdx.x % (p.heads * p.batch);
    int t = blockIdx.x / (p.heads * p.batch);
    if (p.causal) t = p.q_len / kTileRows - 1 - t;
    h = hb % p.heads;
    b = hb / p.heads;
    r0 = t * kTileRows;               // local row of the first query
    qk0 = r0 + p.q_off * p.block;     // its position on the key axis
  }
};

// One stage of keys of a query tile's walk: stage j is sub-tile j % per
// (kN keys each) of segment j / per. Its K and V rows, their stride, the
// key-axis position of its first key, the valid length and whether the
// causal triangle applies.
struct KeyStage {
  const bf16 *k, *v;
  size_t stride;
  int key0, klen;
  bool causal;
  __device__ __forceinline__ KeyStage(const Params& p, const Segments& seg,
                                      int j, int per, int kn, int b, int h,
                                      int length, int cls_len) {
    const int kb = seg.block(j / per);
    const int sub = (j % per) * kn;
    if (kb < 0) {  // the broadcast block: keys 0 .. cls_len - 1
      const size_t at = cls_at(p, b, h, sub);
      k = p.cls_k + at;
      v = p.cls_v + at;
      stride = p.dim;
      key0 = sub;
      klen = cls_len;
      causal = false;
    } else {
      const size_t at = k_at(p, b, h, kb * p.block + sub);
      k = p.k + at;
      v = p.v + at;
      stride = p.k_row;
      key0 = kb * p.block + sub;
      klen = length;
      causal = p.causal != 0;
    }
  }
  // Some key of the stage is valid for some row of the tile at qk0.
  __device__ __forceinline__ bool live(int qk0) const {
    return key0 < klen && !(causal && key0 > qk0 + kTileRows - 1);
  }
};

// The forward's threads: the two consumer warpgroups and, with TMA, a
// producer: one warp, or from kH 3 a warpgroup that hands its registers
// to the consumers (a CTA's registers are allocated by four warps, so a
// ninth warp caps every thread at 168, too few for O at kH 3 and 4).
template <int kH>
constexpr bool kProducerWarpgroup = kH >= 3;
template <int kH, bool kTma>
constexpr int fwd_threads() {
  return kTma ? kWgThreads + (kProducerWarpgroup<kH> ? 128 : 32)
              : kWgThreads;
}
constexpr int kProducerRegs = 24;   // a producer warpgroup's registers
constexpr int kConsumerRegs = 240;  // and each consumer's: 64,512 in all

// The TMA producer of a query tile's K and V stages (the forward's and
// dq's): stage j's first key as (column, row) of the maps, k and v as
// [rows, k_row] (head h's columns from h * k_head % k_row), the broadcast
// block as [B H block, Dh]; one box of [kN rows x 64 dims] a block into
// slot n % kStages of the ring once its previous stage is released on
// empty[slot], counted on full[slot].
template <int kBlocks, int kN, int kStages, typename Next>
__device__ __forceinline__ void produce_kv(
    const Params& p, const Segments& seg, int b, int h, int stages,
    Next next, unsigned char* ring, int stage_bytes, uint64_t* full,
    uint64_t* empty, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tck, const CUtensorMap* tcv) {
  constexpr int kNHalf = kN * 128;
  const int per = p.block / kN;
  const size_t base = (size_t)b * p.k_batch + (size_t)h * p.k_head;
  const int col = (int)(base % p.k_row);
  const int row0 = (int)(base / p.k_row);
  int n = 0;
  for (int j = next(0); j < stages; j = next(j + 1), ++n) {
    const int slot = n % kStages;
    if (n >= kStages) svt::mbar_wait(empty + slot, (n / kStages - 1) & 1);
    const int kb = seg.block(j / per);
    const int sub = (j % per) * kN;
    const bool sep = kb < 0;
    const int c = sep ? 0 : col;
    const int rw =
        sep ? (b * p.heads + h) * p.block + sub : row0 + kb * p.block + sub;
    unsigned char* dst = ring + slot * stage_bytes;
    svt::mbar_expect_tx(full + slot, stage_bytes);
#pragma unroll
    for (int hf = 0; hf < kBlocks; ++hf) {
      svt::tma_load(dst + hf * kNHalf, sep ? tck : tk, full + slot,
                    c + 64 * hf, rw);
      svt::tma_load(dst + (kBlocks + hf) * kNHalf, sep ? tcv : tv,
                    full + slot, c + 64 * hf, rw);
    }
  }
}

// The consumers' side: stage j computed from slot n % kStages once it has
// landed, then released.
template <int kStages, typename Next, typename Compute>
__device__ __forceinline__ void consume_kv(int stages, Next next,
                                           unsigned char* ring,
                                           int stage_bytes, uint64_t* full,
                                           uint64_t* empty,
                                           Compute compute) {
  int n = 0;
  for (int j = next(0); j < stages; j = next(j + 1), ++n) {
    const int slot = n % kStages;
    svt::mbar_wait(full + slot, (n / kStages) & 1);
    compute(j, ring + slot * stage_bytes);
    svt::mbar_arrive(empty + slot);
  }
}

// The tensor maps of a pass's K and V stages (kTma): k and v as [rows,
// k_row] bf16 matrices (head-major: a row per (b, h, key); packed: a row
// per (b, key)), cls_k, cls_v as [B H block, Dh]; boxes of 64 dims x
// box_rows keys. The encoder is a driver call, which fails without the
// device's context current on the calling thread; a thread that has made
// no runtime call yet (autograd's, when a backward is its first work)
// may not have it, so on failure the context is bound and the maps made
// again.
bool kv_maps(const Params& p, int box_rows, CUtensorMap* tk,
             CUtensorMap* tv, CUtensorMap* tck, CUtensorMap* tcv) {
  const long long rows = (long long)p.batch * p.k_batch / p.k_row;
  const int cls_rows = p.batch * p.heads * p.block;
  if (rows > 0x7fffffffLL) return false;
  auto make = [&] {
    return svt::make_map(tk, p.k, p.k_row, (int)rows, box_rows) &&
           svt::make_map(tv, p.v, p.k_row, (int)rows, box_rows) &&
           (!p.cls_k ||
            (svt::make_map(tck, p.cls_k, p.dim, cls_rows, box_rows) &&
             svt::make_map(tcv, p.cls_v, p.dim, cls_rows, box_rows)));
  };
  if (make()) return true;
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess &&
         cudaSetDevice(device) == cudaSuccess && make();
}

// kTma (Dh a multiple of 64): the K and V stages come by TMA. The
// producer's first thread issues one box of [kN rows x 64 dims] a block
// through the tensor maps tk, tv (cls_k, cls_v: tck, tcv) into the ring,
// each stage's arrival counted on full[slot], and reuses a slot once
// both warpgroups have marked it done on empty[slot]; the warpgroups wait
// only on the stages they compute, so they run apart and one's softmax
// overlaps the other's products. Otherwise every thread's cp.async fills
// the ring (ring_walk).
template <int kH, bool kTma>
__global__ void __launch_bounds__(fwd_threads<kH, kTma>(),
                                  Shape<kH>::kMinBlocks)
swa_generic_fwd_wg_kernel(const __grid_constant__ Params p,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tck,
                          const __grid_constant__ CUtensorMap tcv) {
  using S = Shape<kH>;
  using T = Tile<kH>;
  constexpr int kN = S::kFwdKeys;
  constexpr int kSub = S::kFwdStep;  // keys per S step
  constexpr int kNHalf = kN * T::kRowB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = svt::align_smem(smem_raw);
  unsigned char* ring = qs + T::kBlocks * S::kQHalf;  // [kStages][K | V]
  __shared__ uint64_t full[S::kStages], empty[S::kStages];  // kTma

  const QueryTile tile(p);
  const int b = tile.b, h = tile.h, qk0 = tile.qk0;
  const int length = p.lengths[b];
  const int cls_len = p.cls_k ? p.cls_len[b] : 0;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const Segments seg(p, qk0 / p.block);
  const int per = p.block / kN;
  const int stages = seg.count * per;
  auto stage = [&](int j) {
    return KeyStage(p, seg, j, per, kN, b, h, length, cls_len);
  };
  auto next = [&](int j) {
    while (j < stages && !stage(j).live(qk0)) ++j;
    return j;
  };

  if (!kTma || threadIdx.x < kWgThreads)  // not the producer
    load_swz<kTileRows, kH>(qs, p.q + q_at(p, b, h, tile.r0), p.q_row,
                            p.dim, p.dim_pad);

  // This thread's rows of the tile: r and r + 8.
  const int r = 64 * wg + 16 * warp + (lane >> 2);
  const int row[2] = {qk0 + r, qk0 + r + 8};  // key-axis positions
  const int wg_first = qk0 + 64 * wg;         // the warpgroup's first row
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = qs + wg * 64 * T::kRowB;
  Acc<kH> o;
  zero_acc(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // running sum

  // Stage j, its K and V tiles at ks: this warpgroup's steps.
  auto compute = [&](int j, const unsigned char* ks) {
    const unsigned char* vs = ks + T::kBlocks * kNHalf;
    const KeyStage st = stage(j);
    const int nkeys = min(kN, st.klen - st.key0);
#pragma unroll 1
    for (int c0 = 0; c0 < nkeys; c0 += kSub) {
      const int key0 = st.key0 + c0;
      // Warpgroup-uniform: every key of the step lies after every row.
      if (st.causal && key0 > wg_first + 63) break;
      float s[kSub / 2];
      svt::wgmma_fence();
      product_k<kH, kSub>(s, qa, S::kQHalf, ks + c0 * T::kRowB, kNHalf,
                          p.dim_pad);  // S = Q K^T
      svt::wgmma_commit();
      // This product, and the previous step's O product, are done.
      svt::wgmma_wait<0>();
      svt::fence_acc(s);
      fence_all(o);
      // Warpgroup-uniform: a step with every key valid and at or
      // before every row needs no mask; the two forms are separate
      // code.
      const bool edge = key0 + kSub > st.klen ||
                        (st.causal && key0 + kSub - 1 > wg_first);
      float mx[2] = {-INFINITY, -INFINITY};
      auto row_max = [&](auto masked) {
#pragma unroll
        for (int k = 0; k < kSub / 2; ++k) {
          const int i = (k >> 1) & 1;
          if constexpr (decltype(masked)::value) {
            const int key = key0 + 8 * (k >> 2) + 2 * tq + (k & 1);
            const bool ok =
                key < st.klen && (!st.causal || key <= row[i]);
            s[k] = ok ? s[k] : -INFINITY;
          }
          mx[i] = fmaxf(mx[i], s[k]);
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
        // A row with no valid key so far keeps max -inf: ex2(-inf) =
        // 0 then gives p = 0 and leaves the (zero) sums as they are.
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2(m[i] - m_use[i]);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kSub / 2; ++k) {
        const int i = (k >> 1) & 1;
        s[k] = ex2(fmaf(s[k], sl2, -m_use[i]));
        sum[i] += s[k];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
      // Rescale O where some row's max moved (a factor of 1 is exact,
      // so skipping it changes no bit).
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int hf = 0; hf < T::kBlocks; ++hf)
#pragma unroll
          for (int k = 0; k < T::kAcc; ++k)
            o[hf][k] *= alpha[(k >> 1) & 1];
      }
      svt::wgmma_fence();
      product_mn<kH, kSub>(o, s, vs + c0 * T::kRowB,
                           kNHalf);  // O += P V
      svt::wgmma_commit();  // in flight beside the next step's S
    }
    svt::wgmma_wait<0>();
    fence_all(o);
  };

  if constexpr (kTma) {
    if (threadIdx.x == kWgThreads) {
      for (int s = 0; s < S::kStages; ++s) {
        svt::mbar_init(full + s, 1);
        svt::mbar_init(empty + s, kWgThreads);
      }
      svt::mbar_fence_init();
    }
    cp_async_commit();
    __syncthreads();  // the barriers are set up
    if (threadIdx.x >= kWgThreads) {  // the producer
      if constexpr (kProducerWarpgroup<kH>)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
            kProducerRegs));
      if (threadIdx.x == kWgThreads)
        produce_kv<T::kBlocks, kN, S::kStages>(
            p, seg, b, h, stages, next, ring, S::kFwdStage, full, empty,
            &tk, &tv, &tck, &tcv);
      return;
    }
    if constexpr (kProducerWarpgroup<kH>)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          kConsumerRegs));
    cp_async_wait<0>();  // Q
    svt::fence_proxy_async();
    bar_sync(kConsumers, kWgThreads);
    consume_kv<S::kStages>(stages, next, ring, S::kFwdStage, full, empty,
                           compute);
  } else {
    ring_walk<S::kStages>(
        stages, ring, S::kFwdStage, next,
        [&](int j, unsigned char* dst) {
          const KeyStage st = stage(j);
          load_swz<kN, kH>(dst, st.k, st.stride, p.dim, p.dim_pad);
          load_swz<kN, kH>(dst + T::kBlocks * kNHalf, st.v, st.stride,
                           p.dim, p.dim_pad);
        },
        compute);
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  store_acc(o, inv, p.o + q_at(p, b, h, tile.r0 + 64 * wg + 16 * warp),
            p.q_row, p.dim);
  if (tq == 0) {
    const size_t stats =
        ((size_t)b * p.heads + h) * (size_t)p.q_len + tile.r0 + r;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      p.lse[stats + 8 * i] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
  }
}

// dq, and delta = rowsum(do * out) for the tile's rows (written for the
// dk/dv pass). kTma (Dh a multiple of 64, kH >= 2): the K and V stages
// come by TMA from a producer warpgroup, as in the forward at kH 4.
template <int kH, bool kTma>
__global__ void __launch_bounds__(kTma ? kWgThreads + 128 : kWgThreads,
                                  Shape<kH>::kMinBlocks)
swa_generic_dq_wg_kernel(const __grid_constant__ Params p,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tck,
                         const __grid_constant__ CUtensorMap tcv) {
  static_assert(!kTma || kH >= 2, "a producer warpgroup beside two");
  using S = Shape<kH>;
  using T = Tile<kH>;
  constexpr int kN = S::kDqKeys;
  constexpr int kSub = S::kDqStep;  // keys per S step
  constexpr int kNHalf = kN * T::kRowB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = svt::align_smem(smem_raw);
  unsigned char* dos = qs + T::kBlocks * S::kQHalf;
  unsigned char* ring = dos + T::kBlocks * S::kQHalf;  // [kDqStages][K | V]
  __shared__ float deltas[kTileRows];
  __shared__ uint64_t full[S::kStages], empty[S::kStages];  // kTma

  const QueryTile tile(p);
  const int b = tile.b, h = tile.h, qk0 = tile.qk0;
  const int length = p.lengths[b];
  const int cls_len = p.cls_k ? p.cls_len[b] : 0;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const size_t stats = ((size_t)b * p.heads + h) * (size_t)p.q_len + tile.r0;
  const Segments seg(p, qk0 / p.block);
  const int per = p.block / kN;
  const int stages = seg.count * per;
  auto stage = [&](int j) {
    return KeyStage(p, seg, j, per, kN, b, h, length, cls_len);
  };
  auto next = [&](int j) {
    while (j < stages && !stage(j).live(qk0)) ++j;
    return j;
  };
  const bool consumer = !kTma || threadIdx.x < kWgThreads;

  const size_t q0 = q_at(p, b, h, tile.r0);
  if (consumer) {
    load_swz<kTileRows, kH>(qs, p.q + q0, p.q_row, p.dim, p.dim_pad);
    load_swz<kTileRows, kH>(dos, p.dout + q0, p.q_row, p.dim, p.dim_pad);
  }

  if (consumer) {  // delta: two threads a row, 8-dim chunks in turn.
    const int rr = threadIdx.x >> 1;
    const bf16* x = p.out + q0 + (size_t)rr * p.q_row;
    const bf16* y = p.dout + q0 + (size_t)rr * p.q_row;
    float sum = 0.f;
    for (int c = 8 * (threadIdx.x & 1); c < p.dim; c += 16) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + c);
      const uint4 yv = *reinterpret_cast<const uint4*>(y + c);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xs[e]);
        const float2 c2 = __bfloat1622float2(ys[e]);
        sum = fmaf(a.x, c2.x, fmaf(a.y, c2.y, sum));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((threadIdx.x & 1) == 0) {
      deltas[rr] = sum;
      p.delta[stats + rr] = sum;
    }
  }

  const int r = 64 * wg + 16 * warp + (lane >> 2);
  const int row[2] = {qk0 + r, qk0 + r + 8};
  const int wg_first = qk0 + 64 * wg;
  const float lse[2] = {consumer ? p.lse_in[stats + r] : 0.f,
                        consumer ? p.lse_in[stats + r + 8] : 0.f};
  const float l2[2] = {lse[0] * kLog2e, lse[1] * kLog2e};
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = qs + wg * 64 * T::kRowB;
  const unsigned char* da = dos + wg * 64 * T::kRowB;
  Acc<kH> acc;
  zero_acc(acc);

  // Stage j, its K and V tiles at ks: this warpgroup's steps.
  auto compute = [&](int j, const unsigned char* ks) {
    const float del[2] = {deltas[r], deltas[r + 8]};
    const unsigned char* vs = ks + T::kBlocks * kNHalf;
    const KeyStage st = stage(j);
    const int nkeys = min(kN, st.klen - st.key0);
#pragma unroll 1
    for (int c0 = 0; c0 < nkeys; c0 += kSub) {
      const int key0 = st.key0 + c0;
      if (st.causal && key0 > wg_first + 63) break;
      float s[kSub / 2], dp[kSub / 2];
      svt::wgmma_fence();
      product_k<kH, kSub>(s, qa, S::kQHalf, ks + c0 * T::kRowB, kNHalf,
                      p.dim_pad);  // S = Q K^T
      product_k<kH, kSub>(dp, da, S::kQHalf, vs + c0 * T::kRowB, kNHalf,
                      p.dim_pad);  // dP = dO V^T
      svt::wgmma_commit();
      // These products, and the previous step's dQ product, are done.
      svt::wgmma_wait<0>();
      svt::fence_acc(s);
      svt::fence_acc(dp);
      fence_all(acc);
      const bool edge = key0 + kSub > st.klen ||
                        (st.causal && key0 + kSub - 1 > wg_first);
      auto ds_of = [&](auto masked) {
#pragma unroll
        for (int k = 0; k < kSub / 2; ++k) {
          const int i = (k >> 1) & 1;
          float pr = ex2(fmaf(s[k], sl2, -l2[i]));
          if constexpr (decltype(masked)::value) {
            const int key = key0 + 8 * (k >> 2) + 2 * tq + (k & 1);
            const bool ok = key < st.klen && lse[i] != -INFINITY &&
                            (!st.causal || key <= row[i]);
            pr = ok ? pr : 0.f;
          }
          s[k] = pr * (dp[k] - del[i]) * p.scale;  // dS
        }
      };
      if (edge)
        ds_of(std::true_type());
      else
        ds_of(std::false_type());
      svt::wgmma_fence();
      // dQ += dS K
      product_mn<kH, kSub>(acc, s, ks + c0 * T::kRowB, kNHalf);
      svt::wgmma_commit();  // in flight beside the next step's S and dP
    }
    svt::wgmma_wait<0>();
    fence_all(acc);
  };

  if constexpr (kTma) {
    if (threadIdx.x == kWgThreads) {
      for (int s = 0; s < S::kStages; ++s) {
        svt::mbar_init(full + s, 1);
        svt::mbar_init(empty + s, kWgThreads);
      }
      svt::mbar_fence_init();
    }
    cp_async_commit();
    __syncthreads();  // the barriers are set up
    if (!consumer) {  // the producer warpgroup
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
      if (threadIdx.x == kWgThreads)
        produce_kv<T::kBlocks, kN, S::kStages>(
            p, seg, b, h, stages, next, ring, S::kDqStage, full, empty,
            &tk, &tv, &tck, &tcv);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    cp_async_wait<0>();  // Q and dO
    svt::fence_proxy_async();
    bar_sync(kConsumers, kWgThreads);  // and deltas
    consume_kv<S::kStages>(stages, next, ring, S::kDqStage, full, empty,
                           compute);
  } else {
    ring_walk<S::kStages>(
        stages, ring, S::kDqStage, next,
        [&](int j, unsigned char* dst) {
          const KeyStage st = stage(j);
          load_swz<kN, kH>(dst, st.k, st.stride, p.dim, p.dim_pad);
          load_swz<kN, kH>(dst + T::kBlocks * kNHalf, st.v, st.stride,
                           p.dim, p.dim_pad);
        },
        compute);
  }
  const float one[2] = {1.f, 1.f};
  store_acc(acc, one, p.dq + q_at(p, b, h, tile.r0 + 64 * wg + 16 * warp),
            p.q_row, p.dim);
}

// fp32 [block, dim] part `part` of the [CLS] scratch
// [2 (dk, dv), B, H, parts, block, dim].
__device__ __forceinline__ float* scratch_part(const Params& p, int which,
                                               int b, int h, int parts,
                                               int part) {
  return p.scratch +
         ((((size_t)which * p.batch + b) * p.heads + h) * parts + part) *
             (size_t)p.block * p.dim;
}

// The [CLS] scratch's parts: key block 0's band part first (not for the
// broadcast block), then one partial per chunk of query blocks.
__device__ __forceinline__ int cls_parts(const Params& p) {
  return (p.cls_k ? 0 : 1) + p.cls_chunks;
}

// dk/dv and the [CLS] column. blockIdx.x < cls_chunks * (block / 64) * H
// * B: a [CLS] task, 64 keys of the [CLS] block (key block 0, or the
// broadcast block) against query blocks lo .. lo + cls_chunk of one chunk
// (an fp32 partial); past them a band task, key tile kt of (h, b) against
// its band's query blocks. (head, row) runs fastest; the band tasks'
// key tiles ascend (on the dense causal route the first tiles have the
// most queries).
template <int kH>
__global__ void __launch_bounds__(kWgThreads, Shape<kH>::kMinBlocks)
swa_generic_dkv_wg_kernel(const __grid_constant__ Params p) {
  using S = Shape<kH>;
  using T = Tile<kH>;
  constexpr int kHalf = S::kKvHalf;      // a block of K or V
  constexpr int kQHalf = S::kStepHalf;   // a block of Q or dO
  constexpr int kSub = S::kKvStep;       // queries per step
  constexpr int kKeys = S::kCtaKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = svt::align_smem(smem_raw);
  unsigned char* vs = ks + T::kBlocks * kHalf;
  // [stages][Q | dO | lse, delta]
  unsigned char* qbufs = vs + T::kBlocks * kHalf;
  float4* pbuf =
      reinterpret_cast<float4*>(qbufs + S::kStages * S::kQStage);

  const int hb_count = p.heads * p.batch;
  const int tiles = p.block / kKeys;  // key tiles a block
  const int cls_tasks = p.cls_chunks * tiles * hb_count;
  const bool cls = static_cast<int>(blockIdx.x) < cls_tasks;
  const int task = cls ? blockIdx.x : blockIdx.x - cls_tasks;
  const int hb = task % hb_count;
  const int h = hb % p.heads;
  const int b = hb / p.heads;
  const int rest = task / hb_count;
  const int chunk = rest / tiles;             // a [CLS] task's chunk
  const bool sep = cls && p.cls_k != nullptr;  // the broadcast block
  const int k0 = cls ? (rest % tiles) * kKeys : rest * kKeys;
  const int kb = k0 / p.block;
  const int klen = sep ? p.cls_len[b] : p.lengths[b];
  const bool causal = p.causal && !sep;
  const int num_qb = p.q_len / p.block;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int t128 = threadIdx.x & 127;
  const size_t stats = ((size_t)b * p.heads + h) * (size_t)p.q_len;

  // The local query blocks [lo, hi) this CTA visits: the band's (the
  // inverse band map, with q_off) or a [CLS] chunk's (past the band's
  // left extent, or every local block for the broadcast block). None
  // when no key of the tile is valid.
  const int left = p.causal ? p.window : (p.window + 1) / 2;
  int lo, hi;
  if (cls) {
    lo = (sep ? 0 : left) + chunk * p.cls_chunk;
    hi = min(num_qb, lo + p.cls_chunk);
  } else {
    lo = max(0, kb + left - p.window - p.q_off);
    hi = min(num_qb, kb + left - p.q_off);
  }
  if (k0 >= klen) hi = lo;
  const int per = p.block / kQStep;
  const int stages = (hi - lo) * per;
  // Stage j: queries qb * block + sub .. + 63 (local rows), qb = lo + j /
  // per, at key-axis position (qb + q_off) * block + sub.
  auto qrow = [&](int j) {
    return (lo + j / per) * p.block + (j % per) * kQStep;
  };
  auto qpos = [&](int j) { return qrow(j) + p.q_off * p.block; };
  auto load_q = [&](int j, unsigned char* dst) {
    const int r0 = qrow(j);
    const size_t at = q_at(p, b, h, r0);
    load_swz<kQStep, kH>(dst, p.q + at, p.q_row, p.dim, p.dim_pad);
    load_swz<kQStep, kH>(dst + T::kBlocks * kQHalf, p.dout + at, p.q_row,
                         p.dim, p.dim_pad);
    float* ls = reinterpret_cast<float*>(dst + 2 * T::kBlocks * kQHalf);
    if (threadIdx.x < kQStep)
      svt::cp_async4(ls + threadIdx.x, p.lse_in + stats + r0 + threadIdx.x);
    else if (threadIdx.x < 2 * kQStep)
      svt::cp_async4(ls + threadIdx.x,
                     p.delta + stats + r0 + threadIdx.x - kQStep);
  };

  if (sep) {
    const size_t at = cls_at(p, b, h, k0);
    load_swz<kKeys, kH>(ks, p.cls_k + at, p.dim, p.dim, p.dim_pad);
    load_swz<kKeys, kH>(vs, p.cls_v + at, p.dim, p.dim, p.dim_pad);
  } else {
    const size_t at = k_at(p, b, h, k0);
    load_swz<kKeys, kH>(ks, p.k + at, p.k_row, p.dim, p.dim_pad);
    load_swz<kKeys, kH>(vs, p.v + at, p.k_row, p.dim, p.dim_pad);
  }

  // kSplit: warpgroup 0 owns dV, warpgroup 1 dK, of the same 64 keys;
  // otherwise each owns dV (acc) and dK (acc_k) of its own 64 keys. Rows
  // are keys, columns dims.
  Acc<kH> acc, acc_k;
  zero_acc(acc);
  if constexpr (!S::kSplit) zero_acc(acc_k);
  const float sl2 = p.scale * kLog2e;
  const int kw0 = k0 + (S::kSplit ? 0 : 64 * wg);  // the warpgroup's keys
  const int key0 = kw0 + 16 * warp + (lane >> 2);  // this thread's: + 0, 8

  ring_walk<S::kStages>(
      stages, qbufs, S::kQStage,
      [&](int j) {
        // Skip a stage whose queries all lie before every key.
        while (j < stages && causal && qpos(j) + kQStep - 1 < k0) ++j;
        return j;
      },
      load_q,
      [&](int j, const unsigned char* qs) {
        const unsigned char* dos = qs + T::kBlocks * kQHalf;
        const float* lses =
            reinterpret_cast<const float*>(dos + T::kBlocks * kQHalf);
        const float* dels = lses + kQStep;
        const int qpos0 = qpos(j);
        // p = exp(s - lse) of the warpgroup's keys against the step's
        // queries, masked only where a warpgroup-uniform test says a pair
        // may be invalid (then also a query whose lse is -inf).
        auto p_of = [&](float (&x)[kSub / 2], int c0) {
          const int q0 = qpos0 + c0;  // the step's first query, key axis
          const bool edge =
              kw0 + 64 > klen || (causal && kw0 + 63 > q0);
          auto run = [&](auto masked) {
#pragma unroll
            for (int n = 0; n < kSub / 8; ++n) {
              const int col = 8 * n + 2 * tq;
              const float2 l2 =
                  *reinterpret_cast<const float2*>(lses + c0 + col);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int k = 4 * n + e;
                const float l = (e & 1) ? l2.y : l2.x;
                float pr = ex2(fmaf(x[k], sl2, -l * kLog2e));
                if constexpr (decltype(masked)::value) {
                  const int kk = key0 + 8 * (e >> 1);
                  const bool ok = kk < klen && l != -INFINITY &&
                                  (!causal || kk <= q0 + col + (e & 1));
                  pr = ok ? pr : 0.f;
                }
                x[k] = pr;
              }
            }
          };
          if (edge)
            run(std::true_type());
          else
            run(std::false_type());
        };
        // dS^T = P^T (dP^T - delta) scale, in place of dP^T in y.
        auto ds_of = [&](const float (&pr)[kSub / 2], float (&y)[kSub / 2],
                         int c0) {
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(dels + c0 + 8 * n + 2 * tq);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              y[4 * n + e] =
                  pr[4 * n + e] * (y[4 * n + e] - ((e & 1) ? d2.y : d2.x)) *
                  p.scale;
          }
        };
#pragma unroll 1
        for (int c0 = 0; c0 < kQStep; c0 += kSub) {
          // Warpgroup-uniform (CTA-uniform when kSplit): every query of
          // the step lies before every key.
          if (causal && qpos0 + c0 + kSub - 1 < kw0) continue;
          if constexpr (S::kSplit) {
            float x[kSub / 2];
            svt::wgmma_fence();
            // S^T = K Q^T (warpgroup 0), dP^T = V dO^T (warpgroup 1).
            product_k<kH, kSub>(x, wg == 0 ? ks : vs, kHalf,
                                (wg == 0 ? qs : dos) + c0 * T::kRowB,
                                kQHalf, p.dim_pad);
            svt::wgmma_commit();
            // This product, and the previous step's dV or dK product,
            // are done.
            svt::wgmma_wait<0>();
            svt::fence_acc(x);
            fence_all(acc);
            float4* pb = pbuf + (c0 / kSub) * (kSub / 8) * 128;
            if (wg == 0) {
              p_of(x, c0);
#pragma unroll
              for (int n = 0; n < kSub / 8; ++n)
                pb[n * 128 + t128] = make_float4(x[4 * n], x[4 * n + 1],
                                                 x[4 * n + 2], x[4 * n + 3]);
              bar_arrive(kPBar + c0 / kSub, kWgThreads);
            } else {
              bar_sync(kPBar + c0 / kSub, kWgThreads);  // P from warpgroup 0
              float pr[kSub / 2];
#pragma unroll
              for (int n = 0; n < kSub / 8; ++n) {
                const float4 v = pb[n * 128 + t128];
                pr[4 * n] = v.x;
                pr[4 * n + 1] = v.y;
                pr[4 * n + 2] = v.z;
                pr[4 * n + 3] = v.w;
              }
              ds_of(pr, x, c0);
            }
            svt::wgmma_fence();
            // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1).
            product_mn<kH, kSub>(acc, x,
                                 (wg == 0 ? dos : qs) + c0 * T::kRowB,
                                 kQHalf);
            svt::wgmma_commit();  // in flight beside the next product
          } else {
            float x[kSub / 2], y[kSub / 2];
            svt::wgmma_fence();
            const int at = 64 * wg * T::kRowB;  // the warpgroup's keys
            product_k<kH, kSub>(x, ks + at, kHalf, qs + c0 * T::kRowB,
                                kQHalf, p.dim_pad);  // S^T = K Q^T
            product_k<kH, kSub>(y, vs + at, kHalf, dos + c0 * T::kRowB,
                                kQHalf, p.dim_pad);  // dP^T = V dO^T
            svt::wgmma_commit();
            // These products, and the previous step's dV and dK products,
            // are done.
            svt::wgmma_wait<0>();
            svt::fence_acc(x);
            svt::fence_acc(y);
            fence_all(acc);
            fence_all(acc_k);
            p_of(x, c0);
            ds_of(x, y, c0);
            svt::wgmma_fence();
            product_mn<kH, kSub>(acc, x, dos + c0 * T::kRowB,
                                 kQHalf);  // dV += P^T dO
            product_mn<kH, kSub>(acc_k, y, qs + c0 * T::kRowB,
                                 kQHalf);  // dK += dS^T Q
            svt::wgmma_commit();  // in flight beside the next products
          }
        }
        svt::wgmma_wait<0>();
        fence_all(acc);
        if constexpr (!S::kSplit) fence_all(acc_k);
      });

  // [CLS] tasks, and key block 0's band part, go to the scratch as fp32
  // partials that meet in the reduce pass.
  const bool partial = cls || (!p.cls_k && kb == 0 && p.cls_chunks > 0);
  const int parts = cls_parts(p);
  const int part = cls ? (p.cls_k ? 0 : 1) + chunk : 0;
  const int r = kw0 + 16 * warp;  // this warp's first key
  auto store = [&](const Acc<kH>& x, int which) {  // 0: dk, 1: dv
    if (partial) {
      store_acc_f32(x,
                    scratch_part(p, which, b, h, parts, part) +
                        (size_t)(r % p.block) * p.dim,
                    p.dim);
    } else {
      const float one[2] = {1.f, 1.f};
      store_acc(x, one, (which ? p.dv : p.dk) + k_at(p, b, h, r), p.k_row,
                p.dim);
    }
  };
  if constexpr (S::kSplit) {
    store(acc, wg == 0 ? 1 : 0);
  } else {
    store(acc, 1);
    store(acc_k, 0);
  }
}

// The [CLS] block of every (head, row): key block 0's band part and the
// partials, summed in order, rounded once into key block 0 of dk, dv, or
// the broadcast block's partials into dcls_k, dcls_v. Four floats a
// thread; blockIdx.x: 1,024-float slices of [block, dim]; blockIdx.y: dk
// or dv, and the head.
__global__ void __launch_bounds__(kWgThreads)
swa_generic_reduce_kernel(const __grid_constant__ Params p) {
  const int which = blockIdx.y & 1;
  const int h = blockIdx.y >> 1;
  const int b = blockIdx.z;
  const int tile = p.block * p.dim;
  const int e = (blockIdx.x * kWgThreads + threadIdx.x) * 4;
  if (e >= tile) return;
  const int r = e / p.dim;
  const int c = e - r * p.dim;
  const int parts = cls_parts(p);
  const float* src = scratch_part(p, which, b, h, parts, 0) + e;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int part = 0; part < parts; ++part) {
    const float4 x =
        *reinterpret_cast<const float4*>(src + (size_t)part * tile);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  bf16* dst = p.cls_k ? (which ? p.dcls_v : p.dcls_k) + cls_at(p, b, h, r)
                      : (which ? p.dv : p.dk) + k_at(p, b, h, r);
  *reinterpret_cast<__nv_bfloat162*>(dst + c) =
      __floats2bfloat162_rn(sum.x, sum.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + c + 2) =
      __floats2bfloat162_rn(sum.z, sum.w);
}

int fwd_smem(int dim_pad, int dv) {
  return (2 * kRows * (dim_pad + 8) + kFwdKeys * (dv + 8)) * 2;
}
int bwd_smem(int dim_pad) {
  return 2 * (kRows + kStep) * (dim_pad + 8) * 2 + 2 * kStep * 4;
}

// Beyond Dh 256: the forward and dq chunks are 256 columns wide, the
// dk/dv chunks 128 (two accumulators).
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

// The number of [CLS] chunks: ops/swa_kernel.py::cls_chunks sizes the
// scratch from the same count (in query blocks of the call's block).
int count_cls_chunks(const Params& p) {
  const int num_qb = p.q_len / p.block;
  const int left = p.causal ? p.window : (p.window + 1) / 2;
  if (p.cls_k) return (num_qb + p.cls_chunk - 1) / p.cls_chunk;
  if (p.include_cls && num_qb > left)
    return (num_qb - left + p.cls_chunk - 1) / p.cls_chunk;
  return 0;
}

// Raises a Hopper kernel's dynamic shared memory limit and asks for the
// largest shared memory carveout (two CTAs an SM at kH 1), once per
// device, as svt::raise_smem_limit does.
template <typename Kernel>
cudaError_t raise_limits(svt::SmemLimit& limit, Kernel* kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < svt::kMaxDevices && limit.set[device].load())
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return svt::raise_smem_limit(limit, kernel, bytes);
}

template <int kH, bool kTma>
int launch_fwd_wg(const Params& p, cudaStream_t s) {
  using S = Shape<kH>;
  const long long ctas = (long long)(p.q_len / kTileRows) * p.heads * p.batch;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk{}, tv{}, tck{}, tcv{};
  if (kTma && !kv_maps(p, S::kFwdKeys, &tk, &tv, &tck, &tcv))
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit limit;
  const cudaError_t err = raise_limits(
      limit, swa_generic_fwd_wg_kernel<kH, kTma>, S::kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_generic_fwd_wg_kernel<kH, kTma>
      <<<static_cast<unsigned>(ctas), fwd_threads<kH, kTma>(), S::kFwdSmem,
         s>>>(p, tk, tv, tck, tcv);
  return static_cast<int>(cudaGetLastError());
}

// The forward at kH: by TMA where Dh fills whole 64-dim blocks.
template <int kH>
int launch_fwd_at(const Params& p, cudaStream_t s) {
  if (kH > 0 && p.dim % 64 == 0) return launch_fwd_wg<kH, kH != 0>(p, s);
  return launch_fwd_wg<kH, false>(p, s);
}

// dq (with delta), dk/dv with the [CLS] partials, the reduce.
template <int kH>
int launch_bwd_wg(Params p, cudaStream_t s) {
  using S = Shape<kH>;
  if (p.cls_chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.cls_chunks = count_cls_chunks(p);
  if (p.cls_chunks > 0 && !p.scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hb = (long long)p.heads * p.batch;
  const long long dq_ctas = (long long)(p.q_len / kTileRows) * hb;
  const long long kv_ctas =
      ((long long)p.cls_chunks * (p.block / S::kCtaKeys) +
       p.key_len / S::kCtaKeys) * hb;
  if (dq_ctas > 0x7fffffffLL || kv_ctas > 0x7fffffffLL ||
      2 * p.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // dq's K and V by TMA where Dh fills whole 64-dim blocks (kH >= 2).
  constexpr bool kTma = kH >= 2;
  const bool tma = kTma && p.dim % 64 == 0;
  CUtensorMap tk{}, tv{}, tck{}, tcv{};
  if (tma && !kv_maps(p, S::kDqKeys, &tk, &tv, &tck, &tcv))
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit dq_limit, dq_tma_limit, kv_limit;
  cudaError_t err =
      tma ? raise_limits(dq_tma_limit, swa_generic_dq_wg_kernel<kH, kTma>,
                         S::kDqSmem)
          : raise_limits(dq_limit, swa_generic_dq_wg_kernel<kH, false>,
                         S::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = raise_limits(kv_limit, swa_generic_dkv_wg_kernel<kH>, S::kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tma)
    swa_generic_dq_wg_kernel<kH, kTma>
        <<<static_cast<unsigned>(dq_ctas), kWgThreads + 128, S::kDqSmem,
           s>>>(p, tk, tv, tck, tcv);
  else
    swa_generic_dq_wg_kernel<kH, false>
        <<<static_cast<unsigned>(dq_ctas), kWgThreads, S::kDqSmem, s>>>(
            p, tk, tv, tck, tcv);
  swa_generic_dkv_wg_kernel<kH>
      <<<static_cast<unsigned>(kv_ctas), kWgThreads, S::kKvSmem, s>>>(p);
  if (p.cls_chunks > 0) {
    const int slices =
        (p.block * p.dim + 4 * kWgThreads - 1) / (4 * kWgThreads);
    swa_generic_reduce_kernel<<<dim3(slices, 2 * p.heads, p.batch),
                                kWgThreads, 0, s>>>(p);
  }
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
  switch (p.dim_pad <= 32 ? 0 : (p.dim_pad + 63) / 64) {
    case 0: return launch_fwd_at<0>(p, s);
    case 1: return launch_fwd_at<1>(p, s);
    case 2: return launch_fwd_at<2>(p, s);
    case 3: return launch_fwd_at<3>(p, s);
    case 4: return launch_fwd_at<4>(p, s);
    default: return launch_fwd<kFwdWidest>(p, s);  // beyond Dh 256
  }
}

// The generic backward: dq (q's strides), dk, dv (k's), and with cls_k
// not null dcls_k, dcls_v [B, H, block, Dh]; delta [B, H, q_len] fp32
// scratch; at Dh <= 256 the [CLS] scratch [2, B, H, parts, block, Dh]
// fp32 (parts: key block 0's band part unless cls_k, then one partial per
// chunk of cls_chunk query blocks; may be null when the call has no
// chunk). Launches on the stream: at Dh <= 256 dq (with delta), dk/dv and,
// with [CLS] chunks, the reduce; beyond, delta, dq, dk/dv.
extern "C" int svt_swa_generic_bwd(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* lse, const void* out, const void* dout, const void* cls_k,
    const void* cls_v, const void* cls_len, void* dq, void* dk, void* dv,
    void* dcls_k, void* dcls_v, void* delta, void* scratch, int q_row,
    int q_head, int q_batch, int k_row, int k_head, int k_batch, int batch,
    int num_heads, int q_len, int key_len, int head_dim, int block_size,
    int window, int causal, int include_cls, int q_off, int cls_chunk,
    float scale, void* stream) {
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
  p.scratch = static_cast<float*>(scratch);
  p.cls_chunk = cls_chunk;
  if (const int err = check(p)) return err;
  if (p.cls_k && !(p.dcls_k && p.dcls_v))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.dim_pad <= 32 ? 0 : (p.dim_pad + 63) / 64) {
    case 0: return launch_bwd_wg<0>(p, s);
    case 1: return launch_bwd_wg<1>(p, s);
    case 2: return launch_bwd_wg<2>(p, s);
    case 3: return launch_bwd_wg<3>(p, s);
    case 4: return launch_bwd_wg<4>(p, s);
    default: break;  // beyond Dh 256: the mma.sync kernels
  }
  const long long rows = (long long)p.batch * p.heads * p.q_len;
  swa_generic_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p);
  if (const int err = launch_dq<kFwdWidest>(p, s)) return err;
  return launch_dkv<kDkvWidest>(p, s);
}
