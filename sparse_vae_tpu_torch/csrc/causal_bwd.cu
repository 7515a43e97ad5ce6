// The dense causal attention backward for Hopper, at head-major Dh 64 and
// 128: the backward of csrc/causal_fwd.cu, the counterpart of the
// backward of the JAX library's Pallas flash attention that
// sparse_vae_tpu/ops/attention.py calls at :472. The plain PyTorch
// version is sparse_vae_tpu_torch/ops/causal_kernel.py::
// causal_attention_bwd_plain.
//
// What it computes. From q, k, v, out, do (bf16 [B, H, L, Dh]), lengths
// and the forward's lse: p = exp(s - lse) where key j is attended by query
// i (j <= i, j < lengths[b]) and 0 elsewhere, delta = rowsum(do * out) in
// fp32, ds = p (dp - delta) Dh^-0.5 with dp = do v^T, and dq = ds k,
// dk = ds^T q, dv = p^T do, with p and ds rounded to bf16 before their
// products, every sum in fp32, and dq, dk, dv each rounded once. Keys at
// or past lengths[b] get zero gradients; a row with lengths[b] == 0 gets
// zero everywhere.
//
// What bounds it. Five products of Dh multiply-adds a pair over the causal
// triangle: at the r4 LM's [14, 8, 3584, 64] 461 GFLOP against 0.4 GB
// read and written, the tensor cores' bound (0.466 ms on an H100).
//
// Design: one pass over key tiles, FlashAttention's.
//   delta (causal_delta_kernel): rowsum(do * out) a row in a fixed order,
//     and the dq counters zeroed.
//   the pass (causal_bwd_kernel): one CTA per 128-key tile of a (head,
//     row), two consumer warpgroups of 64 keys each and a producer
//     warpgroup that gives them its registers (setmaxnreg, 24 against
//     240). K and V stay in shared memory (TMA; at Dh 64 K also in a
//     64-byte-swizzle copy for dQ's 32-dim halves); the producer's first
//     thread streams the query steps (64 queries from the tile's own
//     first onward: Q and dO by TMA, lse and delta by bulk copy) through
//     a ring of stages. Per step a warpgroup computes S^T = K Q^T and dP^T
//     = V dO^T (m64n64k16; at Dh 64 its K and V rows stay in registers, A
//     of the register form, so only Q and dO are read from shared
//     memory, whose 128 bytes a clock two shared operands would fill),
//     P^T and dS^T in registers (the mask only where a warpgroup-uniform
//     test says a pair may be invalid), issues dV += P^T dO and dK +=
//     dS^T Q (A from registers),
//     and stores dS^T by stmatrix (transposed) as dS [64 queries x 128
//     keys]; after a named barrier each warpgroup computes its half of
//     the dims of dQ = dS K (all 128 keys) and writes it, fp32, to a
//     shared buffer. dK and dV are written once at the end.
//   dq: the producer warpgroup's second warp adds each step's dQ to an
//     fp32 buffer [B, H, L, Dh] by TMA (a store for the first key tile, a
//     reduce-add for the others), in a fixed order of key tiles: the
//     highest key tile of a query step first, down to tile 0, a counter a
//     64-query step saying whose turn it is (acquire, then release once
//     the writes are done, a step later, so the next step's writes run
//     meanwhile). The grid runs in chunks of `group` (head, row) pairs,
//     as many as keep their dq buffer, Q and dO within 32 MiB of L2 (the
//     caller's count, ops/causal_kernel.py `bwd_group`), so the buffer's
//     read-modify-writes stay there; within a chunk the key tile
//     descends (the shortest CTAs first): tile kt reaches a query step
//     two steps after tile kt + 1, which was launched before it, so a
//     CTA seldom waits and never on one launched after it. (Tile 0 first, the order the other way
//     round, makes a CTA wait on every lower tile of its chunk.)
//   dq rounding (causal_dq_kernel): the buffer rounded once to bf16.
// Registers and shared memory: a consumer thread holds dV and dK (32 or
// 64 fp32 each), S^T and dP^T (32 each), dQ (16 or 32) and at Dh 64 its
// K and V rows (32); dynamic shared memory 181,248 bytes at Dh 64 (K, V,
// the narrow K, two dS buffers, three dQ buffers, three stages) and
// 230,400 at Dh 128 (two dQ buffers, two stages; lse and delta in static
// shared memory).
// Every sum has one order: a second call is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 128;      // keys of a CTA
constexpr int kStep = 64;       // queries of a step
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kTileHalf = kTile * 128;      // [128 rows x 64 dims] bf16
constexpr int kStepHalf = kStep * 128;      // [64 rows x 64 dims] bf16
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// wgmma descriptor of a tile of 64-byte rows in the 64-byte swizzle (as
// TMA writes it), 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return static_cast<uint64_t>((svt::smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A K-major in shared memory (the
// 128-byte swizzle) and B MN-major (16 k-rows of 64 bytes in the 64-byte
// swizzle); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32_mn(float (&d)[16], uint64_t da,
                                                uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SVT_D16
      ", %16, %17, p, 1, 1, 0, 1;\n}\n"
      : SVT_ACC16
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A in registers (the mma.sync
// m16n8k16 A layout, warp w of the warpgroup holding rows 16w .. 16w +
// 15), B K-major in shared memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SVT_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The A registers of rows 16 warp .. + 15 and dims 16 kk .. + 15 of a
// warpgroup's 64-row tile at `tile` (K-major, 128-byte swizzle, 64-dim
// halves kTileHalf apart), by one ldmatrix: lane l gives row l % 16 and
// the 16-byte chunk of dims 16 kk + 8 (l / 16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const unsigned char* tile, int kk,
                                       int warp, int lane) {
  const int r = 16 * warp + (lane & 15);
  const int c = 2 * (kk & 3) + (lane >> 4);
  const unsigned char* p =
      tile + (kk >> 2) * kTileHalf + r * 128 + ((c ^ (r & 7)) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(svt::smem_u32(p)));
}

template <int D>
struct Bwd {
  static_assert(D == 64 || D == 128, "instantiated at Dh 64 and 128");
  static constexpr int kHalves = D / 64;
  static constexpr int kKvBytes = kHalves * kTileHalf;   // K or V
  static constexpr int kStepBytes = kHalves * kStepHalf;  // Q or dO
  // A stage: Q and dO (its lse and delta in static shared memory).
  static constexpr int kStage = 2 * kStepBytes;
  static constexpr int kDsBytes = 2 * kStepHalf;  // dS [64 x 128 keys]
  // dQ of a step, fp32 [64 x D] as D / 32 boxes of [64 rows x 32 dims]
  // in the 128-byte swizzle (the dq buffer's tensor map's boxes).
  static constexpr int kDqBytes = kStep * D * 4;
  static constexpr int kDqBufs = D == 64 ? 3 : 2;
  static constexpr int kStages = D == 64 ? 3 : 2;
  // dQ's columns a warpgroup: at Dh 64 each takes 32 dims of K from a
  // copy of the key tile in the narrow (64-byte swizzle) format.
  static constexpr int kDqN = D / 2;
  static constexpr int kNarrowBytes = D == 64 ? kTile * 128 : 0;
  static constexpr int kSmem = svt::kSwizzleAlign + 2 * kKvBytes +
                               kNarrowBytes + 2 * kDsBytes +
                               kDqBufs * kDqBytes + kStages * kStage;
  static_assert(kSmem + 2048 <= 232448, "within the 227 KB a block may use");
};

struct BwdParams {
  const int* lengths;
  const float *lse, *delta;
  float* dq_acc;
  int* counters;
  bf16 *dk, *dv;
  int batch, heads, len, group;
  float scale;
};

// delta = rowsum(do * out) of every row, D / 8 threads a row (16 bytes of
// each a thread, then a fixed shuffle tree), and the counters zeroed.
template <int D>
__global__ void __launch_bounds__(256)
causal_delta_kernel(const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, float* __restrict__ delta,
                    int* __restrict__ counters, int rows, int num_counters) {
  constexpr int kLanes = D / 8;
  const long long gid = (long long)blockIdx.x * 256 + threadIdx.x;
  if (gid < num_counters) counters[gid] = 0;
  const long long rr = gid / kLanes;
  const int c = 8 * (int)(gid % kLanes);
  float sum = 0.f;
  if (rr < rows) {
    const uint4 xv =
        *reinterpret_cast<const uint4*>(out + (size_t)rr * D + c);
    const uint4 yv =
        *reinterpret_cast<const uint4*>(dout + (size_t)rr * D + c);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(xs[e]);
      const float2 g = __bfloat1622float2(ys[e]);
      sum = fmaf(a.x, g.x, fmaf(a.y, g.y, sum));
    }
  }
#pragma unroll
  for (int w = kLanes / 2; w > 0; w >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (rr < rows && gid % kLanes == 0) delta[rr] = sum;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
causal_bwd_kernel(const __grid_constant__ BwdParams p,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdq,
                  const __grid_constant__ CUtensorMap tkn) {
  using G = Bwd<D>;
  constexpr int kStages = G::kStages;
  constexpr int kDqBufs = G::kDqBufs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = svt::align_smem(smem_raw);
  unsigned char* vs = ks + G::kKvBytes;
  unsigned char* kn = vs + G::kKvBytes;                 // narrow K
  unsigned char* dss = kn + G::kNarrowBytes;            // [2] dS buffers
  unsigned char* dqs = dss + 2 * G::kDsBytes;           // [kDqBufs] dQ
  unsigned char* stages = dqs + kDqBufs * G::kDqBytes;  // [kStages]
  __shared__ uint64_t kvfull, full[kStages], empty[kStages],
      dqfull[kDqBufs], dqempty[kDqBufs];
  __shared__ __align__(16) float stat[kStages][2 * kStep];  // lse, delta

  // The grid: chunks of p.group (head, row) pairs, whose dq buffer, Q
  // and dO stay in L2 while the chunk runs; within a chunk the pairs
  // fastest, then the key tile, last (shortest) first: a CTA waits only
  // on the higher key tiles of its pair, launched before it, which reach
  // each query step two steps before it does.
  int hb, kt;
  svt::chunked_tile(blockIdx.x, p.heads * p.batch, p.len / kTile, p.group,
                    &hb, &kt);
  kt = p.len / kTile - 1 - kt;
  const int b = hb / p.heads;
  const int length = p.lengths[b];
  const int k0 = kt * kTile;
  const bool live = k0 < length;  // the tile holds a valid key
  // Query steps from the tile's own first query to the end of the row.
  const int steps = live ? (p.len - k0) / kStep : 0;
  const int row0 = hb * p.len;

  if (threadIdx.x == kConsumers) {
    svt::mbar_init(&kvfull, 1);
    for (int s = 0; s < kStages; ++s) {
      svt::mbar_init(full + s, 1);
      svt::mbar_init(empty + s, kConsumers);
    }
    for (int s = 0; s < kDqBufs; ++s) {
      svt::mbar_init(dqfull + s, kConsumers);
      svt::mbar_init(dqempty + s, 1);
    }
    svt::mbar_fence_init();
  }
  __syncthreads();
  int* counters = p.counters + (size_t)hb * (p.len / kStep);

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == kConsumers && live) {
      svt::mbar_expect_tx(&kvfull, 2 * G::kKvBytes + G::kNarrowBytes);
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf) {
        svt::tma_load(ks + hf * kTileHalf, &tk, &kvfull, 64 * hf, row0 + k0);
        svt::tma_load(vs + hf * kTileHalf, &tv, &kvfull, 64 * hf, row0 + k0);
      }
      if constexpr (D == 64)
        for (int hf = 0; hf < 2; ++hf)
          svt::tma_load(kn + hf * (kTile * 64), &tkn, &kvfull, 32 * hf,
                        row0 + k0);
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kStages;
        const int use = s / kStages;
        const int q0 = k0 + kStep * s;
        unsigned char* st = stages + slot * G::kStage;
        if (use > 0) svt::mbar_wait(empty + slot, (use - 1) & 1);
        svt::mbar_expect_tx(full + slot, 2 * G::kStepBytes + 2 * kStep * 4);
#pragma unroll
        for (int hf = 0; hf < G::kHalves; ++hf) {
          svt::tma_load(st + hf * kStepHalf, &tq, full + slot, 64 * hf,
                        row0 + q0);
          svt::tma_load(st + G::kStepBytes + hf * kStepHalf, &tdo,
                        full + slot, 64 * hf, row0 + q0);
        }
        svt::bulk_load(stat[slot], p.lse + row0 + q0, kStep * 4,
                       full + slot);
        svt::bulk_load(stat[slot] + kStep, p.delta + row0 + q0, kStep * 4,
                       full + slot);
      }
    } else if (threadIdx.x == kConsumers + 32 && live) {
      // The dq reducer: step s's dQ from shared memory into the buffer
      // once the step's counter reads this tile's turn (the first tile
      // stores, the others add), its counter advanced and its shared
      // memory released once the writes are done, a step later.
      for (int s = 0; s <= steps; ++s) {
        if (s < steps) {
          const int buf = s % kDqBufs;
          const int q0 = k0 + kStep * s;
          // The key tiles that add to this step, from the highest
          // (at or before the step's tile, holding a valid key) down:
          // this one is number `turn`.
          const int turn = min(q0 / kTile, (length - 1) / kTile) - kt;
          svt::mbar_wait(dqfull + buf, (s / kDqBufs) & 1);
          while (svt::ld_acquire(counters + q0 / kStep) != turn) {
          }
          svt::fence_proxy_async_global();
          const unsigned char* src = dqs + buf * G::kDqBytes;
#pragma unroll
          for (int box = 0; box < D / 32; ++box) {
            if (turn == 0)
              svt::tma_store(&tdq, src + box * kStep * 128, 32 * box,
                             row0 + q0);
            else
              svt::tma_reduce_add(&tdq, src + box * kStep * 128, 32 * box,
                                  row0 + q0);
          }
          svt::bulk_commit();
        }
        if (s > 0) {
          // Step s - 1's operation is done (reads and writes): release its
          // counter and its buffer; step s's runs on meanwhile.
          if (s < steps)
            svt::bulk_wait<1>();
          else
            svt::bulk_wait<0>();
          const int q1 = k0 + kStep * (s - 1);
          svt::fence_proxy_async_global();
          __threadfence();
          svt::st_release(counters + q1 / kStep,
                          min(q1 / kTile, (length - 1) / kTile) - kt + 1);
          svt::mbar_arrive(dqempty + (s - 1) % kDqBufs);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq4 = lane & 3;
  const int gq = lane >> 2;
  const int kw0 = k0 + 64 * wg;  // the warpgroup's first key
  // This thread's keys: kw0 + kr and kw0 + kr + 8.
  const int kr = 16 * warp + gq;
  const int key[2] = {kw0 + kr, kw0 + kr + 8};
  const float sl2 = p.scale * kLog2e;

  float dv[G::kHalves][32], dk[G::kHalves][32];
#pragma unroll
  for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[hf][i] = dk[hf][i] = 0.f;
  auto fence_dkv = [&] {
#pragma unroll
    for (int hf = 0; hf < G::kHalves; ++hf) {
      svt::fence_acc(dv[hf]);
      svt::fence_acc(dk[hf]);
    }
  };

  if (live) svt::mbar_wait(&kvfull, 0);
  const unsigned char* ka = ks + wg * 64 * 128;  // the warpgroup's keys
  const unsigned char* va = vs + wg * 64 * 128;
  // At Dh 64 the warpgroup's K and V stay in registers (32 a thread), so
  // S^T and dP^T read only Q and dO from shared memory.
  constexpr int kRegKv = D == 64 ? D / 16 : 1;
  uint32_t kf[kRegKv][4], vf[kRegKv][4];
  if (D == 64 && live) {
#pragma unroll
    for (int kk = 0; kk < kRegKv; ++kk) {
      load_a(kf[kk], ka, kk, warp, lane);
      load_a(vf[kk], va, kk, warp, lane);
    }
  }

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    const int q0 = k0 + kStep * s;
    const unsigned char* qst = stages + slot * G::kStage;
    const unsigned char* dost = qst + G::kStepBytes;
    const float* lses = stat[slot];
    const float* dels = lses + kStep;
    svt::mbar_wait(full + slot, (s / kStages) & 1);

    // x = S^T = K Q^T, y = dP^T = V dO^T: x[4n + 2i + e] is key kr + 8i
    // of the warpgroup's, query q0 + 8n + 2 tq4 + e.
    float x[32], y[32];
    svt::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      const int a_off = (k16 >> 2) * kTileHalf + 32 * (k16 & 3);
      const int b_off = (k16 >> 2) * kStepHalf + 32 * (k16 & 3);
      if constexpr (D == 64) {
        wgmma_rs_n64(x, kf[k16], svt::desc_sw128(qst + b_off), k16);
        wgmma_rs_n64(y, vf[k16], svt::desc_sw128(dost + b_off), k16);
      } else {
        svt::wgmma_ss_n64(x, svt::desc_sw128(ka + a_off),
                          svt::desc_sw128(qst + b_off), k16);
        svt::wgmma_ss_n64(y, svt::desc_sw128(va + a_off),
                          svt::desc_sw128(dost + b_off), k16);
      }
    }
    svt::wgmma_commit();
    svt::wgmma_wait<0>();
    svt::fence_acc(x);
    svt::fence_acc(y);
    fence_dkv();

    // P^T and dS^T in place; warpgroup-uniform: a key after a query, or a
    // key past the valid length, may occur only when the test holds.
    const bool edge = kw0 + 63 > q0 || kw0 + 64 > length;
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * tq4;
        const float2 l2 = *reinterpret_cast<const float2*>(lses + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dels + col);
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int k = 4 * n + e4;
          const float lq = (e4 & 1) ? l2.y : l2.x;
          const float dl = (e4 & 1) ? d2.y : d2.x;
          float pr = svt::ex2(fmaf(x[k], sl2, -lq * kLog2e));
          if constexpr (decltype(masked)::value) {
            const int kk = key[e4 >> 1];
            const bool ok = kk < length && kk <= q0 + col + (e4 & 1);
            pr = ok ? pr : 0.f;
          }
          x[k] = pr;
          y[k] = pr * (y[k] - dl) * p.scale;
        }
      }
    };
    if (edge)
      p_ds(std::true_type());
    else
      p_ds(std::false_type());
    uint32_t pp[16], dsp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pp[i] = svt::packf(x[2 * i], x[2 * i + 1]);
      dsp[i] = svt::packf(y[2 * i], y[2 * i + 1]);
    }
    // dV += P^T dO, dK += dS^T Q (Q and dO MN-major).
    svt::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kStep / 16; ++kq)
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf) {
        svt::wgmma_rs_n64_mn(
            dv[hf], pp + 4 * kq,
            svt::desc_sw128(dost + hf * kStepHalf + 16 * kq * 128));
        svt::wgmma_rs_n64_mn(
            dk[hf], dsp + 4 * kq,
            svt::desc_sw128(qst + hf * kStepHalf + 16 * kq * 128));
      }
    svt::wgmma_commit();

    // dS as [64 queries x 128 keys] bf16, K-major in the 128-byte swizzle
    // (the warpgroup's keys are half wg); buffer s % 2: the product that
    // read this buffer two steps ago finished before its reader passed
    // the last step's barrier.
    // By stmatrix, transposed: the warp's dS^T [16 keys x 64 queries] as
    // 16 8x8 blocks, four a store; block (n, i) (keys 16 warp + 8i,
    // queries 8n) is register dsp[2n + i], and lane 8j + r gives the
    // address of row r (query 8n + r) of block j of the store.
    unsigned char* ds = dss + (s & 1) * G::kDsBytes + wg * kStepHalf;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = lane >> 3;
      const int r8 = lane & 7;
      const int n = 2 * m + (j >> 1);
      unsigned char* row = ds + (8 * n + r8) * 128 +
                           (((2 * warp + (j & 1)) ^ r8) << 4);
      asm volatile(
          "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, "
          "%3, %4};\n" ::"r"(svt::smem_u32(row)),
          "r"(dsp[4 * m]), "r"(dsp[4 * m + 1]), "r"(dsp[4 * m + 2]),
          "r"(dsp[4 * m + 3])
          : "memory");
    }
    svt::fence_proxy_async();
    svt::named_bar_sync(1, kConsumers);

    // dQ[:, kDqN wg ..] = dS K: dS from shared memory K-major, K
    // MN-major (at Dh 64 from the narrow copy).
    const unsigned char* dsb = dss + (s & 1) * G::kDsBytes;
    float dq[G::kDqN / 2];
    svt::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kTile / 16; ++k16) {
      const uint64_t da =
          svt::desc_sw128(dsb + (k16 >> 2) * kStepHalf + 32 * (k16 & 3));
      if constexpr (D == 64)
        wgmma_ss_n32_mn(dq, da, desc_sw64(kn + wg * (kTile * 64) + 1024 * k16),
                        k16);
      else
        svt::wgmma_ss_n64_mn(
            dq, da, svt::desc_sw128(ks + wg * kTileHalf + 2048 * k16), k16);
    }
    svt::wgmma_commit();
    svt::wgmma_wait<0>();
    svt::fence_acc(dq);
    fence_dkv();
    svt::mbar_arrive(empty + slot);
    // dQ to its buffer for the reducer: dq[4n + 2i + e] is row kr + 8i of
    // the step, dim kDqN wg + 8n + 2 tq4 + e, in box kDqN wg / 32 + n / 4
    // of 32 dims.
    const int buf = s % kDqBufs;
    if (s >= kDqBufs) svt::mbar_wait(dqempty + buf, (s / kDqBufs - 1) & 1);
    unsigned char* dqb = dqs + buf * G::kDqBytes;
#pragma unroll
    for (int n = 0; n < G::kDqN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rw = kr + 8 * i;
        const int chunk = 2 * (n & 3) + (tq4 >> 1);
        *reinterpret_cast<float2*>(
            dqb + (G::kDqN * wg / 32 + (n >> 2)) * kStep * 128 + rw * 128 +
            ((chunk ^ (rw & 7)) << 4) + 8 * (tq4 & 1)) =
            make_float2(dq[4 * n + 2 * i], dq[4 * n + 2 * i + 1]);
      }
    svt::fence_proxy_async();
    svt::mbar_arrive(dqfull + buf);
  }

  // dK, dV rows kw0 + 16 warp + gq + 8i, columns 64 hf + 8n + 2 tq4 + e
  // (zero for a tile with no valid key).
  const size_t at = ((size_t)row0 + kw0 + kr) * D + 2 * tq4;
#pragma unroll
  for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t e = at + (size_t)8 * i * D + 64 * hf + 8 * n;
        *reinterpret_cast<uint32_t*>(p.dk + e) =
            svt::packf(dk[hf][4 * n + 2 * i], dk[hf][4 * n + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + e) =
            svt::packf(dv[hf][4 * n + 2 * i], dv[hf][4 * n + 2 * i + 1]);
      }
}

// dq = bf16(the fp32 buffer), four values a thread; zero for a row with
// no valid key (no key tile wrote its buffer).
__global__ void __launch_bounds__(256)
causal_dq_kernel(const float* __restrict__ acc,
                 const int* __restrict__ lengths, bf16* __restrict__ dq,
                 long long per_row, long long total) {
  const long long e = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= total) return;
  const bool valid = lengths[e / per_row] > 0;
  const float4 x = valid ? *reinterpret_cast<const float4*>(acc + e)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<__nv_bfloat162*>(dq + e) =
      __floats2bfloat162_rn(x.x, x.y);
  *reinterpret_cast<__nv_bfloat162*>(dq + e + 2) =
      __floats2bfloat162_rn(x.z, x.w);
}

struct Ptrs {
  const void *q, *k, *v, *dout, *out;
  bf16* dq;
};

template <int D>
int launch(const Ptrs& t, const BwdParams& p, cudaStream_t s) {
  using G = Bwd<D>;
  const long long rows = (long long)p.batch * p.heads * p.len;
  const long long ctas = rows / kTile;
  const long long threads = rows * (D / 8);
  if (rows > 0x7fffffffLL || threads / 256 + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // K at Dh 64 also as its two 32-dim halves (the narrow copy).
  static svt::MapCache<64> maps;
  CUtensorMap tq{}, tdo{}, tk{}, tv{}, tdq{}, tkn{};
  if (!maps.get(&tq, svt::kMapBf16, t.q, D, (int)rows, kStep) ||
      !maps.get(&tdo, svt::kMapBf16, t.dout, D, (int)rows, kStep) ||
      !maps.get(&tk, svt::kMapBf16, t.k, D, (int)rows, kTile) ||
      !maps.get(&tv, svt::kMapBf16, t.v, D, (int)rows, kTile) ||
      !maps.get(&tdq, svt::kMapF32, p.dq_acc, D, (int)rows, kStep) ||
      (D == 64 && !maps.get(&tkn, svt::kMapBf16Sw64, t.k, D, (int)rows,
                            kTile)))
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit limit;
  cudaError_t err =
      svt::raise_smem_limit(limit, causal_bwd_kernel<D>, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  causal_delta_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256,
                           0, s>>>(
      static_cast<const bf16*>(t.out), static_cast<const bf16*>(t.dout),
      const_cast<float*>(p.delta), p.counters, (int)rows,
      (int)(rows / kStep));
  causal_bwd_kernel<D><<<static_cast<unsigned>(ctas), kThreads, G::kSmem,
                         s>>>(p, tq, tdo, tk, tv, tdq, tkn);
  const long long total = rows * D;
  causal_dq_kernel<<<static_cast<unsigned>((total / 4 + 255) / 256), 256,
                     0, s>>>(p.dq_acc, p.lengths, t.dq,
                             (long long)p.heads * p.len * D, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, do, dq, dk, dv: bf16 [B, H, L, Dh] contiguous, Dh 64 or
// 128, L a multiple of 128; lengths [B] int32; lse from svt_causal_fwd;
// scratch: delta [B, H, L] fp32, dq_acc [B, H, L, Dh] fp32, counters
// [B H L / 64] int32; group: the (head, row) pairs of a chunk of the
// pass's grid, 1 .. B H. Launches the delta, the pass and the dq rounding
// on the stream.
extern "C" int svt_causal_bwd(const void* q, const void* k, const void* v,
                              const void* lengths, const void* lse,
                              const void* out, const void* dout, void* dq,
                              void* dk, void* dv, void* delta, void* dq_acc,
                              void* counters, int batch, int heads, int len,
                              int head_dim, int group, float scale,
                              void* stream) {
  if (batch < 1 || heads < 1 || len <= 0 || len % kTile != 0 ||
      (head_dim != 64 && head_dim != 128) || group < 1 ||
      group > batch * heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Ptrs t{q, k, v, dout, out, static_cast<bf16*>(dq)};
  const BwdParams p{static_cast<const int*>(lengths),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<float*>(dq_acc),
                    static_cast<int*>(counters),
                    static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv),
                    batch,
                    heads,
                    len,
                    group,
                    scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? launch<64>(t, p, s) : launch<128>(t, p, s);
}
