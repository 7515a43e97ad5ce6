// The dense causal attention forward for Hopper, at head-major Dh 64 and
// 128: the counterpart of the JAX library's Pallas flash attention that
// sparse_vae_tpu/ops/attention.py calls at :472 (jax.experimental.pallas.
// ops.tpu.flash_attention with causal=True and the key mask as segment
// ids) for dense causal self-attention when lq == lk and lq % 512 == 0.
// The plain PyTorch version is sparse_vae_tpu_torch/ops/causal_kernel.py::
// causal_attention_plain; the backward is csrc/causal_bwd.cu.
//
// What it computes. q, k, v are bf16 [B, H, L, Dh], L a multiple of 128;
// lengths[b] is row b's valid key prefix. Query i attends key j iff j <= i
// and j < lengths[b], so a pad query (i >= lengths[b]) attends the valid
// keys, as the JAX package's masked dense path does. Scores are fp32
// q.k * Dh^-0.5, the softmax runs online in fp32, the weights are rounded
// to bf16 for the value product, and out is rounded once; lse [B, H, L]
// fp32. A row with no valid key (lengths[b] == 0) gives out 0 and lse
// -inf.
//
// What bounds it. Per head the causal triangle is L (L + 1) / 2 pairs of
// two products of Dh multiply-adds: at the r4 LM's [14, 8, 3584, 64] that
// is 184 GFLOP against 0.21 GB of q, k, v and out, ~900 FLOP a byte, three
// times the H100's bf16 ridge: the bound is the tensor cores' (0.186 ms).
// Beside the products, each score takes an exp2 on the special-function
// unit (16 a clock an SM): at Dh 64 that unit is as busy as the tensor
// cores, so the softmax must run under the products.
//
// Design. One CTA per 128-query tile of a (head, row): two consumer
// warpgroups of 64 rows and a producer warpgroup that gives them its
// registers (setmaxnreg, 24 against 240; 384 threads, one CTA an SM).
// The grid runs in chunks of `group` (head, row) pairs, as many as keep
// their K and V within 8 MiB of L2 (the caller's count,
// ops/causal_kernel.py `fwd_group`), so that a chunk's reads stay there;
// within a chunk the query tile is the slower index and descends, so the
// longest CTAs (28 key tiles at L 3,584) start first and the chunk ends
// on one-tile CTAs.
// The producer's first thread brings Q by TMA, then the key tiles 0 ..
// min(t, last valid) of 128 keys, K and V each into their own ring of
// kStages slots (3 at Dh 64, 2 at Dh 128), each arrival counted on an
// mbarrier and each slot reused once both warpgroups have released it on
// another: the consumers issue no load. A consumer warpgroup overlaps its
// softmax with its products: it issues S_j = Q K_j^T (m64n128k16, both
// from shared memory, K-major) and then O += P_{j-1} V_{j-1} (P from
// registers, V MN-major), waits for S_j alone, runs the softmax of tile
// j (mask only on the diagonal tile and the ragged end tile, with
// warpgroup-uniform tests; the row max and sum in four partial chains)
// while the value product runs, then waits for it, rescales O where some
// row's max moved and packs P_j to bf16. The two warpgroups take turns
// to issue their products (named barriers), so one's softmax runs under
// the other's products. Each K slot is released as soon as its S is
// done, each V slot once its value product is.
// Registers and shared memory: O (32 or 64 fp32), S (64) and P (32
// packed) a consumer thread, within its 240 registers; dynamic shared
// memory 115,712 bytes at Dh 64 (Q, 3 + 3 tiles) and 164,864 at Dh 128
// (Q, 2 + 2 tiles).
// Every output has one owner and one order of sums: a second call is
// bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 128;                  // queries of a CTA, keys a tile
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// A producer warpgroup that hands its registers to the consumers: a CTA's
// registers are allocated by four warps, so a ninth warp alone would cap
// every thread at 168, too few for O, S and P at Dh 128.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kHalfBytes = kTile * 128;     // [128 rows x 64 dims] bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static_assert(D == 64 || D == 128, "instantiated at Dh 64 and 128");
  static constexpr int kHalves = D / 64;
  static constexpr int kTileBytes = kHalves * kHalfBytes;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kSmem =
      svt::kSwizzleAlign + kTileBytes * (1 + 2 * kStages);
  static_assert(kSmem <= 232448, "within the 227 KB a block may use");
};

struct FwdParams {
  const int* lengths;
  bf16* out;
  float* lse;
  int batch, heads, len, group;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
causal_fwd_kernel(const __grid_constant__ FwdParams p,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv) {
  using G = Fwd<D>;
  constexpr int kStages = G::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = svt::align_smem(smem_raw);
  unsigned char* ks = qs + G::kTileBytes;             // [kStages] K tiles
  unsigned char* vs = ks + kStages * G::kTileBytes;   // [kStages] V tiles
  __shared__ uint64_t qfull, kfull[kStages], kempty[kStages],
      vfull[kStages], vempty[kStages];

  // The grid: chunks of p.group (head, row) pairs, whose K and V stay in
  // L2 while the chunk runs; within a chunk the pairs fastest, then the
  // query tile, last (longest) first.
  int hb, t;
  svt::chunked_tile(blockIdx.x, p.heads * p.batch, p.len / kTile, p.group,
                    &hb, &t);
  t = p.len / kTile - 1 - t;
  const int b = hb / p.heads;
  const int length = p.lengths[b];
  // Key tiles 0 .. tiles - 1: at or before the diagonal, holding a valid
  // key.
  const int tiles = length > 0 ? min(t, (length - 1) / kTile) + 1 : 0;
  const int row0 = hb * p.len;  // the head's first row of the maps
  const int q0 = t * kTile;

  if (threadIdx.x == kConsumers) {
    svt::mbar_init(&qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      svt::mbar_init(kfull + s, 1);
      svt::mbar_init(vfull + s, 1);
      svt::mbar_init(kempty + s, kConsumers);
      svt::mbar_init(vempty + s, kConsumers);
    }
    svt::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == kConsumers && tiles > 0) {
      svt::mbar_expect_tx(&qfull, G::kTileBytes);
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf)
        svt::tma_load(qs + hf * kHalfBytes, &tq, &qfull, 64 * hf, row0 + q0);
      for (int j = 0; j < tiles; ++j) {
        const int slot = j % kStages;
        const int use = j / kStages;
        unsigned char* kd = ks + slot * G::kTileBytes;
        unsigned char* vd = vs + slot * G::kTileBytes;
        if (use > 0) svt::mbar_wait(kempty + slot, (use - 1) & 1);
        svt::mbar_expect_tx(kfull + slot, G::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < G::kHalves; ++hf)
          svt::tma_load(kd + hf * kHalfBytes, &tk, kfull + slot, 64 * hf,
                        row0 + j * kTile);
        if (use > 0) svt::mbar_wait(vempty + slot, (use - 1) & 1);
        svt::mbar_expect_tx(vfull + slot, G::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < G::kHalves; ++hf)
          svt::tma_load(vd + hf * kHalfBytes, &tv, vfull + slot, 64 * hf,
                        row0 + j * kTile);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq4 = lane & 3;
  // This thread's rows of the tile: r and r + 8.
  const int r = 64 * wg + 16 * warp + (lane >> 2);
  const int row[2] = {q0 + r, q0 + r + 8};
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = qs + wg * 64 * 128;  // the warpgroup's rows

  float o[G::kHalves][32];
#pragma unroll
  for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // running sum
  float s[64];       // S of a tile: s[4n + 2i + e] is row r + 8i, key 8n +
                     // 2 tq4 + e
  uint32_t pr[32];   // P of the previous tile, bf16 pairs (A registers)

  auto fence_o = [&] {
#pragma unroll
    for (int hf = 0; hf < G::kHalves; ++hf) svt::fence_acc(o[hf]);
  };
  // S = Q K_j^T over the D dims.
  auto issue_s = [&](int j) {
    const unsigned char* kt = ks + (j % kStages) * G::kTileBytes;
    svt::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      const int off = (k16 >> 2) * kHalfBytes + 32 * (k16 & 3);
      svt::wgmma_ss_n128(s, svt::desc_sw128(qa + off),
                         svt::desc_sw128(kt + off), k16);
    }
    svt::wgmma_commit();
  };
  // O += P V_j, one n64 product a half of the dims.
  auto issue_pv = [&](int j) {
    const unsigned char* vt = vs + (j % kStages) * G::kTileBytes;
    svt::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kTile / 16; ++kq)
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf)
        svt::wgmma_rs_n64_mn(
            o[hf], pr + 4 * kq,
            svt::desc_sw128(vt + hf * kHalfBytes + 16 * kq * 128));
    svt::wgmma_commit();
  };
  // The online softmax of tile j in place in s: p = exp(s - max), the
  // running max and sum updated; alpha: the factor that takes O from the
  // old max to the new.
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int key0 = j * kTile;
    // Warpgroup-uniform: the diagonal tile and the ragged end tile are
    // masked; the two forms are separate code.
    const bool edge = j == t || key0 + kTile > length;
    // Each row's max and sum in four partial chains (n % 4), joined in a
    // fixed order: four times shorter dependent chains.
    float mx4[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx4[i][c] = -INFINITY;
    auto row_max = [&](auto masked) {
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        const int i = (k >> 1) & 1;
        if constexpr (decltype(masked)::value) {
          const int key = key0 + 8 * (k >> 2) + 2 * tq4 + (k & 1);
          s[k] = key < length && key <= row[i] ? s[k] : -INFINITY;
        }
        mx4[i][(k >> 2) & 3] = fmaxf(mx4[i][(k >> 2) & 3], s[k]);
      }
    };
    if (edge)
      row_max(std::true_type());
    else
      row_max(std::false_type());
    float mx[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(fmaxf(mx4[i][0], mx4[i][1]), fmaxf(mx4[i][2], mx4[i][3]));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sl2);
      // A row with no valid key so far keeps max -inf: ex2(-inf) = 0
      // then gives p = 0 and leaves the (zero) sums as they are.
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = svt::ex2(m[i] - m_use[i]);
      m[i] = m_new;
    }
    float sum4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const int i = (k >> 1) & 1;
      s[k] = svt::ex2(fmaf(s[k], sl2, -m_use[i]));
      sum4[i][(k >> 2) & 3] += s[k];
    }
    float sum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = (sum4[i][0] + sum4[i][1]) + (sum4[i][2] + sum4[i][3]);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
  };
  // P to bf16 A registers, once the value product that read them is done.
  auto pack = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(pr[i])::"memory");
#pragma unroll
    for (int i = 0; i < 32; ++i) pr[i] = svt::packf(s[2 * i], s[2 * i + 1]);
  };
  // Rescale O where some row's max moved (a factor of 1 is exact, so
  // skipping it changes no bit).
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
        for (int k = 0; k < 32; ++k) o[hf][k] *= alpha[(k >> 1) & 1];
    }
  };

  // The warpgroups take turns to issue their products (named barriers 1
  // and 2), so that one's softmax runs under the other's products: event
  // e of warpgroup 1 follows event e of warpgroup 0, which follows event
  // e - 1 of warpgroup 1. Each has tiles + 1 events.
  auto my_turn = [&] { svt::named_bar_sync(1 + wg, kConsumers); };
  auto your_turn = [&](bool last) {
    if (!(last && wg == 1)) svt::named_bar_arrive(2 - wg, kConsumers);
  };

  if (tiles > 0) {
    float alpha[2];
    if (wg == 1) svt::named_bar_arrive(1, kConsumers);
    svt::mbar_wait(&qfull, 0);
    svt::mbar_wait(kfull, 0);
    my_turn();
    issue_s(0);
    your_turn(false);
    svt::wgmma_wait<0>();
    svt::fence_acc(s);
    svt::mbar_arrive(kempty);
    softmax(0, alpha);  // O is zero: nothing to rescale
    pack();
#pragma unroll 1
    for (int j = 1; j < tiles; ++j) {
      const int slot = j % kStages;
      const int prev = (j - 1) % kStages;
      svt::mbar_wait(kfull + slot, (j / kStages) & 1);
      svt::mbar_wait(vfull + prev, ((j - 1) / kStages) & 1);
      my_turn();
      issue_s(j);
      issue_pv(j - 1);
      your_turn(false);
      svt::wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} runs on
      svt::fence_acc(s);
      svt::mbar_arrive(kempty + slot);
      softmax(j, alpha);
      svt::wgmma_wait<0>();
      fence_o();
      svt::mbar_arrive(vempty + prev);
      rescale(alpha);
      pack();
    }
    const int last = (tiles - 1) % kStages;
    svt::mbar_wait(vfull + last, ((tiles - 1) / kStages) & 1);
    my_turn();
    issue_pv(tiles - 1);
    your_turn(true);
    svt::wgmma_wait<0>();
    fence_o();
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  // A warp's 16 rows: o[hf][4n + 2i + e] is row 16 warp + lane / 4 + 8i
  // of the warpgroup's, column 64 hf + 8n + 2 tq4 + e.
  bf16* lo = p.out + ((size_t)row0 + q0 + 64 * wg + 16 * warp + (lane >> 2)) *
                         D + 2 * tq4;
  bf16* hi = lo + 8 * D;
#pragma unroll
  for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(lo + 64 * hf + 8 * n) =
          svt::packf(o[hf][4 * n] * inv[0], o[hf][4 * n + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(hi + 64 * hf + 8 * n) =
          svt::packf(o[hf][4 * n + 2] * inv[1], o[hf][4 * n + 3] * inv[1]);
    }
  if (tq4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      p.lse[(size_t)row0 + row[i]] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const FwdParams& p,
           cudaStream_t s) {
  using G = Fwd<D>;
  const long long rows = (long long)p.batch * p.heads * p.len;
  const long long ctas = rows / kTile;
  if (rows > 0x7fffffffLL || ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::MapCache<48> maps;
  CUtensorMap tq{}, tk{}, tv{};
  if (!maps.get(&tq, svt::kMapBf16, q, D, (int)rows, kTile) ||
      !maps.get(&tk, svt::kMapBf16, k, D, (int)rows, kTile) ||
      !maps.get(&tv, svt::kMapBf16, v, D, (int)rows, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  static svt::SmemLimit limit;
  const cudaError_t err =
      svt::raise_smem_limit(limit, causal_fwd_kernel<D>, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  causal_fwd_kernel<D><<<static_cast<unsigned>(ctas), kThreads, G::kSmem,
                         s>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: bf16 [B, H, L, Dh] contiguous, Dh 64 or 128, L a multiple
// of 128; lengths [B] int32; lse [B, H, L] fp32; group: the (head, row)
// pairs of a chunk of the grid, 1 .. B H.
extern "C" int svt_causal_fwd(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, void* lse,
                              int batch, int heads, int len, int head_dim,
                              int group, float scale, void* stream) {
  if (batch < 1 || heads < 1 || len <= 0 || len % kTile != 0 ||
      (head_dim != 64 && head_dim != 128) || group < 1 ||
      group > batch * heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams p{static_cast<const int*>(lengths),
                    static_cast<bf16*>(out),
                    static_cast<float*>(lse),
                    batch,
                    heads,
                    len,
                    group,
                    scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? launch<64>(q, k, v, p, s)
                        : launch<128>(q, k, v, p, s);
}
