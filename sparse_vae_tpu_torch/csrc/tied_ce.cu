// K3: the tied vocab projection fused with softmax cross-entropy, forward,
// for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_ce.py::_fwd (body _fwd_kernel). Its
// plain PyTorch version is sparse_vae_tpu_torch/ops/ce_kernel.py::
// tied_ce_fwd_plain. The backward (K3b, pallas_ce.py::_bwd) is
// csrc/tied_ce_bwd.cu.
//
// What it computes. g [T, D] bf16 (the decoder's pre-logits), the tied
// table E [V, D] bf16 (the input embedding), bias [V] fp32, at the model
// widths D = 512 (the Transformer-VAE) and D = 256 (the draft Transformer
// LM), one instantiation each. Logits x = g E^T + bias are fp32 (the bf16
// products summed in fp32, then the fp32 bias) and never leave the chip:
// lse[t] = logsumexp_v x[t, v] (online max and sum of exp). The label logit
// (nll = lse - g . E[label] - bias[label]) is a gather done outside, in
// fp32, as in the JAX package.
//
// What bounds it. At T = 102,400, V = 32,768, D = 512 it is 2 T V D = 3.4
// TFLOP against ~137 MB of inputs: operations, by far (3.5 ms at the bf16
// peak). At D = 256 the operations halve and the bytes barely move, still
// operations by ~90x.
//
// Design: K3b's logits mainloop (ce_dl_kernel, csrc/tied_ce_bwd.cu) with
// an online logsumexp for its epilogue. A CTA keeps 128 token rows of g
// resident (128 x D bf16, brought in by TMA in the 128-byte swizzle as
// D / 64 boxes of 128 x 64) and streams the E rows of its vocab tiles of
// 128 through a ring of 128 x 64 stages (16 KB each) with mbarriers: six
// stages at D = 512, ten at D = 256, whose resident g takes half the
// shared memory. One thread of a producer warpgroup issues the loads; two
// consumer warpgroups take the vocab tiles in turn and take turns on the
// tensor cores (named barriers), each computing its 128 x 128 tile of
// X = g E^T by wgmma (m64n128k16, bf16 in, fp32 accumulate), so one
// warpgroup's epilogue (bias, running max, sum of exp2) overlaps the
// other's products. setmaxnreg gives the consumers 232 registers. Each
// thread keeps a running (max, sum) for each of its four rows over its own
// columns; the four threads of a row, then the two warpgroups, merge
// theirs once at the end. 231,528 (D = 512) and 231,592 (D = 256) bytes
// of dynamic shared memory (Geometry::kSmemBytes): one CTA per SM.
//
// The vocab axis splits over blockIdx.y when the 128-token row tiles alone
// fill the SMs badly (the caller chooses the split: ce_kernel.fwd_splits);
// each split writes its rows' (max, sum) partials and a second kernel
// merges them in split order. Every value has one owner and every sum a
// fixed order: no atomics, and a second call is bit-identical. Rows past T
// read zeros (TMA's out-of-bounds fill) and are not written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using svt::align_smem;
using svt::desc_sw128;
using svt::ex2;
using svt::fence_acc;
using svt::make_map;
using svt::mbar_arrive;
using svt::mbar_expect_tx;
using svt::mbar_fence_init;
using svt::mbar_init;
using svt::mbar_wait;
using svt::tma_load;
using svt::wgmma_commit;
using svt::wgmma_fence;
using svt::wgmma_ss128;
using svt::wgmma_wait;

constexpr int kBK = 64;                   // depth per stage: one 128 B row
constexpr int kRows = 128;                // resident token rows per CTA
constexpr int kCols = 128;                // vocab rows per tile
constexpr int kConsumers = 256;           // two warpgroups
// A whole producer warpgroup (one thread of it issues the loads), so that
// setmaxnreg can move its registers to the consumers: 3 x 128 x 168 =
// 128 x 40 + 2 x 128 x 232.
constexpr int kThreads = kConsumers + 128;
constexpr int kBoxBytes = kRows * kBK * 2;   // one 128 x 64 box of g
constexpr int kHalfBytes = kBoxBytes / 2;    // its 64-row half
constexpr int kStageBytes = kCols * kBK * 2;

// The shared memory of the model width D: the resident g rows, then as
// many ring stages as fit beside them.
template <int D>
struct Geometry {
  static_assert(D % kBK == 0, "D is a multiple of the stage depth");
  static constexpr int kSteps = D / kBK;  // stages per vocab tile
  static constexpr int kGBytes = kRows * D * 2;
  static constexpr int kStages = D == 512 ? 6 : 10;
  static constexpr int kSmemBytes = svt::kSwizzleAlign + kGBytes +
                                    kStages * kStageBytes +
                                    (2 * kStages + 1) * 8 + kRows * 8;
  static_assert(kSmemBytes <= 232448, "one CTA's shared memory");
};
constexpr int kMaxSplits = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Two running (max, sum) pairs of one row, in log2 units, as one: the
// first keeps the result. Symmetric, so both lanes of a shuffle agree.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mx = fmaxf(m, m2);
  l = l * ex2(m - mx) + l2 * ex2(m2 - mx);
  m = mx;
}

// Token rows [m0, m0 + 128) (blockIdx.x) against `tiles` vocab tiles of
// 128 from v0 = blockIdx.y * tiles * 128. tg = g [T, D] and te = E
// [V, D], both in 64 x 128 boxes. With one split the CTA writes lse;
// otherwise part[blockIdx.y][t] = (max, sum) in log2 units.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tied_ce_kernel(const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap te,
               const float* __restrict__ bias, float* __restrict__ lse,
               float2* __restrict__ part, int tokens, int tiles) {
  using G = Geometry<D>;
  constexpr int kStages = G::kStages;
  constexpr int kGBytes = G::kGBytes;
  constexpr int kSteps = G::kSteps;       // stages per vocab tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* gs = align_smem(smem_raw);
  unsigned char* ring = gs + kGBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* gfull = empty + kStages;
  float2* red = reinterpret_cast<float2*>(gfull + 1);  // [kRows], wg 1's
  const int m0 = blockIdx.x * kRows;
  const int v0 = blockIdx.y * tiles * kCols;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_init(gfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(gfull, kGBytes);
      for (int kb = 0; kb < kSteps; ++kb)
        tma_load(gs + kb * kBoxBytes, &tg, gfull, kb * kBK, m0);
      for (int q = 0; q < tiles * kSteps; ++q) {
        const int s = q % kStages;
        if (q >= kStages) mbar_wait(empty + s, ((q / kStages) - 1) & 1);
        mbar_expect_tx(full + s, kStageBytes);
        tma_load(ring + s * kStageBytes, &te, full + s, (q % kSteps) * kBK,
                 v0 + (q / kSteps) * kCols);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // The running (max, sum) of this thread's four rows, hi = 2h + i: tile
  // row 64h + 16 warp + gq + 8i, over this thread's columns.
  float m_run[4], l_run[4];
#pragma unroll
  for (int hi = 0; hi < 4; ++hi) {
    m_run[hi] = -INFINITY;
    l_run[hi] = 0.f;
  }
  mbar_wait(gfull, 0);

  for (int j = wg, k = 0; j < tiles; j += 2, ++k) {
    // The warpgroups take turns on the tensor cores (named barriers 3 and
    // 4: warpgroup w waits on 3 + w, the other one arrives there when its
    // products are issued). The turns also keep the shared ring safe: a
    // warpgroup waits on a stage only after every earlier phase of it
    // has completed.
    if (wg == 1 || k > 0)
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
    // acc[h][4n + 2i + e]: tile row 64h + 16 warp + gq + 8i, column
    // vt + 8n + 2tq + e.
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    for (int kb = 0; kb < kSteps; ++kb) {
      const int q = j * kSteps + kb;
      const int s = q % kStages;
      mbar_wait(full + s, (q / kStages) & 1);
      unsigned char* b = ring + s * kStageBytes;
      unsigned char* a = gs + kb * kBoxBytes;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_ss128(acc[h],
                      desc_sw128(a + h * kHalfBytes + 32 * k16),
                      desc_sw128(b + 32 * k16));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (kb > 0) mbar_arrive(empty + (q - 1) % kStages);
    }
    if (j + 1 < tiles)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    mbar_arrive(empty + (j * kSteps + kSteps - 1) % kStages);

    // Logits in log2 units, x log2(e) + bias log2(e); then each row's
    // running max and sum of exp2, in a fixed order.
    const int vt = v0 + j * kCols;
    float bl[16][2];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 b2 =
          *reinterpret_cast<const float2*>(bias + vt + 8 * n + 2 * tq);
      bl[n][0] = b2.x * kLog2e;
      bl[n][1] = b2.y * kLog2e;
    }
#pragma unroll
    for (int hi = 0; hi < 4; ++hi) {
      const int h = hi >> 1, c = 2 * (hi & 1);
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = acc[h][4 * n + c + e];
          x = fmaf(x, kLog2e, bl[n][e]);
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m_run[hi], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += ex2(acc[h][4 * n + c + e] - m_new);
      l_run[hi] = l_run[hi] * ex2(m_run[hi] - m_new) + sum;
      m_run[hi] = m_new;
    }
  }

  // The four threads of each row, then the two warpgroups (warpgroup 1
  // holds no tile when tiles == 1).
#pragma unroll
  for (int hi = 0; hi < 4; ++hi)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      merge(m_run[hi], l_run[hi],
            __shfl_xor_sync(0xffffffffu, m_run[hi], off),
            __shfl_xor_sync(0xffffffffu, l_run[hi], off));
  const int row0 = 16 * warp + gq;
  if (wg == 1 && tq == 0) {
#pragma unroll
    for (int hi = 0; hi < 4; ++hi)
      red[row0 + 64 * (hi >> 1) + 8 * (hi & 1)] =
          make_float2(m_run[hi], l_run[hi]);
  }
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
  if (wg == 0 && tq == 0) {
#pragma unroll
    for (int hi = 0; hi < 4; ++hi) {
      const int r = row0 + 64 * (hi >> 1) + 8 * (hi & 1);
      if (m0 + r >= tokens) continue;
      float m = m_run[hi], l = l_run[hi];
      if (tiles > 1) merge(m, l, red[r].x, red[r].y);
      if (gridDim.y == 1)
        lse[m0 + r] = (m + log2f(l)) * kLn2;
      else
        part[(size_t)blockIdx.y * tokens + m0 + r] = make_float2(m, l);
    }
  }
}

// lse[t] from the splits' partials part[s][t], merged in split order.
__global__ void tied_ce_merge_kernel(const float2* __restrict__ part,
                                     float* __restrict__ lse, int tokens,
                                     int splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tokens) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[(size_t)s * tokens + t].x);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 p = part[(size_t)s * tokens + t];
    l += p.y * ex2(p.x - m);
  }
  lse[t] = (m + log2f(l)) * kLn2;
}

bool bad_shape(int tokens, int vocab, int splits) {
  return tokens < 1 || splits < 1 || splits > kMaxSplits ||
         vocab < kCols * splits || vocab % (kCols * splits) != 0;
}

// The D instantiation's launch, with its own once-per-device shared-memory
// limit.
template <int D>
cudaError_t launch(const void* g, const void* table, const float* bias,
                   float* lse, float2* part, int tokens, int vocab,
                   int splits, cudaStream_t s) {
  using G = Geometry<D>;
  CUtensorMap tg, te;
  if (!make_map(&tg, g, D, tokens, kRows) ||
      !make_map(&te, table, D, vocab, kCols))
    return cudaErrorInvalidValue;
  static svt::SmemLimit limit;
  const cudaError_t err =
      svt::raise_smem_limit(limit, tied_ce_kernel<D>, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((tokens + kRows - 1) / kRows, splits);
  tied_ce_kernel<D><<<grid, kThreads, G::kSmemBytes, s>>>(
      tg, te, bias, lse, part, tokens, vocab / (kCols * splits));
  return cudaSuccess;
}

}  // namespace

// g [tokens, dim] bf16, table [vocab, dim] bf16, bias [vocab] fp32 ->
// lse [tokens] fp32, dim 256 or 512, the vocab split `splits` ways; part
// [splits, tokens] float2 is scratch (unused with one split).
extern "C" int svt_tied_ce_fwd(const void* g, const void* table,
                               const void* bias, void* lse, void* part,
                               int tokens, int vocab, int dim, int splits,
                               void* stream) {
  if (bad_shape(tokens, vocab, splits) || (dim != 256 && dim != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const float*>(bias);
  const auto l = static_cast<float*>(lse);
  const auto pt = static_cast<float2*>(part);
  const cudaError_t err =
      dim == 256 ? launch<256>(g, table, b, l, pt, tokens, vocab, splits, s)
                 : launch<512>(g, table, b, l, pt, tokens, vocab, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1)
    tied_ce_merge_kernel<<<(tokens + 255) / 256, 256, 0, s>>>(
        static_cast<const float2*>(part), static_cast<float*>(lse), tokens,
        splits);
  return static_cast<int>(cudaGetLastError());
}
