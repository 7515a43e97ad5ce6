// K3b: the backward of the tied vocab projection fused with softmax
// cross-entropy, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_ce.py::_bwd (bodies _dg_kernel and
// _de_kernel). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/ce_kernel.py::tied_ce_bwd_plain; the chunk loop
// that drives these kernels is ce_kernel.py::tied_ce_bwd_chunked.
//
// What it computes. g [T, D] bf16, the tied table E [V, D] bf16, bias
// [V] fp32, labels [T], the forward's lse [T] and the incoming dnll [T]
// fp32 (0 on padding), at the model widths D = 512 (the Transformer-VAE)
// and D = 256 (the draft Transformer LM), one instantiation each. With
// x = g E^T + bias in fp32 and p = exp(x - lse):
//   dg[t] = sum_v bf16(p dnll[t]) E[v]                 (fp32 out),
//   dE[v] = sum_t bf16((p - [label t == v]) dnll[t]) g[t]  (fp32 out),
//   dbias[v] = the same sum of the unrounded terms.
// dg's -dnll E[label] term stays a gather in fp32 outside, as in the JAX
// package.
//
// What bounds it. At T = 102,400, V = 32,768, D = 512 the least work is
// the logits once and the two gradient products: 3 x 2 T V D = 10.3 TFLOP,
// against ~0.4 GB of inputs and outputs: operations, by far (10.4 ms at
// the bf16 peak). At D = 256 the operations halve: still operations.
//
// Design (a): the logits once, per token chunk. D = 512 makes a 128 x 512
// fp32 accumulator the whole register file of an SM, so one kernel cannot
// keep a tile's dg and dE sums resident; instead the logit gradients of a
// chunk of C tokens go to a bf16 scratch once and two products read them
// (design (b), two kernels that each recompute the logits, does 4 products
// where this does 3, for ~3 x T V 2 bytes of scratch traffic):
//   ce_dl_kernel: X = g_c E^T (K = D) and, in the epilogue, dl =
//        bf16((p - onehot) dnll) into the [C, V] scratch, the per-128-token
//        column sums of the unrounded terms (dbias partials), and for each
//        token fix[t] = bf16(p dnll) - bf16((p - 1) dnll) at its label, so
//        that dg = dl E + fix E[label] is exactly the sum of the dg terms;
//   ce_gemm_kernel<kDg>: dg_c = dl E (K = V), B = E^T, copied once a call;
//   ce_gemm_kernel<kDe>: dE (+)= dl^T g_c (K = C), B = g^T, copied once a
//        call; A = dl^T read from dl's tiles by ldmatrix.trans into
//        registers.
// The chunks run in a fixed order and every output tile has one owner, so
// there are no atomics and the result is deterministic; dbias sums its
// partials in order (ce_dbias_kernel). The caller bounds the scratch
// (<= 1 GB: 7 chunks of 14,720 tokens at V = 32,768).
//
// Every product is wgmma (bf16 in, fp32 accumulate) on tiles that TMA
// brings into shared memory in the 128-byte swizzle, in a ring of stages
// with mbarriers: one producer thread issues the loads, two consumer
// warpgroups issue the products and keep one stage's products in flight
// while releasing the stage before. ce_gemm_kernel: 128 x 256 output
// tiles (m64n256k16 per warpgroup), four 48 KB stages, one CTA per SM
// (197,696 bytes of dynamic shared memory, kGemmSmemBytes); at D = 256
// the output is one column tile wide.
// ce_dl_kernel: 128 token rows of g stay resident while 16 vocab tiles of
// 128 stream through a ring of 128 x 64 stages (three at D = 512, seven
// at D = 256, whose resident g takes half the shared memory); the two
// warpgroups take the tiles in turn and take turns on the tensor cores
// (named barriers), so one's exp / dl epilogue overlaps the other's
// products; setmaxnreg gives the consumers 232 registers; each 64-column
// half of a dl tile leaves by one TMA store from a swizzled staging buffer (218,168 and
// 218,232 bytes of dynamic shared memory at D = 512 and 256,
// DlGeometry::kSmemBytes). The TMA, mbarrier and wgmma helpers and the
// tensor maps (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no
// -lcuda) are csrc/hopper.cuh's, shared with K3 (csrc/tied_ce.cu), which
// runs the same logits mainloop as ce_dl_kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using svt::align_smem;
using svt::desc_sw128;
using svt::fence_acc;
using svt::ldsm_x4_t;
using svt::make_map;
using svt::mbar_arrive;
using svt::mbar_expect_tx;
using svt::mbar_fence_init;
using svt::mbar_init;
using svt::mbar_wait;
using svt::smem_u32;
using svt::tma_load;
using svt::wgmma_commit;
using svt::wgmma_fence;
using svt::wgmma_rs;
using svt::wgmma_ss;
using svt::wgmma_ss128;
using svt::wgmma_wait;

constexpr int kBK = 64;                  // depth per stage: one 128 B row
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kAlign = svt::kSwizzleAlign;

// The gradient products (ce_gemm_kernel): 128 x 256 output tiles.
constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kTileBytes = kBM * kBK * 2;  // A per stage
constexpr int kStageBytes = kTileBytes + kBN * kBK * 2;

constexpr int kStages = 4;                 // one CTA per SM
constexpr int kGemmSmemBytes =
    kAlign + kStages * kStageBytes + 2 * kStages * 8;

enum Mode { kDg = 0, kDe = 1 };

// The logit gradients (ce_dl_kernel): a CTA keeps 128 token rows of g
// resident (128 x D bf16) and streams the E rows of up to kDlMaxTiles
// vocab tiles of 128 through a ring of 128 x 64 stages; its two consumer
// warpgroups take the vocab tiles in turn, and each stores its dl tile
// through a 128 x 64 staging buffer, one half at a time.
constexpr int kDlRows = 128;
constexpr int kDlCols = 128;
constexpr int kDlMaxTiles = 16;            // vocab tiles per CTA at most
// A whole producer warpgroup (one thread of it issues the loads), so that
// setmaxnreg can move its registers to the consumers: 3 x 128 x 168 =
// 128 x 40 + 2 x 128 x 232.
constexpr int kDlThreads = kConsumers + 128;
constexpr int kBoxBytes = kDlRows * kBK * 2;   // one 128 x 64 box of g
constexpr int kHalfBytes = kBoxBytes / 2;      // its 64-row half
constexpr int kDlStageBytes = kDlCols * kBK * 2;
constexpr int kDlOutBytes = kDlRows * 64 * 2;  // half a dl tile, staged

// ce_dl_kernel's shared memory at the model width D: the resident g rows,
// the staging buffers, then as many ring stages as fit.
template <int D>
struct DlGeometry {
  static_assert(D % kBK == 0, "D is a multiple of the stage depth");
  static constexpr int kSteps = D / kBK;   // stages per vocab tile
  static constexpr int kGBytes = kDlRows * D * 2;
  static constexpr int kStages = D == 512 ? 3 : 7;
  static constexpr int kSmemBytes = kAlign + kGBytes + 2 * kDlOutBytes +
                                    kStages * kDlStageBytes +
                                    (2 * kStages + 1) * 8 +
                                    2 * 4 * kDlCols * 4;
  static_assert(kSmemBytes <= 232448, "one CTA's shared memory");
};

struct Params {
  const float* bias;     // [V]            (ce_dl_kernel)
  const float* lse;      // [T]
  const float* dnll;     // [T]
  const int* labels;     // [T]
  __nv_bfloat16* dl;     // [C, V] scratch
  float* part;           // [ceil(T / 128), V] dbias partials
  float* fix;            // [T]
  float* out;            // dg [T, D] (kDg) or dE [V, D] (kDe)
  int vocab;
  int chunk0;            // first token of the chunk
  int rows;              // tokens of the chunk
  int num_k;             // stages of depth kBK (ce_gemm_kernel)
  int tiles;             // vocab tiles per CTA (ce_dl_kernel)
  int accumulate;        // kDe: add into out (every chunk after the first)
};


// The gradient products, one 128 x 256 fp32 output tile per CTA:
//   kDg: dg[chunk0 + r] = dl[r] E; ta = dl [C, V], tb = E^T [D, V];
//   kDe: dE (+)= dl^T g_c; ta = dl [C, V] in 64 x 64 boxes, A = dl^T
//        read by ldmatrix.trans; tb = g^T [D, T'] (T' = T rounded up to
//        128, zero-filled).
// blockIdx.x walks the D / 256 column tiles of the D-wide output, so the
// CTAs of one row panel run together.
template <int MODE, int D>
__global__ void __launch_bounds__(kThreads, 1)
ce_gemm_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < p.num_k; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) mbar_wait(empty + s, ((kb / kStages) - 1) & 1);
        mbar_expect_tx(full + s, kStageBytes);
        unsigned char* a = base + s * kStageBytes;
        unsigned char* b = a + kTileBytes;
        const int k = kb * kBK;
        if (MODE == kDg) {
          tma_load(a, &ta, full + s, k, m0);
          tma_load(b, &tb, full + s, k, n0);
        } else {
          tma_load(a, &ta, full + s, m0, k);
          tma_load(a + kTileBytes / 2, &ta, full + s, m0 + 64, k);
          tma_load(b, &tb, full + s, p.chunk0 + k, n0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;          // consumer warpgroup
  const int warp = (threadIdx.x >> 5) & 3;  // warp within it
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;

  // One stage: wait for its tiles, issue its 4 products, and keep them
  // in flight while releasing the stage before it (whose products are
  // then done). kDe's A fragments alternate between two register sets,
  // since a product in flight still reads its set.
  auto step = [&](int kb, uint32_t(&af)[4][4]) {
    const int s = kb % kStages;
    mbar_wait(full + s, (kb / kStages) & 1);
    unsigned char* a = base + s * kStageBytes + wg * (kTileBytes / 2);
    unsigned char* b = base + s * kStageBytes + kTileBytes;
    if (MODE == kDe) {
      // A = dl^T: this warpgroup's box holds dl[64 tokens][64 vocab]
      // (rows of 128 bytes, 16-byte chunk c of row r at c ^ (r & 7)).
      // Matrices (vocab 0-7 | 8-15 of the warp) x (tokens 0-7 | 8-15 of
      // the k16 step), each read transposed.
      const int mat = lane >> 3;
      const int chunk = 2 * warp + (mat & 1);
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16) {
        const int tok = 16 * k16 + 8 * (mat >> 1) + (lane & 7);
        ldsm_x4_t(af[k16],
                  smem_u32(a) + tok * 128 + ((chunk ^ (tok & 7)) << 4));
      }
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_rs(d, af[k16], desc_sw128(b + 32 * k16));
    } else {
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_ss(d, desc_sw128(a + 32 * k16), desc_sw128(b + 32 * k16));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(d);
    if (kb > 0) mbar_arrive(empty + (kb - 1) % kStages);
  };
  uint32_t af0[4][4], af1[4][4];
  for (int kb = 0; kb < p.num_k; kb += 2) {
    step(kb, af0);
    if (kb + 1 < p.num_k) step(kb + 1, af1);
  }
  wgmma_wait<0>();
  fence_acc(d);

  // d[4j + 2i + e]: row r0 + 8i, column n0 + 8j + 2tq + e.
  const int r0 = m0 + wg * 64 + warp * 16 + gq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (MODE == kDg && r >= p.rows) continue;
    float* row = p.out + (size_t)(MODE == kDg ? p.chunk0 + r : r) * D;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float2* o = reinterpret_cast<float2*>(row + n0 + 8 * j + 2 * tq);
      float2 v = make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      if (MODE == kDe && p.accumulate) {
        const float2 old = *o;
        v.x += old.x;
        v.y += old.y;
      }
      *o = v;
    }
  }
}

// The logit gradients of one chunk: token rows [m0, m0 + 128) of the
// chunk (blockIdx.x) against p.tiles vocab tiles of 128 from v0
// (blockIdx.y). tg = g [T, D] in 64 x 128 boxes, te = E [V, D] in
// 64 x 128 boxes, tdl = dl [C, V] in 64 x 128 boxes (stores). The producer
// loads the g rows once, then each vocab tile's D / 64 stages in order;
// warpgroup w takes tiles w, w + 2, ... and the two take turns on the
// tensor cores, so one's exp / dl epilogue runs beside the other's
// products. The epilogue writes each 64-column half of the bf16 dl tile
// into shared memory in the 128-byte swizzle and one thread stores it
// with TMA; it also writes fix at each token's label and the tile's
// column sums of the unrounded terms into part.
template <int D>
__global__ void __launch_bounds__(kDlThreads, 1)
ce_dl_kernel(const __grid_constant__ CUtensorMap tg,
             const __grid_constant__ CUtensorMap te,
             const __grid_constant__ CUtensorMap tdl, const Params p) {
  using G = DlGeometry<D>;
  constexpr int kDlStages = G::kStages;
  constexpr int kGBytes = G::kGBytes;
  constexpr int kSteps = G::kSteps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* gs = align_smem(smem_raw);
  unsigned char* staged = gs + kGBytes;             // [2][128 x 64] bf16
  unsigned char* ring = staged + 2 * kDlOutBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDlStages *
                                               kDlStageBytes);
  uint64_t* empty = full + kDlStages;
  uint64_t* gfull = empty + kDlStages;
  float* red = reinterpret_cast<float*>(gfull + 1);  // [2][4][128]
  const int m0 = blockIdx.x * kDlRows;
  const int v0 = blockIdx.y * p.tiles * kDlCols;
  const int steps = p.tiles * kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDlStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_init(gfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Registers move from the producer warpgroup to the consumers, whose
  // 128 accumulators and epilogue need more than an even share.
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(gfull, kGBytes);
      for (int kb = 0; kb < kSteps; ++kb)
        tma_load(gs + kb * kBoxBytes, &tg, gfull, kb * kBK, p.chunk0 + m0);
      for (int q = 0; q < steps; ++q) {
        const int s = q % kDlStages;
        if (q >= kDlStages) mbar_wait(empty + s, ((q / kDlStages) - 1) & 1);
        mbar_expect_tx(full + s, kDlStageBytes);
        tma_load(ring + s * kDlStageBytes, &te, full + s,
                 (q % kSteps) * kBK, v0 + (q / kSteps) * kDlCols);
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
  const bool leader = (threadIdx.x & 127) == 0;
  const int bar_wg = 1 + wg;            // this warpgroup's named barrier
  float* wred = red + wg * 4 * kDlCols;
  unsigned char* out = staged + wg * kDlOutBytes;
  constexpr float kLog2e = 1.4426950408889634f;

  // The four token rows of this thread, hi = 2h + i: tile row
  // 64h + 16 warp + gq + 8i. Past the chunk's tokens dnll is 0 (so dl is
  // 0) and the label -1.
  int row[4], label_r[4];
  float nlse[4], dnll_r[4];
#pragma unroll
  for (int hi = 0; hi < 4; ++hi) {
    row[hi] = 64 * (hi >> 1) + 16 * warp + gq + 8 * (hi & 1);
    const bool in = m0 + row[hi] < p.rows;
    const int t = p.chunk0 + (in ? m0 + row[hi] : 0);
    nlse[hi] = -p.lse[t] * kLog2e;
    dnll_r[hi] = in ? p.dnll[t] : 0.f;
    label_r[hi] = in ? p.labels[t] : -1;
  }
  mbar_wait(gfull, 0);

  for (int j = wg, k = 0; j < p.tiles; j += 2, ++k) {
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
      const int s = q % kDlStages;
      mbar_wait(full + s, (q / kDlStages) & 1);
      unsigned char* b = ring + s * kDlStageBytes;
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
      if (kb > 0) mbar_arrive(empty + (q - 1) % kDlStages);
    }
    if (j + 1 < p.tiles)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    mbar_arrive(empty + (j * kSteps + kSteps - 1) % kDlStages);

    const int vt = v0 + j * kDlCols;
    float p_label[4] = {0.f, 0.f, 0.f, 0.f};
    bool at_label[4] = {false, false, false, false};
    // Two halves of 64 columns, each staged and stored on its own; the
    // math is branch-free so the compiler can interleave its exps.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t packed[8][4];
      float cs[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int nn = 8 * c + n;
        const int col = vt + 8 * nn + 2 * tq;
        const float2 bias = *reinterpret_cast<const float2*>(p.bias + col);
        const float bl[2] = {bias.x * kLog2e, bias.y * kLog2e};
        cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
        for (int hi = 0; hi < 4; ++hi) {
          float de[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // p = exp(x + bias - lse), x the product.
            const float pr =
                svt::ex2(fmaf(acc[hi >> 1][4 * nn + 2 * (hi & 1) + e],
                              kLog2e, bl[e] + nlse[hi]));
            const bool hit = label_r[hi] == col + e;
            de[e] = fmaf(pr, dnll_r[hi], hit ? -dnll_r[hi] : 0.f);
            p_label[hi] = hit ? pr : p_label[hi];
            at_label[hi] |= hit;
            cs[n][e] += de[e];
          }
          const __nv_bfloat162 pair = __floats2bfloat162_rn(de[0], de[1]);
          packed[n][hi] = *reinterpret_cast<const uint32_t*>(&pair);
        }
      }
      // The staging buffer is free once this warpgroup's previous store
      // has read it.
      if (leader)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_wg) : "memory");
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hi = 0; hi < 4; ++hi) {
          // Row r, 16-byte chunk n at n ^ (r & 7), this pair at 4 tq.
          const int r = row[hi];
          *reinterpret_cast<uint32_t*>(out + r * 128 +
                                       ((n ^ (r & 7)) << 4) + 4 * tq) =
              packed[n][hi];
        }
      // Column sums over the warp's rows (lanes of equal tq), in a fixed
      // order.
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cs[n][e] += __shfl_xor_sync(0xffffffffu, cs[n][e], 4);
          cs[n][e] += __shfl_xor_sync(0xffffffffu, cs[n][e], 8);
          cs[n][e] += __shfl_xor_sync(0xffffffffu, cs[n][e], 16);
        }
      if (gq == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(wred + warp * kDlCols + 64 * c +
                                     8 * n + 2 * tq) =
              make_float2(cs[n][0], cs[n][1]);
      }
      // This half to the scratch by TMA, once every thread's writes are
      // visible to the async proxy.
      svt::fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_wg) : "memory");
      if (leader) {
        asm volatile(
            "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
            " [%0, {%2, %3}], [%1];\n" ::"l"(
                reinterpret_cast<uint64_t>(&tdl)),
            "r"(smem_u32(out)), "r"(vt + 64 * c), "r"(m0)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    const int col = threadIdx.x & 127;
    p.part[(size_t)((p.chunk0 + m0) / kDlRows) * p.vocab + vt + col] =
        wred[col] + wred[kDlCols + col] + wred[2 * kDlCols + col] +
        wred[3 * kDlCols + col];
    // fix = bf16(p dnll) - bf16((p - 1) dnll) at the label, the second
    // term as dl holds it.
#pragma unroll
    for (int hi = 0; hi < 4; ++hi)
      if (at_label[hi])
        p.fix[p.chunk0 + m0 + row[hi]] =
            __bfloat162float(__float2bfloat16(p_label[hi] * dnll_r[hi])) -
            __bfloat162float(__float2bfloat16(
                fmaf(p_label[hi], dnll_r[hi], -dnll_r[hi])));
  }
  // Shared memory must outlive the last store's reads.
  if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// dbias[v] = sum over token tiles i, in order, of part[i][v].
__global__ void ce_dbias_kernel(const float* __restrict__ part,
                                float* __restrict__ dbias, int tiles,
                                int vocab) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vocab) return;
  float s = 0.f;
  for (int i = 0; i < tiles; ++i) s += part[(size_t)i * vocab + v];
  dbias[v] = s;
}

template <int MODE, int D>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const Params& p,
           dim3 grid, cudaStream_t stream) {
  static svt::SmemLimit limit;
  const cudaError_t err =
      svt::raise_smem_limit(limit, ce_gemm_kernel<MODE, D>, kGemmSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_gemm_kernel<MODE, D><<<grid, kThreads, kGemmSmemBytes, stream>>>(
      ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadValue = static_cast<int>(cudaErrorInvalidValue);

bool bad_chunk(int tokens, int vocab, int dim, int chunk0, int rows,
               int dl_rows) {
  return tokens < 1 || vocab < kBM || vocab % kBM != 0 ||
         (dim != 256 && dim != 512) || chunk0 < 0 || chunk0 % kBM != 0 ||
         rows < 1 || chunk0 + rows > tokens || dl_rows % kBM != 0 ||
         (rows + kBM - 1) / kBM * kBM > dl_rows;
}

// ce_dl_kernel<D> over chunk [chunk0, chunk0 + rows): the tensor maps, the
// vocab tiles per CTA (the largest divisor of V / 128 up to kDlMaxTiles)
// and the launch.
template <int D>
int launch_dl(const void* g, const void* table, void* dl, Params p,
              int tokens, int dl_rows, cudaStream_t stream) {
  using G = DlGeometry<D>;
  CUtensorMap tg, te, tdl;
  if (!make_map(&tg, g, D, tokens, kDlRows) ||
      !make_map(&te, table, D, p.vocab, kDlCols) ||
      !make_map(&tdl, dl, p.vocab, dl_rows, kDlRows))
    return kBadValue;
  int tiles = kDlMaxTiles;
  while ((p.vocab / kDlCols) % tiles) --tiles;
  p.tiles = tiles;
  static svt::SmemLimit limit;
  const cudaError_t err =
      svt::raise_smem_limit(limit, ce_dl_kernel<D>, G::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.rows + kDlRows - 1) / kDlRows,
                  p.vocab / (kDlCols * tiles));
  ce_dl_kernel<D><<<grid, kDlThreads, G::kSmemBytes, stream>>>(tg, te, tdl,
                                                              p);
  return static_cast<int>(cudaGetLastError());
}

// dg[chunk0 .. chunk0 + rows) = dl[:rows] E at width D.
template <int D>
int launch_dg(const void* dl, const void* table_t, Params p, int dl_rows,
              cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!make_map(&ta, dl, p.vocab, dl_rows, kBM) ||
      !make_map(&tb, table_t, p.vocab, D, kBN))
    return kBadValue;
  p.num_k = p.vocab / kBK;
  return launch<kDg, D>(ta, tb, p, dim3(D / kBN, (p.rows + kBM - 1) / kBM),
                        stream);
}

// dE (+)= dl[:rows']^T g_c at width D.
template <int D>
int launch_de(const void* dl, const void* g_t, Params p, int tokens_padded,
              int dl_rows, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!make_map(&ta, dl, p.vocab, dl_rows, 64) ||
      !make_map(&tb, g_t, tokens_padded, D, kBN))
    return kBadValue;
  p.num_k = (p.rows + kBM - 1) / kBM * (kBM / kBK);
  return launch<kDe, D>(ta, tb, p, dim3(D / kBN, p.vocab / kBM), stream);
}

}  // namespace

// Chunk [chunk0, chunk0 + rows) of g [tokens, dim] (dim 256 or 512): dl
// [dl_rows, V] bf16 (rows past the chunk's last token, up to its last
// 128-row tile, are written 0), the dbias partials of its token tiles in
// part [ceil(T / 128), V] fp32, and fix[t] for its tokens.
extern "C" int svt_tied_ce_bwd_dl(const void* g, const void* table,
                                  const void* bias, const void* lse,
                                  const void* dnll, const void* labels,
                                  void* dl, void* part, void* fix,
                                  int tokens, int vocab, int dim, int chunk0,
                                  int rows, int dl_rows, void* stream) {
  if (bad_chunk(tokens, vocab, dim, chunk0, rows, dl_rows)) return kBadValue;
  Params p{};
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.dnll = static_cast<const float*>(dnll);
  p.labels = static_cast<const int*>(labels);
  p.dl = static_cast<__nv_bfloat16*>(dl);
  p.part = static_cast<float*>(part);
  p.fix = static_cast<float*>(fix);
  p.vocab = vocab;
  p.chunk0 = chunk0;
  p.rows = rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dim == 256 ? launch_dl<256>(g, table, dl, p, tokens, dl_rows, s)
                    : launch_dl<512>(g, table, dl, p, tokens, dl_rows, s);
}

// dg[chunk0 .. chunk0 + rows) = dl[:rows] E, fp32; table_t = E^T
// [dim, V].
extern "C" int svt_tied_ce_bwd_dg(const void* dl, const void* table_t,
                                  void* dg, int tokens, int vocab, int dim,
                                  int chunk0, int rows, int dl_rows,
                                  void* stream) {
  if (bad_chunk(tokens, vocab, dim, chunk0, rows, dl_rows)) return kBadValue;
  Params p{};
  p.out = static_cast<float*>(dg);
  p.vocab = vocab;
  p.chunk0 = chunk0;
  p.rows = rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dim == 256 ? launch_dg<256>(dl, table_t, p, dl_rows, s)
                    : launch_dg<512>(dl, table_t, p, dl_rows, s);
}

// dE (+)= dl[:rows']^T g[chunk0 .. chunk0 + rows'), rows' = rows rounded
// up to 128; g_t = g^T [dim, tokens_padded] with zero columns past T.
extern "C" int svt_tied_ce_bwd_de(const void* dl, const void* g_t, void* de,
                                  int tokens, int tokens_padded, int vocab,
                                  int dim, int chunk0, int rows, int dl_rows,
                                  int accumulate, void* stream) {
  if (bad_chunk(tokens, vocab, dim, chunk0, rows, dl_rows) ||
      tokens_padded % kBM != 0 ||
      tokens_padded < (tokens + kBM - 1) / kBM * kBM)
    return kBadValue;
  Params p{};
  p.out = static_cast<float*>(de);
  p.vocab = vocab;
  p.chunk0 = chunk0;
  p.rows = rows;
  p.accumulate = accumulate;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dim == 256
             ? launch_de<256>(dl, g_t, p, tokens_padded, dl_rows, s)
             : launch_de<512>(dl, g_t, p, tokens_padded, dl_rows, s);
}

// dbias [V] from the partials of `tiles` token tiles.
extern "C" int svt_tied_ce_bwd_dbias(const void* part, void* dbias,
                                     int tiles, int vocab, void* stream) {
  if (tiles < 1 || vocab < 1) return kBadValue;
  ce_dbias_kernel<<<(vocab + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), tiles,
      vocab);
  return static_cast<int>(cudaGetLastError());
}
