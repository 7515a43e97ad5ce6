// K3 and K3b: the tied vocab projection fused with softmax cross-entropy,
// forward and backward, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_ce.py::_fwd (body _fwd_kernel) and
// ::_bwd (bodies _dg_kernel and _de_kernel). Their plain PyTorch versions
// are sparse_vae_tpu_torch/ops/ce_kernel.py::tied_ce_fwd_plain and
// ::tied_ce_bwd_plain.
//
// What they compute. g [T, 512] bf16 (the decoder's pre-logits), the tied
// table E [V, 512] bf16 (the input embedding), bias [V] fp32. Logits
// x = g E^T + bias are fp32 (the bf16 products summed in fp32, then the
// fp32 bias) and never leave the chip:
//   forward: lse[t] = logsumexp_v x[t, v] (online max and sum of exp);
//   dg:      dg[t] = sum_v bf16(exp(x - lse[t]) dnll[t]) E[v], fp32 out;
//   dE:      dE[v] = sum_t bf16((exp(x - lse[t]) - [label t == v]) dnll[t])
//            g[t], fp32 out, and dbias[v] = the same sum of the unrounded
//            terms.
// The label logit (nll = lse - g . E[label] - bias[label]) and dg's
// -dnll E[label] term are gathers done outside, in fp32, as in the JAX
// package: the two dg terms nearly cancel for well-predicted tokens, so
// they meet in fp32 and round once.
//
// What bounds them. At T = 102,400, V = 32,768, D = 512 the forward is
// 2 T V D = 3.4 TFLOP against ~137 MB of inputs, and each backward kernel
// twice that: operations, by far.
//
// Design. One kernel template serves all three. A CTA keeps a tile of
// RT = kRows = 64 "resident" rows (tokens for the forward and dg, vocab
// rows for dE) in shared memory and streams the other matrix through it
// in tiles of 64 rows, double-buffered with cp.async. Each stream step is
//   phase A: X = R S^T on the tensor cores (mma.sync m16n8k16, bf16 in,
//            fp32 accumulate), 8 warps tiling the RT x 64 block;
//   then, by mode, the online max/sum-exp (forward), or dl = the
//   gradient of the logits rounded to bf16 into shared memory, and
//   phase B: acc += dl S, each warp owning 64 of the 512 output columns
//            for all RT rows.
// Every row's sum lives in one CTA, so there are no atomics and the
// results are deterministic. The forward's per-warp column partials (m, l)
// merge once at the end. Operands reach the registers by ldmatrix (the
// transposed form for phase B's streamed operand); shared memory rows are
// padded by 8 bf16 so its eight row reads hit distinct banks. mma.sync rather than wgmma/TMA:
// simple first; those are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDim = 512;               // model width D
// Resident rows per CTA. 64 rather than 32 (both measured on the H100):
// half the re-reads of the streamed matrix, 208 registers, no spills.
constexpr int kRows = 64;
constexpr int kRow = kDim + 8;          // smem row stride, bf16
constexpr int kST = 64;                 // streamed rows per step
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDlRow = kST + 8;         // dl tile row stride, bf16
constexpr int kVec = kDim / 8;          // 16-byte vectors per row

enum Mode { kFwd = 0, kDg = 1, kDe = 2 };

template <int RT, int MODE>
constexpr int smem_bytes() {
  return (RT * kRow + 2 * kST * kRow) * 2 +
         (MODE == kFwd ? 0 : RT * kDlRow * 2) +
         2 * (kWarps / (RT / 16)) * RT * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows) of a [count, kDim] bf16 matrix into shared
// memory at stride kRow; rows past `count` are zero-filled.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ src,
                                          int row0, int rows, int count,
                                          __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = i % kVec;
    __nv_bfloat16* d = dst + r * kRow + c * 8;
    if (row0 + r < count)
      cp_async16(d, src + (size_t)(row0 + r) * kDim + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8m..8m+7 give matrix m's rows): r[m] is each lane's pair of
// matrix m in the mma.sync fragment layout. _t transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// R: [r_count, kDim] resident rows; S: [s_count, kDim] streamed rows.
// Forward and dg: R = g (tokens), S = E (vocab). dE: R = E, S = g.
// out: fp32 [r_count] lse (forward) or [r_count, kDim] (dg, dE);
// out_bias: fp32 [V] dbias (dE only).
template <int RT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
tied_ce_kernel(const __nv_bfloat16* __restrict__ R, int r_count,
               const __nv_bfloat16* __restrict__ S, int s_count,
               const float* __restrict__ bias,
               const float* __restrict__ lse,
               const float* __restrict__ dnll,
               const int* __restrict__ labels, float* __restrict__ out,
               float* __restrict__ out_bias) {
  constexpr int WM = RT / 16;         // warp rows in phase A
  constexpr int WN = kWarps / WM;     // warp columns in phase A
  constexpr int WC = kST / WN;        // streamed rows per warp
  constexpr int NT = WC / 8;          // mma n-tiles per warp in phase A
  constexpr int MT = RT / 16;         // mma m-tiles in phase B

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ss0 = rs + RT * kRow;
  __nv_bfloat16* ss1 = ss0 + kST * kRow;
  __nv_bfloat16* dls = ss1 + kST * kRow;
  float* stats = reinterpret_cast<float*>(
      dls + (MODE == kFwd ? 0 : RT * kDlRow));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;           // mma group (row within 8)
  const int tq = lane & 3;            // thread within the group
  const int l8 = lane & 7;            // ldmatrix: row within a matrix
  const int lm = lane >> 3;           // ldmatrix: which of the 4 matrices
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int r0 = blockIdx.x * RT;     // first resident row of this CTA
  const int n_steps = (s_count + kST - 1) / kST;

  load_rows(R, r0, RT, r_count, rs);
  load_rows(S, 0, kST, s_count, ss0);
  cp_async_commit();

  // The two resident rows this thread holds in phase A.
  int arow[2];
  arow[0] = r0 + wm * 16 + gq;
  arow[1] = arow[0] + 8;
  float row_a[2], row_b[2];  // per row: (lse, dnll) for dg, bias for dE
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float db_part[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = arow[i] < r_count;
    if (MODE == kDg) {
      row_a[i] = in ? lse[arow[i]] : 0.f;
      row_b[i] = in ? dnll[arow[i]] : 0.f;
    } else if (MODE == kDe) {
      row_a[i] = in ? bias[arow[i]] : 0.f;
      row_b[i] = 0.f;
    } else {
      row_a[i] = row_b[i] = 0.f;
    }
  }

  float acc[MODE == kFwd ? 1 : MT][8][4];
  if (MODE != kFwd) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  for (int it = 0; it < n_steps; ++it) {
    __nv_bfloat16* cur = (it & 1) ? ss1 : ss0;
    if (it + 1 < n_steps) {
      load_rows(S, (it + 1) * kST, kST, s_count, (it & 1) ? ss0 : ss1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Phase A: this warp's 16 x WC block of X = R S^T.
    float x[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
    // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15); B: for each pair of
    // n-tiles, (tile 0 | 1) x (k 0-7 | 8-15).
    const __nv_bfloat16* ar =
        rs + (wm * 16 + l8 + 8 * (lm & 1)) * kRow + 8 * (lm >> 1);
    const __nv_bfloat16* br =
        cur + (wn * WC + 8 * (lm >> 1) + l8) * kRow + 8 * (lm & 1);
#pragma unroll 4
    for (int k0 = 0; k0 < kDim; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, ar + k0);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, br + np * 16 * kRow + k0);
        mma16816(x[2 * np], a, b);
        mma16816(x[2 * np + 1], a, b + 2);
      }
    }

    // x[nt][e]: resident row arow[e / 2], streamed row scol(nt, e % 2).
    const int s_base = it * kST + wn * WC + 2 * tq;
    if (MODE == kFwd) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float v = x[nt][2 * i + j] + bias[s_base + nt * 8 + j];
            x[nt][2 * i + j] = v;
            tmax = fmaxf(tmax, v);
          }
        const float m_new = fmaxf(m_run[i], quad_max(tmax));
        float tsum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) tsum += __expf(x[nt][2 * i + j] - m_new);
        l_run[i] = l_run[i] * __expf(m_run[i] - m_new) + quad_sum(tsum);
        m_run[i] = m_new;
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float d2[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int sc = s_base + nt * 8 + j;
            const float v = x[nt][2 * i + j];
            float d = 0.f;
            if (MODE == kDg) {
              if (arow[i] < r_count)
                d = __expf(v + bias[sc] - row_a[i]) * row_b[i];
            } else if (sc < s_count) {
              const float p = __expf(v + row_a[i] - lse[sc]) -
                              (labels[sc] == arow[i] ? 1.f : 0.f);
              d = p * dnll[sc];
              db_part[i] += d;
            }
            d2[j] = d;
          }
          const int lr = wm * 16 + gq + 8 * i;
          const int lc = wn * WC + nt * 8 + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(dls + lr * kDlRow + lc) =
              __floats2bfloat162_rn(d2[0], d2[1]);
        }
      }
      __syncthreads();  // dl complete

      // Phase B: acc[RT x 64 columns of this warp] += dl S. B is S
      // read transposed: matrices (k 0-7 | 8-15) x (n-tile 0 | 1).
      const __nv_bfloat16* bt =
          cur + (8 * (lm & 1) + l8) * kRow + warp * 64 + 8 * (lm >> 1);
      const __nv_bfloat16* da =
          dls + (l8 + 8 * (lm & 1)) * kDlRow + 8 * (lm >> 1);
#pragma unroll
      for (int ks = 0; ks < kST; ks += 16) {
        uint32_t b[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t t[4];
          ldsm_x4_t(t, bt + ks * kRow + np * 16);
          b[2 * np][0] = t[0];
          b[2 * np][1] = t[1];
          b[2 * np + 1][0] = t[2];
          b[2 * np + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, da + mt * 16 * kDlRow + ks);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma16816(acc[mt][nt], a, b[nt]);
        }
      }
    }
    __syncthreads();  // this buffer and dl are free for the next step
  }

  if (MODE == kFwd) {
    // Merge the WN column partials of each row.
    float* sm = stats;
    float* sl = stats + WN * RT;
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lr = wm * 16 + gq + 8 * i;
        sm[wn * RT + lr] = m_run[i];
        sl[wn * RT + lr] = l_run[i];
      }
    }
    __syncthreads();
    for (int lr = threadIdx.x; lr < RT; lr += kThreads) {
      if (r0 + lr >= r_count) continue;
      float m = -INFINITY;
      for (int w = 0; w < WN; ++w) m = fmaxf(m, sm[w * RT + lr]);
      float l = 0.f;
      for (int w = 0; w < WN; ++w) l += sl[w * RT + lr] * __expf(sm[w * RT + lr] - m);
      out[r0 + lr] = m + logf(l);
    }
    return;
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + mt * 16 + gq + 8 * i;
      if (row >= r_count) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = warp * 64 + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (size_t)row * kDim + col) =
            make_float2(acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
      }
    }
  }
  if (MODE == kDe) {
    // dbias: the quad's partials, then the WN warps of each row in order.
    float* sb = stats;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = quad_sum(db_part[i]);
      if (tq == 0) sb[wn * RT + wm * 16 + gq + 8 * i] = v;
    }
    __syncthreads();
    for (int lr = threadIdx.x; lr < RT; lr += kThreads) {
      if (r0 + lr >= r_count) continue;
      float s = 0.f;
      for (int w = 0; w < WN; ++w) s += sb[w * RT + lr];
      out_bias[r0 + lr] = s;
    }
  }
}

template <int RT, int MODE>
int launch(const void* r, int r_count, const void* s, int s_count,
           const void* bias, const void* lse, const void* dnll,
           const void* labels, void* out, void* out_bias,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<RT, MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      tied_ce_kernel<RT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (r_count + RT - 1) / RT;
  tied_ce_kernel<RT, MODE><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(r), r_count,
      static_cast<const __nv_bfloat16*>(s), s_count,
      static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(dnll), static_cast<const int*>(labels),
      static_cast<float*>(out), static_cast<float*>(out_bias));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int tokens, int vocab, int dim) {
  return tokens < 1 || vocab < kST || vocab % kST != 0 || dim != kDim;
}

}  // namespace

// g [tokens, 512] bf16, table [vocab, 512] bf16, bias [vocab] fp32 ->
// lse [tokens] fp32.
extern "C" int svt_tied_ce_fwd(const void* g, const void* table,
                               const void* bias, void* lse, int tokens,
                               int vocab, int dim, void* stream) {
  if (bad_shape(tokens, vocab, dim)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRows, kFwd>(g, tokens, table, vocab, bias, nullptr, nullptr,
                             nullptr, lse, nullptr,
                             static_cast<cudaStream_t>(stream));
}

// -> dg [tokens, 512] fp32 without the -dnll E[label] term.
extern "C" int svt_tied_ce_dg(const void* g, const void* table,
                              const void* bias, const void* lse,
                              const void* dnll, void* dg, int tokens,
                              int vocab, int dim, void* stream) {
  if (bad_shape(tokens, vocab, dim)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRows, kDg>(g, tokens, table, vocab, bias, lse, dnll,
                            nullptr, dg, nullptr,
                            static_cast<cudaStream_t>(stream));
}

// -> dE [vocab, 512] fp32 and dbias [vocab] fp32.
extern "C" int svt_tied_ce_de(const void* g, const void* table,
                              const void* bias, const void* lse,
                              const void* dnll, const void* labels, void* de,
                              void* dbias, int tokens, int vocab, int dim,
                              void* stream) {
  if (bad_shape(tokens, vocab, dim)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRows, kDe>(table, vocab, g, tokens, bias, lse, dnll, labels,
                            de, dbias, static_cast<cudaStream_t>(stream));
}
