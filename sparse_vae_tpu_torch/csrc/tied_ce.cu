// K3: the tied vocab projection fused with softmax cross-entropy, forward,
// for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_ce.py::_fwd (body _fwd_kernel). Its
// plain PyTorch version is sparse_vae_tpu_torch/ops/ce_kernel.py::
// tied_ce_fwd_plain. The backward (K3b, pallas_ce.py::_bwd) is
// csrc/tied_ce_bwd.cu.
//
// What it computes. g [T, 512] bf16 (the decoder's pre-logits), the tied
// table E [V, 512] bf16 (the input embedding), bias [V] fp32. Logits
// x = g E^T + bias are fp32 (the bf16 products summed in fp32, then the
// fp32 bias) and never leave the chip: lse[t] = logsumexp_v x[t, v]
// (online max and sum of exp). The label logit (nll = lse - g . E[label] -
// bias[label]) is a gather done outside, in fp32, as in the JAX package.
//
// What bounds it. At T = 102,400, V = 32,768, D = 512 it is 2 T V D = 3.4
// TFLOP against ~137 MB of inputs: operations, by far.
//
// Design. A CTA keeps RT = kRows = 64 token rows of g resident in shared
// memory and streams E through it in tiles of 64 rows, double-buffered
// with cp.async. Each stream step computes X = R S^T on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate), 8 warps tiling the
// RT x 64 block, then folds it into each row's online max and sum-exp.
// The per-warp column partials (m, l) merge once at the end; every row
// lives in one CTA, so there are no atomics. Operands reach the registers
// by ldmatrix; shared memory rows are padded by 8 bf16 so its eight row
// reads hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using svt::cp_async16;
using svt::ldsm_x4;
using svt::mma16816;

constexpr int kDim = 512;               // model width D
// Resident rows per CTA. 64 rather than 32 (both measured on the H100):
// half the re-reads of the streamed matrix, 208 registers, no spills.
constexpr int kRows = 64;
constexpr int kRow = kDim + 8;          // smem row stride, bf16
constexpr int kST = 64;                 // streamed rows per step
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = kDim / 8;          // 16-byte vectors per row

template <int RT>
constexpr int smem_bytes() {
  return (RT * kRow + 2 * kST * kRow) * 2 + 2 * (kWarps / (RT / 16)) * RT * 4;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// R: [r_count, kDim] token rows of g; S: [s_count, kDim] rows of E.
// out: fp32 [r_count] lse.
template <int RT>
__global__ void __launch_bounds__(kThreads, 1)
tied_ce_kernel(const __nv_bfloat16* __restrict__ R, int r_count,
               const __nv_bfloat16* __restrict__ S, int s_count,
               const float* __restrict__ bias, float* __restrict__ out) {
  constexpr int WM = RT / 16;         // warp rows
  constexpr int WN = kWarps / WM;     // warp columns
  constexpr int WC = kST / WN;        // streamed rows per warp
  constexpr int NT = WC / 8;          // mma n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ss0 = rs + RT * kRow;
  __nv_bfloat16* ss1 = ss0 + kST * kRow;
  float* stats = reinterpret_cast<float*>(ss1 + kST * kRow);

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

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

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

    // x[nt][e]: resident row wm * 16 + gq + 8 (e / 2), streamed row
    // s_base + nt * 8 + e % 2.
    const int s_base = it * kST + wn * WC + 2 * tq;
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
    __syncthreads();  // this buffer is free for the next step
  }

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
}

template <int RT>
int launch(const void* r, int r_count, const void* s, int s_count,
           const void* bias, void* out, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<RT>();
  static svt::SmemLimit limit;
  const cudaError_t err =
      svt::raise_smem_limit(limit, tied_ce_kernel<RT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (r_count + RT - 1) / RT;
  tied_ce_kernel<RT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(r), r_count,
      static_cast<const __nv_bfloat16*>(s), s_count,
      static_cast<const float*>(bias), static_cast<float*>(out));
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
  return launch<kRows>(g, tokens, table, vocab, bias, lse,
                       static_cast<cudaStream_t>(stream));
}
