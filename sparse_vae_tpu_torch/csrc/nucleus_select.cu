// K4: fused nucleus (top-p) + Gumbel-max token selection, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_select.py::nucleus_gumbel_argmax
// (body _kernel, math _select_tile). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/select_kernel.py::nucleus_gumbel_argmax_plain.
//
// What it computes, per row of fp32 logits s [N, V]:
//   1. temperature: s / t when t != 1 and t > 0;
//   2. when 0 < top_p < 1: m = max s, p = exp(s - m) (unnormalised),
//      z = sum p, and a threshold lo found by 24 bisection steps on
//      [0, max p]: keep raising while the mass of {p >= mid} is >= top_p z.
//      A token is kept when p >= lo or p == max p;
//   3. val = s + noise (Gumbel noise, an input drawn by the caller), -inf
//      where not kept;
//   4. the first index attaining max val.
//
// What bounds it. The logits and the noise are read once and one int64 is
// written per row: 2 * N * V * 4 bytes. The ~50 fp32 operations per
// element (24 compare-and-add passes plus exp) sit well under the card's
// fp32 rate at that traffic, so the bound is bytes.
//
// Design. One CTA of 1024 threads per row. The row's V logits stay in
// shared memory for all 26 passes (V = 32,768 -> 128 KB of dynamic shared
// memory), so device memory is touched once per element. p is recomputed
// as expf(s - m) in each pass rather than stored: a second 128 KB array
// would not fit beside the first, and the recomputation is bitwise
// deterministic. Sums are per-thread partials, then warp shuffles, then
// one pass over the 32 warp totals; every thread ends with the same total,
// so the bisection branch is uniform. CUDA rather than Triton because the
// whole row must stay resident in one CTA across the 24 passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide sum; every thread returns the same value.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();  // red is free: every thread read the previous result
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return warp_sum(red[threadIdx.x & 31]);
}

__device__ float block_max(float x, float* red) {
  x = warp_max(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return warp_max(red[threadIdx.x & 31]);
}

// Larger value wins; equal values go to the smaller index.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
nucleus_select_kernel(const float* __restrict__ logits,
                      const float* __restrict__ noise,
                      int64_t* __restrict__ out, int vocab, float top_p,
                      float temperature, int num_iters) {
  extern __shared__ float row[];
  __shared__ float red[kWarps];
  __shared__ int red_i[kWarps];

  const size_t base = (size_t)blockIdx.x * vocab;
  const bool scale = temperature != 1.f && temperature > 0.f;
  const bool nucleus = top_p > 0.f && top_p < 1.f;

  const float4* src = reinterpret_cast<const float4*>(logits + base);
  for (int i = threadIdx.x; i < vocab / 4; i += kThreads) {
    float4 x = src[i];
    if (scale) {
      x.x = x.x / temperature;
      x.y = x.y / temperature;
      x.z = x.z / temperature;
      x.w = x.w / temperature;
    }
    reinterpret_cast<float4*>(row)[i] = x;
  }
  __syncthreads();

  float m = 0.f, lo = 0.f;
  const float pmax = 1.f;  // exp(m - m): the argmax token's p
  if (nucleus) {
    float part = -INFINITY;
    for (int i = threadIdx.x; i < vocab; i += kThreads)
      part = fmaxf(part, row[i]);
    m = block_max(part, red);
    part = 0.f;
    for (int i = threadIdx.x; i < vocab; i += kThreads)
      part += expf(row[i] - m);
    const float target = top_p * block_sum(part, red);
    float hi = pmax;
    for (int it = 0; it < num_iters; ++it) {
      const float mid = (lo + hi) * 0.5f;
      part = 0.f;
      for (int i = threadIdx.x; i < vocab; i += kThreads) {
        const float p = expf(row[i] - m);
        part += p >= mid ? p : 0.f;
      }
      if (block_sum(part, red) >= target)
        lo = mid;
      else
        hi = mid;
    }
  }

  float best = -INFINITY;
  int best_i = vocab;
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    float val = row[i];
    if (noise != nullptr) val += noise[base + i];
    if (nucleus) {
      const float p = expf(row[i] - m);
      if (!(p >= lo || p == pmax)) val = -INFINITY;
    }
    // Indices rise within a thread, so a strict > keeps the first tie;
    // the first element seen is taken even when it is -inf.
    if (val > best || best_i == vocab) {
      best = val;
      best_i = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
    arg_better(best, best_i, v2, i2);
  }
  __syncthreads();  // the last block_sum's reads of red are done
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = best;
    red_i[threadIdx.x >> 5] = best_i;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    best = red[threadIdx.x];
    best_i = red_i[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
      arg_better(best, best_i, v2, i2);
    }
    if (threadIdx.x == 0) out[blockIdx.x] = best_i;
  }
}

}  // namespace

extern "C" int svt_nucleus_select(const void* logits, const void* noise,
                                  void* out, int rows, int vocab,
                                  float top_p, float temperature,
                                  int num_iters, void* stream) {
  const int smem = vocab * (int)sizeof(float);
  if (rows < 1 || vocab < 4 || vocab % 4 != 0 ||
      smem > 227 * 1024 - 512 || num_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nucleus_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nucleus_select_kernel<<<rows, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<int64_t*>(out), vocab, top_p, temperature, num_iters);
  return static_cast<int>(cudaGetLastError());
}
