// K4: fused nucleus (top-p) + Gumbel-max token selection, for Hopper.
//
// Replaces sparse_vae_tpu/ops/pallas_select.py::nucleus_gumbel_argmax
// (body _kernel, math _select_tile). Its plain PyTorch version is
// sparse_vae_tpu_torch/ops/select_kernel.py::nucleus_gumbel_argmax_plain.
//
// What it computes, per row of fp32 logits s [N, V], step by step as
// _select_tile does:
//   1. temperature: s / t when t != 1 and t > 0;
//   2. when 0 < top_p < 1: m = max s, p = exp(s - m) (unnormalised),
//      z = sum p, and a threshold lo found by num_iters bisection steps on
//      [0, max p = 1]: each step raises lo to mid while the mass of
//      {p >= mid} is >= top_p z. A token is kept when p >= lo or p == 1;
//   3. val = s + noise (Gumbel noise, an input drawn by the caller), -inf
//      where not kept;
//   4. the first index attaining max val (0 when every val is -inf).
//
// What bounds it. Every logit is read once, the noise of the kept tokens
// only (all of it without a nucleus), and one int64 is written a row:
// about N * V * 4 bytes at top_p 0.9, against about a dozen fp32
// operations an element, so the bound is bytes (chip_smoke.py's
// k4_bound). The first version (one CTA of 1024 threads a row, 26 passes
// over the row, all of the noise read) took 0.065 ms at [64, 32768] on an
// H100, 26 times that bound. Its five limits, and what this design does
// about each:
//   1. exp was recomputed in each of the 26 passes (sum, 24 bisection
//      steps, select): ~850k MUFU operations a row. Here p = expf(s - m)
//      is computed once and written over s / t in shared memory, where the
//      later passes read it.
//   2. 24 dependent block-wide reductions. Here the bisection is replayed
//      from histograms: with max p = 1, every mid of the first 24 steps is
//      an exact multiple of 2^-j in fp32 (j the step), so p >= mid is
//      exactly floor(p 2^(8l+8)) >= mid 2^(8l+8), an integer, for level l
//      = j / 8 (scaling by a power of two is exact, subnormals included).
//      One pass per level bins the p inside the current bracket into 256
//      bins of floor(p 2^(8l+8)); after one barrier the bins' suffix sums
//      give the mass of {p >= mid} for every mid of that level's 8 steps.
//      The bisection's comparison at mid falls from true to false once as
//      mid rises, so each bin's thread makes it for its own bin and one
//      counting barrier (__syncthreads_count) gives where the 8 steps end.
//      The mass past the bracket comes from the previous level's bins. 24
//      steps take 3 passes and 3 row barriers; steps past 24,
//      where an fp32 mid rounds, run as plain bisection steps of one pass
//      and one reduction each.
//   3. One CTA per row left 68 of 132 SMs idle at the serving batch of 64.
//      Here a row is split over a cluster of 2 CTAs of 512 threads, which
//      combine their max, bins and argmax through distributed shared
//      memory (5 cluster barriers a row), while each CTA can have an SM of
//      its own (2 rows <= SMs); beyond that, one CTA of 1024 threads a
//      row, its reductions block-wide. With the passes and barriers
//      above, a row's time is mostly its chain of dependent steps, so the
//      split gains little: on an H100 the cluster was ahead by about 2%
//      at 32 and 64 rows (ten seeds of ten) and one CTA a row ahead by
//      15% at 100 rows and 11% at 512 and 2,048 (chip_smoke.py's
//      k4_instantiations; PERF.md section 6). Rows one CTA cannot hold
//      (V > 2^15, up to 58,240) always take the cluster.
//   4. The noise was read in the last pass only, after the search, all
//      V of it. The select needs the noise, and s, of the kept tokens
//      only: each warp lists its kept elements in place of their p and
//      reads just those logits and noise from device memory (at top_p 0.9
//      on peaked logits, a few hundred of 32,768). Without a nucleus
//      every token is kept: one thread starts the row's noise towards L2
//      (cp.async.bulk.prefetch) before the row is loaded.
//   5. cudaFuncSetAttribute ran on every launch. It now runs once per
//      device and instantiation (svt::raise_smem_limit).
// Determinism: the masses are sums of p in fixed point (units of 2^-40),
// integers whose sum does not depend on the order of the atomics and
// shuffles that form it (each in three 32-bit parts); z sums each
// thread's fp32 partial, taken in a fixed order, the same way. Max and
// the first-index argmax do not depend on order either. The same inputs
// give bit-identical choices. Against the plain version only the rounding
// of the masses differs, so a row whose mass sat within rounding of
// top_p z at some step may keep another set (chip_smoke.py's
// K4_FLIP_MARGIN).
//
// Shared memory: a 14 KB header and the CTA's part of the row (128 KB
// for one CTA a row at V = 32,768; V / 2 elements, at most 114 KB, for a
// CTA of a cluster).
// CUDA rather than Triton: the two CTAs of a cluster read each other's
// shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tiles.cuh"

namespace {

namespace cg = cooperative_groups;
using u64 = unsigned long long;

constexpr int kMaxWarps = 32;
constexpr int kBins = 256;    // one level: 8 bisection steps
constexpr int kLevels = 3;    // 24 steps, every mid exact in fp32
constexpr int kMaxSmem = 227 * 1024;
constexpr float kUnit = 0x1p40f;   // masses in units of 2^-40
// A mass in three parts of 17, 17 and 7 bits: a CTA holds at most 2^15
// elements, so no part's sum overflows 32 bits, and each part is one
// 32-bit shared atomic (ATOMS.ADD).
constexpr int kParts = 3;
constexpr int kPartBits = 17;
// Level l's sums: bins 1..255 of the bracket, then (level 0) z and the
// mass of p == 1.
constexpr int kZ = kBins, kTop = kBins + 1, kSums = kBins + 2;

// Shared memory: this header, then the CTA's part of the row.
struct Header {
  uint32_t sums[kLevels][kParts][kSums];
  u64 suffix[kBins];          // within each 32-bin group, summed from b
  u64 group[kBins / 32];      // each group's total
  u64 from[kBins + 1];        // the level's bins over the row, from b up
  u64 extra[2];               // z and the mass of p == 1, over the row
  u64 warp_sums[2][kMaxWarps];  // plain steps: a ring of two reductions
  float warp_max[kMaxWarps];
  float warp_val[kMaxWarps];
  int warp_idx[kMaxWarps];
  float cta_val[2];           // rank 0: each CTA's argmax
  int cta_idx[2];
};
constexpr int kHeaderBytes = (sizeof(Header) + 127) / 128 * 128;

__device__ __forceinline__ u64 fixed(float p) {
  return __float2ull_rn(p * kUnit);
}
__device__ __forceinline__ float unfixed(u64 mass) {
  return __ull2float_rn(mass) * 0x1p-40f;
}

__device__ __forceinline__ u64 warp_sum(u64 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void sum_add(uint32_t (*sums)[kSums], int b,
                                        u64 mass) {
  constexpr u64 kMask = (1ull << kPartBits) - 1;
  atomicAdd(&sums[0][b], static_cast<uint32_t>(mass & kMask));
  atomicAdd(&sums[1][b], static_cast<uint32_t>((mass >> kPartBits) & kMask));
  const uint32_t top = static_cast<uint32_t>(mass >> (2 * kPartBits));
  if (top) atomicAdd(&sums[2][b], top);
}

// Larger value wins; equal values go to the smaller index.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// CTA `rank`'s copy of *p: its own shared memory, or a cluster peer's.
template <int kCluster, typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  if constexpr (kCluster > 1)
    return cg::this_cluster().map_shared_rank(p, rank);
  else
    return p;
}

// Every thread of the row's CTAs waits here; shared-memory writes before
// it, to its own CTA or a peer, are visible to all of them after it.
template <int kCluster>
__device__ __forceinline__ void row_barrier() {
  if constexpr (kCluster > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The row's max: warp maxima, one barrier, then every warp reduces the
// kCluster x kWarps of them (no broadcast needed).
template <int kCluster, int kWarps>
__device__ float row_max(float x, Header& h) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31;
  if (lane == 0) h.warp_max[threadIdx.x >> 5] = x;
  row_barrier<kCluster>();
  float m = -INFINITY;
  for (int e = lane; e < kCluster * kWarps; e += 32)
    m = fmaxf(m, at_rank<kCluster>(h.warp_max, e / kWarps)[e % kWarps]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// A mass over the row, for the plain steps past 24: warp sums, one
// barrier, then every warp sums the kCluster x kWarps of them. A CTA
// rewrites a ring slot two reductions later, after a barrier that every
// CTA passes only once it has read it.
template <int kCluster, int kWarps>
__device__ u64 row_sum(u64 x, Header& h, int ring) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31;
  if (lane == 0) h.warp_sums[ring][threadIdx.x >> 5] = x;
  row_barrier<kCluster>();
  x = 0;
  for (int e = lane; e < kCluster * kWarps; e += 32)
    x += at_rank<kCluster>(h.warp_sums[ring], e / kWarps)[e % kWarps];
  return warp_sum(x);
}

// After the barrier that follows level l's pass: its sums over the row's
// CTAs and parts (integer sums: the order does not matter), h.from[b] =
// the mass of bins b..255 (h.from[256] = 0) and, at level 0, the target
// top_p z and the mass of p == 1 into `above`. Then the level's `steps`
// (<= 8) bisection steps: the step at bin mid keeps raising lo while
// above + h.from[mid] (the mass of {p >= mid}) >= target, the bisection's
// own comparison. That test falls from true to false once as mid rises,
// so the steps end on the last bin of their grid (multiples of 2^(8 -
// steps)) that passes it: each bin's thread tests its own bin and one
// counting barrier gives lo. Returns lo in bins and leaves in `above` the
// mass from the final hi up.
template <int kCluster>
__device__ int level_lo(Header& h, int l, int steps, float top_p,
                        float& target, u64& above) {
  const int b = threadIdx.x;
  u64 mass = 0;
  if (b < kSums) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const uint32_t(*parts)[kSums] = at_rank<kCluster>(h.sums[l], r);
#pragma unroll
      for (int part = 0; part < kParts; ++part)
        mass += static_cast<u64>(parts[part][b]) << (kPartBits * part);
    }
  }
  if (b < kBins) {
    // Suffix sums within each group of 32 bins, and the group's total.
    const int lane = b & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 up = __shfl_down_sync(0xffffffffu, mass, o);
      if (lane + o < 32) mass += up;
    }
    h.suffix[b] = mass;
    if (lane == 0) h.group[b >> 5] = mass;
  } else if (b < kSums) {
    h.extra[b - kBins] = mass;
  }
  __syncthreads();
  if (l == 0) {
    target = top_p * unfixed(h.extra[0]);
    above = h.extra[1];
  }
  const int stride = 1 << (8 - steps);
  bool raise = false;
  if (b < kBins) {
    mass = h.suffix[b];
#pragma unroll
    for (int g = 1; g < kBins / 32; ++g)
      if (g > (b >> 5)) mass += h.group[g];
    h.from[b] = mass;
    raise = b > 0 && b % stride == 0 && unfixed(above + mass) >= target;
  }
  const int lo = stride * __syncthreads_count(raise);
  above += h.from[lo + stride];
  return lo;
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// One row per cluster of kCluster CTAs; CTA r holds elements [r chunk,
// (r + 1) chunk) of it in shared memory (`row`, as float4s: thread t
// takes the float4s t, t + kThreads, ...): s / t, then p in its place.
template <int kCluster, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
nucleus_select_kernel(const float* __restrict__ logits,
                      const float* __restrict__ noise,
                      int64_t* __restrict__ out, int vocab, int chunk,
                      float top_p, float temperature, int num_iters) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads >= kSums && kWarps <= kMaxWarps && kCluster <= 2);
  extern __shared__ __align__(128) unsigned char smem[];
  Header& h = *reinterpret_cast<Header*>(smem);
  float4* row = reinterpret_cast<float4*>(smem + kHeaderBytes);

  int rank = 0;
  if constexpr (kCluster > 1) rank = cg::this_cluster().block_rank();
  const int r = blockIdx.x / kCluster;
  const int begin = rank * chunk;
  const int n4 = max(0, min(vocab - begin, chunk)) / 4;
  const size_t base = (size_t)r * vocab + begin;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool scale = temperature != 1.f && temperature > 0.f;
  const bool nucleus = top_p > 0.f && top_p < 1.f;

  // Without a nucleus every element's noise is read: start it towards L2.
  if (tid == 0 && !nucleus && noise != nullptr && n4 > 0)
    prefetch_l2(noise + base, n4 * 16);
  for (int i = tid; i < kLevels * kParts * kSums; i += kThreads)
    (&h.sums[0][0][0])[i] = 0;
  if (tid == 0) h.from[kBins] = 0;

  // s / t into shared memory, and its max.
  const float4* src = reinterpret_cast<const float4*>(logits + base);
  float m = -INFINITY;
#pragma unroll 8
  for (int i = tid; i < n4; i += kThreads) {
    float4 v = __ldg(src + i);
    if (scale) {
      v.x = v.x / temperature;
      v.y = v.y / temperature;
      v.z = v.z / temperature;
      v.w = v.w / temperature;
    }
    m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    row[i] = v;
  }

  float best = -INFINITY;
  int best_i = INT_MAX;
  if (nucleus) {
    // Its barrier also publishes the zeroed sums.
    m = row_max<kCluster, kWarps>(m, h);
    // p, once, in place of s; z; and level 0's bins (the bracket [0, 1)).
    // z: each thread's fp32 sum of its p (a few dozen) in a fixed order,
    // then fixed point: one conversion a thread, not one a p.
    float zf = 0.f;
    u64 top = 0;
#pragma unroll 4
    for (int i = tid; i < n4; i += kThreads) {
      float4 v = row[i];
      float* p = &v.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(p[e] - m);
        zf += p[e];
        if (p[e] == 1.f)
          top += fixed(p[e]);
        else if (p[e] >= 0x1p-8f)  // bin floor(p 2^8) >= 1
          sum_add(h.sums[0], __float2uint_rz(p[e] * 0x1p8f), fixed(p[e]));
      }
      row[i] = v;
    }
    u64 z = warp_sum(fixed(zf));
    top = warp_sum(top);
    if (lane == 0) {
      sum_add(h.sums[0], kZ, z);
      sum_add(h.sums[0], kTop, top);
    }
    const int levels = min(kLevels, (num_iters + 7) / 8);
    float target = 0.f;
    u64 above = 0;   // the mass of p >= the bracket's top
    uint32_t a = 0;  // lo in units of 2^-(8 l) after l levels
    for (int l = 0; l < levels; ++l) {
      if (l > 0) {
        // Level l's bins: the p inside the bracket [a, a + 1) 2^-(8 l).
        // Bins 1..255: p in [first + 1, first + 256) / unit, bounds that
        // are exact in fp32 (first + 256 <= 2^24).
        const float unit = l == 1 ? 0x1p16f : 0x1p24f;
        const uint32_t first = a * kBins;
        const float from = (first + 1) / unit, to = (first + kBins) / unit;
#pragma unroll 4
        for (int i = tid; i < n4; i += kThreads) {
          const float4 v = row[i];
          const float* p = &v.x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p[e] >= from && p[e] < to)
              sum_add(h.sums[l], __float2uint_rz(p[e] * unit) - first,
                      fixed(p[e]));
        }
      }
      row_barrier<kCluster>();
      a = a * kBins + level_lo<kCluster>(h, l, min(8, num_iters - 8 * l),
                                         top_p, target, above);
    }
    float lo = __uint2float_rn(a) * (levels == 0   ? 1.f
                                     : levels == 1 ? 0x1p-8f
                                     : levels == 2 ? 0x1p-16f
                                                   : 0x1p-24f);
    // Steps past 24: the mid rounds in fp32, so plain bisection steps.
    float hi = lo + 0x1p-24f;
    for (int it = 8 * kLevels; it < num_iters; ++it) {
      const float mid = (lo + hi) * 0.5f;
      u64 mass = 0;
      for (int i = tid; i < n4; i += kThreads) {
        const float4 v = row[i];
        const float* p = &v.x;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p[e] >= mid) mass += fixed(p[e]);
      }
      if (unfixed(row_sum<kCluster, kWarps>(mass, h, it & 1)) >= target)
        lo = mid;
      else
        hi = mid;
    }
    // The kept elements (p >= lo or p == 1), listed by each warp in place
    // of its own p (slot k of warp w is float 4 ((k / 128) kThreads + 32 w)
    // + k % 128: never past the float4s the warp has read); their logits
    // and noise are read from device memory here, the only place they are
    // needed.
    int* list = reinterpret_cast<int*>(row);
    auto slot = [&](int k) {
      return 4 * ((k >> 7) * kThreads + 32 * warp) + (k & 127);
    };
    const unsigned below = (1u << lane) - 1;
    int kept = 0;  // the same in every lane of the warp
    for (int i0 = 32 * warp; i0 < n4; i0 += kThreads) {
      const int i = i0 + lane;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n4) v = row[i];
      const float* p = &v.x;
      bool keep[4];
      unsigned mask[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        keep[e] = i < n4 && (p[e] >= lo || p[e] == 1.f);
        mask[e] = __ballot_sync(0xffffffffu, keep[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (mask[e] == 0) continue;  // the warp keeps none: most elements
        if (keep[e]) list[slot(kept + __popc(mask[e] & below))] = 4 * i + e;
        kept += __popc(mask[e]);
      }
    }
    __syncwarp();
    for (int k = lane; k < kept; k += 32) {
      const int i = list[slot(k)];
      float val = __ldg(logits + base + i);
      if (scale) val = val / temperature;
      if (noise != nullptr) val += __ldg(noise + base + i);
      arg_better(best, best_i, val, begin + i);
    }
  } else {
    const float4* row_noise =
        noise != nullptr ? reinterpret_cast<const float4*>(noise + base)
                         : nullptr;
    for (int i = tid; i < n4; i += kThreads) {
      float4 v = row[i];
      if (row_noise != nullptr) {
        const float4 e = __ldg(row_noise + i);
        v.x += e.x;
        v.y += e.y;
        v.z += e.z;
        v.w += e.w;
      }
      arg_better(best, best_i, v.x, begin + 4 * i);
      arg_better(best, best_i, v.y, begin + 4 * i + 1);
      arg_better(best, best_i, v.z, begin + 4 * i + 2);
      arg_better(best, best_i, v.w, begin + 4 * i + 3);
    }
    // Every CTA of the cluster has started before rank 0's shared memory
    // is written below.
    if constexpr (kCluster > 1) row_barrier<kCluster>();
  }

  // The argmax: warps, then the CTA, then rank 0 over the CTAs.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
    arg_better(best, best_i, v2, i2);
  }
  if (lane == 0) {
    h.warp_val[warp] = best;
    h.warp_idx[warp] = best_i;
  }
  __syncthreads();
  if (tid < 32) {
    best = lane < kWarps ? h.warp_val[lane] : -INFINITY;
    best_i = lane < kWarps ? h.warp_idx[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
      arg_better(best, best_i, v2, i2);
    }
    if (tid == 0) {
      if constexpr (kCluster > 1) {
        at_rank<kCluster>(h.cta_val, 0)[rank] = best;
        at_rank<kCluster>(h.cta_idx, 0)[rank] = best_i;
      } else {
        out[r] = best == -INFINITY ? 0 : best_i;
      }
    }
  }
  if constexpr (kCluster > 1) {
    row_barrier<kCluster>();
    if (rank == 0 && tid == 0) {
      for (int c = 1; c < kCluster; ++c)
        arg_better(best, best_i, h.cta_val[c], h.cta_idx[c]);
      out[r] = best == -INFINITY ? 0 : best_i;
    }
  }
}

// The SM count of each device, read once.
std::atomic<int> sm_counts[svt::kMaxDevices];

cudaError_t sm_count(int* count) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < svt::kMaxDevices && sm_counts[device].load() > 0) {
    *count = sm_counts[device].load();
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount,
                               device);
  if (err == cudaSuccess && device < svt::kMaxDevices)
    sm_counts[device] = *count;
  return err;
}

template <int kCluster, int kThreads>
cudaError_t launch(const float* logits, const float* noise, int64_t* out,
                   int rows, int vocab, float top_p, float temperature,
                   int num_iters, cudaStream_t stream) {
  static svt::SmemLimit limit;
  auto* kernel = nucleus_select_kernel<kCluster, kThreads>;
  cudaError_t err = svt::raise_smem_limit(limit, kernel, kMaxSmem);
  if (err != cudaSuccess) return err;
  const int chunk = (vocab + 4 * kCluster - 1) / (4 * kCluster) * 4;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(rows * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kHeaderBytes + chunk * 4;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = kCluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, logits, noise, out, vocab,
                            chunk, top_p, temperature, num_iters);
}

}  // namespace

// K4 on one instantiation: `cluster` 2 (a row over a cluster of two CTAs
// of 512 threads) or 1 (one CTA of 1024 threads a row, V <= 2^15: its
// fixed-point parts take at most 2^15 elements), or 0 for the rule of
// svt_nucleus_select (a cluster while 2 rows <= SMs or V > 2^15).
// chip_smoke.py times the two against each other.
extern "C" int svt_nucleus_select_on(const void* logits, const void* noise,
                                     void* out, int rows, int vocab,
                                     float top_p, float temperature,
                                     int num_iters, int cluster,
                                     void* stream) {
  if (rows < 1 || vocab < 4 || vocab % 4 != 0 ||
      vocab * (int)sizeof(float) > kMaxSmem - 512 || num_iters < 0 ||
      cluster < 0 || cluster > 2 || (cluster == 1 && vocab > (1 << 15)) ||
      reinterpret_cast<uintptr_t>(logits) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(noise) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (cluster == 0) {
    // A cluster while each of its CTAs can have an SM of its own, or when
    // one CTA cannot hold the row; else one CTA a row.
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    cluster = 2 * rows <= sms || vocab > (1 << 15) ? 2 : 1;
  }
  const auto* s = static_cast<const float*>(logits);
  const auto* g = static_cast<const float*>(noise);
  auto* o = static_cast<int64_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (cluster == 2)
    err = launch<2, 512>(s, g, o, rows, vocab, top_p, temperature,
                         num_iters, st);
  else
    err = launch<1, 1024>(s, g, o, rows, vocab, top_p, temperature,
                          num_iters, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svt_nucleus_select(const void* logits, const void* noise,
                                  void* out, int rows, int vocab,
                                  float top_p, float temperature,
                                  int num_iters, void* stream) {
  return svt_nucleus_select_on(logits, noise, out, rows, vocab, top_p,
                               temperature, num_iters, 0, stream);
}
