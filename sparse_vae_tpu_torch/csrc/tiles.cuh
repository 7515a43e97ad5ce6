// Pieces shared by the hand-written kernels: bf16 packing, ldmatrix and
// cp.async from and to shared memory, exp2 by the special-function unit,
// and the host-side setting of a kernel's dynamic shared memory limit. The
// Hopper-only pieces (TMA, mbarriers, wgmma) are in hopper.cuh, the
// attention kernels' tiles and band map in swa_tiles.cuh.

#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace svt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t packf(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x by the special-function unit (ex2.approx, denormals flushed).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8m..8m+7 give matrix m's rows), each read transposed: r[m] is
// each lane's pair of matrix m in the mma.sync fragment layout.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
// Closes this thread's group of cp.async copies; cp_async_wait<N> waits
// until at most N of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raises a kernel's dynamic shared memory limit to `bytes` once per
// device: the attribute belongs to the device that is current when it is
// set. `limit` is the caller's record for that kernel, one per kernel.
constexpr int kMaxDevices = 64;
struct SmemLimit {
  std::atomic<bool> set[kMaxDevices];
};

template <typename Kernel>
cudaError_t raise_smem_limit(SmemLimit& limit, Kernel* kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && limit.set[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < kMaxDevices) limit.set[device] = true;
  return err;
}

}  // namespace svt
