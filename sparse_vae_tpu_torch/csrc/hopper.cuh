// Hopper pieces shared by the tied-CE kernels (K3, csrc/tied_ce.cu; K3b,
// csrc/tied_ce_bwd.cu) and the attention kernels (csrc/swa_tiles.cuh,
// csrc/swa_generic.cu, csrc/causal_fwd.cu, csrc/causal_bwd.cu):
// mbarriers, TMA and bulk loads into shared memory (2-D tensor maps in
// the 128-byte swizzle), named barriers, flags between CTAs, wgmma
// descriptors and products (bf16 in, fp32 accumulate), and the host-side
// encoding of a tensor map through cudaGetDriverEntryPoint (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tiles.cuh"

namespace svt {

constexpr int kSwizzleAlign = 1024;  // a 128-byte swizzle atom: 8 rows

__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((kSwizzleAlign - (smem_u32(raw) & (kSwizzleAlign - 1))) &
                (kSwizzleAlign - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map (inner coordinate c0, row c1) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-aligned) of contiguous
// global memory into shared memory by one bulk copy; completion is
// counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory into one box of a 2-D tensor map (inner coordinate c0, row
// c1): tma_store writes it, tma_reduce_add adds it elementwise (fp32) to
// what is there. bulk_commit closes this thread's group of such
// operations; bulk_wait<N> waits until at most N of its groups are in
// flight (the older ones' reads and writes done).
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               const void* src, int c0,
                                               int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile"
      ".bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's async-proxy accesses to global memory (bulk
// copies) with its generic-proxy ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A grid of `tiles` CTAs for each of `rows` (head, batch row) pairs, in
// chunks of `group` pairs (the last chunk may hold fewer): CTA `cta` is
// tile `*tile` (the order within a chunk, 0 first) of pair `*row`, the
// pairs fastest within a chunk. A chunk's pairs run together, so that
// what they share stays in L2.
__device__ __forceinline__ void chunked_tile(int cta, int rows, int tiles,
                                             int group, int* row,
                                             int* tile) {
  const int chunk = cta / (group * tiles);
  const int within = cta - chunk * group * tiles;
  const int g = min(group, rows - chunk * group);
  *row = chunk * group + within % g;
  *tile = within / g;
}

// A named barrier (ids 1..15; 0 is __syncthreads's) at which `count`
// threads, a multiple of 32, meet; named_bar_arrive counts this thread
// without waiting.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A flag in global memory read with acquire and written with release at
// the device's scope: what one CTA wrote before its release is visible to
// another after its acquire reads the value.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (as TMA writes it), 8-row groups 1024 bytes apart; the tile
// starts 1024-aligned, a k16 step within it adds 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Orders this thread's generic-proxy writes to shared memory (stores,
// cp.async) before later reads by the async proxy (wgmma, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SVT_ACC8(b)                                                   \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),     \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define SVT_ACC64 \
  SVT_ACC8(0), SVT_ACC8(8), SVT_ACC8(16), SVT_ACC8(24), SVT_ACC8(32), \
  SVT_ACC8(40), SVT_ACC8(48), SVT_ACC8(56)
#define SVT_ACC128 \
  SVT_ACC64, SVT_ACC8(64), SVT_ACC8(72), SVT_ACC8(80), SVT_ACC8(88), \
  SVT_ACC8(96), SVT_ACC8(104), SVT_ACC8(112), SVT_ACC8(120)
#define SVT_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SVT_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"

// d[64 x 256] += A[64 x 16] B[256 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SVT_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SVT_ACC128
      : "l"(da), "l"(db), "r"(1));
}
// The same with A in registers (the mma.sync m16n8k16 A layout, warp w of
// the warpgroup holding rows 16w .. 16w + 15).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SVT_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : SVT_ACC128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 128] += A[64 x 16] B[128 x 16]^T, both K-major in shared memory.
// d[4n + 2i + e] is row 16 w + gq + 8i of the warpgroup's 64 (w its warp,
// gq = lane / 4), column 8n + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SVT_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SVT_ACC64
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in shared
// memory; `accumulate` 0 overwrites d. The layout of wgmma_ss128.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SVT_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SVT_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SVT_ACC16 SVT_ACC8(0), SVT_ACC8(8)
#define SVT_ACC32 SVT_ACC16, SVT_ACC8(16), SVT_ACC8(24)
#define SVT_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SVT_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"

// d[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, both K-major in shared memory;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SVT_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SVT_ACC16
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SVT_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the mma.sync
// m16n8k16 A layout, warp w of the warpgroup holding rows 16w .. 16w + 15)
// and B MN-major in shared memory: its 16 k-rows of 128 bytes (the 64 n
// values) in the 128-byte swizzle, so desc_sw128 of the first k-row
// describes it.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SVT_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major in shared memory and B
// MN-major (its 16 k-rows of 128 bytes in the 128-byte swizzle, as
// wgmma_rs_n64_mn reads it); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SVT_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// Host side: cuTensorMapEncodeTiled from the driver, found at run time.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// A row-major [rows, inner] bf16 matrix in boxes of 64 x box_rows, 128-byte
// swizzle; reads past the edge fill zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int inner, int rows,
                     int box_rows) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major [rows, inner] fp32 matrix in boxes of 32 x box_rows (128
// bytes a box row), 128-byte swizzle.
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int inner,
                         int rows, int box_rows) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make() (tensor maps' encoding), again with the device's context bound
// if it fails: the encoder is a driver call, which fails without a
// current context, and a thread that has made no runtime call yet
// (autograd's, when a backward is its first work) may not have one.
template <typename Make>
inline bool with_context(Make make) {
  if (make()) return true;
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess &&
         cudaSetDevice(device) == cudaSuccess && make();
}

// A row-major [rows, 64] bf16 matrix in boxes of 32 x box_rows (64 bytes
// a box row), 64-byte swizzle: the two 32-dim halves of a tile.
inline bool make_map_sw64(CUtensorMap* map, const void* ptr, int rows,
                          int box_rows) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {64, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps kept by what they are made from. A map is a function of its
// format, address, sizes and box alone, so a tensor seen again (PyTorch's
// caching allocator gives same-shaped tensors the same addresses) skips
// the driver's encoder, whose host time would otherwise be paid by every
// call of a latency-bound kernel. N entries, replaced in turn; a miss
// encodes with the device's context bound (`with_context`).
enum MapFormat { kMapBf16 = 0, kMapF32 = 1, kMapBf16Sw64 = 2 };
template <int N>
class MapCache {
 public:
  // The map of a row-major [rows, inner] matrix at ptr in boxes of
  // box_rows rows: kMapBf16 `make_map`, kMapF32 `make_map_f32`,
  // kMapBf16Sw64 `make_map_sw64` (inner 64).
  bool get(CUtensorMap* map, MapFormat format, const void* ptr, int inner,
           int rows, int box_rows) {
    const Key key{ptr, format, inner, rows, box_rows};
    {
      std::lock_guard<std::mutex> lock(mutex_);
      for (int i = 0; i < filled_; ++i)
        if (keys_[i] == key) {
          *map = maps_[i];
          return true;
        }
    }
    const bool made = with_context([&] {
      switch (format) {
        case kMapF32: return make_map_f32(map, ptr, inner, rows, box_rows);
        case kMapBf16Sw64: return make_map_sw64(map, ptr, rows, box_rows);
        default: return make_map(map, ptr, inner, rows, box_rows);
      }
    });
    if (!made) return false;
    std::lock_guard<std::mutex> lock(mutex_);
    keys_[next_] = key;
    maps_[next_] = *map;
    next_ = (next_ + 1) % N;
    if (filled_ < N) ++filled_;
    return true;
  }

 private:
  struct Key {
    const void* ptr;
    int format, inner, rows, box_rows;
    bool operator==(const Key& o) const {
      return ptr == o.ptr && format == o.format && inner == o.inner &&
             rows == o.rows && box_rows == o.box_rows;
    }
  };
  std::mutex mutex_;
  Key keys_[N] = {};
  CUtensorMap maps_[N];
  int filled_ = 0, next_ = 0;
};


}  // namespace svt
