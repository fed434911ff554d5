// Hopper building blocks of the wgmma + TMA kernels (K1, K4, K5, K6):
// mbarriers, TMA tile loads and stores, shared-memory matrix descriptors,
// wgmma's fence / commit / wait, named barriers, and the host-side encoding
// of 128-byte-swizzled int8 and bf16 tensor maps. sm_90a only.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace mt::hopper {

// the width of one swizzle row: TMA boxes are this many bytes deep in k
constexpr int kSwizzleBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one 2-D tile (c0 = the contiguous coordinate, c1 = the row) of the tensor
// map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory by one 1-D
// bulk copy, completing on bar (both addresses and bytes multiples of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 3-D and 4-D forms (c0 contiguous; K6's chunked and per-expert views)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// one 4-D tile from shared memory to the tensor map's tensor (the box's
// out-of-bounds elements are not written); a bulk group the caller commits
// and waits for
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory descriptor of a K-major tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row atoms 1024 bytes apart (SBO), layout type 1 (B128).
// Adding 2 to it steps 32 bytes along k inside the atom.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// shared-memory descriptor of an MN-major (transposed) 16-bit operand in the
// 128-byte swizzle: k runs down the 128-byte rows (8-row groups 1024 bytes
// apart, SBO), each row holds 64 consecutive elements of m or n, and the
// next 64 of them start lbo bytes further on (LBO)
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of logical byte b of row r in a TMA tile written in the
// 128-byte swizzle (1024-byte aligned): the 16-byte chunk index is XORed
// with the row's index within its 8-row atom
__device__ __forceinline__ int swizzle128(int r, int b) {
  return r * kSwizzleBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
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

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a tensor of `type` and `rank` (<= 5) dimensions, dims[0] contiguous and
// strides[i] the byte stride of dims[i + 1] (multiples of 16), as tiles of
// box[] elements with box[0] = 128 bytes, 128-byte swizzled; out-of-bounds
// elements read as zero. ptr 16-byte aligned.
inline bool make_map_nd(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                        const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || rank < 1 || rank > 5) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  return encode(map, type, rank, const_cast<void*>(ptr), d, st, b, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool make_map_s8_nd(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box) {
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, rank, dims, strides, box);
}

// the bf16 form (box[0] = 64 elements)
inline bool make_map_bf16_nd(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                             const uint64_t* strides, const uint32_t* box) {
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box);
}

// the row-major 8-bit [rows, cols] matrix as 2-D tiles of box_rows x 128
// bytes. cols is the row stride in bytes (a multiple of 16).
inline bool make_map_s8(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols)};
  const uint32_t box[2] = {static_cast<uint32_t>(kSwizzleBytes),
                           static_cast<uint32_t>(box_rows)};
  return make_map_s8_nd(map, ptr, 2, dims, strides, box);
}

}  // namespace mt::hopper
