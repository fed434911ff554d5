// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace mt {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch and XLA
}

// value rounded to T's precision and widened back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// ---- the int8 tensor-core block tile of K1 and K6 -------------------------
// A 128 x 128 block tile over 64-deep k steps staged in padded shared memory
// (rows of kTileLds bytes: conflict-free fragment loads); eight warps, 2 x 4,
// each accumulating a 64 x 32 warp tile with mma.sync m16n8k32 s8 -> s32.
constexpr int kTileM = 128, kTileN = 128, kTileK = 64;
constexpr int kTileLds = kTileK + 16;
constexpr int kTileThreads = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// stage rows [r0, r0 + 128) x k [k0, k0 + 64) of a row-major [R, K] int8
// matrix into smem; rows >= R and k >= k_end are zero (they add nothing).
// k_end - k0 is a multiple of 16 where it is < 64.
__device__ __forceinline__ void load_tile_s8(int8_t* s, const int8_t* g, int r0,
                                             int R, int k0, int k_end, int K) {
  for (int c = threadIdx.x; c < kTileM * kTileK / 16; c += kTileThreads) {
    const int r = c / (kTileK / 16), kc = (c % (kTileK / 16)) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + r < R && k0 + kc < k_end)
      v = *reinterpret_cast<const int4*>(g + static_cast<size_t>(r0 + r) * K +
                                         k0 + kc);
    *reinterpret_cast<int4*>(s + r * kTileLds + kc) = v;
  }
}

// the four high (low) nibbles of a packed word, sign-extended to four int8
// lanes: (n ^ 8) - 8 per byte maps 0..15 onto 0..7, -8..-1
__device__ __forceinline__ uint32_t hi_nibbles_s8(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t lo_nibbles_s8(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// stage rows [r0, r0 + 128) x packed columns [p0, p0 + 64) of a row-major
// [R, K2] split-halves int4 matrix (column p holds logical k = p in its high
// nibble and k = p + K/2 in its low one) as two k-contiguous int8 tiles: the
// high nibbles into sHi, the low ones into sLo; either may be null (one half
// staged). Each packed byte is read once. Rows >= R and columns >= p_end are
// zero; p_end - p0 is a multiple of 16 where it is < 64.
__device__ __forceinline__ void load_tile_s4(int8_t* sHi, int8_t* sLo,
                                             const int8_t* g, int r0, int R,
                                             int p0, int p_end, int K2) {
  for (int c = threadIdx.x; c < kTileM * kTileK / 16; c += kTileThreads) {
    const int r = c / (kTileK / 16), kc = (c % (kTileK / 16)) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < R && p0 + kc < p_end)
      v = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(r0 + r) * K2 +
                                          p0 + kc);
    if (sHi)
      *reinterpret_cast<uint4*>(sHi + r * kTileLds + kc) =
          make_uint4(hi_nibbles_s8(v.x), hi_nibbles_s8(v.y), hi_nibbles_s8(v.z),
                     hi_nibbles_s8(v.w));
    if (sLo)
      *reinterpret_cast<uint4*>(sLo + r * kTileLds + kc) =
          make_uint4(lo_nibbles_s8(v.x), lo_nibbles_s8(v.y), lo_nibbles_s8(v.z),
                     lo_nibbles_s8(v.w));
  }
}

// one staged 64-deep k step: warp (wm, wn) adds its 64 x 32 product of the
// A tile sA [128 rows] and the k-contiguous B tile sB [128 columns]
__device__ __forceinline__ void mma_tile_s8(int (&acc)[4][4][4],
                                            const int8_t* sA, const int8_t* sB,
                                            int wm, int wn, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 32) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* p = sA + (wm * 64 + mi * 16 + g) * kTileLds + kk + t4 * 4;
      af[mi][0] = ld32(p);
      af[mi][1] = ld32(p + 8 * kTileLds);
      af[mi][2] = ld32(p + 16);
      af[mi][3] = ld32(p + 8 * kTileLds + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = sB + (wn * 32 + ni * 8 + g) * kTileLds + kk + t4 * 4;
      bf[ni][0] = ld32(p);
      bf[ni][1] = ld32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
}

}  // namespace mt
