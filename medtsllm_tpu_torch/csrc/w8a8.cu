// K1: w8a8 projection GEMM — per-row int8 activation quantization, then an
// s8 x s8 -> s32 product with a fused (row scale x channel scale) epilogue.
//
// Replaces medtsllm_tpu/ops/pallas/smallm_matmul.py::w8a8_smallm_matmul_pallas
// and the XLA dot it stands in for (models/llm/transformer.py
// _act_quant_matmul), whose numerics it follows:
//   x_scale = max(amax / 127, 1e-10);  xq = round_half_even(x / x_scale)
//   out     = float(acc) * (x_scale * w_scale)      (scales multiplied first)
// Division is IEEE (__fdiv_rn, never a reciprocal multiply) so ties round as
// jnp.round does. |acc| < K * 127^2 < 2^31 for K <= 11008: s32 cannot wrap.
//
// What bounds it: at the serving shapes (M = 8 x 112 rows, K, N in
// {4096, 11008}) the product is compute-bound on the int8 tensor cores
// (~2*M*N*K ops over M*K + K*N bytes). The design is the simple right one:
// 128x128 block tiles, 64-deep k steps staged through padded shared memory,
// eight warps each issuing mma.sync m16n8k32 s8 on a 64x32 warp tile, s32
// accumulators in registers and the rescale fused into the store. No
// wgmma/TMA/pipelining yet — later work.
//
// Weight layout: the B operand is the transposed int8 weight [N, K]
// (k contiguous, the "col" operand of mma.sync); the port transposes the
// JAX [K, N] kernel_q once at load (weights.py).

#include "common.cuh"

namespace {

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
act_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                      float* __restrict__ x_scale, int K) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(mt::to_f32(xr[i])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float warp_max[kQuantThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = threadIdx.x < kQuantThreads / 32 ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) warp_max[0] = m;
  }
  __syncthreads();
  const float scale = fmaxf(__fdiv_rn(warp_max[0], 127.0f), 1e-10f);
  if (threadIdx.x == 0) x_scale[row] = scale;
  int8_t* qr = xq + static_cast<size_t>(row) * K;
  for (int i = threadIdx.x; i < K; i += kQuantThreads)
    qr[i] = static_cast<int8_t>(
        __float2int_rn(__fdiv_rn(mt::to_f32(xr[i]), scale)));
}

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // padded smem row (bytes): conflict-free frags
constexpr int kGemmThreads = 256;

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
// matrix into smem; out-of-range rows and k are zero (they add nothing)
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g, int r0,
                                          int R, int k0, int K) {
  for (int c = threadIdx.x; c < BM * BK / 16; c += kGemmThreads) {
    const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + r < R && k0 + kc < K)
      v = *reinterpret_cast<const int4*>(g + static_cast<size_t>(r0 + r) * K +
                                         k0 + kc);
    *reinterpret_cast<int4*>(s + r * LDS + kc) = v;
  }
}

// OUT: 0 = f32, 1 = bf16 (scaled), 2 = raw s32 accumulators
template <int OUT>
__global__ void __launch_bounds__(kGemmThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(sA, A, m0, M, k0, K);
    load_tile(sB, Bt, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = sA + (wm * 64 + mi * 16 + g) * LDS + kk + t4 * 4;
        af[mi][0] = ld32(p);
        af[mi][1] = ld32(p + 8 * LDS);
        af[mi][2] = ld32(p + 16);
        af[mi][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = sB + (wn * 32 + ni * 8 + g) * LDS + kk + t4 * 4;
        bf[ni][0] = ld32(p);
        bf[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 64 + mi * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn * 32 + ni * 8 + t4 * 2 + (e & 1);
        if (r >= M || c >= N) continue;
        const size_t o = static_cast<size_t>(r) * N + c;
        if (OUT == 2) {
          static_cast<int*>(out)[o] = acc[mi][ni][e];
        } else {
          const float y = __fmul_rn(__int2float_rn(acc[mi][ni][e]),
                                    __fmul_rn(xs[r], ws[c]));
          if (OUT == 0)
            static_cast<float*>(out)[o] = y;
          else
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
        }
      }
}

}  // namespace

extern "C" {

const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mt_act_quant_rows(const void* x, int x_is_bf16, void* xq, void* x_scale,
                      int M, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    act_quant_rows_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(x_scale), K);
  else
    act_quant_rows_kernel<float><<<M, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(x_scale), K);
  return static_cast<int>(cudaGetLastError());
}

int mt_w8a8_gemm(const void* xq, const void* wq_t, const void* x_scale,
                 const void* w_scale, void* out, int out_kind, int M, int N,
                 int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* a = static_cast<const int8_t*>(xq);
  const auto* b = static_cast<const int8_t*>(wq_t);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  if (out_kind == 0)
    w8a8_gemm_kernel<0><<<grid, kGemmThreads, 0, s>>>(a, b, xs, ws, out, M, N, K);
  else if (out_kind == 1)
    w8a8_gemm_kernel<1><<<grid, kGemmThreads, 0, s>>>(a, b, xs, ws, out, M, N, K);
  else if (out_kind == 2)
    w8a8_gemm_kernel<2><<<grid, kGemmThreads, 0, s>>>(a, b, xs, ws, out, M, N, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
