// K5: w4a8 projection GEMM — an int8 activation (K1's per-row quantizer)
// against split-halves packed int4 weights, s8 x s8 -> s32, with a fused
// rescale epilogue.
//
// Replaces medtsllm_tpu/ops/pallas/quant_matmul.py::w4a8_matmul_pallas and
// the XLA unpack-then-dot it stands in for (w4a8_matmul_reference), whose
// numerics it follows:
//   out = (float(acc) * x_scale) * w_scale       (the scales one at a time,
//                                                 not K1's x_scale * w_scale)
// |acc| <= K * 127 * 8 < 2^31: s32 cannot wrap.
//
// Weight layout: packed [N, K/2] int8 (the JAX kernel_q [K/2, N]
// transposed); byte p of row n holds w[n][p] in its high nibble and
// w[n][p + K/2] in its low one (pack4_split), so
//   y = x[:, :K/2] . hi^T + x[:, K/2:] . lo^T.
//
// What bounds it: at the serving shapes (M = 8 x 112 rows, K, N in
// {4096, 11008}) the product is compute-bound on the int8 tensor cores
// (2*M*N*K ops over M*K + N*K/2 bytes). The design is K1's tile with the
// unpack in the staging: per 64-deep packed step a block reads the packed
// bytes [p0, p0 + 64) of its 128 weight rows once, sign-extends the high
// nibbles into one shared B tile and the low ones into another, stages the
// activation columns [p0, p0 + 64) and [K/2 + p0, K/2 + p0 + 64) beside
// them, and runs the mma.sync tile twice (common.cuh). Weight bytes read
// from memory are half of K1's. No wgmma / TMA / pipelining yet.

#include "common.cuh"

namespace {

constexpr int BM = mt::kTileM, BN = mt::kTileN, BK = mt::kTileK;
constexpr int LDS = mt::kTileLds;
constexpr int kThreads = mt::kTileThreads;

// OUT: 0 = f32, 1 = bf16 (scaled), 2 = raw s32 accumulators
template <int OUT>
__global__ void __launch_bounds__(kThreads)
w4a8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bp,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = K / 2;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int p0 = 0; p0 < half; p0 += BK) {
    mt::load_tile_s8(sA[0], A, m0, M, p0, half, K);
    mt::load_tile_s8(sA[1], A + half, m0, M, p0, half, K);
    mt::load_tile_s4(sB[0], sB[1], Bp, n0, N, p0, half, half);
    __syncthreads();
    mt::mma_tile_s8(acc, sA[0], sB[0], wm, wn, g, t4);
    mt::mma_tile_s8(acc, sA[1], sB[1], wm, wn, g, t4);
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
          const float y =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), xs[r]), ws[c]);
          if (OUT == 0)
            static_cast<float*>(out)[o] = y;
          else
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
        }
      }
}

}  // namespace

extern "C" {

// xq [M, K] int8, packed [N, K/2] int8, x_scale [M] f32, w_scale [N] f32,
// out [M, N] (out_kind 0 f32, 1 bf16, 2 s32); K / 2 a multiple of 16
int mt_w4a8_gemm(const void* xq, const void* packed, const void* x_scale,
                 const void* w_scale, void* out, int out_kind, int M, int N,
                 int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* a = static_cast<const int8_t*>(xq);
  const auto* b = static_cast<const int8_t*>(packed);
  const auto* xsp = static_cast<const float*>(x_scale);
  const auto* wsp = static_cast<const float*>(w_scale);
  if (out_kind == 0)
    w4a8_gemm_kernel<0><<<grid, kThreads, 0, s>>>(a, b, xsp, wsp, out, M, N, K);
  else if (out_kind == 1)
    w4a8_gemm_kernel<1><<<grid, kThreads, 0, s>>>(a, b, xsp, wsp, out, M, N, K);
  else if (out_kind == 2)
    w4a8_gemm_kernel<2><<<grid, kThreads, 0, s>>>(a, b, xsp, wsp, out, M, N, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
