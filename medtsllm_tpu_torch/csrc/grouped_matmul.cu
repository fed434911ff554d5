// K6: the grouped per-expert w8a8 / w4a8 matmul ("gmm") of the dropless MoE
// chain.
//
// Replaces medtsllm_tpu/ops/pallas/grouped_matmul.py::gmm (_make_kernel,
// w_bits = 8 and 4). Rows of xq [R_pad, K] int8 are packed per expert into
// block_m-aligned groups; visit v covers rows [v * block_m, (v + 1) * block_m)
// and multiplies them by expert visit_e[v]'s weight. Numerics follow the JAX
// kernel op for op (rounded f32 ops, never contracted into an FMA):
//   per-row scales:  y = (float(acc) * x_scale[r]) * w_scale[e][c]
//   chunked scales:  y = ((p_0 + p_1) + ...) * w_scale[e][c],
//                    p_kb = float(acc over K-chunk kb) * x_scale[kb][r]
//   fuse_silu:       t = (y_gate * sigmoid(y_gate)) * y_up,
//                    sigmoid(x) = 1 / (1 + expf(-x))
//   emit_quant:      per (row, block_n-wide N-tile): s = max(amax / 127,
//                    1e-10) (IEEE division), q = round_half_even(t / s)
//                    clipped to +-127 (equal to JAX's unclipped cast
//                    whenever t is finite)
// Invalid visits write zeros; their requantized rows get the 1e-10 scale.
//
// What bounds it: at the moe-8x1b serving shape (R_pad ~ 15k rows, K 2048,
// N 5632 and back) the two calls do ~1 TOP per layer; with each weight read
// once per group it is compute-bound on the int8 tensor cores (~0.5 ms per
// layer at peak). The design is common.cuh's mma.sync tile, made grouped:
// one 128 x 128 block tile per (N tile, 128-row tile of a visit), the
// expert's weight block picked from visit_e, 64-deep k steps staged
// through padded shared memory, eight warps of mma.sync m16n8k32. Two
// weights share each staged activation tile. Consecutive blocks share one
// activation tile and walk the expert's N tiles, so an expert's weights
// stay in L2 across its visits.
//
// The requant tile is semantic: one scale per row over a block_n = 1408-wide
// N tile, wider than any block tile. The activated f32 tile t goes through a
// workspace [R_pad, N] (written once, read once: ~0.67 GB of traffic per
// layer at the serving shape), then a second kernel, one warp per (row,
// N tile), takes the amax and quantizes. Fusing the two is later work, as
// are wgmma / TMA pipelines.
//
// Weight layout: [E, N, K] int8 (k contiguous, the "col" operand of
// mma.sync), the transpose of the JAX [E, K, N]; scales [E, N] f32.
//
// w_bits = 4 (packed int4 experts [E, N, K/2], split halves: byte p holds
// k = p in its high nibble and k = p + K/2 in its low one) unpacks while
// staging, as K5 does (common.cuh load_tile_s4): the weight bytes read are
// half of w8's. The per-row form (gate + up) stages, per 64-deep packed
// step, the activation columns of both halves and each weight's hi and lo
// nibbles from one read, and runs two mma steps per weight (six tiles, 60 KB
// of dynamic shared memory). The chunked down form needs an even chunk
// count, so a chunk lies wholly in one half: it stages the hi nibbles of
// packed columns k0 or the lo nibbles of k0 - K/2. The integer sums, and so
// every rounding above, are those of w8 on the unpacked weights.

#include "common.cuh"

namespace {

using mt::kTileK;
using mt::kTileLds;
using mt::kTileM;
using mt::kTileN;
using mt::kTileThreads;

__device__ __forceinline__ float silu_f32(float x) {
  return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
}

template <int OUT>
__device__ __forceinline__ void store(void* out, size_t o, float y) {
  if (OUT == 0)
    static_cast<float*>(out)[o] = y;
  else
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
}

// tiles of shared memory a gmm_kernel instance stages per k step: the
// activation tile and one per weight, both halves of each under the paired
// int4 steps
template <bool CHUNKED, bool W4>
__host__ __device__ constexpr int gmm_halves() { return W4 && !CHUNKED ? 2 : 1; }
template <int NW, bool CHUNKED, bool W4>
constexpr size_t gmm_smem_bytes() {
  return static_cast<size_t>(gmm_halves<CHUNKED, W4>()) * (1 + NW) * kTileM *
         kTileLds;
}

// NW weights (1 or 2); CHUNKED: per-(K-chunk, row) activation scales
// [n_chunks, R_pad] (NW == 1); SILU: out0 = silu(y0) * y1 (NW == 2);
// OUT: 0 = f32, 1 = bf16, 2 = raw s32 accumulators (per-row form only);
// W4: split-halves packed int4 weights [E, N, K/2]
template <int NW, bool CHUNKED, bool SILU, int OUT, bool W4>
__global__ void __launch_bounds__(kTileThreads)
gmm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B0,
           const int8_t* __restrict__ B1, const float* __restrict__ xs,
           const float* __restrict__ ws0, const float* __restrict__ ws1,
           const int* __restrict__ visit_e, const int* __restrict__ visit_valid,
           void* __restrict__ out0, void* __restrict__ out1,
           int tiles_per_visit, int R_pad, int N, int K, int n_chunks) {
  constexpr int kHalves = gmm_halves<CHUNKED, W4>();
  constexpr int kTile = kTileM * kTileLds;
  // sA[h] at h * kTile; weight w's half h at (kHalves * (1 + w) + h) * kTile
  extern __shared__ __align__(16) int8_t smem[];
  const int8_t* sA = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int v = blockIdx.y / tiles_per_visit;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const bool ok = visit_valid[v] != 0;
  const size_t e = static_cast<size_t>(visit_e[v]);
  const int half = K / 2;
  const int KW = W4 ? half : K;  // bytes of a weight row
  const int8_t* b[NW];
  const float* wsc[NW];
  int8_t* sB[NW];
  b[0] = B0 + e * N * KW;
  wsc[0] = ws0 + e * N;
  sB[0] = smem + kHalves * kTile;
  if constexpr (NW == 2) {
    b[1] = B1 + e * N * KW;
    wsc[1] = ws1 + e * N;
    sB[1] = smem + 2 * kHalves * kTile;
  }

  int acc[NW][4][4][4];
  float res[4][4][4];  // CHUNKED: the running sum of the chunk partials
  if (ok) {
    const int nck = CHUNKED ? n_chunks : 1;
    const int ck = K / nck;
    for (int kb = 0; kb < nck; ++kb) {
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[w][i][j][q] = 0;
      if constexpr (W4 && !CHUNKED) {
        // full K: each packed step stages the activation columns of both
        // halves and the hi / lo nibbles of every weight, then two mma steps
        for (int p0 = 0; p0 < half; p0 += kTileK) {
          mt::load_tile_s8(smem, A, m0, R_pad, p0, half, K);
          mt::load_tile_s8(smem + kTile, A + half, m0, R_pad, p0, half, K);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            mt::load_tile_s4(sB[w], sB[w] + kTile, b[w], n0, N, p0, half, half);
          __syncthreads();
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            mt::mma_tile_s8(acc[w], sA, sB[w], wm, wn, g, t4);
            mt::mma_tile_s8(acc[w], sA + kTile, sB[w] + kTile, wm, wn, g, t4);
          }
          __syncthreads();
        }
      } else {
        // a chunk of the int4 form lies wholly in the hi or the lo half
        // (n_chunks even): stage those nibbles of packed columns k0 or
        // k0 - K/2
        const int k_end = (kb + 1) * ck;
        const bool lo = W4 && kb * ck >= half;
        for (int k0 = kb * ck; k0 < k_end; k0 += kTileK) {
          mt::load_tile_s8(smem, A, m0, R_pad, k0, k_end, K);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if constexpr (W4) {
              const int off = lo ? half : 0;
              mt::load_tile_s4(lo ? nullptr : sB[w], lo ? sB[w] : nullptr, b[w], n0,
                               N, k0 - off, k_end - off, half);
            } else {
              mt::load_tile_s8(sB[w], b[w], n0, N, k0, k_end, K);
            }
          }
          __syncthreads();
#pragma unroll
          for (int w = 0; w < NW; ++w)
            mt::mma_tile_s8(acc[w], sA, sB[w], wm, wn, g, t4);
          __syncthreads();
        }
      }
      if constexpr (CHUNKED) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = m0 + wm * 64 + mi * 16 + g + (q >> 1) * 8;
              const float part =
                  __fmul_rn(__int2float_rn(acc[0][mi][ni][q]),
                            xs[static_cast<size_t>(kb) * R_pad + r]);
              res[mi][ni][q] = kb == 0 ? part : __fadd_rn(res[mi][ni][q], part);
            }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + wm * 64 + mi * 16 + g + (q >> 1) * 8;
        const int c = n0 + wn * 32 + ni * 8 + t4 * 2 + (q & 1);
        if (c >= N) continue;  // r < R_pad: the grid covers R_pad exactly
        const size_t o = static_cast<size_t>(r) * N + c;
        if constexpr (OUT == 2) {
          static_cast<int*>(out0)[o] = ok ? acc[0][mi][ni][q] : 0;
          if constexpr (NW == 2)
            static_cast<int*>(out1)[o] = ok ? acc[NW - 1][mi][ni][q] : 0;
        } else {
          float y[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            float base = 0.f;
            if (ok)
              base = CHUNKED ? res[mi][ni][q]
                             : __fmul_rn(__int2float_rn(acc[w][mi][ni][q]), xs[r]);
            y[w] = ok ? __fmul_rn(base, wsc[w][c]) : 0.f;
          }
          if constexpr (SILU) {
            store<OUT>(out0, o, ok ? __fmul_rn(silu_f32(y[0]), y[NW - 1]) : 0.f);
          } else {
            store<OUT>(out0, o, y[0]);
            if constexpr (NW == 2) store<OUT>(out1, o, y[NW - 1]);
          }
        }
      }
}

constexpr int kRequantWarps = 8;

// emit_quant: one warp per (row, N tile of block_n columns) of the activated
// f32 t: the tile's amax, its scale, the int8 codes; scales [N/bn, R_pad]
__global__ void __launch_bounds__(kRequantWarps * 32)
requant_kernel(const float* __restrict__ t, int8_t* __restrict__ q,
               float* __restrict__ qs, int R_pad, int N, int block_n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRequantWarps + warp, j = blockIdx.y;
  if (row >= R_pad) return;  // the whole warp
  const size_t base = static_cast<size_t>(row) * N + static_cast<size_t>(j) * block_n;
  const float* tr = t + base;
  float amax = 0.f;
  for (int i = lane; i < block_n; i += 32) amax = fmaxf(amax, fabsf(tr[i]));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-10f);
  if (lane == 0) qs[static_cast<size_t>(j) * R_pad + row] = s;
  int8_t* qr = q + base;
  for (int i = lane; i < block_n; i += 32)  // clipped: no wrap on the int8 cast
    qr[i] = static_cast<int8_t>(
        max(-127, min(127, __float2int_rn(__fdiv_rn(tr[i], s)))));
}

struct GmmArgs {
  const int8_t* A;
  const int8_t* B0;
  const int8_t* B1;
  const float* xs;
  const float* ws0;
  const float* ws1;
  const int* ve;
  const int* valid;
  void* out0;
  void* out1;
  int tiles_per_visit, R_pad, N, K, n_chunks;
  dim3 grid;
};

template <int NW, bool CHUNKED, bool SILU, int OUT, bool W4>
cudaError_t launch(const GmmArgs& a, cudaStream_t s) {
  constexpr size_t smem = gmm_smem_bytes<NW, CHUNKED, W4>();
  if constexpr (smem > 48 * 1024) {  // dynamic shared memory above 48 KB
    static const cudaError_t attr = cudaFuncSetAttribute(
        gmm_kernel<NW, CHUNKED, SILU, OUT, W4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  gmm_kernel<NW, CHUNKED, SILU, OUT, W4><<<a.grid, kTileThreads, smem, s>>>(
      a.A, a.B0, a.B1, a.xs, a.ws0, a.ws1, a.ve, a.valid, a.out0, a.out1,
      a.tiles_per_visit, a.R_pad, a.N, a.K, a.n_chunks);
  return cudaGetLastError();
}

// the instances: out_kind 0 / 1 (f32 / bf16) everywhere, 2 (s32) when S32
template <int NW, bool CHUNKED, bool SILU, bool S32, bool W4>
cudaError_t launch_by_out(int out_kind, const GmmArgs& a, cudaStream_t s) {
  if (out_kind == 0) return launch<NW, CHUNKED, SILU, 0, W4>(a, s);
  if (out_kind == 1) return launch<NW, CHUNKED, SILU, 1, W4>(a, s);
  if (S32 && out_kind == 2) return launch<NW, CHUNKED, SILU, S32 ? 2 : 0, W4>(a, s);
  return cudaErrorInvalidValue;
}

template <bool W4>
cudaError_t launch_form(int nw, bool chunked, bool silu, int out_kind,
                        const GmmArgs& a, cudaStream_t s) {
  if (nw == 1)
    return chunked ? launch_by_out<1, true, false, false, W4>(out_kind, a, s)
                   : launch_by_out<1, false, false, true, W4>(out_kind, a, s);
  return silu ? launch_by_out<2, false, true, false, W4>(out_kind, a, s)
              : launch_by_out<2, false, false, true, W4>(out_kind, a, s);
}

}  // namespace

extern "C" {

// xq [V * block_m, K] int8; x_scale [R_pad] or [n_chunks, R_pad] f32; w0/w1
// [E, N, K] int8, or [E, N, K/2] split-halves int4 when w_bits is 4 (w1
// NULL for one weight); ws0/ws1 [E, N] f32; visit_e, visit_valid [V] int32;
// out0/out1 [R_pad, N] (out_kind 0 f32, 1 bf16, 2 s32). With q_out
// (emit_quant, needs fuse_silu and out_kind 0) out0 is the f32 workspace of
// t and the kernel also writes q_out [R_pad, N] int8 and q_scale
// [N / block_n, R_pad] f32.
int mt_gmm(const void* xq, const void* x_scale, int n_chunks, const void* w0,
           const void* w1, const void* ws0, const void* ws1, const void* visit_e,
           const void* visit_valid, void* out0, void* out1, int out_kind,
           int fuse_silu, void* q_out, void* q_scale, int block_n, int V,
           int block_m, int N, int K, int w_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = w1 ? 2 : 1;
  const bool chunked = n_chunks > 0, emit = q_out != nullptr;
  if (block_m % kTileM || (chunked && nw != 1) || (fuse_silu && nw != 2) ||
      (emit && (!fuse_silu || out_kind != 0)) || (emit && N % block_n) ||
      (w_bits != 8 && w_bits != 4) ||
      (w_bits == 4 && (K % 32 || (chunked && n_chunks % 2))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_visit = block_m / kTileM;
  const int R_pad = V * block_m;
  GmmArgs a{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w0),
            static_cast<const int8_t*>(w1), static_cast<const float*>(x_scale),
            static_cast<const float*>(ws0), static_cast<const float*>(ws1),
            static_cast<const int*>(visit_e), static_cast<const int*>(visit_valid),
            out0, out1, tiles_per_visit, R_pad, N, K, n_chunks,
            dim3((N + kTileN - 1) / kTileN, V * tiles_per_visit)};
  cudaError_t err =
      w_bits == 4 ? launch_form<true>(nw, chunked, fuse_silu, out_kind, a, s)
                  : launch_form<false>(nw, chunked, fuse_silu, out_kind, a, s);
  if (err != cudaSuccess || !emit) return static_cast<int>(err);
  const dim3 grid((R_pad + kRequantWarps - 1) / kRequantWarps, N / block_n);
  requant_kernel<<<grid, kRequantWarps * 32, 0, s>>>(
      static_cast<const float*>(out0), static_cast<int8_t*>(q_out),
      static_cast<float*>(q_scale), R_pad, N, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
