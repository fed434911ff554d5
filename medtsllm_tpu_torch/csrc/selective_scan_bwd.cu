// K10: the reverse adjoint of the selective-SSM scan (the Mamba block's
// backward), f32 throughout. With g = dL/dy and hhat_t = dL/dh_t:
//   hhat_t  = C_t g_t + dA_{t+1} hhat_{t+1}     (hhat after the last token = 0)
//   ddt_t   = sum_n hhat h_{t-1} A dA_t + x_t sum_n hhat B_t
//   dx_t    = dt_t sum_n hhat B_t               (the D * g term: the caller)
//   dB_t[n] = sum_e hhat dt_t x_t;   dC_t[n] = sum_e h_t g_t
//   dA_T   += sum_{b,t} hhat h_{t-1} dt_t dA_t  with dA_t = exp(dt_t A)
// dt, x, g, ddt, dx [B, L, E]; B, C [B, L, N]; A_T [N, E]; hb [B, ceil(L /
// chunk), N, E], the chunk-start states K9 recorded.
//
// Replaces medtsllm_tpu/ops/pallas/selective_scan.py::_ssm_pallas_bwd (body
// _ssm_bwd_kernel). The TPU kernel walked the chunks right to left on a
// sequential grid axis with hhat in VMEM scratch, recomputed the chunk's
// states from its boundary into a list of [B, N, 128] values, and gave each
// 128-channel block its own dB/dC slab. Here, as in the forward, one thread
// owns one (b, e) channel and walks the whole sequence right to left in a
// loop, with hhat, A and the dA_T partial sums in registers.
//
// Where the trouble is and what the design does about it:
//   - the recomputed states: the reverse step at token t needs h_{t-1}. The
//     thread recomputes them forward from hb[b, c] and keeps them in shared
//     memory, SC tokens at a time (SC x N x 128 floats, 64 KB for N = 16):
//     a recorded chunk longer than SC is re-chunked, each sub-chunk
//     recomputing from the chunk start, so the chunk K9 recorded does not
//     fix the kernel's footprint.
//   - dB and dC sum over e: per token, each warp reduces its 2N per-thread
//     terms with a butterfly reduce-scatter (2N - 1 shuffles a lane instead
//     of 2N x 5), the four warps' partials meet in shared memory, and the
//     block writes one slab [ceil(E / 128), B, L, N] that the caller sums.
//     No float atomics: the gradients are the same from run to run.
//   - dA_T sums over b and t: each thread writes its [N] partial sums to a
//     [B, N, E] slab that the caller sums; a NULL slab (A frozen) skips it.
//   - numerics: expf, no fast-math.
//
// What bounds it: it reads dt, x, g and hb and writes ddt, dx and the
// slabs, ~0.27 GB per layer at the Mamba train shape (B 48, L 144, E 1536,
// N 16), ~0.08 ms at 3.35 TB/s; it runs 2 B L N E expf (the forward
// recompute and the reverse pass), about as long on the special-function
// units.

#include "common.cuh"

namespace {

constexpr int EB = 128;      // channels per block, one thread each
constexpr int NW = EB / 32;  // warps per block
constexpr int SC = 8;        // tokens whose states one pass keeps in shared memory

// One level of the reduce-scatter: a lane keeps half of its 2K values
// (the upper half when lane bit K is set, moved down), adds its partner's
// copy of that half and sends the other half. K is a template argument so
// every index is known at compile time and v stays in registers.
template <int K, int V>
__device__ __forceinline__ void reduce_scatter_level(float (&v)[V], int lane) {
  const bool upper = (lane & K) != 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float send = upper ? v[i] : v[i + K];
    const float keep = upper ? v[i + K] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, K);
  }
  if constexpr (K > 1) reduce_scatter_level<K / 2>(v, lane);
}

// After the call, lane l (l < V) holds the warp's sum of v[l].
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[V], int lane) {
  reduce_scatter_level<V / 2>(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = V; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int N>
__global__ void __launch_bounds__(EB)
selective_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                          const float* __restrict__ Bs, const float* __restrict__ Cs,
                          const float* __restrict__ A_T, const float* __restrict__ g,
                          const float* __restrict__ hb, float* __restrict__ ddt,
                          float* __restrict__ dx, float* __restrict__ dB_slab,
                          float* __restrict__ dC_slab, float* __restrict__ dA_slab,
                          int chunk, int L, int E) {
  extern __shared__ float smem[];
  float* hs = smem;                  // [SC][N][EB]: h_{t-1} of the sub-chunk
  float* red = smem + SC * N * EB;   // [SC][NW][2N]: the warps' dB/dC partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x * EB + tid;
  const int b = blockIdx.y, n_batch = gridDim.y;
  const bool live = e < E;  // threads past E add zeros, and shuffle and sync
  const int n_chunks = (L + chunk - 1) / chunk;
  const size_t row = static_cast<size_t>(b) * L;

  float a[N], hhat_next[N], dat[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A_T[static_cast<size_t>(n) * E + e] : 0.f;
    hhat_next[n] = 0.f;  // dA_{t+1} * hhat_{t+1}, carried right to left
    dat[n] = 0.f;
  }

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int cs = c * chunk, ce = min(L, cs + chunk);
    const float* hb_c = hb + (static_cast<size_t>(b) * n_chunks + c) * N * E + e;
    for (int s_end = ce; s_end > cs;) {
      const int s_start = cs + ((s_end - 1 - cs) / SC) * SC;
      // forward from the chunk start; keep h_{t-1} for t in [s_start, s_end)
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = live ? hb_c[static_cast<size_t>(n) * E] : 0.f;
      for (int t = cs; t < s_end; ++t) {
        if (t >= s_start) {
#pragma unroll
          for (int n = 0; n < N; ++n) hs[((t - s_start) * N + n) * EB + tid] = h[n];
        }
        const size_t o = (row + t) * E + e;
        const float dtv = live ? dt[o] : 0.f;
        const float dbx = dtv * (live ? x[o] : 0.f);
        const float* bt = Bs + (row + t) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = expf(dtv * a[n]) * h[n] + dbx * bt[n];
      }
      // h is now h_{s_end - 1}; walk the sub-chunk backwards
      for (int t = s_end - 1; t >= s_start; --t) {
        const size_t o = (row + t) * E + e;
        const float dtv = live ? dt[o] : 0.f;
        const float xv = live ? x[o] : 0.f;
        const float gv = live ? g[o] : 0.f;
        const float dbx = dtv * xv;
        const float* bt = Bs + (row + t) * N;
        const float* ct = Cs + (row + t) * N;
        float v[2 * N];  // this channel's terms of dB_t (v[n]) and dC_t (v[N + n])
        float s_da = 0.f, s_hb = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float hp = hs[((t - s_start) * N + n) * EB + tid];
          const float dA = expf(dtv * a[n]);
          const float hh = ct[n] * gv + hhat_next[n];
          const float hp_dA = hh * hp * dA;
          s_da += hp_dA * a[n];
          s_hb += hh * bt[n];
          v[n] = hh * dbx;
          v[N + n] = h[n] * gv;
          dat[n] += hp_dA * dtv;
          hhat_next[n] = dA * hh;
          h[n] = hp;
        }
        if (live) {
          ddt[o] = s_da + s_hb * xv;
          dx[o] = s_hb * dtv;
        }
        const float s = warp_reduce_scatter<2 * N>(v, lane);
        if (lane < 2 * N) red[((t - s_start) * NW + warp) * 2 * N + lane] = s;
      }
      __syncthreads();  // the warps' partials of the sub-chunk are in red
      const int n_vals = (s_end - s_start) * 2 * N;
      for (int i = tid; i < n_vals; i += EB) {
        const int tt = i / (2 * N), j = i % (2 * N);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) s += red[(tt * NW + w) * 2 * N + j];
        const size_t off =
            ((static_cast<size_t>(blockIdx.x) * n_batch + b) * L + s_start + tt) * N;
        if (j < N)
          dB_slab[off + j] = s;
        else
          dC_slab[off + j - N] = s;
      }
      __syncthreads();  // red is free for the next sub-chunk
      s_end = s_start;
    }
  }
  if (live && dA_slab != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      dA_slab[(static_cast<size_t>(b) * N + n) * E + e] = dat[n];
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* Bs, const float* Cs,
           const float* A_T, const float* g, const float* hb, float* ddt, float* dx,
           float* dB_slab, float* dC_slab, float* dA_slab, int chunk, int B, int L, int E,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(SC) * N * EB + SC * NW * 2 * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((E + EB - 1) / EB, B);
  selective_scan_bwd_kernel<N><<<grid, EB, smem, stream>>>(
      dt, x, Bs, Cs, A_T, g, hb, ddt, dx, dB_slab, dC_slab, dA_slab, chunk, L, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dB_slab and dC_slab are [ceil(E / 128), B, L, N]; dA_slab is [B, N, E] or
// NULL (dA_T not wanted). chunk is the one K9 recorded hb with.
extern "C" int mt_selective_scan_bwd(const void* dt, const void* x, const void* Bs,
                                     const void* Cs, const void* A_T, const void* g,
                                     const void* hb, void* ddt, void* dx, void* dB_slab,
                                     void* dC_slab, void* dA_slab, int chunk, int B,
                                     int L, int E, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(Bs);
  const auto* cf = static_cast<const float*>(Cs);
  const auto* af = static_cast<const float*>(A_T);
  const auto* gf = static_cast<const float*>(g);
  const auto* hbf = static_cast<const float*>(hb);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dxf = static_cast<float*>(dx);
  auto* dbf = static_cast<float*>(dB_slab);
  auto* dcf = static_cast<float*>(dC_slab);
  auto* daf = static_cast<float*>(dA_slab);
  if (N == 16)
    return launch<16>(dtf, xf, bf, cf, af, gf, hbf, ddtf, dxf, dbf, dcf, daf, chunk, B, L,
                      E, st);
  if (N == 8)
    return launch<8>(dtf, xf, bf, cf, af, gf, hbf, ddtf, dxf, dbf, dcf, daf, chunk, B, L,
                     E, st);
  if (N == 4)
    return launch<4>(dtf, xf, bf, cf, af, gf, hbf, ddtf, dxf, dbf, dcf, daf, chunk, B, L,
                     E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
