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
// states from its boundary, and gave each 128-channel block its own dB/dC
// slab.
//
// What bounds it: it reads dt, x, g and hb and writes ddt, dx and the
// slabs, ~0.27 GB at the Mamba train shape (B 48, L 144, E 1536, N 16),
// ~0.08 ms at 3.35 TB/s; one expf per (b, t, n, e) on the special-function
// units, ~0.04 ms; ~15 f32 operations per (b, t, n, e), ~0.05 ms. What held
// the first design (one thread per (b, e) channel with all N states, 9x its
// bound) back was latency with little in flight: a 64 KB shared-memory
// state history capped an SM at 12 warps over 1.45 waves, the reverse pass
// recomputed every exp(dt A), and each 8-token sub-chunk recomputed forward
// from the 16-token chunk start. This design:
//   - the N states of a channel are split over N / 4 lanes, 4 states a
//     thread (lane = channel-in-warp x N / 4 + state group), so 4x the
//     threads carry the same work and every state chain has 4-way ILP;
//   - a sub-chunk of up to SC = 16 tokens (the recorded chunk, 16 in
//     training) runs forward from its recorded start once, keeping h_{t-1}
//     in registers and exp(dt_t A) in the thread's own column of shared
//     memory (64 registers, not 128: 16 warps an SM, not 12), then
//     backward from them: each exponential is computed once and no state is
//     recomputed (a recorded chunk longer than SC re-runs the forward from
//     the chunk start for its earlier sub-chunks);
//   - the sub-chunk's dt, x, g, B and C are staged in shared memory by the
//     whole block in coalesced rows with cp.async, double-buffered: the
//     next sub-chunk's copies are in flight while this one is computed;
//   - ddt and dx sum the channel's state groups with log2(N / 4) xor
//     shuffles; dB and dC sum over the warp's channels with a reduce-scatter
//     (2 x 4 values over the lanes of a state group), the block's warps meet
//     in shared memory, and each block writes one slab [ceil(E / CPB), B, L,
//     N] that the caller sums (CPB = 1024 / N channels a block). No float
//     atomics: the gradients are the same bits from run to run;
//   - dA_T sums over b and t: each thread writes its 4 partial sums to a
//     [B, N, E] slab that the caller sums; a NULL slab (A frozen) compiles
//     the accumulation out.
// Grid (ceil(E / CPB), B) of 256-thread blocks, two an SM: 1,152 blocks at
// the train shape, over four waves, so the last one is not a near-empty
// fraction (128-thread blocks, four an SM, timed 2.5% slower on an H100
// with twice the slabs).

#include "common.cuh"

namespace {

using mt::cp_async4;
using mt::cp_async_commit;
using mt::ex2;

constexpr int kThreads = 256;
constexpr int NW = kThreads / 32;  // warps per block
constexpr int NPT = 4;             // states per thread
constexpr int SC = 16;             // tokens whose states a pass keeps in registers
constexpr float kLog2e = 1.4426950408889634f;

// the channels a block covers at state size N (N / NPT lanes a channel)
__host__ __device__ constexpr int block_channels(int N) { return kThreads * NPT / N; }

// One level of the reduce-scatter over the lanes of a state group (lane
// stride S): a lane keeps half of its 2K values (the upper half when its
// channel bit K is set, moved down), adds its partner's copy of that half
// and sends the other half. K is a template argument so every index is
// known at compile time and v stays in registers.
template <int K, int V, int S>
__device__ __forceinline__ void reduce_scatter_level(float (&v)[V], int el) {
  const bool upper = (el & K) != 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float send = upper ? v[i] : v[i + K];
    const float keep = upper ? v[i + K] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, K * S);
  }
  if constexpr (K > 1) reduce_scatter_level<K / 2, V, S>(v, el);
}

// After the call, the lane of channel el (el < V) in each state group holds
// the sum of v[el] over the warp's EPW channels of that group.
template <int V, int S, int EPW>
__device__ __forceinline__ float reduce_scatter_channels(float (&v)[V], int el) {
  reduce_scatter_level<V / 2, V, S>(v, el);
  float s = v[0];
#pragma unroll
  for (int off = V; off < EPW; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off * S);
  return s;
}

// the dynamic shared memory of a block at state size N, in floats: exp(dt A)
// of the sub-chunk per thread ([SC][kThreads] float4s), two staging buffers
// (dt, x, g [SC][CPB]; B, C [SC][N]) and the warps' dB / dC partials
template <int N>
struct BwdSmem {
  static constexpr int CPB = block_channels(N);
  static constexpr int kDa = SC * kThreads * NPT;
  static constexpr int kStage = 3 * SC * CPB + 2 * SC * N;
  static constexpr int kRed = SC * NW * 2 * N;
  static constexpr int kBytes = (kDa + 2 * kStage + kRed) * 4;
};

// the sub-chunks, right to left: [s0, s_end) of recorded chunk c, at most SC
// tokens, the last sub-chunk of a chunk ending where the chunk ends
struct Sub {
  int c, s0, s_end;
};
__device__ __forceinline__ int sub_start(int cs, int s_end) {
  return cs + ((s_end - 1 - cs) / SC) * SC;
}
__device__ __forceinline__ bool next_sub(Sub& u, int chunk, int L) {
  if (u.s0 == u.c * chunk) {
    if (u.c == 0) return false;
    --u.c;
    u.s_end = min(L, (u.c + 1) * chunk);
  } else {
    u.s_end = u.s0;
  }
  u.s0 = sub_start(u.c * chunk, u.s_end);
  return true;
}

template <int N, bool NEED_DA>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                          const float* __restrict__ Bs, const float* __restrict__ Cs,
                          const float* __restrict__ A_T, const float* __restrict__ g,
                          const float* __restrict__ hb, float* __restrict__ ddt,
                          float* __restrict__ dx, float* __restrict__ dB_slab,
                          float* __restrict__ dC_slab, float* __restrict__ dA_slab,
                          int chunk, int L, int E) {
  using M = BwdSmem<N>;
  constexpr int NG = N / NPT;   // lanes a channel
  constexpr int CPB = M::CPB;   // channels a block
  constexpr int EPW = 32 / NG;  // channels a warp
  extern __shared__ __align__(16) float smem[];
  float4* s_da = reinterpret_cast<float4*>(smem);  // [SC][kThreads]
  float* stage_base = smem + M::kDa;               // [2][kStage]
  float* red = stage_base + 2 * M::kStage;         // [SC][NW][2N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = lane % NG, el = lane / NG;  // state group, channel in the warp
  const int ec = warp * EPW + el;            // channel in the block
  const int e0 = blockIdx.x * CPB, e = e0 + ec;
  const int b = blockIdx.y, n_batch = gridDim.y;
  const int n0 = ng * NPT;
  const bool live = e < E;  // threads past E add zeros, and shuffle and sync
  const int n_chunks = (L + chunk - 1) / chunk;
  const size_t row = static_cast<size_t>(b) * L;

  // the sub-chunk's dt, x, g, B and C into staging buffer buf, by the whole
  // block in coalesced rows (zeros past the sub-chunk and past E)
  auto stage = [&](const Sub& u, int buf) {
    float* st = stage_base + buf * M::kStage;
    const int n_tok = u.s_end - u.s0;
    for (int i = tid; i < SC * CPB; i += kThreads) {
      const int tt = i / CPB, ee = i % CPB;
      const bool ok = tt < n_tok && e0 + ee < E;
      const size_t o = ok ? (row + u.s0 + tt) * E + e0 + ee : 0;
      cp_async4(st + i, dt + o, ok);
      cp_async4(st + SC * CPB + i, x + o, ok);
      cp_async4(st + 2 * SC * CPB + i, g + o, ok);
    }
    for (int i = tid; i < SC * N; i += kThreads) {
      const bool ok = i / N < n_tok;
      const size_t o = ok ? (row + u.s0) * N + i : 0;
      cp_async4(st + 3 * SC * CPB + i, Bs + o, ok);
      cp_async4(st + 3 * SC * CPB + SC * N + i, Cs + o, ok);
    }
  };

  // exp(dt A) is taken as 2^((dt log2(e)) A) on the special-function unit
  float a[NPT], hhat[NPT], dat[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    a[k] = live ? A_T[static_cast<size_t>(n0 + k) * E + e] : 0.f;
    hhat[k] = 0.f;  // dA_{t+1} * hhat_{t+1}, carried right to left
    dat[k] = 0.f;
  }

  Sub u;
  u.c = n_chunks - 1;
  u.s_end = L;
  u.s0 = sub_start(u.c * chunk, L);
  stage(u, 0);
  cp_async_commit();
  for (int buf = 0;; buf ^= 1) {
    // the next sub-chunk's inputs load while this one is computed
    Sub nx = u;
    const bool more = next_sub(nx, chunk, L);
    if (more) stage(nx, buf ^ 1);
    cp_async_commit();  // an empty group keeps the wait count
    mt::cp_async_wait<1>();
    __syncthreads();  // this sub-chunk's staging has landed for every thread
    const float* st = stage_base + buf * M::kStage;
    const float* s_dt = st;
    const float* s_x = st + SC * CPB;
    const float* s_g = st + 2 * SC * CPB;
    const float* s_B = st + 3 * SC * CPB;
    const float* s_C = s_B + SC * N;
    const int cs = u.c * chunk, s0 = u.s0, n_tok = u.s_end - u.s0;

    // the state before s0: recorded at the chunk start, run forward over
    // the chunk's earlier sub-chunks (only for a chunk longer than SC)
    const float* hb_c = hb + (static_cast<size_t>(b) * n_chunks + u.c) * N * E + e;
    float h[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) h[k] = live ? hb_c[static_cast<size_t>(n0 + k) * E] : 0.f;
    for (int t = cs; t < s0; ++t) {
      const size_t o = (row + t) * E + e;
      const float dtv = live ? dt[o] : 0.f, dbx = dtv * (live ? x[o] : 0.f);
      const float dtl = dtv * kLog2e;
      const float* bt = Bs + (row + t) * N + n0;
#pragma unroll
      for (int k = 0; k < NPT; ++k) h[k] = fmaf(ex2(dtl * a[k]), h[k], dbx * bt[k]);
    }
    // forward over the sub-chunk: w_t = exp(dt_t A) h_{t-1} kept in
    // registers (the reverse step needs h_{t-1} only in that product, and
    // h_t = w_t + dt_t x_t B_t), exp(dt_t A) in this thread's column of
    // shared memory
    float w[SC][NPT];
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      if (i < n_tok) {
        const float dtv = s_dt[i * CPB + ec], dbx = dtv * s_x[i * CPB + ec];
        const float dtl = dtv * kLog2e;
        const float4 bv = *reinterpret_cast<const float4*>(s_B + i * N + n0);
        const float bk[NPT] = {bv.x, bv.y, bv.z, bv.w};
        float dA[NPT];
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          dA[k] = ex2(dtl * a[k]);
          w[i][k] = dA[k] * h[k];
          h[k] = fmaf(dbx, bk[k], w[i][k]);
        }
        s_da[i * kThreads + tid] = make_float4(dA[0], dA[1], dA[2], dA[3]);
      }
    }
    // backward over the sub-chunk
#pragma unroll
    for (int i = SC - 1; i >= 0; --i) {
      if (i < n_tok) {
        const float dtv = s_dt[i * CPB + ec], xv = s_x[i * CPB + ec], gv = s_g[i * CPB + ec];
        const float dbx = dtv * xv;
        const float4 bv = *reinterpret_cast<const float4*>(s_B + i * N + n0);
        const float4 cv = *reinterpret_cast<const float4*>(s_C + i * N + n0);
        const float4 dv = s_da[i * kThreads + tid];
        const float bk[NPT] = {bv.x, bv.y, bv.z, bv.w};
        const float ck[NPT] = {cv.x, cv.y, cv.z, cv.w};
        const float dAk[NPT] = {dv.x, dv.y, dv.z, dv.w};
        float v[2 * NPT];  // this thread's terms of dB_t (v[k]) and dC_t (v[NPT + k])
        float s_da_sum = 0.f, s_hb = 0.f;
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const float dA = dAk[k];
          const float hc = fmaf(dbx, bk[k], w[i][k]);  // h_t, as the forward computed it
          const float hh = fmaf(ck[k], gv, hhat[k]);
          const float hp_dA = hh * w[i][k];
          s_da_sum = fmaf(hp_dA, a[k], s_da_sum);
          s_hb = fmaf(hh, bk[k], s_hb);
          v[k] = hh * dbx;
          v[NPT + k] = hc * gv;
          if constexpr (NEED_DA) dat[k] = fmaf(hp_dA, dtv, dat[k]);
          hhat[k] = dA * hh;
        }
#pragma unroll
        for (int off = 1; off < NG; off <<= 1) {
          s_da_sum += __shfl_xor_sync(0xffffffffu, s_da_sum, off);
          s_hb += __shfl_xor_sync(0xffffffffu, s_hb, off);
        }
        if (live && ng == 0) {
          const size_t o = (row + s0 + i) * E + e;
          ddt[o] = fmaf(s_hb, xv, s_da_sum);
          dx[o] = s_hb * dtv;
        }
        const float sum = reduce_scatter_channels<2 * NPT, NG, EPW>(v, el);
        if (el < 2 * NPT) red[(i * NW + warp) * 2 * N + (el < NPT ? 0 : N) + n0 + el % NPT] = sum;
      }
    }
    __syncthreads();  // the warps' partials are in red; the staging is consumed
    for (int i = tid; i < n_tok * 2 * N; i += kThreads) {
      const int tt = i / (2 * N), j = i % (2 * N);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += red[(tt * NW + w) * 2 * N + j];
      const size_t off = ((static_cast<size_t>(blockIdx.x) * n_batch + b) * L + s0 + tt) * N;
      if (j < N)
        dB_slab[off + j] = sum;
      else
        dC_slab[off + j - N] = sum;
    }
    if (!more) break;
    u = nx;  // (the next sub-chunk writes red after its first barrier)
  }
  if constexpr (NEED_DA) {
    if (live) {
#pragma unroll
      for (int k = 0; k < NPT; ++k)
        dA_slab[(static_cast<size_t>(b) * N + n0 + k) * E + e] = dat[k];
    }
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* Bs, const float* Cs,
           const float* A_T, const float* g, const float* hb, float* ddt, float* dx,
           float* dB_slab, float* dC_slab, float* dA_slab, int n_slabs, int chunk, int B,
           int L, int E, cudaStream_t stream) {
  constexpr int CPB = block_channels(N), smem = BwdSmem<N>::kBytes;
  const dim3 grid((E + CPB - 1) / CPB, B);
  if (n_slabs != static_cast<int>(grid.x) || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = dA_slab ? selective_scan_bwd_kernel<N, true> : selective_scan_bwd_kernel<N, false>;
  // the most shared memory the SM can give: two blocks' 108 KB at N 16
  cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kThreads, smem, stream>>>(dt, x, Bs, Cs, A_T, g, hb, ddt, dx, dB_slab,
                                           dC_slab, dA_slab, chunk, L, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the dB / dC slabs of a launch at state size N over E channels:
// ceil(E / (1024 / N)), one per block of channels
extern "C" int mt_selective_scan_bwd_slabs(int E, int N) {
  return N == 4 || N == 8 || N == 16 ? (E + block_channels(N) - 1) / block_channels(N) : 0;
}

// dB_slab and dC_slab are [n_slabs, B, L, N] with n_slabs =
// mt_selective_scan_bwd_slabs(E, N); dA_slab is [B, N, E] or NULL (dA_T not
// wanted). chunk is the one K9 recorded hb with.
extern "C" int mt_selective_scan_bwd(const void* dt, const void* x, const void* Bs,
                                     const void* Cs, const void* A_T, const void* g,
                                     const void* hb, void* ddt, void* dx, void* dB_slab,
                                     void* dC_slab, void* dA_slab, int n_slabs, int chunk,
                                     int B, int L, int E, int N, void* stream) {
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
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 16)
    return launch<16>(dtf, xf, bf, cf, af, gf, hbf, ddtf, dxf, dbf, dcf, daf, n_slabs, chunk,
                      B, L, E, st);
  if (N == 8)
    return launch<8>(dtf, xf, bf, cf, af, gf, hbf, ddtf, dxf, dbf, dcf, daf, n_slabs, chunk,
                     B, L, E, st);
  if (N == 4)
    return launch<4>(dtf, xf, bf, cf, af, gf, hbf, ddtf, dxf, dbf, dcf, daf, n_slabs, chunk,
                     B, L, E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
