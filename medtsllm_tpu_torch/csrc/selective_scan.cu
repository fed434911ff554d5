// K7/K8: the selective-SSM scan of the Mamba block, f32 throughout.
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel e)
//   y_t = sum_n C_t[n] * h_t[n] + D * x_t
// dt, x, y [B, L, E]; B, C [B, L, N]; A_T [N, E]; D [E]; h0 [1 or B, N, E]
// (optional); h_final [B, N, E] (optional).
//
// Replaces medtsllm_tpu/ops/pallas/selective_scan.py::_ssm_pallas (h starts
// at 0) and ::_ssm_pallas_h0 (h starts at a cached prefix state), and runs
// the prefill form selective_ssm_final (JAX leaves that one to XLA) when
// h_final is given, so the scan has no plain version on the card's path.
// The TPU kernel tiled the sequence into chunks of 16 carried through VMEM
// scratch by a sequential grid axis, padding L with dt = 0; here the whole
// sequence is a loop inside one thread and runs the true L, so neither the
// chunks nor the padding carry over.
//
// What bounds it: every channel (b, e) is an independent recurrence over L
// with a diagonal A, so the [B, L, N, E] discretised tensors never need to
// exist. The kernel reads dt and x once and writes y once (3 x B*L*E*4
// bytes, ~127 MB per layer at the Mamba serving shape B=48, L=144,
// E=1536), and runs B*L*N*E expf on the special-function units, whose
// time is of the same order. One thread owns
// one (b, e) channel with its N states and A_T[:, e], D[e] in registers;
// a block of 128 neighbouring channels of one batch row stages dt and x for
// TT tokens (coalesced: neighbouring threads read neighbouring e) and the
// row's B_t, C_t, which all its threads share, in shared memory. expf, not
// __expf, and no fast-math: the result agrees with the f32 reference to
// 1e-5.

#include "common.cuh"

namespace {

constexpr int EB = 128;  // channels per block, one thread each
constexpr int TT = 32;   // tokens staged per tile

template <int N>
__global__ void __launch_bounds__(EB)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ Bs, const float* __restrict__ Cs,
                      const float* __restrict__ A_T, const float* __restrict__ D,
                      const float* __restrict__ h0, size_t h0_bstride,
                      float* __restrict__ y, float* __restrict__ h_final,
                      int L, int E) {
  __shared__ float s_dt[TT][EB];
  __shared__ float s_x[TT][EB];
  __shared__ float s_b[TT][N];
  __shared__ float s_c[TT][N];

  const int tid = threadIdx.x;
  const int e = blockIdx.x * EB + tid;
  const int b = blockIdx.y;
  const bool live = e < E;  // threads past E still stage B/C and sync

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A_T[static_cast<size_t>(n) * E + e] : 0.f;
    h[n] = (live && h0 != nullptr)
               ? h0[b * h0_bstride + static_cast<size_t>(n) * E + e] : 0.f;
  }
  const float d = live ? D[e] : 0.f;

  const size_t row = static_cast<size_t>(b) * L;  // first token of batch b
  for (int t0 = 0; t0 < L; t0 += TT) {
    const int nt = min(TT, L - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = 0; i < nt; ++i) {
      const size_t o = (row + t0 + i) * E + e;
      s_dt[i][tid] = live ? dt[o] : 0.f;
      s_x[i][tid] = live ? x[o] : 0.f;
    }
    for (int i = tid; i < nt * N; i += EB) {
      s_b[i / N][i % N] = Bs[(row + t0) * N + i];
      s_c[i / N][i % N] = Cs[(row + t0) * N + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nt; ++i) {
      const float dtv = s_dt[i][tid], xv = s_x[i][tid];
      const float dbx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + dbx * s_b[i][n];
        acc += h[n] * s_c[i][n];
      }
      y[(row + t0 + i) * E + e] = acc + d * xv;
    }
  }
  if (live && h_final != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      h_final[(static_cast<size_t>(b) * N + n) * E + e] = h[n];
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* Bs, const float* Cs,
           const float* A_T, const float* D, const float* h0, int h0_batched,
           float* y, float* h_final, int B, int L, int E, cudaStream_t stream) {
  const dim3 grid((E + EB - 1) / EB, B);
  const size_t h0_bstride = h0_batched ? static_cast<size_t>(N) * E : 0;
  selective_scan_kernel<N><<<grid, EB, 0, stream>>>(
      dt, x, Bs, Cs, A_T, D, h0, h0_bstride, y, h_final, L, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h0 and h_final may be NULL; h0_batched = 0 lets every batch row read one
// cached state (h0 [1, N, E]), 1 gives each row its own (h0 [B, N, E]).
extern "C" int mt_selective_scan(const void* dt, const void* x, const void* Bs,
                                 const void* Cs, const void* A_T, const void* D,
                                 const void* h0, int h0_batched, void* y,
                                 void* h_final, int B, int L, int E, int N,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(Bs);
  const auto* cf = static_cast<const float*>(Cs);
  const auto* af = static_cast<const float*>(A_T);
  const auto* df = static_cast<const float*>(D);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* ff = static_cast<float*>(h_final);
  if (N == 16)
    return launch<16>(dtf, xf, bf, cf, af, df, hf, h0_batched, yf, ff, B, L, E, st);
  if (N == 8)
    return launch<8>(dtf, xf, bf, cf, af, df, hf, h0_batched, yf, ff, B, L, E, st);
  if (N == 4)
    return launch<4>(dtf, xf, bf, cf, af, df, hf, h0_batched, yf, ff, B, L, E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
