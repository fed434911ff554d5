// K3: reprogramming cross-attention, f32 throughout.
//   out[b, l, h, :] = softmax(scale * q[b, l, h, :] . k[:, h, :]) @ v[:, h, :]
// q [B, L, H, E]; the K/V basis [S, H, E] is shared by the whole batch.
//
// Replaces medtsllm_tpu/ops/pallas/reprogramming.py::reprogramming_attention
// (_kernel). The TPU kernel kept one head's basis resident in VMEM and ran
// the grid head-major. One head's K/V is S*E*4*2 = 1 MB at the serving shape
// (S=1024, E=128), far above the 227 KB of shared memory a block may use, so
// here K/V stream through shared memory in 32-row tiles under an online
// softmax, and head-major order moves to the grid: blocks of one head are
// launched back to back (head is the slowest grid axis) so the 4 MB basis
// stays hot in the 50 MB L2.
//
// What bounds it: ~2*B*H*L*S*E*2 = 1 GFLOP at the serving shape, read from
// L2 — latency and L2 bandwidth, not FLOPs. One block per (query tile of 16,
// batch, head); one thread owns one E column of the output. No TF32: the
// fusion layers run in f32 (flax promotion), and so does this kernel.

#include "common.cuh"

namespace {

constexpr int QT = 16;  // queries per block
constexpr int ST = 32;  // keys per staged tile

template <int E>
__global__ void __launch_bounds__(E)
reprogramming_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int L, int H, int S, float scale) {
  __shared__ float sq[QT][E + 1];
  __shared__ float sk[ST][E + 1];
  __shared__ float sv[ST][E];
  __shared__ float sp[QT][ST];
  __shared__ float s_m[QT], s_l[QT], s_corr[QT];

  const int l0 = blockIdx.x * QT, b = blockIdx.y, h = blockIdx.z;
  const int t = threadIdx.x;
  for (int r = 0; r < QT; ++r) {
    const int l = l0 + r;
    sq[r][t] = l < L ? q[((static_cast<size_t>(b) * L + l) * H + h) * E + t] : 0.f;
  }
  if (t < QT) {
    s_m[t] = -INFINITY;
    s_l[t] = 0.f;
  }
  float acc[QT];
#pragma unroll
  for (int r = 0; r < QT; ++r) acc[r] = 0.f;

  for (int s0 = 0; s0 < S; s0 += ST) {
    __syncthreads();
    for (int j = 0; j < ST; ++j) {
      const int s = s0 + j;
      const size_t o = (static_cast<size_t>(s) * H + h) * E + t;
      sk[j][t] = s < S ? k[o] : 0.f;
      sv[j][t] = s < S ? v[o] : 0.f;
    }
    __syncthreads();
    for (int i = t; i < QT * ST; i += E) {
      const int r = i / ST, j = i % ST;
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < E; ++e) dot = fmaf(sq[r][e], sk[j][e], dot);
      sp[r][j] = s0 + j < S ? dot * scale : -INFINITY;
    }
    __syncthreads();
    if (t < QT) {  // online-softmax update of row t
      const float m_old = s_m[t];
      float mx = m_old;
      for (int j = 0; j < ST; ++j) mx = fmaxf(mx, sp[t][j]);
      const float corr = expf(m_old - mx);
      float sum = 0.f;
      for (int j = 0; j < ST; ++j) {
        const float p = expf(sp[t][j] - mx);
        sp[t][j] = p;
        sum += p;
      }
      s_l[t] = s_l[t] * corr + sum;
      s_m[t] = mx;
      s_corr[t] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QT; ++r) acc[r] *= s_corr[r];
    for (int j = 0; j < ST; ++j) {
      const float vv = sv[j][t];
#pragma unroll
      for (int r = 0; r < QT; ++r) acc[r] = fmaf(sp[r][j], vv, acc[r]);
    }
  }
  for (int r = 0; r < QT; ++r) {
    const int l = l0 + r;
    if (l < L) out[((static_cast<size_t>(b) * L + l) * H + h) * E + t] = acc[r] / s_l[r];
  }
}

template <int E>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int L, int H, int S, float scale, cudaStream_t stream) {
  const dim3 grid((L + QT - 1) / QT, B, H);  // head slowest: head-major order
  reprogramming_kernel<E><<<grid, E, 0, stream>>>(q, k, v, out, L, H, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mt_reprogramming_attention(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int L, int H, int E, int S,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  if (E == 128) return launch<128>(qf, kf, vf, of, B, L, H, S, scale, st);
  if (E == 64) return launch<64>(qf, kf, vf, of, B, L, H, S, scale, st);
  if (E == 32) return launch<32>(qf, kf, vf, of, B, L, H, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
