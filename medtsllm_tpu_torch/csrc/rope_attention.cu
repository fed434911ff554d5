// K2: fused RoPE + cached-prefix + end-aligned causal attention.
//
// Replaces medtsllm_tpu/ops/pallas/rope_attention.py::fused_rope_attention
// (_pallas_forward / _kernel), forward only, and follows the numerics of the
// XLA path JAX runs at this length (flash_attention._attention_reference):
//   - q/k rotated half-split at the compute dtype: cos/sin (f32 tables) are
//     cast to it first, the rotation rounds once to it;
//   - the prefix K/V [1 or B, KV, P, D] is already rotated and is masked by
//     its true length P (no TPU tile padding);
//   - f32 scores x sm_scale, end-aligned causal mask (query i sees keys
//     <= i + S - L, S = P + L), f32 softmax NORMALISED before the
//     probabilities round to v's dtype, PV accumulated in f32, output
//     rounded to the compute dtype, written in [B, L, H, D];
//   - KV may divide H (kv head = h / (H / KV)); the JAX kernel gated KV == H.
//
// What bounds it: at the serving shape (B=8, L~112, P~48, H=32, D=128) the
// work is ~2.6k tiny [L, D] x [D, S] problems — a few MFLOP each — so the
// cost is memory traffic and launch/latency, not FLOPs. The design keeps
// everything of one (batch, head, 16-query tile) in shared memory: q rows
// rotated once, keys rotated as their tile is staged, the whole score row
// kept on chip for an exact two-pass softmax (S <= 2048), then V streamed
// in 32-row tiles against the probabilities. One thread owns one head-dim
// column (blockDim = D); no tensor cores yet.

#include "common.cuh"

namespace {

constexpr int QT = 16;   // queries per block
constexpr int KT = 32;   // keys / values staged per tile

// element d of the half-split rotation of row x at cos/sin row c/s,
// computed at T's precision (the tables are cast to T before use)
template <typename T, int D>
__device__ __forceinline__ float rope_elem(const T* x, const float* c,
                                           const float* s, int d) {
  constexpr int HALF = D / 2;
  const int i = d < HALF ? d : d - HALF;
  const float cf = mt::round_to<T>(c[i]), sf = mt::round_to<T>(s[i]);
  const float x1 = mt::to_f32(x[i]), x2 = mt::to_f32(x[i + HALF]);
  const float r = d < HALF ? __fsub_rn(__fmul_rn(x1, cf), __fmul_rn(x2, sf))
                           : __fadd_rn(__fmul_rn(x2, cf), __fmul_rn(x1, sf));
  return mt::round_to<T>(r);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ cosb,
                      const float* __restrict__ sinb,
                      const T* __restrict__ pk, const T* __restrict__ pv,
                      T* __restrict__ out, int L, int H, int KV, int P,
                      int PB, float sm_scale, int S_pad) {
  constexpr int HALF = D / 2, LD = D + 1, NW = D / 32;
  extern __shared__ float smem[];
  float* sq = smem;               // [QT][LD] rotated queries
  float* skv = sq + QT * LD;      // [KT][LD] staged keys, then values
  float* ss = skv + KT * LD;      // [QT][S_pad] scores, then probabilities

  const int l0 = blockIdx.x * QT, b = blockIdx.y, h = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int kvh = h / (H / KV);
  const int pb = PB == 1 ? 0 : b;
  const int rows = min(QT, L - l0);
  const int kmax = min(P + L, l0 + rows + P);  // keys any row here may see

  for (int r = 0; r < QT; ++r) {
    const int l = l0 + r;
    sq[r * LD + t] =
        l < L ? rope_elem<T, D>(q + (static_cast<size_t>(b) * L + l) * H * D +
                                    static_cast<size_t>(h) * D,
                                cosb + static_cast<size_t>(l) * HALF,
                                sinb + static_cast<size_t>(l) * HALF, t)
              : 0.f;
  }

  // pass 1: scores into ss
  for (int j0 = 0; j0 < kmax; j0 += KT) {
    __syncthreads();
    for (int j = 0; j < KT; ++j) {
      const int kg = j0 + j;
      float val = 0.f;
      if (kg < P) {
        val = mt::to_f32(pk[((static_cast<size_t>(pb) * KV + kvh) * P + kg) * D + t]);
      } else if (kg < kmax) {
        const int l = kg - P;
        val = rope_elem<T, D>(k + (static_cast<size_t>(b) * L + l) * KV * D +
                                  static_cast<size_t>(kvh) * D,
                              cosb + static_cast<size_t>(l) * HALF,
                              sinb + static_cast<size_t>(l) * HALF, t);
      }
      skv[j * LD + t] = val;
    }
    __syncthreads();
    for (int i = t; i < QT * KT; i += D) {
      const int r = i / KT, j = i % KT, kg = j0 + j;
      float sc = -INFINITY;
      if (r < rows && kg < kmax && kg <= l0 + r + P) {
        float dot = 0.f;
#pragma unroll 8
        for (int e = 0; e < D; ++e) dot = fmaf(sq[r * LD + e], skv[j * LD + e], dot);
        sc = dot * sm_scale;
      }
      ss[r * S_pad + kg] = sc;
    }
  }
  __syncthreads();

  // exact softmax per row (one warp per row), normalised then rounded to T;
  // keys a row may not see get probability 0
  for (int r = warp; r < rows; r += NW) {
    float* row = ss + r * S_pad;
    const int n = min(kmax, l0 + r + P + 1);
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < n; j += 32) row[j] = mt::round_to<T>(__fdiv_rn(row[j], sum));
    for (int j = n + lane; j < kmax; j += 32) row[j] = 0.f;
  }

  // pass 2: out[r, t] = sum_j p[r, j] * v[j, t]
  float acc[QT];
#pragma unroll
  for (int r = 0; r < QT; ++r) acc[r] = 0.f;
  for (int j0 = 0; j0 < kmax; j0 += KT) {
    __syncthreads();
    for (int j = 0; j < KT; ++j) {
      const int kg = j0 + j;
      float val = 0.f;
      if (kg < P)
        val = mt::to_f32(pv[((static_cast<size_t>(pb) * KV + kvh) * P + kg) * D + t]);
      else if (kg < kmax)
        val = mt::to_f32(v[(static_cast<size_t>(b) * L + (kg - P)) * KV * D +
                           static_cast<size_t>(kvh) * D + t]);
      skv[j * LD + t] = val;
    }
    __syncthreads();
    const int jn = min(KT, kmax - j0);
    for (int j = 0; j < jn; ++j) {
      const float vv = skv[j * LD + t];
#pragma unroll
      for (int r = 0; r < QT; ++r) acc[r] = fmaf(ss[r * S_pad + j0 + j], vv, acc[r]);
    }
  }
  for (int r = 0; r < rows; ++r)
    out[(static_cast<size_t>(b) * L + l0 + r) * H * D + static_cast<size_t>(h) * D + t] =
        mt::from_f32<T>(acc[r]);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* cosb,
           const float* sinb, const void* pk, const void* pv, void* out,
           int B, int L, int H, int KV, int P, int PB, float sm_scale,
           cudaStream_t stream) {
  const int S_pad = (P + L + KT - 1) / KT * KT;
  const size_t smem = sizeof(float) * ((QT + KT) * (D + 1) + QT * S_pad);
  auto kernel = rope_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + QT - 1) / QT, B, H);
  kernel<<<grid, D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      cosb, sinb, static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<T*>(out), L, H, KV, P, PB, sm_scale, S_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mt_rope_attention(const void* q, const void* k, const void* v,
                                 const void* cosb, const void* sinb,
                                 const void* pk, const void* pv, void* out,
                                 int is_bf16, int B, int L, int H, int KV, int D,
                                 int P, int PB, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cosb);
  const auto* sn = static_cast<const float*>(sinb);
  if (is_bf16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, c, sn, pk, pv, out, B, L, H, KV, P, PB, sm_scale, s);
  if (is_bf16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, c, sn, pk, pv, out, B, L, H, KV, P, PB, sm_scale, s);
  if (!is_bf16 && D == 128)
    return launch<float, 128>(q, k, v, c, sn, pk, pv, out, B, L, H, KV, P, PB, sm_scale, s);
  if (!is_bf16 && D == 64)
    return launch<float, 64>(q, k, v, c, sn, pk, pv, out, B, L, H, KV, P, PB, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
