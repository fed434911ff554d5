// K4: blocked online-softmax attention (flash attention), forward.
//
// Replaces medtsllm_tpu/ops/pallas/flash_attention.py::flash_attention
// (_flash_attention_pallas / _flash_kernel). It computes what _flash_kernel
// computes, not its block layout:
//   - q [B, H, L, D] against k/v [B, KV, S, D], KV dividing H: query row
//     b * H + h reads kv row b * KV + h / (H / KV), never another batch row;
//   - f32 scores x sm_scale; masked scores are -1e30, as in JAX: columns
//     past S (the K/V rows past S are zeroed in shared memory, since
//     garbage x 0 can be NaN) and, when causal, columns above the
//     end-aligned diagonal (query i sees keys <= i + S - L);
//   - per query row an f32 running max m, sum l and accumulator acc; per
//     k-tile m_new = max(m, rowmax(s)), alpha = exp(m - m_new),
//     p = exp(s - m_new), l = alpha l + rowsum(p) (p in f32),
//     acc = alpha acc + p v with p rounded to v's dtype first (JAX's
//     p.astype(v.dtype));
//   - out = acc / max(l, 1e-30), rounded to q's dtype; query rows past L
//     are not written; k-tiles wholly above the diagonal are skipped.
// The normalisation comes after PV here and before the cast in the plain
// version, so bf16 outputs differ from it by a few bf16 ulps.
//
// What bounds it: at the long-window serving shape (B 8, H 32, D 128,
// L ~2128, S ~2165, causal) a call does ~0.3 TFLOP of bf16 products against
// ~0.6 GB of operands, ~500 operations per byte, so it is bound by the
// tensor cores, not by memory. The bf16 design: one block of four warps per
// 64-query tile of one (batch, head), each warp holding its 16 query rows
// as mma fragments in registers; 64-key tiles of K and V staged in padded
// shared memory (34 KB at D 128: conflict-free fragment loads); QK^T and PV
// on mma.sync m16n8k16 bf16 -> f32, the score fragments reused in registers
// as PV's A operand; the softmax state in registers, reduced across the
// four threads of a quad. No cp.async double buffering, wgmma or TMA yet.
// f32 inputs take a plain FMA kernel (no TF32): one thread per head-dim
// column over 16-query x 32-key tiles, for f32 parity with the CPU.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---- bf16: tensor cores ---------------------------------------------------
constexpr int BQ = 64;       // queries per block (16 per warp)
constexpr int BK = 64;       // keys per staged tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// stage rows [r0, r0 + 64) of a row-major [R, D] bf16 matrix into s (rows
// of D + 8 elements); rows >= R are zero
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s, const __nv_bfloat16* g,
                                           int r0, int R) {
  constexpr int LDS = D + 8, CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BK * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < R)
      val = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(r0 + r) * D + cc);
    *reinterpret_cast<uint4*>(s + r * LDS + cc) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int H, int KV, int L, int S,
                  int causal, float sm_scale) {
  constexpr int LDS = D + 8;       // padded row: 4-word bank shift per row
  constexpr int KSTEPS = D / 16;   // QK^T steps over the head dim
  constexpr int NT_O = D / 8;      // output column tiles of 8
  constexpr int NT_S = BK / 8;     // score column tiles of 8
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LDS];

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kv_row = static_cast<size_t>(b) * KV + h / (H / KV);
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * L * D;
  const __nv_bfloat16* kb = k + kv_row * S * D;
  const __nv_bfloat16* vb = v + kv_row * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int offs = S - L;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  // the warp's 16 query rows as A fragments (staged through sK)
  stage_rows<D>(sK, qb, q0, L);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  {
    const __nv_bfloat16* sq = sK + (warp * 16 + g) * LDS + t4 * 2;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      qf[ks][0] = ld_pair(sq + ks * 16);
      qf[ks][1] = ld_pair(sq + 8 * LDS + ks * 16);
      qf[ks][2] = ld_pair(sq + ks * 16 + 8);
      qf[ks][3] = ld_pair(sq + 8 * LDS + ks * 16 + 8);
    }
  }

  // keys any row of this block may see
  const int kend = causal ? min(S, q0 + BQ + offs) : S;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile (or the Q staging) is consumed
    stage_rows<D>(sK, kb, j0, S);
    stage_rows<D>(sV, vb, j0, S);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* sk = sK + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(s[nt], qf[ks], ld_pair(sk + ks * 16), ld_pair(sk + ks * 16 + 8));
    }

    // scale, mask, the rows' max over this tile
    float mc[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = j0 + nt * 8 + t4 * 2 + (e & 1);
        float val = s[nt][e] * sm_scale;
        if (col >= S || (causal && col > row + offs)) val = kNegInf;
        s[nt][e] = val;
        mc[e >> 1] = fmaxf(mc[e >> 1], val);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float m_new = fmaxf(m_r[i], mc[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = alpha[i] * l_r[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // acc += P V: two adjacent score tiles form one 16 x 16 A fragment;
    // B[key][col] = V[j0 + key][col], two keys per register
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* sv = sV + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* p = sv + n * 8;
        mma_bf16(o[n], a, pack_raw(p[0], p[LDS]), pack_raw(p[8 * LDS], p[9 * LDS]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= L) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * L + row) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(__fdiv_rn(o[n][2 * i], den), __fdiv_rn(o[n][2 * i + 1], den));
  }
}

// ---- f32: plain FMAs, one thread per head-dim column ----------------------
constexpr int FQ = 16;  // queries per block
constexpr int FK = 32;  // keys per staged tile (one per lane in the softmax)

template <int D>
__global__ void __launch_bounds__(D)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int KV, int L, int S, int causal, float sm_scale) {
  constexpr int LD = D + 1, NW = D / 32, RW = FQ / NW;  // rows per warp
  __shared__ float sq[FQ * LD];
  __shared__ float skv[FK * LD];
  __shared__ float sp[FQ][FK];  // scores, then probabilities
  __shared__ float s_alpha[FQ];
  __shared__ float s_l[FQ];

  const int q0 = blockIdx.x * FQ, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kv_row = static_cast<size_t>(b) * KV + h / (H / KV);
  const float* qb = q + static_cast<size_t>(bh) * L * D;
  const float* kb = k + kv_row * S * D;
  const float* vb = v + kv_row * S * D;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int offs = S - L;

  for (int r = 0; r < FQ; ++r)
    sq[r * LD + t] = q0 + r < L ? qb[static_cast<size_t>(q0 + r) * D + t] : 0.f;
  const int kend = causal ? min(S, q0 + FQ + offs) : S;
  const int ntiles = kend > 0 ? (kend + FK - 1) / FK : 0;

  float m_w[RW], l_w[RW], acc[FQ];
#pragma unroll
  for (int i = 0; i < RW; ++i) m_w[i] = kNegInf, l_w[i] = 0.f;
#pragma unroll
  for (int r = 0; r < FQ; ++r) acc[r] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int j0 = tile * FK;
    __syncthreads();
    for (int j = 0; j < FK; ++j)
      skv[j * LD + t] = j0 + j < S ? kb[static_cast<size_t>(j0 + j) * D + t] : 0.f;
    __syncthreads();
    for (int i = t; i < FQ * FK; i += D) {
      const int r = i / FK, j = i % FK;
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(sq[r * LD + e], skv[j * LD + e], dot);
      sp[r][j] = dot * sm_scale;
    }
    __syncthreads();
    // online softmax: warp w owns rows w, w + NW, ...; lane j owns key j0 + j
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * NW, row = q0 + r, col = j0 + lane;
      float val = sp[r][lane];
      if (col >= S || (causal && col > row + offs)) val = kNegInf;
      float mc = val;
      for (int o = 16; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_new = fmaxf(m_w[i], mc);
      const float alpha = expf(m_w[i] - m_new);
      const float p = expf(val - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_w[i] = alpha * l_w[i] + sum;
      m_w[i] = m_new;
      sp[r][lane] = p;
      if (lane == 0) s_alpha[r] = alpha;
    }
    for (int j = 0; j < FK; ++j)
      skv[j * LD + t] = j0 + j < S ? vb[static_cast<size_t>(j0 + j) * D + t] : 0.f;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FQ; ++r) {
      float a = acc[r] * s_alpha[r];
      for (int j = 0; j < FK; ++j) a = fmaf(sp[r][j], skv[j * LD + t], a);
      acc[r] = a;
    }
  }
  if (lane == 0)
    for (int i = 0; i < RW; ++i) s_l[warp + i * NW] = l_w[i];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < FQ; ++r)
    if (q0 + r < L)
      out[(static_cast<size_t>(bh) * L + q0 + r) * D + t] =
          __fdiv_rn(acc[r], fmaxf(s_l[r], 1e-30f));
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int H, int KV, int L, int S, int causal, float sm_scale,
                cudaStream_t stream) {
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, KV,
      L, S, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int L, int S, int causal, float sm_scale,
               cudaStream_t stream) {
  const dim3 grid((L + FQ - 1) / FQ, B * H);
  flash_f32_kernel<D><<<grid, D, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, L, S, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int is_bf16, int causal, int B, int H,
                                  int KV, int L, int S, int D, float sm_scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && D == 128)
    return launch_bf16<128>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  if (is_bf16 && D == 64)
    return launch_bf16<64>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  if (!is_bf16 && D == 128)
    return launch_f32<128>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  if (!is_bf16 && D == 64)
    return launch_f32<64>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
