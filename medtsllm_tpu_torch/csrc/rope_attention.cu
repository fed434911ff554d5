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
// (The Pallas body rounds the unnormalised probabilities and divides after
// PV; the plain version, and this kernel, normalise first.)
//
// What bounds it: at the serving shapes (7B: B 8, L 112, H = KV = 32, D 128,
// P 37; moe-8x1b: B 48, L 144, H 32, KV 4, D 64, P 14) a few MFLOP per
// (batch, head) against reading q/k/v once: bytes and latency, not FLOPs.
//
// bf16, the served form: tensor cores on a K/V tile shared by the G = H / KV
// query heads of a group.
//   - rope_attention_keys_kernel rotates the region's keys once (f32, one
//     rounding to bf16) into a scratch copy in k's layout: each key is
//     rotated once, not once per query tile and pass, and the attention
//     kernel reads no cos/sin for keys (f32 tables, twice a key's bytes).
//   - rope_attention_tc_kernel: one block per (64 query rows, batch, KV
//     head); its rows are drawn from all G heads of the group, row r <->
//     (position r / G, head r % G), so a K/V tile is staged once per group,
//     not G times, and the causal extent of a tile stays tight (64 / G
//     positions). q is rotated once into shared memory (as the keys are)
//     and held in registers as mma.sync A fragments.
//   - 64-key tiles copied by cp.async into a double-buffered ring straight
//     from the projection layout (a head's rows are H * D apart: no
//     transpose in front); rows past the keys are zero-filled. The first
//     tile is in flight while q is rotated.
//   - Scores: mma.sync m16n8k16 bf16 -> f32 (each warp 16 rows x 64 keys).
//     mma.sync, not wgmma: the per-(batch, head) products are a few MFLOP,
//     64-row wgmma tiles would idle on the short causal rows, and the row's
//     softmax statistics need the scores in registers anyway.
//   - Two passes over the key tiles, run as one tile sequence so the next
//     tile is always in flight: the first keeps each row's running max and
//     sum, the second recomputes the scores, normalises, rounds the
//     probabilities to bf16 in the A-fragment order and accumulates P.V (V
//     read by ldmatrix.trans) in f32. No score row lives in shared memory;
//     S is bounded only by MAX_KEYS.
//
// f32, the card-versus-CPU checks' form (rope_attention_f32_kernel): exact
// f32 on FMAs, no TF32. One block of D threads per (batch, query head,
// 16-query tile); the whole score row in shared memory for an exact
// two-pass softmax (S <= 2048), then V streamed in 32-row tiles.

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
rope_attention_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  auto kernel = rope_attention_f32_kernel<T, D>;
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


// ---- bf16: tensor cores on a GQA-shared K/V tile ---------------------------

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;         // query rows per block: 4 warps x 16
constexpr int kKeys = 64;         // keys per staged tile
constexpr int kTcThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the half-split rotation of the pair (x1, x2) = (x[d], x[d + D/2]) at
// position row c/s, in f32 with the tables rounded to bf16 first, rounded
// once to bf16 (the f32 kernel's rope_elem, two lanes at a time)
__device__ __forceinline__ void rope_pair(__nv_bfloat162& a, __nv_bfloat162& b, float2 c,
                                          float2 s) {
  const float c0 = mt::round_to<bf16>(c.x), c1 = mt::round_to<bf16>(c.y);
  const float s0 = mt::round_to<bf16>(s.x), s1 = mt::round_to<bf16>(s.y);
  const float2 x1 = __bfloat1622float2(a), x2 = __bfloat1622float2(b);
  a = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(x1.x, c0), __fmul_rn(x2.x, s0)),
                            __fsub_rn(__fmul_rn(x1.y, c1), __fmul_rn(x2.y, s1)));
  b = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(x2.x, c0), __fmul_rn(x1.x, s0)),
                            __fadd_rn(__fmul_rn(x2.y, c1), __fmul_rn(x1.y, s1)));
}

// k [B * L * KV rows, D] rotated once into kr, row (b, l, kvh) at position
// l: one thread a pair of pairs (d, d + 1) and (d + D/2, d + D/2 + 1)
template <int D>
__global__ void __launch_bounds__(256)
rope_attention_keys_kernel(const bf16* __restrict__ k, const float* __restrict__ cosb,
                 const float* __restrict__ sinb, bf16* __restrict__ kr, int rows, int L,
                 int KV) {
  constexpr int HALF = D / 2, PAIRS = HALF / 2;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(rows) * PAIRS) return;
  const int row = static_cast<int>(idx / PAIRS), d = 2 * static_cast<int>(idx % PAIRS);
  const int l = (row / KV) % L;
  const size_t o = static_cast<size_t>(row) * D + d;
  __nv_bfloat162 x1 = *reinterpret_cast<const __nv_bfloat162*>(k + o);
  __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(k + o + HALF);
  rope_pair(x1, x2, *reinterpret_cast<const float2*>(cosb + l * HALF + d),
            *reinterpret_cast<const float2*>(sinb + l * HALF + d));
  *reinterpret_cast<__nv_bfloat162*>(kr + o) = x1;
  *reinterpret_cast<__nv_bfloat162*>(kr + o + HALF) = x2;
}

// kr: the region's keys, rotated (rope_attention_keys_kernel). At D 64 the
// registers are capped for four blocks an SM (128 a thread): the MoE
// shape's thousands of short blocks then hide each other's latency.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 4 : 1)
rope_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kr,
                         const bf16* __restrict__ v, const float* __restrict__ cosb,
                         const float* __restrict__ sinb, const bf16* __restrict__ pk,
                         const bf16* __restrict__ pv, bf16* __restrict__ out, int L, int H,
                         int KV, int P, int PB, float sm_scale) {
  constexpr int HALF = D / 2;
  constexpr int LDS = D + 8;        // row pitch (elements): conflict-free ldmatrix
  constexpr int CH = D / 8;         // 16-byte chunks per row
  constexpr int DK = D / 16;        // k-steps of q . k over d
  constexpr int ND = D / 8;         // n-tiles of P . V over d
  constexpr int NK = kKeys / 8;     // n-tiles of q . k over keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [2][kKeys][LDS] keys
  bf16* sV = sK + 2 * kKeys * LDS;               // [2][kKeys][LDS] values
  bf16* sQ = sV;  // [kRows][LDS] rotated queries, before the first value tile

  const int G = H / KV, GL = G * L;
  const int r0 = blockIdx.x * kRows, b = blockIdx.y, kvh = blockIdx.z;
  const int pb = PB == 1 ? 0 : b;
  const int rows = min(kRows, GL - r0);
  const int kmax = P + (r0 + rows - 1) / G + 1;  // keys any row here may see
  const int nkt = (kmax + kKeys - 1) / kKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;

  // the key tiles run twice, u = 0 .. 2 nkt - 1: pass 1 (u < nkt) keys
  // only, pass 2 keys and values. Tile u (keys [j0, j0 + kKeys)) goes to
  // buffer u % 2: the prefix's rows from pk / pv, the region's from kr / v;
  // rows at or past kmax zero-filled
  auto stage = [&](int u) {
    const int buf = u & 1, j0 = (u < nkt ? u : u - nkt) * kKeys;
#pragma unroll
    for (int it = 0; it < kKeys * CH / kTcThreads; ++it) {
      const int i = tid + it * kTcThreads, jr = i / CH, ch = i % CH, kg = j0 + jr;
      const bool ok = kg < kmax;
      size_t off = 0;
      const bf16 *ks = kr, *vs = v;
      if (ok && kg < P) {
        off = ((static_cast<size_t>(pb) * KV + kvh) * P + kg) * D + ch * 8;
        ks = pk, vs = pv;
      } else if (ok) {
        off = ((static_cast<size_t>(b) * L + kg - P) * KV + kvh) * D + ch * 8;
      }
      const int n = ok ? 16 : 0;
      cp_async16(sK + (buf * kKeys + jr) * LDS + ch * 8, ks + off, n);
      if (u >= nkt) cp_async16(sV + (buf * kKeys + jr) * LDS + ch * 8, vs + off, n);
    }
    cp_async_commit();
  };
  stage(0);  // in flight while q is rotated

  // q rows rotated once into sQ: local row r is (position (r0 + r) / G,
  // head kvh * G + (r0 + r) % G); rows past G * L are zero. Each thread
  // rotates QIT pairs of pairs, loading four at a time so their reads are
  // in flight together
  constexpr int PAIRS = HALF / 2, QIT = kRows * PAIRS / kTcThreads;
#pragma unroll
  for (int it0 = 0; it0 < QIT; it0 += 4) {
    __nv_bfloat162 x1[4], x2[4];
    float2 c[4], sn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + (it0 + j) * kTcThreads, r = i / PAIRS, d = 2 * (i % PAIRS);
      x1[j] = x2[j] = __float2bfloat162_rn(0.f);
      if (r < rows) {
        const int rr = r0 + r, l = rr / G;
        const bf16* x = q + ((static_cast<size_t>(b) * L + l) * H + kvh * G + rr % G) * D + d;
        x1[j] = *reinterpret_cast<const __nv_bfloat162*>(x);
        x2[j] = *reinterpret_cast<const __nv_bfloat162*>(x + HALF);
        c[j] = *reinterpret_cast<const float2*>(cosb + l * HALF + d);
        sn[j] = *reinterpret_cast<const float2*>(sinb + l * HALF + d);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + (it0 + j) * kTcThreads, r = i / PAIRS, d = 2 * (i % PAIRS);
      if (r < rows) rope_pair(x1[j], x2[j], c[j], sn[j]);
      *reinterpret_cast<__nv_bfloat162*>(sQ + r * LDS + d) = x1[j];
      *reinterpret_cast<__nv_bfloat162*>(sQ + r * LDS + d + HALF) = x2[j];
    }
  }
  __syncthreads();
  uint32_t qf[DK][4];  // this warp's 16 rows as m16n8k16 A fragments
#pragma unroll
  for (int kd = 0; kd < DK; ++kd)
    ldmatrix_x4(qf[kd], sQ + (warp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDS + kd * 16 +
                            8 * (lane / 16));
  __syncthreads();  // sQ's space takes values from the first pass-2 tile on

  // the last key each of this thread's two rows (g, g + 8) may see; -1 for
  // a row past G * L
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + warp * 16 + g + 8 * h;
    lim[h] = rr < GL ? rr / G + P : -1;
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, inv[2];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int u = 0; u < 2 * nkt; ++u) {
    const int j0 = (u < nkt ? u : u - nkt) * kKeys, buf = u & 1;
    if (u + 1 < 2 * nkt) stage(u + 1);
    else cp_async_commit();  // an empty group keeps the wait count
    cp_async_wait<1>();
    __syncthreads();

    // this warp's 16 x 64 scores, unscaled
    float sc[NK][4];
    const bf16* kt = sK + buf * kKeys * LDS;
#pragma unroll
    for (int n = 0; n < NK; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < NK / 2; ++n2)
#pragma unroll
      for (int kd = 0; kd < DK; ++kd) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (n2 * 16 + lane % 8 + 8 * (lane / 16)) * LDS + kd * 16 +
                            8 * ((lane / 8) % 2));
        mma_bf16(sc[2 * n2], qf[kd], kb[0], kb[1]);
        mma_bf16(sc[2 * n2 + 1], qf[kd], kb[2], kb[3]);
      }

    if (u < nkt) {
      // pass 1: each row's running max and sum of exp over the keys it sees
      // (this thread's columns; the four lanes of a row merge after)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kg = j0 + n * 8 + 2 * t4 + e;
            const float sv = kg <= lim[h] ? sc[n][2 * h + e] * sm_scale : -INFINITY;
            sc[n][2 * h + e] = sv;
            tmax = fmaxf(tmax, sv);
          }
        const float m_new = fmaxf(m_run[h], tmax);
        if (m_new == -INFINITY) continue;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n)
          sum += __expf(sc[n][2 * h] - m_new) + __expf(sc[n][2 * h + 1] - m_new);
        l_run[h] = l_run[h] * __expf(m_run[h] - m_new) + sum;
        m_run[h] = m_new;
      }
    } else {
      if (u == nkt) {  // the row statistics, merged across the row's lanes
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = m_run[h];
          for (int x = 1; x < 4; x <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
          float l = m == -INFINITY ? 0.f : l_run[h] * __expf(m_run[h] - m);
          for (int x = 1; x < 4; x <<= 1) l += __shfl_xor_sync(0xffffffffu, l, x);
          m_run[h] = m;
          inv[h] = l > 0.f ? __fdiv_rn(1.f, l) : 0.f;
        }
      }
      // pass 2: probabilities normalised, rounded to bf16 in the A-fragment
      // order, times V in f32
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, kg = j0 + n * 8 + 2 * t4 + e % 2;
          p[e] = kg <= lim[h] ? __expf(sc[n][e] * sm_scale - m_run[h]) * inv[h] : 0.f;
        }
        pa[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);      // row g
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);  // row g + 8
      }
      const bf16* vt = sV + buf * kKeys * LDS;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vt + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDS +
                                    n2 * 16 + 8 * (lane / 16));
          mma_bf16(o[2 * n2], pa[kk], vb[0], vb[1]);
          mma_bf16(o[2 * n2 + 1], pa[kk], vb[2], vb[3]);
        }
    }
    __syncthreads();  // the buffer is free for the load after next
  }

  // out [B, L, H, D]: this thread's rows g and g + 8, columns 2 t4, 2 t4 + 1
  // of each 8-wide d tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + warp * 16 + g + 8 * h;
    if (rr >= GL) continue;
    bf16* y = out + ((static_cast<size_t>(b) * L + rr / G) * H + kvh * G + rr % G) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(y + n * 8) =
          __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const float* cosb, const float* sinb,
              const void* pk, const void* pv, void* out, void* k_rot, int B, int L, int H,
              int KV, int P, int PB, float sm_scale, cudaStream_t stream) {
  if (!k_rot) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * L * KV;
  const long long pairs = static_cast<long long>(rows) * (D / 4);
  rope_attention_keys_kernel<D><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(k), cosb, sinb, static_cast<bf16*>(k_rot), rows, L, KV);
  const int smem = 4 * kKeys * (D + 8) * static_cast<int>(sizeof(bf16));
  auto kernel = rope_attention_tc_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((H / KV * L + kRows - 1) / kRows, B, KV);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_rot), static_cast<const bf16*>(v),
      cosb, sinb, static_cast<const bf16*>(pk), static_cast<const bf16*>(pv),
      static_cast<bf16*>(out), L, H, KV, P, PB, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k_rot: scratch like k for its rotated copy (bf16 only; null for f32)
extern "C" int mt_rope_attention(const void* q, const void* k, const void* v,
                                 const void* cosb, const void* sinb,
                                 const void* pk, const void* pv, void* out,
                                 void* k_rot, int is_bf16, int B, int L, int H, int KV, int D,
                                 int P, int PB, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cosb);
  const auto* sn = static_cast<const float*>(sinb);
  if (is_bf16 && D == 128)
    return launch_tc<128>(q, k, v, c, sn, pk, pv, out, k_rot, B, L, H, KV, P, PB, sm_scale, s);
  if (is_bf16 && D == 64)
    return launch_tc<64>(q, k, v, c, sn, pk, pv, out, k_rot, B, L, H, KV, P, PB, sm_scale, s);
  if (!is_bf16 && D == 128)
    return launch<float, 128>(q, k, v, c, sn, pk, pv, out, B, L, H, KV, P, PB, sm_scale, s);
  if (!is_bf16 && D == 64)
    return launch<float, 64>(q, k, v, c, sn, pk, pv, out, B, L, H, KV, P, PB, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
