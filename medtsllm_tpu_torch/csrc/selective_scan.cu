// K7 / K8 / K9 and the prefill form: the forward of the selective-SSM scan
// (the Mamba block's recurrence), computed in f32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel e)
//   y_t = sum_n C_t[n] * h_t[n] + D * x_t
// One kernel template behind two interfaces:
//   - raw (z NULL): dt, x, y [B, L, E] f32; B, C [B, L, N] f32; A_T [N, E];
//     D [E], as the JAX kernels take them;
//   - gated, the mixer's serving forms: dt_raw (dt_proj's output, bias
//     included), x (the conv output), z (the gate half of in_proj's output),
//     B and C (views of x_proj's output) at the compute dtype T (f32 or
//     bf16), each with its own row stride; A_log [E, N] and D at the
//     parameters' dtype (f32 or bf16). In f32, dt = softplus(dt_raw) with
//     F.softplus's formula (x above 20 passes through, else
//     log1pf(expf(x))) and A = -expf(A_log); the output is
//     round(round(y) * round(silu(z))) at T, the mixer's
//     y.to(T) * F.silu(z) step by step (the f32 instance rounds nothing).
// Either takes h0 [1 or B, N, E] f32 (the cached prefix state) and writes
// h_final [B, N, E] (the prefill) and hb [B, ceil(L / chunk), N, E] (K9: the
// state before every chunk of `chunk` tokens, hb[:, 0] = h0 or 0, in the
// JAX layout; selective_scan_bwd.cu resumes from it); all three optional.
//
// Replaces medtsllm_tpu/ops/pallas/selective_scan.py::_ssm_pallas (K7, h
// from 0), ::_ssm_pallas_h0 (K8, h from a cached prefix state),
// ::_ssm_pallas_with_bounds (K9, bodies _ssm_kernel_bounds /
// _ssm_kernel_bounds_h0) and the prefill form selective_ssm_final (XLA in
// JAX); the gated interface also takes in the glue the JAX mixer runs around
// them (models/llm/mamba.py:131-157, which XLA fuses). The TPU kernels
// walked 16-token chunks on a sequential grid axis with the state in VMEM
// scratch and padded L with dt = 0; here a block loops over the true L.
//
// What bounds it: at the Mamba serving shape (B 48, L 144, E 1536, N 16) the
// raw form moves 12 bytes a (b, t, e) (dt, x read, y written: 0.127 GB,
// 0.038 ms at 3.35 TB/s) and the gated bf16 form 8 (dt_raw, x, z, out:
// 0.025 ms), while the B*L*N*E = 1.70e8 exponentials alone take 0.041 ms on
// the special-function units (16 a clock per SM; 132 SMs at 1.98 GHz), and
// the gated form adds two a (b, t, e) (softplus, silu): that floor is above
// the bytes, so the MUFU, not HBM, bounds the kernel; the FP32 pipe carries
// four operations a (t, n) beside it. What the design does:
//   - one MUFU op a (t, n): log2(e) is folded into A once, at load, and
//     each step is ex2.approx.ftz(dt * a2) (accurate expf ran ~30% slower,
//     PERF.md);
//   - the N states of a channel are split into N / 4 groups of 4 states, a
//     thread each, so the grid carries B * E * N / 4 threads (295k at the
//     served shape) with four independent state chains each. A warp holds
//     one group of 32 neighbouring channels: its lanes read the token's B
//     and C at one address (a shared-memory broadcast) and dt, dt * x at
//     neighbouring ones. Each group leaves its per-token sums in shared
//     memory and the output pass adds the groups pairwise in a fixed order,
//     so a call's bits repeat;
//   - tiles of TT tokens of dt, x (and z) for the block's CPB channels, and
//     of the B, C rows, are staged by cp.async (16 bytes a copy where every
//     row is 16-byte aligned, else 4; bf16 rows at an odd offset by plain
//     loads), double-buffered: the next tile is in flight while this one is
//     scanned. TMA is not used: a tile is a few KB over 16 rows, one or two
//     cp.async a thread, and a tensor map per operand and call buys nothing
//     at that size;
//   - once a tile lands, one pass of the whole block converts it to f32 (the
//     softplus, dt * x, B and C), so a channel's state groups share that
//     work; the same phase writes the previous tile's outputs (y + D x, and
//     the gate) from the sums the scan left in shared memory. Both passes
//     take 4 neighbouring channels a thread, with 128-bit shared-memory
//     accesses and one vector store where the row allows: two barriers a
//     tile;
//   - a full tile's token loop is unrolled, so every shared-memory address
//     is an immediate offset and the loop carries no address arithmetic.
// It runs at ~2.3x its MUFU floor, at about half an instruction a clock per
// scheduler. Timed on an H100 with clock64() stamps, a block spent about
// half its cycles in the token loop and the rest in the per-tile passes
// and the copies' issue, in proportion to their instructions; the time
// moved little with the exponentials made FMAs, the shared-memory reads
// hoisted out of the loop, the barriers removed, three staging slots, 8-
// or 32-token tiles, or the state groups on neighbouring lanes summed by
// shuffles, and it moved with the instructions a token (the passes
// vectorised, the loop unrolled) and with the warps an SM holds. What
// holds the issue rate near one half is an open question (PERF.md).

#include <algorithm>

#include "common.cuh"

namespace {

using mt::from_f32;
using mt::round_to;
using mt::to_f32;

constexpr int kThreads = 256;      // threads a block
constexpr int kMinBlocks = 4;      // blocks an SM holds at least (caps the registers)
constexpr int kWarps = kThreads / 32;
constexpr int TT = 16;             // tokens a tile
constexpr int kSlots = 2;           // staged tiles: one scanned, one in flight
constexpr int NPT = 4;              // states a thread
constexpr float kLog2e = 1.4426950408889634f;

// a channel's state groups (NPT states each, one warp of 32 channels per
// group) and the channels a block covers, at state size N
__host__ __device__ constexpr int groups(int N) { return N / NPT; }
__host__ __device__ constexpr int block_channels(int N) { return 32 * (kWarps / groups(N)); }

// dynamic shared memory of a block: kSlots staging buffers of T (dt, x, and
// z when gated [TT][CPB]; B, C [TT][N]), then the f32 work tile (dt, dt * x
// [TT][CPB]; each state group's per-token sums [groups][TT][CPB]; B, C
// [TT][N]; D [CPB])
template <int N, typename T, bool GATED>
struct FwdSmem {
  static constexpr int CPB = block_channels(N);
  static constexpr int kWide = GATED ? 3 : 2;
  static constexpr int kStage = kWide * TT * CPB + 2 * TT * N;  // elements of T
  static constexpr int kWork = (2 + groups(N)) * TT * CPB + 2 * TT * N + CPB;  // floats
  static constexpr int kBytes = kSlots * kStage * static_cast<int>(sizeof(T)) + 4 * kWork;
};

// Copy rows [0, TT) x columns [0, W) of a global row-major matrix (row
// stride ld elements, from src) into shared [TT][W]; rows from n_rows and
// columns from n_cols on are zero. VEC is the bytes of one copy: 16 or 4
// (cp.async; rows, columns and n_cols aligned to it), or 2 (bf16 at odd
// offsets: plain loads and stores).
template <typename T, int W, int VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, size_t ld, int n_rows,
                                           int n_cols, int tid) {
  constexpr int EPC = VEC / static_cast<int>(sizeof(T)), PER_ROW = W / EPC;
  static_assert(EPC >= 1 && W % EPC == 0, "copy width");
  for (int i = tid; i < TT * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * EPC;
    const bool ok = r < n_rows && c < n_cols;
    if constexpr (VEC == 16) {
      mt::cp_async16(dst + r * W + c, ok ? src + r * ld + c : src, ok);
    } else if constexpr (VEC == 4) {
      mt::cp_async4(dst + r * W + c, ok ? src + r * ld + c : src, ok);
    } else {
      dst[r * W + c] = ok ? src[r * ld + c] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void stage_any(T* dst, const T* src, size_t ld, int n_rows,
                                          int n_cols, int vec, int tid) {
  if (vec == 16) {
    if constexpr (W * sizeof(T) % 16 == 0) stage_rows<T, W, 16>(dst, src, ld, n_rows, n_cols, tid);
  } else if (vec == 4) {
    stage_rows<T, W, 4>(dst, src, ld, n_rows, n_cols, tid);
  } else if constexpr (sizeof(T) == 2) {
    stage_rows<T, W, 2>(dst, src, ld, n_rows, n_cols, tid);
  }
}

// 4 consecutive f32 of shared memory (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// 4 consecutive values of T in shared memory (aligned to 4 of them) as f32
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// 4 f32 stored as 4 consecutive values of T (aligned to 4 of them)
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename P>
__device__ __forceinline__ float param(const void* p, size_t i) {
  return to_f32<P>(static_cast<const P*>(p)[i]);
}

struct Args {
  const void *dt, *x, *z, *Bs, *Cs, *A, *D;
  const float* h0;
  size_t h0_bstride;
  void* y;
  float *h_final, *hb;
  int chunk, L, E;
  int ld_dt, ld_x, ld_z, ld_bc;  // row strides (elements)
  int vec_wide, vec_bc;          // bytes a staging copy: dt / x / z; B / C
  int params_bf16;               // A_log and D (gated) at bf16
};

// kMinBlocks blocks an SM at least (64 registers a thread)
template <int N, typename T, bool GATED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_kernel(const Args a) {
  using M = FwdSmem<N, T, GATED>;
  constexpr int NG = groups(N), CPB = M::CPB;
  static_assert(kWarps % NG == 0 && NPT == 4 && CPB * sizeof(T) % 16 == 0, "tile layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage_base = reinterpret_cast<T*>(smem_raw);  // [kSlots][kStage]
  float* w_dt = reinterpret_cast<float*>(smem_raw + kSlots * M::kStage * sizeof(T));
  float* w_dbx = w_dt + TT * CPB;
  float* w_y = w_dbx + TT * CPB;  // [NG][TT][CPB]
  float* w_B = w_y + NG * TT * CPB;
  float* w_C = w_B + TT * N;  // right after w_B, as the staged B and C
  float* w_D = w_C + TT * N;

  // warp w holds state group w % NG of the block's channels
  // [(w / NG) * 32, + 32): its lanes read one address of B and C (a
  // broadcast) and neighbouring addresses of dt, x and the sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = warp % NG;                   // state group
  const int ec = (warp / NG) * 32 + lane;     // channel in the block
  const int E = a.E, L = a.L, b = blockIdx.y;
  const int e0 = blockIdx.x * CPB, e = e0 + ec, n0 = ng * NPT;
  const bool live = e < E;  // threads past E scan zeros and sync
  const int n_cols = min(CPB, E - e0);
  const size_t row = static_cast<size_t>(b) * L;  // first token of batch row b

  // the tile of tokens [t0, t0 + TT) into staging buffer buf
  auto stage = [&](int t0, int buf) {
    T* st = stage_base + buf * M::kStage;
    const int nt = min(TT, L - t0);
    const size_t r0 = row + t0;
    stage_any<T, CPB>(st, static_cast<const T*>(a.dt) + r0 * a.ld_dt + e0, a.ld_dt, nt,
                       n_cols, a.vec_wide, tid);
    stage_any<T, CPB>(st + TT * CPB, static_cast<const T*>(a.x) + r0 * a.ld_x + e0, a.ld_x,
                       nt, n_cols, a.vec_wide, tid);
    if constexpr (GATED)
      stage_any<T, CPB>(st + 2 * TT * CPB, static_cast<const T*>(a.z) + r0 * a.ld_z + e0,
                         a.ld_z, nt, n_cols, a.vec_wide, tid);
    T* sb = st + M::kWide * TT * CPB;
    stage_any<T, N>(sb, static_cast<const T*>(a.Bs) + r0 * a.ld_bc, a.ld_bc, nt, N, a.vec_bc,
                     tid);
    stage_any<T, N>(sb + TT * N, static_cast<const T*>(a.Cs) + r0 * a.ld_bc, a.ld_bc, nt, N,
                     a.vec_bc, tid);
  };
  for (int k = 0; k < kSlots - 1; ++k) {  // the first tiles' copies
    if (k * TT < L) stage(k * TT, k);
    mt::cp_async_commit();
  }

  // this lane's states, A * log2(e) for them, and the block's D
  float a2[NPT], h[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int n = n0 + k;
    float av = 0.f;
    if (live) {
      if constexpr (GATED)
        av = -expf(a.params_bf16 ? param<__nv_bfloat16>(a.A, static_cast<size_t>(e) * N + n)
                                 : param<float>(a.A, static_cast<size_t>(e) * N + n));
      else
        av = param<float>(a.A, static_cast<size_t>(n) * E + e);
    }
    a2[k] = av * kLog2e;
    h[k] = live && a.h0 != nullptr ? a.h0[b * a.h0_bstride + static_cast<size_t>(n) * E + e]
                                   : 0.f;
  }
  for (int c = tid; c < CPB; c += kThreads) {
    float d = 0.f;
    if (e0 + c < E) {
      if constexpr (GATED)
        d = a.params_bf16 ? param<__nv_bfloat16>(a.D, e0 + c) : param<float>(a.D, e0 + c);
      else
        d = param<float>(a.D, e0 + c);
    }
    w_D[c] = d;
  }

  const int n_chunks = a.hb != nullptr ? (L + a.chunk - 1) / a.chunk : 0;
  int rec_t = 0, rec_c = 0;  // the next token whose state hb records, its chunk
  // Tile k lives in staging slot k % kSlots. Iteration k: (A) tile k has
  // landed and tile k - 1's sums are in w_y; tile k - 1's outputs and tile
  // k's f32 conversion; (B) both done; tile k + 1's copies are issued into
  // the slot tile k - 1 held, then tile k is scanned.
  const int n_tiles = (L + TT - 1) / TT;
  for (int k = 0;; ++k) {
    mt::cp_async_wait<kSlots - 2>();
    __syncthreads();  // (A)
    if (k > 0) {
      // tile k - 1's outputs, coalesced, 4 neighbouring channels a thread:
      // y = the groups' sums, pairwise in a fixed order ((g0 + g1) + (g2 +
      // g3)), + D x (rounded as the plain version rounds); gated:
      // round(round(y) * round(silu(z))) at T. One vector store where the
      // four lie in the row and E keeps rows aligned, else one at a time
      const int t0 = (k - 1) * TT, nt = min(TT, L - t0);
      const T* st = stage_base + ((k - 1) % kSlots) * M::kStage;
      for (int i = 4 * tid; i < nt * CPB; i += 4 * kThreads) {
        const int r = i / CPB, c = i % CPB;
        if (c >= n_cols) continue;
        float part[NG][4], xv[4], dv[4], out[4];
#pragma unroll
        for (int j = 0; j < NG; ++j) load4(w_y + j * TT * CPB + i, part[j]);
        lds4(st + TT * CPB + i, xv);
        load4(w_D + c, dv);
        float zv[4];
        if constexpr (GATED) lds4(st + 2 * TT * CPB + i, zv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int w = 1; w < NG; w <<= 1)
#pragma unroll
            for (int j = 0; j < NG; j += 2 * w) part[j][q] += part[j + w][q];
          const float yv = __fadd_rn(part[0][q], __fmul_rn(dv[q], xv[q]));
          if constexpr (GATED) {
            const float s = round_to<T>(__fdiv_rn(zv[q], __fadd_rn(1.f, expf(-zv[q]))));
            out[q] = __fmul_rn(round_to<T>(yv), s);
          } else {
            out[q] = yv;
          }
        }
        T* dst = static_cast<T*>(a.y) + (row + t0 + r) * E + e0 + c;
        if (E % 4 == 0 && c + 4 <= n_cols) {
          st4(dst, out);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < n_cols) dst[q] = from_f32<T>(out[q]);
        }
      }
    }
    if (k < n_tiles) {
      // tile k in f32, once a (t, e): dt (softplus'd when gated), dt * x,
      // B, C
      const T* st = stage_base + (k % kSlots) * M::kStage;
      for (int i = 4 * tid; i < TT * CPB; i += 4 * kThreads) {
        float d[4], xv[4], dbx[4];
        lds4(st + i, d);
        lds4(st + TT * CPB + i, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (GATED) d[q] = d[q] > 20.f ? d[q] : log1pf(expf(d[q]));
          dbx[q] = d[q] * xv[q];
        }
        st4(w_dt + i, d);
        st4(w_dbx + i, dbx);
      }
      for (int i = 4 * tid; i < 2 * TT * N; i += 4 * kThreads) {  // B, then C
        float v[4];
        lds4(st + M::kWide * TT * CPB + i, v);
        st4(w_B + i, v);  // w_C follows w_B
      }
    }
    __syncthreads();  // (B)
    if (k == n_tiles) break;
    if (k + kSlots - 1 < n_tiles) stage((k + kSlots - 1) * TT, (k + kSlots - 1) % kSlots);
    mt::cp_async_commit();  // an empty group keeps the wait count

    const int t0 = k * TT, nt = min(TT, L - t0);
    const float* s_dt = w_dt + ec;
    const float* s_dbx = w_dbx + ec;
    const float* s_B = w_B + n0;
    const float* s_C = w_C + n0;
    float* s_y = w_y + ng * TT * CPB + ec;
    auto token = [&](int i) {
      if (n_chunks && t0 + i == rec_t) {  // a chunk starts: record h
        if (live) {
          float* dst = a.hb + (static_cast<size_t>(b) * n_chunks + rec_c) * N * E + e;
#pragma unroll
          for (int j = 0; j < NPT; ++j) dst[static_cast<size_t>(n0 + j) * E] = h[j];
        }
        rec_t += a.chunk;
        ++rec_c;
      }
      const float dtv = s_dt[i * CPB], dbx = s_dbx[i * CPB];
      float bk[NPT], ck[NPT];
      load4(s_B + i * N, bk);
      load4(s_C + i * N, ck);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float dA = mt::ex2(dtv * a2[j]);
        h[j] = fmaf(dA, h[j], dbx * bk[j]);
        acc = fmaf(h[j], ck[j], acc);
      }
      s_y[i * CPB] = acc;
    };
    // a full tile unrolled: every shared-memory address an immediate offset
    if (nt == TT) {
#pragma unroll
      for (int i = 0; i < TT; ++i) token(i);
    } else {
#pragma unroll 1
      for (int i = 0; i < nt; ++i) token(i);
    }
  }
  if (live && a.h_final != nullptr) {
#pragma unroll
    for (int k = 0; k < NPT; ++k)
      a.h_final[(static_cast<size_t>(b) * N + n0 + k) * E + e] = h[k];
  }
}

// the widest staging copy (16, 4 or 2 bytes) every row start of an operand
// allows: its pointer, its row stride and the row's valid width, in bytes
int vec_bytes(const void* p, long long ld_bytes, long long width_bytes) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  if (addr % 16 == 0 && ld_bytes % 16 == 0 && width_bytes % 16 == 0) return 16;
  if (addr % 4 == 0 && ld_bytes % 4 == 0 && width_bytes % 4 == 0) return 4;
  return 2;
}

template <int N, typename T, bool GATED>
int launch(Args a, int B, int elem, cudaStream_t stream) {
  using M = FwdSmem<N, T, GATED>;
  auto* kernel = selective_scan_kernel<N, T, GATED>;
  if (M::kBytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long E = a.E;
  a.vec_wide = vec_bytes(a.dt, a.ld_dt * elem, E * elem);
  a.vec_wide = std::min(a.vec_wide, vec_bytes(a.x, a.ld_x * elem, E * elem));
  if (GATED) a.vec_wide = std::min(a.vec_wide, vec_bytes(a.z, a.ld_z * elem, E * elem));
  a.vec_bc = std::min(vec_bytes(a.Bs, a.ld_bc * elem, N * elem),
                 vec_bytes(a.Cs, a.ld_bc * elem, N * elem));
  if (sizeof(T) == 4 && (a.vec_wide < 4 || a.vec_bc < 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((a.E + M::CPB - 1) / M::CPB, B);
  kernel<<<grid, kThreads, M::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int dispatch(const Args& a, int B, bool gated, bool bf16, cudaStream_t st) {
  if (!gated) return launch<N, float, false>(a, B, 4, st);
  if (bf16) return launch<N, __nv_bfloat16, true>(a, B, 2, st);
  return launch<N, float, true>(a, B, 4, st);
}

}  // namespace

// the groups one channel's N states are split over, NPT states a thread
// (host only, no stream)
extern "C" int mt_selective_scan_groups(int N) {
  return N == 4 || N == 8 || N == 16 ? groups(N) : 0;
}

// z NULL: the raw interface (every operand f32 and contiguous, A = A_T [N,
// E], y f32); z given: the gated one (dt, x, z, Bs, Cs at bf16 when is_bf16
// else f32, rows ld_* elements apart; A = A_log [E, N] and D at bf16 when
// params_bf16; y the gated output at the compute dtype). h0, h_final and hb
// may be NULL; h0_batched = 0 lets every batch row read one cached state
// (h0 [1, N, E]), 1 gives each row its own; chunk (> 0) is read only when hb
// is given.
extern "C" int mt_selective_scan(const void* dt, const void* x, const void* z, const void* Bs,
                                 const void* Cs, const void* A, const void* D, const void* h0,
                                 int h0_batched, void* y, void* h_final, void* hb, int chunk,
                                 int B, int L, int E, int N, int ld_dt, int ld_x, int ld_z,
                                 int ld_bc, int is_bf16, int params_bf16, void* stream) {
  const bool gated = z != nullptr;
  if (L < 1 || (hb != nullptr && chunk < 1) || (!gated && (is_bf16 || params_bf16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{dt,
         x,
         z,
         Bs,
         Cs,
         A,
         D,
         static_cast<const float*>(h0),
         h0_batched ? static_cast<size_t>(N) * E : 0,
         y,
         static_cast<float*>(h_final),
         static_cast<float*>(hb),
         chunk,
         L,
         E,
         ld_dt,
         ld_x,
         ld_z,
         ld_bc,
         0,
         0,
         params_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) return dispatch<16>(a, B, gated, is_bf16, st);
  if (N == 8) return dispatch<8>(a, B, gated, is_bf16, st);
  if (N == 4) return dispatch<4>(a, B, gated, is_bf16, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
