// K3: reprogramming cross-attention, f32 throughout.
//   out[b, l, h, :] = softmax(scale * q[b, l, h, :] . k[:, h, :]) @ v[:, h, :]
// q [B, L, H, E]; the K/V basis [S, H, E] is shared by the whole batch.
//
// Replaces medtsllm_tpu/ops/pallas/reprogramming.py::reprogramming_attention
// (_kernel). The TPU kernel keeps one head's basis resident in VMEM across
// the whole batch. Here the batch is folded into the query rows instead:
// per head, the R = B * L rows (row r = b * L + l sits at q[(r * H + h) * E])
// all read the same K/V, so one block takes 64 of them, whatever window
// they come from, and every K/V tile it stages in shared memory serves all
// 64. At the serving shapes R is 256 (llama), 1,536 (Mamba, MoE) or 16,384
// (the long window).
//
// What bounds it: 4 * R * H * S * E f32 operations (1.07 GFLOP at the llama
// shape) against 4 * (2 * R * H * E + 2 * S * H * E) bytes, ~30 operations
// a byte, so the FP32 units, not memory; the previous design was bound
// instead by shared-memory reads (both score operands read from shared
// memory for every FMA) and by an idle card (128 blocks of 4 warps).
// The design:
//   - register micro-tiles: 256 threads as 16 x 16; thread (ty, tx) owns
//     query rows 4ty..4ty+3, keys tx + 16j of a 64-key tile (4 x 4 scores)
//     and E / 16 output columns of its four rows. Per 4-wide slice of E it
//     reads 4 q and 4 k float4s and does 64 FMAs; q reads are broadcasts
//     (16 threads share a row), and K rows are XOR-swizzled by 16-byte
//     chunk so the 8 keys of a quarter-warp hit distinct banks;
//   - the online softmax across the 16 threads that share a row: the row
//     max by four xor shuffles, the row sum kept per thread and reduced
//     once at the end (the rescale factor is the same for the whole row);
//     p goes through shared memory (read back as broadcast float4s) as the
//     A operand of P V, which each thread accumulates for its 4 x E/16
//     outputs;
//   - filling the card: where H * ceil(R / 64) blocks are fewer than two
//     per SM, S is split across blocks (flash-decoding): each split writes
//     its unnormalised acc with its row max m and sum l, and a second
//     kernel merges the splits exactly, acc = sum_i exp(m_i - m) acc_i,
//     l = sum_i exp(m_i - m) l_i, m = max_i m_i. The split count is a fixed
//     rule of the shape (split_plan below). The wrapper sizes the splits'
//     scratch from mt_reprogramming_splits, this very rule, and the launcher
//     refuses a split launch without scratch; ops/kernels/reprogramming.py::
//     split_plan restates the rule for the CPU reference of the merge, and
//     a card test holds the two equal. The long window (2,048 blocks) takes
//     no split.
// No TF32: exact f32 FMAs, expf, and the division by l at the end; only the
// summation order differs from the plain version.

#include "common.cuh"

namespace {

constexpr int RT = 64;         // query rows per block (across the batch)
constexpr int KT = 64;         // keys per staged tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kSMs = 132;      // H100 SXM

template <int E>
struct Smem {
  float q[RT][E];  // read as broadcasts: no padding
  float k[KT][E];  // 16-byte chunk c of key j stored at chunk c ^ (j & 7)
  float v[KT][E];
  float p[RT][KT];
};

struct Plan {
  int splits, tiles_per_split;
};
Plan split_plan(int R, int H, int S) {
  const int tiles = (S + KT - 1) / KT;
  const int base = H * ((R + RT - 1) / RT);
  int splits = base >= 2 * kSMs ? 1 : (2 * kSMs + base - 1) / base;
  splits = splits < tiles ? splits : tiles;
  const int per = (tiles + splits - 1) / splits;
  return {(tiles + per - 1) / per, per};
}

// the n-th output column of thread tx (E / 16 of them: float4 chunks
// 64 apart, or a float2 at E = 32)
template <int E>
__device__ __forceinline__ int out_col(int tx, int n) {
  return E >= 64 ? (n / 4) * 64 + tx * 4 + (n % 4) : tx * 2 + n;
}

// grid (row tiles, splits, heads). splits == 1: the normalised output;
// otherwise split blockIdx.y's unnormalised acc [splits, H, R, E] and its
// (m, l) [splits, H, R, 2].
template <int E>
__global__ void __launch_bounds__(kThreads, 2)
reprogramming_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ part, float* __restrict__ part_ml,
                     int R, int H, int S, int tiles_per_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(smem_raw);
  constexpr int NC = E / 16;  // output columns per thread
  constexpr int C4 = E / 4;   // float4 chunks per row
  const int r0 = blockIdx.x * RT, split = blockIdx.y, h = blockIdx.z;
  const int splits = gridDim.y;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int s_begin = split * tiles_per_split * KT;
  const int s_end = min(S, s_begin + tiles_per_split * KT);

  for (int i = t; i < RT * C4; i += kThreads) {
    const int r = i / C4, c = i % C4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R)
      val = reinterpret_cast<const float4*>(
          q + (static_cast<size_t>(r0 + r) * H + h) * E)[c];
    reinterpret_cast<float4*>(sm.q[r])[c] = val;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int s0 = s_begin; s0 < s_end; s0 += KT) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    for (int i = t; i < KT * C4; i += kThreads) {
      const int j = i / C4, c = i % C4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (s0 + j < s_end) {  // rows past the split are zero: garbage x 0 can be NaN
        const size_t o = (static_cast<size_t>(s0 + j) * H + h) * E;
        kv = reinterpret_cast<const float4*>(k + o)[c];
        vv = reinterpret_cast<const float4*>(v + o)[c];
      }
      reinterpret_cast<float4*>(sm.k[j])[c ^ (j & 7)] = kv;
      reinterpret_cast<float4*>(sm.v[j])[c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C4; ++c) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = reinterpret_cast<const float4*>(sm.q[ty * 4 + i])[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        b[j] = reinterpret_cast<const float4*>(sm.k[key])[c ^ (key & 7)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax over the 16 threads of a half-warp (one row group)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s0 + tx + 16 * j < s_end ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = expf(m[i] - mx);  // 0 on the first tile (m = -inf)
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        sm.p[ty * 4 + i][tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
    }
    __syncwarp();  // a row's p is written and read by its own half-warp

#pragma unroll 2
    for (int j4 = 0; j4 < KT; j4 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&sm.p[ty * 4 + i][j4]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vr[NC];
        if constexpr (E >= 64) {
#pragma unroll
          for (int n4 = 0; n4 < NC / 4; ++n4) {
            const float4 w = *reinterpret_cast<const float4*>(&sm.v[j4 + jj][n4 * 64 + tx * 4]);
            vr[n4 * 4 + 0] = w.x;
            vr[n4 * 4 + 1] = w.y;
            vr[n4 * 4 + 2] = w.z;
            vr[n4 * 4 + 3] = w.w;
          }
        } else {
          const float2 w = *reinterpret_cast<const float2*>(&sm.v[j4 + jj][tx * 2]);
          vr[0] = w.x;
          vr[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p, vr[n], acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
    const size_t row = static_cast<size_t>(split) * H * R + static_cast<size_t>(h) * R + r;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = out_col<E>(tx, n);
      if (splits == 1)
        out[(static_cast<size_t>(r) * H + h) * E + c] = acc[i][n] / l[i];
      else
        part[row * E + c] = acc[i][n];
    }
    if (splits > 1 && tx == 0) {
      part_ml[row * 2] = m[i];
      part_ml[row * 2 + 1] = l[i];
    }
  }
}

// one thread per (row, head, float4 of E): the exact merge of the splits
template <int E>
__global__ void __launch_bounds__(256)
reprogramming_merge_kernel(const float* __restrict__ part, const float* __restrict__ part_ml,
             float* __restrict__ out, int R, int H, int splits) {
  constexpr int C4 = E / 4;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(R) * H * C4) return;
  const int c = static_cast<int>(i % C4);
  const size_t rh = i / C4;
  const int h = static_cast<int>(rh % H), r = static_cast<int>(rh / H);
  const size_t stride = static_cast<size_t>(H) * R;  // rows per split
  const size_t row0 = static_cast<size_t>(h) * R + r;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[(s * stride + row0) * 2]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t row = s * stride + row0;
    const float w = expf(part_ml[row * 2] - mx);
    l = fmaf(part_ml[row * 2 + 1], w, l);
    const float4 a = reinterpret_cast<const float4*>(part + row * E)[c];
    acc.x = fmaf(a.x, w, acc.x);
    acc.y = fmaf(a.y, w, acc.y);
    acc.z = fmaf(a.z, w, acc.z);
    acc.w = fmaf(a.w, w, acc.w);
  }
  reinterpret_cast<float4*>(out + (static_cast<size_t>(r) * H + h) * E)[c] =
      make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

template <int E>
int launch(const float* q, const float* k, const float* v, float* out, float* part,
           float* part_ml, int R, int H, int S, float scale, cudaStream_t stream) {
  const Plan plan = split_plan(R, H, S);
  if (plan.splits > 1 && (part == nullptr || part_ml == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(Smem<E>));
  static const cudaError_t attr = cudaFuncSetAttribute(
      reprogramming_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((R + RT - 1) / RT, plan.splits, H);
  reprogramming_kernel<E><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, part, part_ml, R, H, S, plan.tiles_per_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(R) * H * (E / 4);
  reprogramming_merge_kernel<E><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      part, part_ml, out, R, H, plan.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the number of splits of S that a launch over R = B * L rows takes
extern "C" int mt_reprogramming_splits(int R, int H, int S) {
  return split_plan(R, H, S).splits;
}

// part [splits, H, B * L, E] and part_ml [splits, H, B * L, 2]: scratch for
// mt_reprogramming_splits(B * L, H, S) splits (unused, and may be null, when
// that is one)
extern "C" int mt_reprogramming_attention(const void* q, const void* k,
                                          const void* v, void* out, void* part,
                                          void* part_ml, int B, int L, int H,
                                          int E, int S, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* pf = static_cast<float*>(part);
  auto* mf = static_cast<float*>(part_ml);
  const int R = B * L;
  if (E == 128) return launch<128>(qf, kf, vf, of, pf, mf, R, H, S, scale, st);
  if (E == 64) return launch<64>(qf, kf, vf, of, pf, mf, R, H, S, scale, st);
  if (E == 32) return launch<32>(qf, kf, vf, of, pf, mf, R, H, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
