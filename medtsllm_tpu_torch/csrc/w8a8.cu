// K1: w8a8 projection GEMM — per-row int8 activation quantization, then an
// s8 x s8 -> s32 product with a fused (row scale x channel scale) epilogue.
//
// Replaces medtsllm_tpu/ops/pallas/smallm_matmul.py::w8a8_smallm_matmul_pallas
// and the XLA dot it stands in for (models/llm/transformer.py
// _act_quant_matmul), whose numerics it follows:
//   x_scale = max(amax / 127, 1e-10);  xq = round_half_even(x / x_scale)
//   out     = float(acc) * (x_scale * w_scale)      (scales multiplied first)
// Division is IEEE (__fdiv_rn, never a reciprocal multiply) so ties round as
// jnp.round does. |acc| < K * 127^2 < 2^31 for K <= 11008: s32 cannot wrap,
// and integer sums are exact in any order, so every output row is the same
// whatever M is and wherever the row sits in a tile.
//
// What bounds the GEMM: at the serving shapes (M = 896, 6,912 or 17,024
// rows; K, N in {256, 2048, 4096, 11008}) 2 * M * N * K operations against
// M * K + N * K bytes, hundreds of operations a byte: the int8 tensor cores.
// Only wgmma reaches their rate on Hopper, so the design is Hopper's own:
//   - a ring of kStages shared-memory stages, each a 128-row A tile and a
//     256-row B tile 128 k-bytes deep (one 128-byte swizzle row), filled by
//     TMA (cp.async.bulk.tensor.2d) under full / empty mbarriers; TMA's
//     out-of-bounds zero fill covers ragged M, N and the K tail
//     (K % 16 == 0 keeps the row stride a multiple of 16 bytes);
//   - one producer warpgroup (one thread issues the copies; setmaxnreg
//     gives its registers away) and two consumer warpgroups, each owning 64
//     rows: per stage four wgmma.mma_async m64n256k32 s8.s8 -> s32 with both
//     operands read from shared memory through 128-byte-swizzle
//     descriptors (the k32 steps advance the descriptor inside the swizzle
//     atom), one batch kept in flight while the previous stage is released;
//   - the epilogue reads the s32 fragments in wgmma's accumulator layout,
//     applies the rescale above, stages the tile in shared memory (the ring,
//     free by then) and stores it in coalesced 16-byte rows.
// Operands are K-major as wgmma wants 8-bit types: xq [M, K] row-major and
// the transposed weight wq_t [N, K] (weights.py transposes once at load).
// Tile width: 128 x 256, four stages. At M 896 and N 4096 that is 112
// tiles, 0.85 of a wave on 132 SMs (128 x 128 tiles would give 224, two
// waves, the second 0.7 full); the wide tile reads A once for twice the
// columns and halves the epilogues. Timed against 128 x 128 (two 64 x 128
// consumer tiles, six stages) at every GEMM of the serving blocks, it was
// faster or level at each (PERF.md).
//
// The tensor maps are encoded on the host per call (hopper.cuh, which also
// holds the barrier, TMA and wgmma helpers K5 shares) and passed by value
// as __grid_constant__ parameters.

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::hopper;

// ---- the row quantizers -------------------------------------------------------
//
// Both quantizers (the activation rows x -> xq, x_scale, and the int8 dx's
// gradient rows g * scale -> gq, g_scale) are one pass over M rows of K
// elements: bound by bytes (K * (4 or 2) read, K + 4 written a row), with
// little arithmetic. Each row is read from device memory once, by one of
// two kernels the wrapper picks from the shape and the addresses
// (ops/kernels/w8a8.py::quant_plan):
//
// The tile kernel (bf16 rows, and the dx's, of >= 16 MiB a call). A row
// held in registers ties them up for the whole round trip, and 2,048
// threads an SM hold too few bytes to cover it; so the rows travel by 1-D
// bulk copies (TMA, cp.async.bulk) through a ring of shared-memory stages,
// up to 200 KB in flight an SM:
//   - a tile is R consecutive rows (R = 16, 8, .. 1: every SM a tile); one
//     persistent block an SM (two where the ring fits twice) takes every
//     gridDim.x-th tile of one scale row;
//   - a producer warp keeps S stages in flight: one bulk copy a row, each
//     completing on its own full mbarrier, so a row's group starts as soon
//     as its row is in; a stage is refilled once all 16 consumer warps
//     have released it (its empty mbarrier);
//   - each row of a tile belongs to 16 / R consumer warps. They read it
//     from shared memory in 16-byte vectors, reduce the absmax with
//     __shfl_xor_sync and, across the group's warps, through a slot of
//     shared memory under the group's own named barrier (bar.sync 1 +
//     group; the slot alternates with the tile, so no second barrier
//     guards its reuse); then they read it again from shared memory and
//     store the codes as 4- (f32) or 8-byte (bf16) words, a warp's stores
//     one contiguous span.
// The dx's channel scale has one row a block (gridDim.y = the scale's rows:
// 1 for a projection, E for the experts of the capacity MoE path, whose
// rows a block never straddles): it is bulk-copied into shared memory once
// a block, and g * scale formed in f32 from it.
//
// The row-group kernel (the rest). A row goes to a group of W warps whose
// lanes hold it in registers: units t, t + 32W, ... of the row on lane t,
// 16-byte loads (the vector instance, 16 elements a lane) or single
// elements (the scalar instance, 32 a lane: rows or bases off 16 bytes);
// the same warp-shuffle and named-barrier reduction; codes stored from
// registers. A block holds several groups (<= 512 threads) and the grid is
// cut to the blocks the SMs hold, each group looping over rows, so the dx's
// scale slice is loaded once into a lane's registers for all its rows.
// Rows wider than 16 warps hold are read twice (absmax, then codes).
//
// Numerics as before, in any order: amax by fmaxf(fabsf(.)) (a max is exact
// in any order), scale = max(amax / 127, 1e-10) and codes round-half-even(v
// / scale) with IEEE division (__fdiv_rn), v = f32(g) * scale[col] with one
// rounding (__fmul_rn).

constexpr int kTileWarps = 16;  // the tile kernel's consumer warps
constexpr int kTileThreads = 32 * (kTileWarps + 1);  // and one producer warp
constexpr int kRowThreads = 512;  // the row-group kernel's most threads a block
constexpr int kVectorLane = 16;   // the elements a lane of its vector instance holds
constexpr int kScalarLane = 32;   // and of its scalar instance

__device__ __forceinline__ uint32_t code_byte(float v, float scale) {
  return static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v, scale))) & 0xffu;
}

// 16 bytes of T as f32: 4 f32 or 8 bf16 elements
template <typename T>
__device__ __forceinline__ void widen16(uint4 a, float* v) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {  // element 2i in the low half of word i, its f32 bits << 16
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// U consecutive elements of a row at p, widened to f32: U * sizeof(T) / 16
// 16-byte loads, or one element (U 1)
template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* __restrict__ p, float* v) {
  if constexpr (U == 1) {
    v[0] = mt::to_f32(p[0]);
  } else {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int n = 0; n < U / kPer; ++n)
      widen16<T>(__ldg(reinterpret_cast<const uint4*>(p) + n), v + n * kPer);
  }
}

// the codes of U elements at q: one U-byte store
template <int U>
__device__ __forceinline__ void store_codes(int8_t* q, const float* v, float scale) {
  if constexpr (U == 1) {
    q[0] = static_cast<int8_t>(code_byte(v[0], scale));
  } else {
    uint32_t w[U / 4];
#pragma unroll
    for (int k = 0; k < U / 4; ++k)
      w[k] = code_byte(v[4 * k], scale) | code_byte(v[4 * k + 1], scale) << 8 |
             code_byte(v[4 * k + 2], scale) << 16 | code_byte(v[4 * k + 3], scale) << 24;
    if constexpr (U == 4)
      *reinterpret_cast<uint32_t*>(q) = w[0];
    else
      *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  }
}

// unit j of row xr into v, times the scale row's unit j (GRAD): from the
// lane's registers `s` when the row is held, else from srow
template <typename T, int U, bool GRAD>
__device__ __forceinline__ void load_scaled(const T* __restrict__ xr,
                                            const float* __restrict__ srow, int j, bool held,
                                            const float* s, float* v) {
  load_unit<T, U>(xr + static_cast<size_t>(j) * U, v);
  if constexpr (GRAD) {
    float sc[U];
    if (held) {
#pragma unroll
      for (int k = 0; k < U; ++k) sc[k] = s[k];
    } else {
      load_unit<float, U>(srow + static_cast<size_t>(j) * U, sc);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) v[k] = __fmul_rn(v[k], sc[k]);
  }
}

template <int U>
__device__ __forceinline__ void store_zero(int8_t* q) {
  if constexpr (U == 1)
    q[0] = 0;
  else if constexpr (U == 4)
    *reinterpret_cast<uint32_t*>(q) = 0u;
  else
    *reinterpret_cast<uint2*>(q) = make_uint2(0u, 0u);
}

// chunk c (16 bytes) of a staged row as f32, times the scale row's chunk
// (GRAD; the scale row f32 in shared memory)
template <typename T, bool GRAD>
__device__ __forceinline__ void chunk_values(const unsigned char* row, const float* srow,
                                             int c, float* v) {
  constexpr int VE = 16 / sizeof(T);
  widen16<T>(*reinterpret_cast<const uint4*>(row + c * 16), v);
  if constexpr (GRAD) {
    float s[VE];
#pragma unroll
    for (int k = 0; k < VE; k += 4)
      widen16<float>(*reinterpret_cast<const uint4*>(srow + c * VE + k), s + k);
#pragma unroll
    for (int k = 0; k < VE; ++k) v[k] = __fmul_rn(v[k], s[k]);
  }
}

// The tile kernel both quantizers run on 16-byte rows: tiles of R rows of
// the rows_per_scale rows of scale row blockIdx.y, block b taking tiles b,
// b + gridDim.x, ...; S stages. x's rows K elements, the codes' rows ld >=
// K bytes (columns K.. zero). Dynamic shared memory: [the scale row, GRAD]
// [S input tiles of R * K elements][S * R full mbarriers, one a row of a
// stage][S empty mbarriers][the scale row's mbarrier].
template <typename T, bool GRAD>
__device__ __forceinline__ void quant_tiles(const T* __restrict__ x,
                                            const float* __restrict__ scales,
                                            int8_t* __restrict__ q, float* __restrict__ q_scale,
                                            int K, int ld, int rows_per_scale, int R, int S) {
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][kTileWarps / 2][kTileWarps];
  const int W = kTileWarps / R, nt = 32 * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / W, t = threadIdx.x - grp * nt;
  const int in_bytes = R * K * static_cast<int>(sizeof(T));
  const int n_chunks = K / VE, n_pad = (ld - K) / VE;
  float* srow = reinterpret_cast<float*>(smem_raw);
  unsigned char* in = smem_raw + (GRAD ? K * 4 : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(in + S * in_bytes);
  uint64_t* empty = full + S * R;
  uint64_t* sbar = empty + S;
  const int e = blockIdx.y;
  const int n_tiles = (rows_per_scale + R - 1) / R;
  const int n_local = (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      for (int r = 0; r < R; ++r) mbar_init(&full[s * R + r], 1);
      mbar_init(&empty[s], kTileWarps);
    }
    mbar_init(sbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kTileWarps) {  // the producer warp: one lane issues the copies
    if (lane == 0) {
      if constexpr (GRAD) {
        mbar_expect_tx(sbar, K * 4);
        bulk_load(srow, scales + static_cast<size_t>(e) * K, K * 4, sbar);
      }
      const T* xe = x + static_cast<size_t>(e) * rows_per_scale * K;
      for (int i = 0; i < n_local; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);
        const int r0 = (blockIdx.x + i * gridDim.x) * R;
        const int bytes = K * static_cast<int>(sizeof(T));
        for (int r = 0; r < R && r0 + r < rows_per_scale; ++r) {  // a copy a row
          mbar_expect_tx(&full[s * R + r], bytes);
          bulk_load(in + s * in_bytes + r * bytes, xe + static_cast<size_t>(r0 + r) * K, bytes,
                    &full[s * R + r]);
        }
      }
    }
    return;
  }

  if constexpr (GRAD) mbar_wait(sbar, 0);
  for (int i = 0; i < n_local; ++i) {
    const int s = i % S;
    const int r0 = (blockIdx.x + i * gridDim.x) * R;
    if (grp < min(R, rows_per_scale - r0)) {
      mbar_wait(&full[s * R + grp], (i / S) & 1);
      const unsigned char* xr = in + s * in_bytes + grp * K * static_cast<int>(sizeof(T));
      float amax = 0.f;
      for (int c = t; c < n_chunks; c += nt) {
        float v[VE];
        chunk_values<T, GRAD>(xr, srow, c, v);
#pragma unroll
        for (int k = 0; k < VE; ++k) amax = fmaxf(amax, fabsf(v[k]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (W > 1) {
        if (lane == 0) red[i & 1][grp][warp - grp * W] = amax;
        named_bar(1 + grp, nt);
        amax = red[i & 1][grp][0];
        for (int w = 1; w < W; ++w) amax = fmaxf(amax, red[i & 1][grp][w]);
      }
      const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-10f);
      const size_t row = static_cast<size_t>(e) * rows_per_scale + r0 + grp;
      if (t == 0) q_scale[row] = scale;
      int8_t* qr = q + row * ld;
      for (int c = t; c < n_chunks; c += nt) {
        float v[VE];
        chunk_values<T, GRAD>(xr, srow, c, v);
        store_codes<VE>(qr + c * VE, v, scale);
      }
      for (int c = t; c < n_pad; c += nt) store_zero<VE>(qr + K + c * VE);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with the stage
  }
}

// K1's activation rows on the tile kernel: x [M, K] bf16 -> xq [M, K],
// x_scale [M]
__global__ void __launch_bounds__(kTileThreads, 1)
act_quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                      float* __restrict__ x_scale, int K, int M, int R, int S) {
  quant_tiles<__nv_bfloat16, false>(x, nullptr, xq, x_scale, K, K, M, R, S);
}

// The gradient rows of the int8 dx (llm.int8_backward; transformer.py:269-278
// of the JAX package, the batched form :814-820): gs = g * scale[col] in f32,
// then gs's own per-row quantization as above, the codes written into rows of
// ld >= N bytes whose columns N.. are zero (the GEMM that contracts over N
// needs a multiple of 16; zero columns add nothing to the s32 sums). Rows
// [e * rows_per_scale, (e + 1) * rows_per_scale) read scale row e: one row
// for a projection, one an expert for the [E, C, N] gradient of the capacity
// MoE path.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
grad_quant_rows_kernel(const T* __restrict__ g, const float* __restrict__ scales,
                       int8_t* __restrict__ gq, float* __restrict__ g_scale, int N, int ld,
                       int rows_per_scale, int R, int S) {
  quant_tiles<T, true>(g, scales, gq, g_scale, N, ld, rows_per_scale, R, S);
}

// The row-group kernel: rows lr = blockIdx.x * G + group, stepping
// gridDim.x * G, of the rows_per_scale rows of scale row blockIdx.y, a row
// to a group of W warps. Units of U elements (16 bytes, or one element for
// the scalar instance): lane t holds units t, t + 32W, ... of its row in
// registers, CH of them (a wider row is read twice: once for its absmax,
// once for its codes), and the scale row's units alike (GRAD).
template <typename T, int U, bool GRAD>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                  int8_t* __restrict__ q, float* __restrict__ q_scale, int K, int ld,
                  int rows_per_scale, int W) {
  constexpr int CH = (U == 1 ? kScalarLane : kVectorLane) / U;  // units a lane holds
  __shared__ float red[2][kRowThreads / 64][kRowThreads / 32];
  const int nt = 32 * W, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / W, t = threadIdx.x - grp * nt, G = blockDim.x / nt;
  const int nu = K / U, ldu = ld / U, seg = nt * CH;
  const bool held = nu <= seg;  // the row fits the group's registers
  const float* srow = scales + static_cast<size_t>(blockIdx.y) * K;
  float v[CH][U];
  float s[GRAD ? CH : 1][U];  // the lane's slice of the scale row, when held
  if constexpr (GRAD) {
    if (held) {
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (t + i * nt < nu) load_unit<float, U>(srow + (t + i * nt) * U, s[i]);
    }
  }
  int parity = 0;
  for (int lr = blockIdx.x * G + grp; lr < rows_per_scale; lr += gridDim.x * G, parity ^= 1) {
    const size_t row = static_cast<size_t>(blockIdx.y) * rows_per_scale + lr;
    const T* xr = x + row * K;
    float amax = 0.f;
    for (int base = 0; base < nu; base += seg) {  // one segment when held
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (base + t + i * nt < nu) {
          load_scaled<T, U, GRAD>(xr, srow, base + t + i * nt, held, s[GRAD ? i : 0], v[i]);
#pragma unroll
          for (int k = 0; k < U; ++k) amax = fmaxf(amax, fabsf(v[i][k]));
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (W > 1) {
      if (lane == 0) red[parity][grp][warp - grp * W] = amax;
      named_bar(1 + grp, nt);
      amax = red[parity][grp][0];
      for (int w = 1; w < W; ++w) amax = fmaxf(amax, red[parity][grp][w]);
    }
    const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-10f);
    if (t == 0) q_scale[row] = scale;
    int8_t* qr = q + row * ld;
    for (int base = 0; base < nu; base += seg) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int j = base + t + i * nt;
        if (j < nu) {
          if (!held) load_scaled<T, U, GRAD>(xr, srow, j, held, s[GRAD ? i : 0], v[i]);
          store_codes<U>(qr + static_cast<size_t>(j) * U, v[i], scale);
        }
      }
    }
    for (int j = nu + t; j < ldu; j += nt) store_zero<U>(qr + static_cast<size_t>(j) * U);
  }
}

// The tile kernel's dynamic shared memory for (element bytes, K, R, S, GRAD)
int tile_smem(int es, int K, int R, int S, bool grad) {
  return (grad ? K * 4 : 0) + S * R * K * es + (S * R + S + 1) * 8;
}

// Launch the tile kernel over n_scales x rows_per_scale rows: tiles of R
// rows, S stages, the grid cut to the blocks the SMs hold (one an SM, two
// where the ring fits twice), a block's tiles in one scale row.
template <auto kKernel, typename... Args>
int launch_tiles(int es, int K, int R, int S, bool grad, int rows_per_scale,
                 int n_scales, cudaStream_t s, Args... args) {
  const int smem = tile_smem(es, K, R, S, grad);
  if (R < 1 || R > kTileWarps || kTileWarps % R || S < 1 || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  static int attr_bytes = 0;  // the dynamic shared memory the kernel was allowed
  if (smem > attr_bytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = smem;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (rows_per_scale + R - 1) / R;
  // blocks an SM holds: its shared memory over the block's (two at most: the
  // registers of a third do not fit)
  const int per_sm = smem <= 110 * 1024 ? 2 : 1;
  const int per_scale = per_sm * sms / n_scales > 1 ? per_sm * sms / n_scales : 1;
  const dim3 grid(n_tiles < per_scale ? n_tiles : per_scale, n_scales);
  kKernel<<<grid, kTileThreads, smem, s>>>(args..., R, S);
  return static_cast<int>(cudaGetLastError());
}

// Launch the row-group kernel: `warps` a row, `groups` a block, the grid
// cut to the blocks the SMs hold at once (each group then loops over rows),
// in equal shares of row groups.
template <typename T, int U, bool GRAD>
int launch_rows(int warps, int groups, int rows_per_scale, int n_scales, cudaStream_t s,
                const void* x, const float* scales, void* q, void* q_scale, int K, int ld) {
  auto* kernel = quant_rows_kernel<T, U, GRAD>;
  static int resident[kRowThreads / 32 + 1];  // blocks an SM holds, by warps a block
  const int threads = 32 * warps * groups;
  if (warps < 1 || groups < 1 || threads > kRowThreads || (warps > 1 && groups > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int& res = resident[threads / 32];
  if (!res) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res, kernel, threads, 0);
    res = res > 0 ? res : 1;
  }
  const int row_groups = (rows_per_scale + groups - 1) / groups;
  const int cap = sms * res / n_scales > 1 ? sms * res / n_scales : 1;
  const int iters = (row_groups + cap - 1) / cap;
  const dim3 grid((row_groups + iters - 1) / iters, n_scales);
  kernel<<<grid, threads, 0, s>>>(static_cast<const T*>(x), scales, static_cast<int8_t*>(q),
                                  static_cast<float*>(q_scale), K, ld, rows_per_scale, warps);
  return static_cast<int>(cudaGetLastError());
}

// the row-group kernel's instance for `unit`: 16 bytes of T (refused unless
// the rows and bases are 16-byte multiples) or 1 (scalar)
template <typename T, bool GRAD>
int launch_rows_unit(int unit, int warps, int groups, int rows_per_scale, int n_scales,
                     cudaStream_t s, const void* x, const float* scales, void* q,
                     void* q_scale, int K, int ld) {
  constexpr int VU = 16 / static_cast<int>(sizeof(T));
  if (unit == 1)
    return launch_rows<T, 1, GRAD>(warps, groups, rows_per_scale, n_scales, s, x, scales, q,
                                   q_scale, K, ld);
  if (unit != VU || K % VU || ld % VU || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 || (GRAD && reinterpret_cast<uintptr_t>(scales) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<T, VU, GRAD>(warps, groups, rows_per_scale, n_scales, s, x, scales, q,
                                  q_scale, K, ld);
}

// the tile kernel's operands: 16-byte rows of input and codes on 16-byte
// bases
bool tiles_ok(int es, int K, int ld, std::initializer_list<const void*> ptrs) {
  if ((K * es) % 16 || K % 16 || ld % 16) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// ---- the wgmma GEMM ---------------------------------------------------------

constexpr int kBM = 128;       // rows of a block tile: two consumer warpgroups
constexpr int kBN = 256;       // columns of a block tile
constexpr int kBK = kSwizzleBytes;  // k bytes per stage: one swizzle row
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK;
constexpr int kStageBytes = kABytes + kBN * kBK;
constexpr int kRingBytes = kStages * kStageBytes;
// + barriers, + slack to align the ring to the 1024-byte swizzle atom
constexpr int kSmem = kRingBytes + 2 * kStages * 8 + 1024;

// m64n256k32, s8 x s8 -> s32, A and B from shared memory; d accumulates
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// OUT: 0 = f32, 1 = bf16 (scaled), 2 = raw s32 accumulators
template <int OUT>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const float* __restrict__ xs,
                 const float* __restrict__ ws, void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int num_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kb = 0, s = 0, ph = 0; kb < num_k; ++kb) {
        mbar_wait(&empty[s], ph ^ 1);  // passes at once on the first lap
        mbar_expect_tx(&full[s], kStageBytes);
        unsigned char* st = ring + s * kStageBytes;
        tma_load(st, &map_a, kb * kBK, m0, &full[s]);
        tma_load(st + kABytes, &map_b, kb * kBK, n0, &full[s]);
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows [64 c, 64 c + 64) of the block tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  int s = 0, ph = 0, prev = 0;
  for (int kb = 0; kb < num_k; ++kb) {
    mbar_wait(&full[s], ph);
    const unsigned char* st = ring + s * kStageBytes;
    const uint64_t da = smem_desc(st + c * 64 * kBK), db = smem_desc(st + kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes = 2 descriptor units
      wgmma_n256(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's batch is done: release it
    if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == kStages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();

  // epilogue: the ring is free once both consumer warpgroups are done
  named_bar(1, 256);
  constexpr int ES = OUT == 1 ? 2 : 4;              // output element bytes
  constexpr int PITCH = kBN * ES + (ES == 2 ? 16 : 32);  // conflict-free fragment stores
  static_assert(kBM * PITCH <= kRingBytes, "the staged tile must fit the ring");
  unsigned char* tile = ring + c * 64 * PITCH;
  const int w = t / 32, g = lane / 4, t4 = lane % 4;
  const int lr = w * 16 + g;  // local rows lr and lr + 8 of this warpgroup
  float xs_lo = 0.f, xs_hi = 0.f;
  if (OUT != 2) {
    const int r = m0 + c * 64 + lr;
    xs_lo = r < M ? xs[r] : 0.f;
    xs_hi = r + 8 < M ? xs[r + 8] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    unsigned char* lo = tile + lr * PITCH + col * ES;
    unsigned char* hi = lo + 8 * PITCH;
    if constexpr (OUT == 2) {
      *reinterpret_cast<int2*>(lo) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(hi) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      const int gc = n0 + col;
      const float w0 = gc < N ? ws[gc] : 0.f, w1 = gc + 1 < N ? ws[gc + 1] : 0.f;
      const float y0 = __fmul_rn(__int2float_rn(acc[4 * j]), __fmul_rn(xs_lo, w0));
      const float y1 = __fmul_rn(__int2float_rn(acc[4 * j + 1]), __fmul_rn(xs_lo, w1));
      const float y2 = __fmul_rn(__int2float_rn(acc[4 * j + 2]), __fmul_rn(xs_hi, w0));
      const float y3 = __fmul_rn(__int2float_rn(acc[4 * j + 3]), __fmul_rn(xs_hi, w1));
      if constexpr (OUT == 0) {
        *reinterpret_cast<float2*>(lo) = make_float2(y0, y1);
        *reinterpret_cast<float2*>(hi) = make_float2(y2, y3);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(lo) =
            __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        *reinterpret_cast<__nv_bfloat162*>(hi) =
            __halves2bfloat162(__float2bfloat16_rn(y2), __float2bfloat16_rn(y3));
      }
    }
  }
  named_bar(2 + c, 128);
  // coalesced stores: 16-byte chunks along the rows; element by element
  // where the chunk crosses N or the rows are not 16-byte aligned
  constexpr int VEC = 16 / ES, CHUNKS = kBN / VEC;
  const bool aligned = (static_cast<size_t>(N) * ES) % 16 == 0;
  unsigned char* o = static_cast<unsigned char*>(out);
  for (int i = t; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    const int gr = m0 + c * 64 + r, gc = n0 + ch * VEC;
    if (gr >= M || gc >= N) continue;
    const unsigned char* src = tile + r * PITCH + ch * 16;
    unsigned char* dst = o + (static_cast<size_t>(gr) * N + gc) * ES;
    if (aligned && gc + VEC <= N) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < VEC && gc + e < N; ++e)
        for (int b = 0; b < ES; ++b) dst[e * ES + b] = src[e * ES + b];
    }
  }
}

template <int OUT>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, const float* xs, const float* ws,
                void* out, int M, int N, int K, cudaStream_t s) {
  auto* kernel = w8a8_gemm_kernel<OUT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, s>>>(ma, mb, xs, ws, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The two quantizers' entries take the launch plan the wrapper chose from
// the shape and the addresses (ops/kernels/w8a8.py::quant_plan): R rows a
// tile and S stages for the tile kernel (refused unless its operands allow
// it), or, with R 0, the row-group kernel's unit (16 bytes or 1 element),
// warps a row and groups a block. M 0 launches nothing.
int mt_act_quant_rows(const void* x, int x_is_bf16, void* xq, void* x_scale, int M, int K,
                      int R, int S, int unit, int warps, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaSuccess);
  if (R == 0)
    return x_is_bf16 ? launch_rows_unit<__nv_bfloat16, false>(unit, warps, groups, M, 1, s, x,
                                                              nullptr, xq, x_scale, K, K)
                     : launch_rows_unit<float, false>(unit, warps, groups, M, 1, s, x, nullptr,
                                                      xq, x_scale, K, K);
  // the tile kernel takes bf16 activation rows (f32 ones timed faster on the
  // row-group kernel)
  if (!x_is_bf16 || !tiles_ok(2, K, K, {x, xq})) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiles<act_quant_rows_kernel>(2, K, R, S, false, M, 1, s,
                                             static_cast<const __nv_bfloat16*>(x),
                                             static_cast<int8_t*>(xq),
                                             static_cast<float*>(x_scale), K, M);
}

int mt_grad_quant_rows(const void* g, int g_is_bf16, const void* scale, void* gq,
                       void* g_scale, int M, int N, int ld, int rows_per_scale, int R, int S,
                       int unit, int warps, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaSuccess);
  if (rows_per_scale < 1 || M % rows_per_scale || ld < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = M / rows_per_scale;
  const auto* sc = static_cast<const float*>(scale);
  if (R == 0)
    return g_is_bf16 ? launch_rows_unit<__nv_bfloat16, true>(unit, warps, groups,
                                                             rows_per_scale, E, s, g, sc, gq,
                                                             g_scale, N, ld)
                     : launch_rows_unit<float, true>(unit, warps, groups, rows_per_scale, E, s,
                                                     g, sc, gq, g_scale, N, ld);
  const int es = g_is_bf16 ? 2 : 4;
  if (!tiles_ok(es, N, ld, {g, scale, gq})) return static_cast<int>(cudaErrorInvalidValue);
  auto* q = static_cast<int8_t*>(gq);
  auto* qs = static_cast<float*>(g_scale);
  if (g_is_bf16)
    return launch_tiles<grad_quant_rows_kernel<__nv_bfloat16>>(
        es, N, R, S, true, rows_per_scale, E, s, static_cast<const __nv_bfloat16*>(g), sc,
        q, qs, N, ld, rows_per_scale);
  return launch_tiles<grad_quant_rows_kernel<float>>(es, N, R, S, true, rows_per_scale, E,
                                                     s, static_cast<const float*>(g), sc, q,
                                                     qs, N, ld, rows_per_scale);
}

int mt_w8a8_gemm(const void* xq, const void* wq_t, const void* x_scale,
                 const void* w_scale, void* out, int out_kind, int M, int N,
                 int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  CUtensorMap ma, mb;
  if (!make_map_s8(&ma, xq, M, K, kBM) || !make_map_s8(&mb, wq_t, N, K, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind == 0) return launch_gemm<0>(ma, mb, xs, ws, out, M, N, K, s);
  if (out_kind == 1) return launch_gemm<1>(ma, mb, xs, ws, out, M, N, K, s);
  if (out_kind == 2) return launch_gemm<2>(ma, mb, xs, ws, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
