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

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::hopper;

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
act_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                      float* __restrict__ x_scale, int K) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(mt::to_f32(xr[i])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float warp_max[kQuantThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = threadIdx.x < kQuantThreads / 32 ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) warp_max[0] = m;
  }
  __syncthreads();
  const float scale = fmaxf(__fdiv_rn(warp_max[0], 127.0f), 1e-10f);
  if (threadIdx.x == 0) x_scale[row] = scale;
  int8_t* qr = xq + static_cast<size_t>(row) * K;
  for (int i = threadIdx.x; i < K; i += kQuantThreads)
    qr[i] = static_cast<int8_t>(
        __float2int_rn(__fdiv_rn(mt::to_f32(xr[i]), scale)));
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

int mt_act_quant_rows(const void* x, int x_is_bf16, void* xq, void* x_scale,
                      int M, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    act_quant_rows_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(x_scale), K);
  else
    act_quant_rows_kernel<float><<<M, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(x_scale), K);
  return static_cast<int>(cudaGetLastError());
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
