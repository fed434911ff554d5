// K5: w4a8 projection GEMM — an int8 activation (K1's per-row quantizer)
// against split-halves packed int4 weights, s8 x s8 -> s32, with a fused
// rescale epilogue.
//
// Replaces medtsllm_tpu/ops/pallas/quant_matmul.py::w4a8_matmul_pallas and
// the XLA unpack-then-dot it stands in for (w4a8_matmul_reference), whose
// numerics it follows:
//   out = (float(acc) * x_scale) * w_scale       (the scales one at a time,
//                                                 not K1's x_scale * w_scale)
//
// Weight layout: packed [N, K/2] int8 (the JAX kernel_q [K/2, N]
// transposed); byte p of row n holds w[n][p] in its high nibble and
// w[n][p + K/2] in its low one (pack4_split), so
//   y = x[:, :K/2] . hi^T + x[:, K/2:] . lo^T.
//
// What bounds it: at the serving shapes (M = 896 or 6,912 rows; K, N in
// {2048, 4096, 11008}) 2 * M * N * K operations against M * K + N * K / 2
// bytes: the int8 tensor cores, which only wgmma drives at their rate. The
// design is K1's pipeline (hopper.cuh) with the operands swapped: an output
// tile's transpose is W_tile . x_tile^T, so
//   - the weight is wgmma's A, from REGISTERS: a block owns 128 weight rows
//     (two consumer warpgroups of 64) and each consumer thread reads the
//     packed bytes of its m16n8k32 fragment rows once from the TMA-staged
//     packed tile [128 rows, 128 bytes] (128-byte swizzle: conflict-free
//     32-bit reads). One byte feeds two k-steps: its high nibbles the
//     fragment for k in [p0, p0 + 128), its low nibbles the same fragment
//     position for k in [K/2 + p0, ...). No unpacked copy of the weight
//     exists anywhere. A nibble is kept in place, as 16 x its value
//     (byte & 0xF0, (byte << 4) & 0xF0: one or two logic operations a word,
//     no sign-extension), and the accumulator is shifted right by 4 at the
//     end: every term is a multiple of 16, so the shift is exact, and
//     |acc| <= 16 * K * 127 * 8 < 2^31 for K <= 131072;
//   - the activation is wgmma's B, from shared memory, K-major in the
//     128-byte swizzle: exactly K1's B operand, 256 rows a block;
//   - a ring of four 48 KB stages filled by TMA under full / empty
//     mbarriers by one producer thread (its warpgroup gives its registers
//     away with setmaxnreg): a packed step takes two stages, the first
//     holding the packed weight tile and x's columns [p0, p0 + 128), the
//     second x's columns [K/2 + p0, ...). TMA's zero fill covers ragged M,
//     N and the K/2 tail (past K/2 the weight reads as zero, so whatever x
//     holds there adds nothing);
//   - per stage each consumer issues four wgmma m64n256k32 with A from
//     registers, keeps one batch in flight and releases the stage before;
//   - the epilogue applies (float(acc >> 4) * xs) * ws with __fmul_rn (the
//     plain version's order: bit-equal), stages each consumer's 256 x 64
//     output tile transposed in the free ring and stores 16-byte rows.
// The tensor maps are encoded on the host per call.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::hopper;

constexpr int kBW = 128;            // weight rows (output columns) of a block tile
constexpr int kBX = 256;            // activation rows (output rows): wgmma's N
constexpr int kBP = kSwizzleBytes;  // packed bytes per step: 2 x 128 logical k
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kStages = 4;
constexpr int kWBytes = kBW * kBP;
constexpr int kXBytes = kBX * kBP;
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kRingBytes = kStages * kStageBytes;
// + barriers, + slack to align the ring to the 1024-byte swizzle atom
constexpr int kSmem = kRingBytes + 2 * kStages * 8 + 1024;
constexpr int kMaxK = 131072;  // 16 * K * 127 * 8 < 2^31
constexpr uint32_t kHiMask = 0xF0F0F0F0u;

// m64n256k32, s8 x s8 -> s32: A (64 weight rows x 32 k) from registers in
// the m16n8k32 fragment order of each warp, B (256 activation rows, K-major)
// from shared memory; d accumulates
__device__ __forceinline__ void wgmma_n256_ra(int (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// OUT: 0 = f32, 1 = bf16 (scaled), 2 = raw s32 accumulators
template <int OUT>
__global__ void __launch_bounds__(kThreads, 1)
w4a8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const float* __restrict__ xs,
                 const float* __restrict__ ws, void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * kBW, m0 = blockIdx.y * kBX;
  const int half = K / 2;
  const int num_p = (half + kBP - 1) / kBP;  // packed steps, two stages each

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
      for (int kb = 0, s = 0, ph = 0; kb < num_p; ++kb) {
        const int p0 = kb * kBP;
        mbar_wait(&empty[s], ph ^ 1);  // passes at once on the first lap
        mbar_expect_tx(&full[s], kStageBytes);
        unsigned char* st = ring + s * kStageBytes;
        tma_load(st, &map_w, p0, n0, &full[s]);
        tma_load(st + kWBytes, &map_x, p0, m0, &full[s]);
        if (++s == kStages) s = 0, ph ^= 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], kXBytes);
        tma_load(ring + s * kStageBytes + kWBytes, &map_x, half + p0, m0, &full[s]);
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup c owns weight rows [64 c, 64 c + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
  const int w = t / 32, g = lane / 4, t4 = lane % 4;
  const int ra = c * 64 + w * 16 + g;  // this thread's fragment rows ra, ra + 8
  int acc[kBX / 2];
#pragma unroll
  for (int i = 0; i < kBX / 2; ++i) acc[i] = 0;
  uint32_t pw[4][4], ahi[4][4], alo[4][4];
  int s = 0, ph = 0, prev = -1;
  for (int kb = 0; kb < num_p; ++kb) {
    // first stage: the packed weight tile and x's columns [p0, p0 + 128)
    mbar_wait(&full[s], ph);
    const unsigned char* st = ring + s * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // m16n8k32 order: (ra, k), (ra + 8, k), then k + 16
        const int b = kk * 32 + (i >> 1) * 16 + t4 * 4;
        pw[kk][i] = *reinterpret_cast<const uint32_t*>(st + swizzle128(ra + (i & 1) * 8, b));
        ahi[kk][i] = pw[kk][i] & kHiMask;
      }
    uint64_t db = smem_desc(st + kWBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n256_ra(acc, ahi[kk], db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's second batch is done: release it
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    const int first = s;
    if (++s == kStages) s = 0, ph ^= 1;
    // second stage: x's columns [K/2 + p0, ...) against the low nibbles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) alo[kk][i] = (pw[kk][i] << 4) & kHiMask;
    mbar_wait(&full[s], ph);
    db = smem_desc(ring + s * kStageBytes + kWBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n256_ra(acc, alo[kk], db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the first batch is done: release the weight tile's stage
    if (lane == 0) mbar_arrive(&empty[first]);
    prev = s;
    if (++s == kStages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
  // the epilogue's reads of the accumulators stay after the wait
#pragma unroll
  for (int i = 0; i < kBX / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");

  // epilogue: the ring is free once both consumer warpgroups are done.
  // Consumer c stages its [256 x rows, 64 weight rows] slice of the output
  // tile row-major (output rows = activation rows) and stores it.
  named_bar(1, 256);
  constexpr int ES = OUT == 1 ? 2 : 4;                 // output element bytes
  constexpr int PITCH = (kBW / 2) * ES + 16;           // conflict-free fragment stores
  static_assert(2 * kBX * PITCH <= kRingBytes, "the staged tile must fit the ring");
  unsigned char* tile = ring + c * kBX * PITCH;
  const int nl = w * 16 + g;  // local weight rows nl and nl + 8 of this consumer
  float ws_lo = 0.f, ws_hi = 0.f;
  if (OUT != 2) {
    const int n = n0 + c * 64 + nl;
    ws_lo = n < N ? ws[n] : 0.f;
    ws_hi = n + 8 < N ? ws[n + 8] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kBX / 8; ++j) {
    const int ml = j * 8 + t4 * 2;  // local activation rows ml and ml + 1
    unsigned char* p00 = tile + ml * PITCH + nl * ES;  // (ml, nl)
    unsigned char* p10 = p00 + PITCH;                  // (ml + 1, nl)
    const int a0 = acc[4 * j] >> 4, a1 = acc[4 * j + 1] >> 4;  // (nl, ml), (nl, ml + 1)
    const int a2 = acc[4 * j + 2] >> 4, a3 = acc[4 * j + 3] >> 4;  // nl + 8
    if constexpr (OUT == 2) {
      *reinterpret_cast<int*>(p00) = a0;
      *reinterpret_cast<int*>(p10) = a1;
      *reinterpret_cast<int*>(p00 + 8 * ES) = a2;
      *reinterpret_cast<int*>(p10 + 8 * ES) = a3;
    } else {
      const int m = m0 + ml;
      const float x0 = m < M ? xs[m] : 0.f, x1 = m + 1 < M ? xs[m + 1] : 0.f;
      const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), x0), ws_lo);
      const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), x1), ws_lo);
      const float y2 = __fmul_rn(__fmul_rn(__int2float_rn(a2), x0), ws_hi);
      const float y3 = __fmul_rn(__fmul_rn(__int2float_rn(a3), x1), ws_hi);
      if constexpr (OUT == 0) {
        *reinterpret_cast<float*>(p00) = y0;
        *reinterpret_cast<float*>(p10) = y1;
        *reinterpret_cast<float*>(p00 + 8 * ES) = y2;
        *reinterpret_cast<float*>(p10 + 8 * ES) = y3;
      } else {
        *reinterpret_cast<__nv_bfloat16*>(p00) = __float2bfloat16_rn(y0);
        *reinterpret_cast<__nv_bfloat16*>(p10) = __float2bfloat16_rn(y1);
        *reinterpret_cast<__nv_bfloat16*>(p00 + 8 * ES) = __float2bfloat16_rn(y2);
        *reinterpret_cast<__nv_bfloat16*>(p10 + 8 * ES) = __float2bfloat16_rn(y3);
      }
    }
  }
  named_bar(2 + c, 128);
  // coalesced stores: 16-byte chunks along the rows; element by element
  // where the chunk crosses N or the rows are not 16-byte aligned
  constexpr int VEC = 16 / ES, CHUNKS = (kBW / 2) / VEC;
  const bool aligned = (static_cast<size_t>(N) * ES) % 16 == 0;
  unsigned char* o = static_cast<unsigned char*>(out);
  for (int i = t; i < kBX * CHUNKS; i += 128) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    const int gr = m0 + r, gc = n0 + c * 64 + ch * VEC;
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
int launch_gemm(const CUtensorMap& mx, const CUtensorMap& mw, const float* xs, const float* ws,
                void* out, int M, int N, int K, cudaStream_t s) {
  auto* kernel = w4a8_gemm_kernel<OUT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + kBW - 1) / kBW, (M + kBX - 1) / kBX);
  kernel<<<grid, kThreads, kSmem, s>>>(mx, mw, xs, ws, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xq [M, K] int8, packed [N, K/2] int8, x_scale [M] f32, w_scale [N] f32,
// out [M, N] (out_kind 0 f32, 1 bf16, 2 s32); K / 2 a multiple of 16
// (TMA's row stride), K <= 131072, xq and packed 16-byte aligned
int mt_w4a8_gemm(const void* xq, const void* packed, const void* x_scale,
                 const void* w_scale, void* out, int out_kind, int M, int N,
                 int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 32 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  CUtensorMap mx, mw;
  if (!make_map_s8(&mx, xq, M, K, kBX) || !make_map_s8(&mw, packed, N, K / 2, kBW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind == 0) return launch_gemm<0>(mx, mw, xs, ws, out, M, N, K, s);
  if (out_kind == 1) return launch_gemm<1>(mx, mw, xs, ws, out, M, N, K, s);
  if (out_kind == 2) return launch_gemm<2>(mx, mw, xs, ws, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
