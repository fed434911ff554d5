// K4: blocked online-softmax attention (flash attention), forward, with
// the long-window route's RoPE, transposes and prefix concat folded in.
//
// Replaces medtsllm_tpu/ops/pallas/flash_attention.py::flash_attention
// (_flash_attention_pallas / _flash_kernel) and, on the fused entry, the
// route around it in medtsllm_tpu/models/llm/transformer.py:591-633
// (rotary_embedding in the projection layout, the head transpose, the
// prefix concat). It computes what _flash_kernel computes, not its blocks:
//   - q against k/v [B, KV, S, D], KV dividing H: query head h of batch b
//     reads kv row b * KV + h / (H / KV), never another batch row;
//   - f32 scores x sm_scale; masked scores are -1e30 in JAX (-inf in the
//     bf16 kernel, whose running max starts at -1e30: both give p = 0):
//     columns past S (TMA zero-fills the K/V rows past S, so no garbage x
//     0) and, when causal, columns above the end-aligned diagonal (query i
//     sees keys <= i + S - L);
//   - per query row an f32 running max m, sum l and accumulator acc; per
//     k-tile m_new = max(m, rowmax(s)), alpha = exp(m - m_new),
//     p = exp(s - m_new), l = alpha l + rowsum(p) (p in f32),
//     acc = alpha acc + p v with p rounded to v's dtype first (JAX's
//     p.astype(v.dtype)); in the bf16 kernel exp is the special-function
//     unit's exp2 of the log2(e)-scaled scores (one FMA and one MUFU op);
//   - out = acc / max(l, 1e-30), rounded to q's dtype; query rows past L
//     are not written; k-tiles wholly above the diagonal are skipped.
//
// Two entries launch the same main kernel:
//   - mt_flash_attention: the JAX function's own interface, q [B, H, L, D]
//     already rotated, k/v [B, KV, S, D], causal or not;
//   - mt_rope_flash_attention: the decoder's long-window route, q in the
//     projection layout [B, L, H, D] before rotary, rotated inside the
//     kernel, and k/v [B, KV, S, D] from mt_flash_keys; the output is
//     written in [B, L, H, D], so o_proj's reshape is a view.
// mt_flash_keys, the pre-pass, rotates the region's keys once (f32 with the
// tables rounded to bf16, one rounding: K2's rope_pair law) and writes
// [prefix | rotated region] keys and [prefix | region] values into
// [B, KV, S, D] scratch the wrapper allocates: one launch in place of
// rope(k), two transposes, two expands and two cats. The concatenated
// scratch ships rather than two TMA maps (prefix and region) because the
// prefix's length (37-39 at the served windows) is no multiple of the tile:
// a key tile would straddle the two sources. The same scratch is the
// prefill's cache, so cached and uncached calls attend with the same bits.
//
// What bounds it: at the long-window serving shape (B 8, H 32, D 128,
// L ~2128, S ~2167, causal) a call does ~0.3 TFLOP of bf16 products against
// ~0.6 GB of operands, ~500 operations per byte: the tensor cores, which only
// wgmma drives at their rate. The bf16 design (Hopper's own):
//   - one block per 128 query rows of one (batch, head), the longest causal
//     rows first; one producer warpgroup (one thread issues every TMA copy;
//     setmaxnreg gives its registers to the consumers) and two consumer
//     warpgroups, each owning 64 query rows;
//   - q arrives by TMA as 64-column boxes in the 128-byte swizzle (a 4-D
//     map over either layout); at D 128 the two boxes are exactly the
//     rotation's halves x1 and x2, so each consumer rotates its rows once in
//     shared memory (K2's rope_pair rounding), fences the async proxy, and
//     reads q from there as wgmma's A for every key tile;
//   - K and V tiles of 128 keys fill a 2-stage (D 128, 32 KB each for K and
//     V) or 4-stage (D 64) ring by TMA under full / empty mbarriers, K and V
//     on barriers of their own so QK^T starts before V has landed (three
//     stages at D 128 timed the same on an H100);
//   - S = Q K^T on wgmma m64n128k16 (bf16 -> f32, K K-major); the online
//     softmax in registers (each thread holds 2 rows x 32 columns; row
//     statistics meet across the 4 lanes of a quad); P rounded to bf16 in
//     wgmma's register-A fragment order and multiplied into V on
//     m64n{D}k16 with V read MN-major (16-bit wgmma transposes B); one
//     warpgroup's softmax overlaps the other's products. Timed on an H100
//     and not kept, each 5-15% slower: a tile's PV and the next tile's QK^T
//     issued back to back (with or without the two warpgroups taking turns
//     by named barriers); the scores and probabilities declared outside the
//     tile loop;
//   - the output is staged in the warpgroup's own q rows (free once its last
//     QK^T is done) and written by a TMA store that clips the rows past L.
// Head dims 192 and 256 (the ln family's wide heads, e.g. pythia-1b's 256;
// JAX's dispatcher sends every D % 64 == 0 to its kernel) take the same bf16
// design with 64-key tiles (m64n64k16 for S, m64n{D}k16 for PV): a
// consumer thread then holds D / 2 accumulators, 32 scores and 16 words of
// P, 176 registers at D 256, inside setmaxnreg's 240; two stages fit beside
// q. The fused entry (RoPE in the kernel) stays at D 64 / 128, the route's
// head dims.
// Head dims 320, 384, 448 and 512 (JAX's dispatcher sends them to its
// kernel too) take a simple kernel in both dtypes, past wgmma's N of 256:
// passes of at most 256 output columns that each recompute the scores
// (flash_wide_kernel below).
// f32 inputs take a plain FMA kernel (no TF32): one thread per head-dim
// column over 16-query (24 at D 192, 8 at D 256) x 32-key tiles, for f32
// parity with the CPU; on the fused entry a first kernel rotates q for it
// (torch's f32 rounding).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::hopper;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- the pre-pass: [prefix | rotated region] keys, [prefix | region] values

// kc/vc [B, KV, S = P + L, D] from the region k/v [B, L, KV, D] (keys
// rotated at position s - P) and the rotated prefix pk/pv [PB, KV, P, D]:
// one thread per row and pair of pairs (d, d + 1), (d + D/2, d + D/2 + 1)
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_keys_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ cosb, const float* __restrict__ sinb,
                  const T* __restrict__ pk, const T* __restrict__ pv, T* __restrict__ kc,
                  T* __restrict__ vc, int L, int KV, int P, int PB, long long n) {
  using T2 = typename std::conditional<std::is_same<T, float>::value, float2,
                                       __nv_bfloat162>::type;
  constexpr int HALF = D / 2, PAIRS = HALF / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int S = P + L;
  const long long row = idx / PAIRS;
  const int d = 2 * static_cast<int>(idx % PAIRS);
  const int s = static_cast<int>(row % S);
  const long long bk = row / S;
  const int kvh = static_cast<int>(bk % KV), b = static_cast<int>(bk / KV);
  const size_t o = static_cast<size_t>(row) * D + d;
  T2 x1, x2, v1, v2;
  if (s < P) {
    const size_t src = ((static_cast<size_t>(PB == 1 ? 0 : b) * KV + kvh) * P + s) * D + d;
    x1 = *reinterpret_cast<const T2*>(pk + src);
    x2 = *reinterpret_cast<const T2*>(pk + src + HALF);
    v1 = *reinterpret_cast<const T2*>(pv + src);
    v2 = *reinterpret_cast<const T2*>(pv + src + HALF);
  } else {
    const int l = s - P;
    const size_t src = ((static_cast<size_t>(b) * L + l) * KV + kvh) * D + d;
    x1 = *reinterpret_cast<const T2*>(k + src);
    x2 = *reinterpret_cast<const T2*>(k + src + HALF);
    v1 = *reinterpret_cast<const T2*>(v + src);
    v2 = *reinterpret_cast<const T2*>(v + src + HALF);
    mt::rope_pair(x1, x2, *reinterpret_cast<const float2*>(cosb + static_cast<size_t>(l) * HALF + d),
                  *reinterpret_cast<const float2*>(sinb + static_cast<size_t>(l) * HALF + d));
  }
  *reinterpret_cast<T2*>(kc + o) = x1;
  *reinterpret_cast<T2*>(kc + o + HALF) = x2;
  *reinterpret_cast<T2*>(vc + o) = v1;
  *reinterpret_cast<T2*>(vc + o + HALF) = v2;
}

// x [rows, D] rotated into xr, row r at position (r / heads) % L (q
// [B, L, H, D] for the f32 kernel, which rotates nothing itself)
template <int D>
__global__ void __launch_bounds__(256)
rotate_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ cosb,
                       const float* __restrict__ sinb, float* __restrict__ xr, int L,
                       int heads, long long n) {
  constexpr int HALF = D / 2, PAIRS = HALF / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long row = idx / PAIRS;
  const int d = 2 * static_cast<int>(idx % PAIRS);
  const int l = static_cast<int>((row / heads) % L);
  const size_t o = static_cast<size_t>(row) * D + d;
  float2 x1 = *reinterpret_cast<const float2*>(x + o);
  float2 x2 = *reinterpret_cast<const float2*>(x + o + HALF);
  mt::rope_pair(x1, x2, *reinterpret_cast<const float2*>(cosb + static_cast<size_t>(l) * HALF + d),
                *reinterpret_cast<const float2*>(sinb + static_cast<size_t>(l) * HALF + d));
  *reinterpret_cast<float2*>(xr + o) = x1;
  *reinterpret_cast<float2*>(xr + o + HALF) = x2;
}

// ---- bf16: wgmma + TMA ------------------------------------------------------

constexpr int kBQ = 128;           // query rows per block: two consumer warpgroups
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kQBox = 64 * kSwizzleBytes;     // 64 rows x 64 columns

// D 64 / 128: 128-key tiles. D 192 / 256: 64-key tiles, so that a consumer's
// accumulator (D / 2 floats a thread), scores (kBK / 2) and bf16 P fragments
// (kBK / 4 words) stay in its 240 registers (176 at D 256), and two stages of
// K and V fit shared memory beside q (144 KB at D 192, 192 KB at D 256)
template <int D>
struct Smem {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256, "head dim");
  static constexpr int kBK = D <= 128 ? 128 : 64;           // keys per tile
  static constexpr int kKVBox = kBK * kSwizzleBytes;        // kBK keys x 64 columns
  static constexpr int kHalves = D / 64;        // 64-column boxes per row
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kQBytes = 2 * kHalves * kQBox;
  static constexpr int kTileBytes = kHalves * kKVBox;  // one K or one V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // + q_full[2], k_full, v_full and empty per stage; + slack to align to
  // the 1024-byte swizzle atom
  static constexpr int kBytes = kQBytes + kRingBytes + (2 + 3 * kStages) * 8 + 1024;
};

struct FlashArgs {
  const float* cosb;  // the rotation's tables [L, D/2], or null: q is rotated
  const float* sinb;
  int H, KV, L, S, causal;
  int lhd;            // q and out in [B, L, H, D] (else [B, H, L, D])
  float scale_log2;   // sm_scale * log2(e)
};

// m64n128k16 bf16 -> f32, A (64 query rows) and B (128 keys, K-major) from
// shared memory; d is overwritten when scale_d is 0, else accumulated
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n64k16 bf16 -> f32 (the 64-key tile of D 192 / 256), A and B from
// shared memory as wgmma_qk's
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n{D}k16 bf16 -> f32: A (64 rows x 16 keys of P) from registers in the
// m16n8k16 fragment order of each warp, B (16 keys x D of V) from shared
// memory MN-major (imm-trans-b 1); d accumulates
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// reads of the accumulators stay after the wgmma wait that completes them
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// 2^x on the special-function unit (subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the 64-row q (or output) box at (column col, row row, head h, batch b) in
// either layout's 4-D map
__device__ __forceinline__ void load_q(void* dst, const CUtensorMap* map, int col, int row,
                                       int h, int b, int lhd, uint64_t* bar) {
  if (lhd) tma_load_4d(dst, map, col, h, row, b, bar);
  else tma_load_4d(dst, map, col, row, h, b, bar);
}
__device__ __forceinline__ void store_o(const CUtensorMap* map, const void* src, int col,
                                        int row, int h, int b, int lhd) {
  if (lhd) tma_store_4d(map, src, col, h, row, b);
  else tma_store_4d(map, src, col, row, h, b);
}

// this warpgroup's 64 q rows (global rows r_first..) rotated in place in
// shared memory; x1 = columns [0, D/2), x2 = [D/2, D) of the swizzled boxes.
// The thread's cos/sin pairs are loaded first (load_tables), while q's TMA
// load is still in flight, then applied (rotate_q)
template <int D>
struct QTables {
  static constexpr int kPairs = D / 4;                // pairs of pairs a row
  static constexpr int kIters = 64 * kPairs / 128;    // a thread's share of 64 rows
  float2 c[kIters], s[kIters];
};

template <int D>
__device__ __forceinline__ void load_tables(QTables<D>& tb, const float* __restrict__ cosb,
                                            const float* __restrict__ sinb, int r_first, int L,
                                            int t) {
  constexpr int HALF = D / 2, PAIRS = QTables<D>::kPairs;
#pragma unroll
  for (int it = 0; it < QTables<D>::kIters; ++it) {
    const int i = t + it * 128, r = i / PAIRS, d = 2 * (i % PAIRS), l = r_first + r;
    const size_t o = static_cast<size_t>(l < L ? l : 0) * HALF + d;
    tb.c[it] = *reinterpret_cast<const float2*>(cosb + o);
    tb.s[it] = *reinterpret_cast<const float2*>(sinb + o);
  }
}

template <int D>
__device__ __forceinline__ void rotate_q(unsigned char* q, const QTables<D>& tb, int r_first,
                                         int L, int t) {
  constexpr int HALF = D / 2, PAIRS = QTables<D>::kPairs;
#pragma unroll
  for (int it = 0; it < QTables<D>::kIters; ++it) {
    const int i = t + it * 128, r = i / PAIRS, d = 2 * (i % PAIRS);
    if (r_first + r >= L) continue;
    // column c of a row lies in box c / 64 at byte 2 (c % 64)
    auto* p1 = reinterpret_cast<__nv_bfloat162*>(q + (d / 64) * kQBox + swizzle128(r, 2 * (d % 64)));
    auto* p2 = reinterpret_cast<__nv_bfloat162*>(q + ((d + HALF) / 64) * kQBox +
                                                 swizzle128(r, 2 * ((d + HALF) % 64)));
    __nv_bfloat162 x1 = *p1, x2 = *p2;
    mt::rope_pair(x1, x2, tb.c[it], tb.s[it]);
    *p1 = x1;
    *p2 = x2;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, const FlashArgs a) {
  using C = Smem<D>;
  constexpr int kBK = C::kBK, kKVBox = C::kKVBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = sq + C::kQBytes;  // per stage: K's boxes, then V's
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + C::kRingBytes);
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  // one block a (query tile, batch x head), the tiles of one batch x head
  // together and the longest causal rows first; B x H lives in grid.x, whose
  // range (2^31 - 1) has room for any batch, where grid.y stops at 65535
  const int nqt = (a.L + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nqt, qt = nqt - 1 - blockIdx.x % nqt;
  const int b = bh / a.H, h = bh % a.H;
  const int kv_row = b * a.KV + h / (a.H / a.KV);
  const int q0 = qt * kBQ, offs = a.S - a.L;
  const int kend = a.causal ? min(a.S, q0 + kBQ + offs) : a.S;  // keys any row here sees
  const int ntiles = (kend + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&q_full[0], 1);
    mbar_init(&q_full[1], 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);  // the producer's expect_tx arrivals
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int c = 0; c < 2; ++c) {
        mbar_expect_tx(&q_full[c], C::kHalves * kQBox);
        for (int hf = 0; hf < C::kHalves; ++hf)
          load_q(sq + (c * C::kHalves + hf) * kQBox, &map_q, hf * 64, q0 + c * 64, h, b, a.lhd,
                 &q_full[c]);
      }
      for (int t = 0, s = 0, ph = 0; t < ntiles; ++t) {
        mbar_wait(&empty[s], ph ^ 1);  // passes at once on the first lap
        unsigned char* st = ring + s * C::kStageBytes;
        mbar_expect_tx(&k_full[s], C::kTileBytes);
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_3d(st + hf * kKVBox, &map_k, hf * 64, t * kBK, kv_row, &k_full[s]);
        mbar_expect_tx(&v_full[s], C::kTileBytes);
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_3d(st + C::kTileBytes + hf * kKVBox, &map_v, hf * 64, t * kBK, kv_row,
                      &v_full[s]);
        if (++s == C::kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1, t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  unsigned char* my_q = sq + c * C::kHalves * kQBox;
  const int r_first = q0 + c * 64;
  const int row0 = r_first + w * 16 + g;  // this thread's rows: row0, row0 + 8
  // every row of this warpgroup past L: nothing to compute or store, but
  // its warps still release each stage
  const bool idle = r_first >= a.L;
  if constexpr (D <= 128) {  // the route (in-kernel rotation) runs at D 64 / 128 only
    const bool rotate = a.cosb != nullptr && !idle;
    QTables<D> tb;
    if (rotate) load_tables<D>(tb, a.cosb, a.sinb, r_first, a.L, t);
    mbar_wait(&q_full[c], 0);
    if (rotate) {
      rotate_q<D>(my_q, tb, r_first, a.L, t);
      fence_proxy_async();
      named_bar(1 + c, 128);
    }
  } else {
    mbar_wait(&q_full[c], 0);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const uint64_t dq = smem_desc(my_q);
  for (int tile = 0, s = 0, ph = 0; tile < ntiles; ++tile) {
    const int j0 = tile * kBK;
    const unsigned char* st = ring + s * C::kStageBytes;
    if (idle || (a.causal && j0 > r_first + 63 + offs)) {
      mbar_wait(&k_full[s], ph);
      mbar_wait(&v_full[s], ph);
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == C::kStages) s = 0, ph ^= 1;
      continue;
    }
    float sc[kBK / 2];
    mbar_wait(&k_full[s], ph);
    const uint64_t dk = smem_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(sc, dq + (kk / 4) * (kQBox >> 4) + 2 * (kk % 4),
               dk + (kk / 4) * (kKVBox >> 4) + 2 * (kk % 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    // mask (only a tile that reaches past S or the first row's diagonal
    // has masked entries) and take the rows' max on the raw scores; the
    // scale to log2 units goes into the exponent's FMA (sm_scale > 0, so
    // the max commutes with it)
    const bool edge = j0 + kBK > a.S || (a.causal && j0 + kBK - 1 > r_first + offs);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = j0 + 8 * j + 2 * t4 + (e & 1), row = row0 + (e >> 1) * 8;
          if (col >= a.S || (a.causal && col > row + offs)) sc[4 * j + e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i] * a.scale_log2);
      alpha[i] = ex2(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(sc[4 * j + e], a.scale_log2, -m_r[e >> 1]));
        l_r[e >> 1] += p[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    mbar_wait(&v_full[s], ph);
    const unsigned char* sv = st + C::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv(o, pa[kk], smem_desc_mn(sv + kk * 16 * kSwizzleBytes, kKVBox));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == C::kStages) s = 0, ph ^= 1;
  }
  if (idle) return;

  // out = acc / max(l, 1e-30): staged in this warpgroup's q boxes (its
  // last QK^T is done, and the other warpgroup reads only its own rows),
  // then one TMA store per box, which clips the rows past L
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
  }
  const int lr = w * 16 + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    unsigned char* box = my_q + (col / 64) * kQBox;
    const int byte = 2 * (col % 64);
    *reinterpret_cast<uint32_t*>(box + swizzle128(lr, byte)) =
        pack_bf16(__fdiv_rn(o[4 * j], l_r[0]), __fdiv_rn(o[4 * j + 1], l_r[0]));
    *reinterpret_cast<uint32_t*>(box + swizzle128(lr + 8, byte)) =
        pack_bf16(__fdiv_rn(o[4 * j + 2], l_r[1]), __fdiv_rn(o[4 * j + 3], l_r[1]));
  }
  fence_proxy_async();
  named_bar(1 + c, 128);
  if (t == 0) {
    for (int hf = 0; hf < C::kHalves; ++hf)
      store_o(&map_o, my_q + hf * kQBox, hf * 64, r_first, h, b, a.lhd);
    bulk_commit();
    bulk_wait_read();
  }
}

// q / out as 64-row, 64-column boxes of a 4-D map over [B, L, H, D] (lhd)
// or [B, H, L, D]; k / v as 128-key boxes of a 3-D map over [B * KV, S, D]
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const FlashArgs& a,
                 int B, cudaStream_t stream) {
  const uint64_t row = D * 2;  // bytes
  const uint64_t H = a.H, L = a.L;
  uint64_t qd[4], qs[3];
  uint32_t qb[4];
  if (a.lhd) {
    const uint64_t d[4] = {D, H, L, static_cast<uint64_t>(B)}, st[3] = {row, H * row, L * H * row};
    const uint32_t bx[4] = {64, 1, 64, 1};
    for (int i = 0; i < 4; ++i) qd[i] = d[i], qb[i] = bx[i];
    for (int i = 0; i < 3; ++i) qs[i] = st[i];
  } else {
    const uint64_t d[4] = {D, L, H, static_cast<uint64_t>(B)}, st[3] = {row, L * row, H * L * row};
    const uint32_t bx[4] = {64, 64, 1, 1};
    for (int i = 0; i < 4; ++i) qd[i] = d[i], qb[i] = bx[i];
    for (int i = 0; i < 3; ++i) qs[i] = st[i];
  }
  const uint64_t kd[3] = {D, static_cast<uint64_t>(a.S), static_cast<uint64_t>(B) * a.KV};
  const uint64_t ks[2] = {row, a.S * row};
  const uint32_t kb[3] = {64, Smem<D>::kBK, 1};
  CUtensorMap mq, mk, mv, mo;
  if (!make_map_bf16_nd(&mq, q, 4, qd, qs, qb) || !make_map_bf16_nd(&mo, out, 4, qd, qs, qb) ||
      !make_map_bf16_nd(&mk, k, 3, kd, ks, kb) || !make_map_bf16_nd(&mv, v, 3, kd, ks, kb))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_wgmma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((a.L + kBQ - 1) / kBQ) * B * a.H);
  kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(mq, mk, mv, mo, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: plain FMAs, one thread per head-dim column ----------------------
// queries per block: 16, but 24 at D 192 (a multiple of its 6 warps) and 8 at
// D 256 (the staged tiles stay in the 48 KB of static shared memory)
template <int D>
struct F32Tile {
  static constexpr int kQ = D == 192 ? 24 : D == 256 ? 8 : 16;
};
constexpr int FK = 32;  // keys per staged tile (one per lane in the softmax)

// q and out element (b, h, l, d) at b * sb + h * sh + l * sl + d
struct Strides {
  long long sb, sh, sl;
};

template <int D>
__global__ void __launch_bounds__(D)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int KV, int L, int S, int causal, float sm_scale, Strides qs) {
  constexpr int FQ = F32Tile<D>::kQ, LD = D + 1, NW = D / 32, RW = FQ / NW;  // rows per warp
  static_assert(FQ % NW == 0, "whole rows per warp");
  __shared__ float sq[FQ * LD];
  __shared__ float skv[FK * LD];
  __shared__ float sp[FQ][FK];  // scores, then probabilities
  __shared__ float s_alpha[FQ];
  __shared__ float s_l[FQ];

  const int nq = (L + FQ - 1) / FQ;  // B x H folded into grid.x, as the bf16 kernel's
  const int q0 = (blockIdx.x % nq) * FQ, bh = blockIdx.x / nq;
  const int b = bh / H, h = bh % H;
  const size_t kv_row = static_cast<size_t>(b) * KV + h / (H / KV);
  const size_t qoff = static_cast<size_t>(b) * qs.sb + static_cast<size_t>(h) * qs.sh;
  const float* qb = q + qoff;
  const float* kb = k + kv_row * S * D;
  const float* vb = v + kv_row * S * D;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int offs = S - L;

  for (int r = 0; r < FQ; ++r)
    sq[r * LD + t] = q0 + r < L ? qb[static_cast<size_t>(q0 + r) * qs.sl + t] : 0.f;
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
      out[qoff + static_cast<size_t>(q0 + r) * qs.sl + t] =
          __fdiv_rn(acc[r], fmaxf(s_l[r], 1e-30f));
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
               int L, int S, int causal, float sm_scale, Strides qs, cudaStream_t stream) {
  const dim3 grid(((L + F32Tile<D>::kQ - 1) / F32Tile<D>::kQ) * B * H);
  flash_f32_kernel<D><<<grid, D, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, KV, L, S, causal, sm_scale, qs);
  return static_cast<int>(cudaGetLastError());
}

// ---- wide heads (D 320, 384, 448, 512): column passes ----------------------
// Past wgmma's N of 256 and the f32 kernel's one-thread-a-column block, both
// dtypes take one simple kernel: a block holds WQ query rows of one (batch,
// head) and one pass of at most WT output columns (grid.y = the passes, 2 at
// every wide D). Each pass recomputes the full-D scores of its rows: K tiles
// of WK keys staged in f32, one (row, key) dot a thread, the online softmax a
// warp a row (lane = key), then the pass's columns of the V tile and the
// f32 accumulators, a column a thread. bf16 rounds p to bf16 before the PV
// product, as the other kernels do (l sums the f32 p); f32 is exact FMAs.
constexpr int WQ = 8, WK = 32, WT = 256;
static_assert(WQ * WK == WT, "one (row, key) score a thread");
static_assert(WT / 32 == WQ, "one warp a query row");

template <typename T>
__device__ __forceinline__ float wide_load(T x) {
  if constexpr (std::is_same_v<T, float>) return x;
  else return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T wide_store(float x) {
  if constexpr (std::is_same_v<T, float>) return x;
  else return __float2bfloat16_rn(x);
}

template <int D>
struct WideSmem {  // floats: q rows, the K tile (padded rows) or the V pass, p, alpha, l
  static constexpr int kFloats = WQ * D + WK * (D + 1) + WQ * WK + 2 * WQ;
  static constexpr int kBytes = kFloats * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(WT)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int H, int KV, int L, int S, int causal,
                  float sm_scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sq = smem;                 // [WQ][D]
  float* skv = sq + WQ * D;         // [WK][LD] keys, then [WK][WT] the pass's values
  float* sp = skv + WK * LD;        // [WQ][WK] scores, then probabilities
  float* s_alpha = sp + WQ * WK;    // [WQ]
  float* s_l = s_alpha + WQ;        // [WQ]

  const int nq = (L + WQ - 1) / WQ;
  const int q0 = (blockIdx.x % nq) * WQ, bh = blockIdx.x / nq;
  const int b = bh / H, h = bh % H;
  const size_t kv_row = static_cast<size_t>(b) * KV + h / (H / KV);
  const T* qb = q + static_cast<size_t>(bh) * L * D;
  const T* kb = k + kv_row * S * D;
  const T* vb = v + kv_row * S * D;
  T* ob = out + static_cast<size_t>(bh) * L * D;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int col = blockIdx.y * WT + t;  // this thread's output column
  const bool has_col = col < D;
  const int offs = S - L;

  for (int i = t; i < WQ * D; i += WT) {
    const int r = i / D;
    sq[i] = q0 + r < L ? wide_load(qb[static_cast<size_t>(q0) * D + i]) : 0.f;
  }
  const int kend = causal ? min(S, q0 + WQ + offs) : S;
  const int ntiles = kend > 0 ? (kend + WK - 1) / WK : 0;

  float m = kNegInf, l = 0.f;  // row `warp`'s statistics, the same in every lane
  float acc[WQ];
#pragma unroll
  for (int r = 0; r < WQ; ++r) acc[r] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int j0 = tile * WK;
    __syncthreads();  // the previous tile's values and probabilities are read
    for (int i = t; i < WK * D; i += WT) {
      const int j = i / D, e = i - j * D;
      skv[j * LD + e] = j0 + j < S ? wide_load(kb[static_cast<size_t>(j0) * D + i]) : 0.f;
    }
    __syncthreads();
    {
      const int r = t / WK, j = t % WK;
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(sq[r * D + e], skv[j * LD + e], dot);
      sp[r * WK + j] = dot * sm_scale;
    }
    __syncthreads();
    {
      const int row = q0 + warp, c = j0 + lane;
      float val = sp[warp * WK + lane];
      if (c >= S || (causal && c > row + offs)) val = kNegInf;
      float mc = val;
      for (int o = 16; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      const float p = expf(val - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l = alpha * l + sum;
      m = m_new;
      sp[warp * WK + lane] = wide_load(wide_store<T>(p));  // p at v's dtype
      if (lane == 0) s_alpha[warp] = alpha;
    }
    __syncthreads();  // the keys are read: the pass's values take their place
    if (has_col)
      for (int j = 0; j < WK; ++j)
        skv[j * WT + t] = j0 + j < S ? wide_load(vb[static_cast<size_t>(j0 + j) * D + col]) : 0.f;
    __syncthreads();
    if (has_col) {
#pragma unroll
      for (int r = 0; r < WQ; ++r) {
        float a = acc[r] * s_alpha[r];
        for (int j = 0; j < WK; ++j) a = fmaf(sp[r * WK + j], skv[j * WT + t], a);
        acc[r] = a;
      }
    }
  }
  if (lane == 0) s_l[warp] = l;
  __syncthreads();
  if (has_col) {
#pragma unroll
    for (int r = 0; r < WQ; ++r)
      if (q0 + r < L)
        ob[static_cast<size_t>(q0 + r) * D + col] =
            wide_store<T>(__fdiv_rn(acc[r], fmaxf(s_l[r], 1e-30f)));
  }
}

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
                int L, int S, int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_wide_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WideSmem<D>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((L + WQ - 1) / WQ) * B * H, (D + WT - 1) / WT);
  kernel<<<grid, WT, WideSmem<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, L, S, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attend_wide(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
                int L, int S, int D, int causal, float sm_scale, cudaStream_t s) {
  if (D == 320) return launch_wide<T, 320>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  if (D == 384) return launch_wide<T, 384>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  if (D == 448) return launch_wide<T, 448>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  if (D == 512) return launch_wide<T, 512>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int attend(const void* q, const void* k, const void* v, void* out, const float* cosb,
           const float* sinb, int is_bf16, int causal, int lhd, int B, int H, int KV, int L,
           int S, int D, float sm_scale, cudaStream_t s) {
  if (static_cast<long long>(B) * H * ((L + 7) / 8) > 0x7fffffffLL || KV <= 0 || H % KV ||
      L <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 256) {  // the JAX interface only: the route's heads are 64 / 128
    if (cosb || lhd || static_cast<long long>(B) * H * ((L + WQ - 1) / WQ) > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16 ? attend_wide<bf16>(q, k, v, out, B, H, KV, L, S, D, causal, sm_scale, s)
                   : attend_wide<float>(q, k, v, out, B, H, KV, L, S, D, causal, sm_scale, s);
  }
  if (is_bf16) {
    const FlashArgs a{cosb, sinb, H, KV, L, S, causal, lhd, sm_scale * kLog2e};
    if (D == 128) return launch_wgmma<128>(q, k, v, out, a, B, s);
    if (D == 64) return launch_wgmma<64>(q, k, v, out, a, B, s);
    if (cosb) return static_cast<int>(cudaErrorInvalidValue);  // the route: D 64 / 128
    if (D == 192) return launch_wgmma<192>(q, k, v, out, a, B, s);
    if (D == 256) return launch_wgmma<256>(q, k, v, out, a, B, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long LD = static_cast<long long>(L) * D, HD = static_cast<long long>(H) * D;
  const Strides qs = lhd ? Strides{L * HD, D, HD} : Strides{H * LD, LD, D};
  if (D == 128) return launch_f32<128>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, qs, s);
  if (D == 64) return launch_f32<64>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, qs, s);
  if (D == 192) return launch_f32<192>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, qs, s);
  if (D == 256) return launch_f32<256>(q, k, v, out, B, H, KV, L, S, causal, sm_scale, qs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int launch_keys(const void* k, const void* v, const float* cosb, const float* sinb,
                const void* pk, const void* pv, void* kc, void* vc, int B, int L, int KV,
                int P, int PB, cudaStream_t s) {
  const long long n = static_cast<long long>(B) * KV * (P + L) * (D / 4);
  flash_keys_kernel<T, D><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), cosb, sinb,
      static_cast<const T*>(pk), static_cast<const T*>(pv), static_cast<T*>(kc),
      static_cast<T*>(vc), L, KV, P, PB, n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_rotate_q(const void* q, const float* cosb, const float* sinb, void* qr, int B,
                    int L, int H, cudaStream_t s) {
  const long long n = static_cast<long long>(B) * L * H * (D / 4);
  rotate_rows_f32_kernel<D><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(q), cosb, sinb, static_cast<float*>(qr), L, H, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, L, D] (rotated), k/v [B, KV, S, D] -> out [B, H, L, D]
extern "C" int mt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int is_bf16, int causal, int B, int H, int KV, int L, int S,
                                  int D, float sm_scale, void* stream) {
  return attend(q, k, v, out, nullptr, nullptr, is_bf16, causal, 0, B, H, KV, L, S, D,
                sm_scale, static_cast<cudaStream_t>(stream));
}

// the pre-pass: k/v [B, L, KV, D] (k before rotary), cos/sin [L, D/2] f32,
// the rotated prefix pk/pv [PB, KV, P, D] (null when P is 0) -> kc/vc
// [B, KV, P + L, D]
extern "C" int mt_flash_keys(const void* k, const void* v, const void* cosb, const void* sinb,
                             const void* pk, const void* pv, void* kc, void* vc, int is_bf16,
                             int B, int L, int KV, int D, int P, int PB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cosb);
  const auto* sn = static_cast<const float*>(sinb);
  if (L <= 0 || (P > 0 && (!pk || !pv))) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && D == 128)
    return launch_keys<bf16, 128>(k, v, c, sn, pk, pv, kc, vc, B, L, KV, P, PB, s);
  if (is_bf16 && D == 64)
    return launch_keys<bf16, 64>(k, v, c, sn, pk, pv, kc, vc, B, L, KV, P, PB, s);
  if (!is_bf16 && D == 128)
    return launch_keys<float, 128>(k, v, c, sn, pk, pv, kc, vc, B, L, KV, P, PB, s);
  if (!is_bf16 && D == 64)
    return launch_keys<float, 64>(k, v, c, sn, pk, pv, kc, vc, B, L, KV, P, PB, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the long-window route: q [B, L, H, D] before rotary, cos/sin [L, D/2] f32,
// kc/vc [B, KV, S, D] from mt_flash_keys -> out [B, L, H, D], end-aligned
// causal. q_rot: scratch like q for the f32 form's rotated q (null for bf16,
// which rotates q inside the kernel).
extern "C" int mt_rope_flash_attention(const void* q, const void* kc, const void* vc,
                                       const void* cosb, const void* sinb, void* out,
                                       void* q_rot, int is_bf16, int B, int L, int H, int KV,
                                       int D, int S, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cosb);
  const auto* sn = static_cast<const float*>(sinb);
  if (is_bf16) return attend(q, kc, vc, out, c, sn, 1, 1, 1, B, H, KV, L, S, D, sm_scale, s);
  if (!q_rot || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = D == 128 ? launch_rotate_q<128>(q, c, sn, q_rot, B, L, H, s)
                           : launch_rotate_q<64>(q, c, sn, q_rot, B, L, H, s);
  if (err) return err;
  return attend(q_rot, kc, vc, out, nullptr, nullptr, 0, 1, 1, B, H, KV, L, S, D, sm_scale, s);
}
