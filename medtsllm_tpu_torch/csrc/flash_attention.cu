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
// Every head dim D % 64 == 0 runs on the card, as JAX's dispatcher sends
// every such D to its kernel:
//   - bf16 D 192 and 256 (the ln family's wide heads, e.g. pythia-1b's 256)
//     take the same bf16 design with 64-key tiles (m64n64k16 for S,
//     m64n{D}k16 for PV): a consumer thread then holds D / 2 accumulators,
//     32 scores and 16 words of P, 176 registers at D 256, inside
//     setmaxnreg's 240; two stages fit beside q;
//   - bf16 D >= 320 (past wgmma's N of 256 and a resident q) take
//     flash_wide_kernel: q and K streamed as 64-column boxes, S accumulated
//     over D / 64 k-steps on the tensor cores, PV in output-column passes of
//     at most 256 (its note below);
//   - f32, every D, takes flash_f32_kernel: K3's register micro-tiles on
//     exact FMAs (no TF32), for f32 parity with the CPU (its note below); on
//     the fused entry a first kernel rotates q for it (torch's f32
//     rounding).
// The fused entry (RoPE in the kernel) stays at D 64 / 128, the route's head
// dims.

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

// q / out [B, L, H, D] (lhd) or [B, H, L, D] as a 4-D map of 64-row boxes
// 128 bytes wide (64 bf16 or 32 f32 columns)
bool make_q_map(CUtensorMap* map, const void* p, int lhd, int B, int H, int L, int D, bool f32) {
  const uint64_t row = static_cast<uint64_t>(D) * (f32 ? 4 : 2);  // bytes
  const uint64_t h = H, l = L, b = B, d = D;
  const uint32_t w = f32 ? 32 : 64;
  const uint64_t dims_l[4] = {d, h, l, b}, st_l[3] = {row, h * row, l * h * row};
  const uint64_t dims_h[4] = {d, l, h, b}, st_h[3] = {row, l * row, h * l * row};
  const uint32_t box_l[4] = {w, 1, 64, 1}, box_h[4] = {w, 64, 1, 1};
  return make_map_nd(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     p, 4, lhd ? dims_l : dims_h, lhd ? st_l : st_h, lhd ? box_l : box_h);
}

// k / v [B * KV, S, D] as a 3-D map of `keys`-row boxes 128 bytes wide
bool make_kv_map(CUtensorMap* map, const void* p, int rows, int S, int D, int keys, bool f32) {
  const uint64_t row = static_cast<uint64_t>(D) * (f32 ? 4 : 2);
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(rows)};
  const uint64_t st[2] = {row, static_cast<uint64_t>(S) * row};
  const uint32_t box[3] = {f32 ? 32u : 64u, static_cast<uint32_t>(keys), 1};
  return make_map_nd(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     p, 3, dims, st, box);
}

// q / out as 64-row, 64-column boxes of a 4-D map over [B, L, H, D] (lhd)
// or [B, H, L, D]; k / v as kBK-key boxes of a 3-D map over [B * KV, S, D]
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const FlashArgs& a,
                 int B, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!make_q_map(&mq, q, a.lhd, B, a.H, a.L, D, false) ||
      !make_q_map(&mo, out, a.lhd, B, a.H, a.L, D, false) ||
      !make_kv_map(&mk, k, B * a.KV, a.S, D, Smem<D>::kBK, false) ||
      !make_kv_map(&mv, v, B * a.KV, a.S, D, Smem<D>::kBK, false))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_wgmma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((a.L + kBQ - 1) / kBQ) * B * a.H);
  kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(mq, mk, mv, mo, a);
  return static_cast<int>(cudaGetLastError());
}

// output columns a block computes past D 256 (both dtypes): the fewest passes
// of at most 256 columns, as even as 64-column chunks allow (192 or 256)
int pass_width(int D) {
  if (D <= 256) return D;
  const int chunks = D / 64, passes = (chunks + 3) / 4;
  return 64 * ((chunks + passes - 1) / passes);
}

// ---- bf16, D >= 320: wgmma over streamed 64-column boxes -------------------
// Replaces the bf16 side of _flash_kernel past D 256. What bounds it: at D
// 512 (B 8, H 8, L 512, S 768, causal) a call is ~34 GFLOP of bf16 products
// against ~168 MB, ~205 operations a byte, just under the bf16 ridge (~295):
// bytes, but only the tensor cores keep the products under that bound
// (scalar f32 FMAs alone would take ~0.5 ms). The design, on the D <= 256
// kernel's machinery (one producer warpgroup, two consumer warpgroups of 64
// query rows, 64-key tiles, the same softmax and rounding):
//   - no D has to fit shared memory whole: the producer streams each key
//     tile's q and K as 64-column chunks (the two consumers' q boxes and the
//     K box, 24 KB) through a 4-stage mbarrier ring, and S = Q K^T
//     accumulates over the D / 64 chunks on wgmma m64n64k16 (each chunk's
//     group committed, its stage released once the next chunk's products
//     are issued and it is done);
//   - PV on wgmma m64n{PW}k16 over one pass of PW <= 256 output columns
//     (pass_width: 192 at D 320 / 384 / 576, else 256), V's pass slice
//     double-buffered by TMA, so a consumer thread holds PW / 2 <= 128
//     accumulators, 32 scores and 16 words of P, inside setmaxnreg's 240;
//   - the passes are blocks of their own (grid.y): the accumulators of every
//     pass of a 64-row tile do not fit one block's registers, so each pass
//     recomputes S on the tensor cores: D / PW passes do D / PW times the QK^T
//     products and re-read q and K that often (1.5x the minimal products at
//     D 512, 2x its q and K bytes, from L2); q itself is re-read per key tile
//     rather than held (128 rows x D at D 1024 would be 256 KB);
//   - the output is written from the accumulators (bf16 pairs), rows past L
//     and columns past D skipped; V columns past D (a last pass narrower
//     than PW) arrive as TMA's zeros.
constexpr int kWStages = 4;

template <int PW>
struct WideSmem {
  static_assert(PW == 192 || PW == 256, "pass width");
  static constexpr int kBox = 64 * kSwizzleBytes;       // 64 rows x 64 columns, 8 KB
  static constexpr int kStageBytes = 3 * kBox;          // q box of each consumer | K box
  static constexpr int kRingBytes = kWStages * kStageBytes;
  static constexpr int kVBytes = PW / 64 * kBox;        // one pass's V slice of a key tile
  // + full / empty per stage, v_full / v_empty per slice; + slack to align to
  // the 1024-byte swizzle atom
  static constexpr int kBytes = kRingBytes + 2 * kVBytes + (2 * kWStages + 4) * 8 + 1024;
};

struct WideArgs {
  int H, KV, L, S, D, causal;
  float scale_log2;  // sm_scale * log2(e)
};

template <int PW>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                  const WideArgs a) {
  using C = WideSmem<PW>;
  constexpr int kBox = C::kBox, kBK = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* svb = ring + C::kRingBytes;  // two V slices
  uint64_t* full = reinterpret_cast<uint64_t*>(svb + 2 * C::kVBytes);
  uint64_t* empty = full + kWStages;
  uint64_t* v_full = empty + kWStages;
  uint64_t* v_empty = v_full + 2;

  const int nqt = (a.L + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nqt, qt = nqt - 1 - blockIdx.x % nqt;
  const int b = bh / a.H, h = bh % a.H;
  const int kv_row = b * a.KV + h / (a.H / a.KV);
  const int q0 = qt * kBQ, offs = a.S - a.L;
  const int kend = a.causal ? min(a.S, q0 + kBQ + offs) : a.S;
  const int ntiles = (kend + kBK - 1) / kBK;
  const int nc = a.D / 64, col0 = blockIdx.y * PW;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int t = 0, s = 0, ph = 0; t < ntiles; ++t) {
        for (int c = 0; c < nc; ++c) {
          mbar_wait(&empty[s], ph ^ 1);  // passes at once on the first lap
          unsigned char* st = ring + s * C::kStageBytes;
          mbar_expect_tx(&full[s], C::kStageBytes);
          load_q(st, &map_q, 64 * c, q0, h, b, 0, &full[s]);
          load_q(st + kBox, &map_q, 64 * c, q0 + 64, h, b, 0, &full[s]);
          tma_load_3d(st + 2 * kBox, &map_k, 64 * c, t * kBK, kv_row, &full[s]);
          if (++s == kWStages) s = 0, ph ^= 1;
        }
        const int vs = t & 1;
        mbar_wait(&v_empty[vs], ((t >> 1) & 1) ^ 1);
        mbar_expect_tx(&v_full[vs], C::kVBytes);
        for (int n = 0; n < PW / 64; ++n)
          tma_load_3d(svb + vs * C::kVBytes + n * kBox, &map_v, col0 + 64 * n, t * kBK, kv_row,
                      &v_full[vs]);
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1, t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r_first = q0 + c * 64;
  const int row0 = r_first + w * 16 + g;  // this thread's rows: row0, row0 + 8
  const bool idle = r_first >= a.L;       // still releases every stage

  float o[PW / 2];
#pragma unroll
  for (int i = 0; i < PW / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  for (int tile = 0, s = 0, ph = 0; tile < ntiles; ++tile) {
    const int j0 = tile * kBK, vs = tile & 1, vph = (tile >> 1) & 1;
    if (idle || (a.causal && j0 > r_first + 63 + offs)) {
      for (int cc = 0; cc < nc; ++cc) {
        mbar_wait(&full[s], ph);
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == kWStages) s = 0, ph ^= 1;
      }
      mbar_wait(&v_full[vs], vph);
      if (lane == 0) mbar_arrive(&v_empty[vs]);
      continue;
    }
    float sc[kBK / 2];
    int prev = s;
    for (int cc = 0; cc < nc; ++cc) {
      mbar_wait(&full[s], ph);
      const unsigned char* st = ring + s * C::kStageBytes;
      const uint64_t dq = smem_desc(st + c * kBox), dk = smem_desc(st + 2 * kBox);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_qk(sc, dq + 2 * kk, dk + 2 * kk, cc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: its stage is free
      if (cc > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kWStages) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    reg_fence(sc);
    if (lane == 0) mbar_arrive(&empty[prev]);
    // the D <= 256 kernel's softmax at 64-key tiles
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
    for (int j = 0; j < PW / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    mbar_wait(&v_full[vs], vph);
    const unsigned char* sv = svb + vs * C::kVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv(o, pa[kk], smem_desc_mn(sv + kk * 16 * kSwizzleBytes, kBox));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(&v_empty[vs]);
  }
  if (idle) return;

  // out = acc / max(l, 1e-30), rounded once, in bf16 pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
  }
  bf16* ob = out + static_cast<size_t>(bh) * a.L * a.D;
#pragma unroll
  for (int j = 0; j < PW / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
    if (col >= a.D) continue;
    if (row0 < a.L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row0) * a.D + col) =
          pack_bf16(__fdiv_rn(o[4 * j], l_r[0]), __fdiv_rn(o[4 * j + 1], l_r[0]));
    if (row0 + 8 < a.L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row0 + 8) * a.D + col) =
          pack_bf16(__fdiv_rn(o[4 * j + 2], l_r[1]), __fdiv_rn(o[4 * j + 3], l_r[1]));
  }
}

template <int PW>
int launch_wide(const void* q, const void* k, const void* v, void* out, const WideArgs& a, int B,
                cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_q_map(&mq, q, 0, B, a.H, a.L, a.D, false) ||
      !make_kv_map(&mk, k, B * a.KV, a.S, a.D, 64, false) ||
      !make_kv_map(&mv, v, B * a.KV, a.S, a.D, 64, false))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_wide_kernel<PW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WideSmem<PW>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((a.L + kBQ - 1) / kBQ) * B * a.H, (a.D + PW - 1) / PW);
  kernel<<<grid, kThreads, WideSmem<PW>::kBytes, stream>>>(mq, mk, mv, static_cast<bf16*>(out),
                                                           a);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32, every D: register micro-tiles (K3's design) ----------------------
// Replaces the f32 side of _flash_kernel. What bounds it: at gpt2's shape (B
// 16, H 12, L = S 512, D 64, causal) a call does 4 B H D x pairs = 6.45 GFLOP
// against ~101 MB of q, k, v and output, ~64 operations a byte against the
// f32 ridge of ~20: the FP32 units (no TF32: f32 parity with the CPU). The
// design is K3's (csrc/reprogramming.cu), which moved that kernel from
// shared-memory reads to the FMAs:
//   - one block per 64 query rows of one (batch, head), the longest causal
//     rows first; row groups of 16 threads, thread (ty, tx) owning RM rows
//     (ty + NTY i, NTY = 64 / RM, so the two row groups of a warp read
//     adjacent rows) and the keys tx + 16 j of a 64-key tile: K3's 16 x 16
//     threads with 4 x 4 scores (RM 4) for every D but 64, where 8 x 16
//     threads with 8 x 4 scores (RM 8, three blocks an SM) timed 8-9%
//     faster on an H100 (0.278-0.284 against 0.307 ms at gpt2's shape, in
//     turns in one call). Timed there and not kept: two blocks an SM at RM 8
//     (0.302-0.306 ms: no spills, fewer warps), the 8-step slice loop
//     unrolled by 4 (0.296-0.301), 128-row blocks of 8 x 4 or 8 x 8 scores
//     (0.356-0.365: a quarter of the diagonal tiles' pairs masked, and 8 x 8
//     spills). Per 4-column slice a thread reads RM q and 4 K float4s for
//     16 RM FMAs, q as broadcasts, K rows in the 128-byte swizzle (16-byte
//     chunk c of row r at c ^ (r & 7), K3's XOR layout, here TMA's own), so
//     the 8 keys of a quarter-warp hit distinct banks;
//   - the online softmax across the 16 threads of a row group (the max by
//     four xor shuffles; each thread's share of l, reduced once at the
//     end); p through shared memory (16-byte chunks XOR-swizzled by row
//     group), read back as broadcast float4s, as the A operand of PV into
//     an RM-row x (PW / 16)-column accumulator;
//   - q, K and V arrive by TMA (one thread issues, mbarriers complete), one
//     buffer each, staggered: V(t) lands while QK^T(t) runs and K(t + 1)
//     while the softmax and PV(t) run, so every tile's copy overlaps the
//     FMAs with one buffer per operand; rows past L and keys past S arrive
//     as zeros;
//   - D <= 256: q stays resident (64 rows x D; with K, V and p 64 KB at D
//     64, 208 KB at D 256, one block an SM past D 64); past 256, q and K
//     stream as 64-column chunks through a 2-stage ring each key tile (q
//     re-read from L2 per tile; 64 x D floats at D 1024 would be 256 KB),
//     and the output columns split into passes of PW <= 256 (pass_width,
//     grid.y): PW / 16 x 4 accumulators a thread (64 at PW 256) is the
//     register budget, and each pass recomputes the scores (1.5x the
//     minimal FMAs at D 512);
//   - the end-aligned causal mask (query i sees keys <= i + S - L), key tiles
//     wholly above it skipped; GQA as b * KV + h / (H / KV); q and out in
//     [B, H, L, D] or the route's [B, L, H, D].
// Held back (H100 runs): a thread's float4 feeds only 4 (K) or RM (q) x 4
// FMAs, and with the softmax's expf and the staggered barriers the FMA
// pipes stay ~35% busy: gpt2's shape and D 192 / 256 at ~2.9x their
// bounds; past 256 the passes' recomputed scores add to that (D 512 4.3x,
// D 1024 6.9x).
// Exact: expf, plain FMAs, masked scores -1e30 (as JAX's), out = acc /
// max(l, 1e-30) by __fdiv_rn; only the summation order differs from the
// plain version.
constexpr int FQ = 64;                       // query rows a block
constexpr int FK = 64;                       // keys a tile
constexpr int kFBox = 64 * kSwizzleBytes;    // one [64 rows][32 floats] TMA box, 8 KB

// The block's shape: 64 query rows as NTY = 64 / RM row groups of TR
// threads; thread (ty, tx) owns the RM rows ty + NTY i (i < RM) and the 64 /
// TR keys tx + TR j of a tile. TR is 16 in every instance; as a parameter
// the kernels timed 3-5% faster on an H100 than with 16 written in (the
// same arithmetic, in turns in one call)
template <int RM, int TR>
struct F32Tile {
  static constexpr int kGroups = FQ / RM;          // row groups (NTY)
  static constexpr int kThreads = kGroups * TR;
  static constexpr int kKeys = FK / TR;            // keys a thread
  static constexpr int kTyWarp = 32 / TR;          // row groups a warp
  static_assert(kGroups % 8 == 0 && TR % 8 == 0, "row & 7 = ty & 7, key & 7 = tx & 7");
};

// q and out element (b, h, l, d) at b * sb + h * sh + l * sl + d
struct Strides {
  long long sb, sh, sl;
};

struct F32Args {
  int H, KV, L, S, D, causal, lhd;
  float sm_scale;
  Strides os;  // out's strides (q's layout)
};

// QRES (D = PW <= 256): q [D / 32 boxes], the K tile, the V tile, p
// [64][64]; else a 2-stage ring of [q chunk | K chunk] (2 + 2 boxes), the
// pass's V tile, p
template <int PW, bool QRES>
struct F32Smem {
  static constexpr int kBoxes = PW / 32;
  static constexpr int kQBytes = QRES ? kBoxes * kFBox : 0;
  static constexpr int kStages = QRES ? 1 : 2;
  static constexpr int kStageBytes = QRES ? kBoxes * kFBox : 4 * kFBox;
  static constexpr int kVBytes = kBoxes * kFBox;
  static constexpr int kPBytes = FQ * FK * 4;
  // + q_full, v_full and full per stage; + slack to align to the swizzle atom
  static constexpr int kBytes =
      kQBytes + kStages * kStageBytes + kVBytes + kPBytes + (2 + kStages) * 8 + 1024;
};

// s[i][j] += q[ty + NTY i] . k[tx + 16 j] over nbox boxes of 32 columns. In
// the 128-byte swizzle chunk c of row r sits at c ^ (r & 7): for q rows that
// is c ^ (ty & 7) and for keys c ^ (tx & 7), whatever i and j (NTY is 8 or
// 16), so each load is a per-c base plus an immediate (rows NTY i and keys
// 16 j apart); the two row groups of a warp read adjacent rows, distinct
// chunks
template <int RM, int TR>
__device__ __forceinline__ void qk_f32(float (&s)[RM][FK / TR], const unsigned char* qb,
                                       const unsigned char* kb, int nbox, int ty, int tx) {
  using T = F32Tile<RM, TR>;
  constexpr int KN = T::kKeys;
  const unsigned char* qr = qb + 128 * ty;
  const unsigned char* kr = kb + 128 * tx;
  const int qx = ty & 7, kx = tx & 7;
#pragma unroll 1
  for (int bx = 0; bx < nbox; ++bx, qr += kFBox, kr += kFBox) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned char* qc = qr + 16 * (c ^ qx);
      const unsigned char* kc = kr + 16 * (c ^ kx);
      float4 qa[RM], kv[KN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qc + 128 * T::kGroups * i);
#pragma unroll
      for (int j = 0; j < KN; ++j) kv[j] = *reinterpret_cast<const float4*>(kc + 128 * TR * j);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
        }
    }
  }
}

// chunk g of the streamed form: q and K columns [64 c, 64 c + 64) of key
// tile g / nc (c = g % nc) into stage g & 1 of the ring
__device__ __forceinline__ void f32_chunk(unsigned char* ring, uint64_t* full,
                                          const CUtensorMap* map_q, const CUtensorMap* map_k,
                                          int g, int nc, int q0, int h, int b, int lhd,
                                          int kv_row) {
  const int tile = g / nc, c = g % nc, s = g & 1;
  unsigned char* st = ring + s * 4 * kFBox;
  mbar_expect_tx(&full[s], 4 * kFBox);
  for (int hf = 0; hf < 2; ++hf) {
    load_q(st + hf * kFBox, map_q, 64 * c + 32 * hf, q0, h, b, lhd, &full[s]);
    tma_load_3d(st + (2 + hf) * kFBox, map_k, 64 * c + 32 * hf, tile * FK, kv_row, &full[s]);
  }
}

template <int PW, bool QRES, int RM, int TR>
__global__ void __launch_bounds__(F32Tile<RM, TR>::kThreads, RM == 8 ? 3 : 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, float* __restrict__ out,
                 const F32Args a) {
  using C = F32Smem<PW, QRES>;
  using T = F32Tile<RM, TR>;
  constexpr int KN = T::kKeys, NTY = T::kGroups;
  constexpr int NB = C::kBoxes, NC = PW / TR;  // V boxes; output columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = sq + C::kQBytes;
  unsigned char* sv = ring + C::kStages * C::kStageBytes;
  float* sp = reinterpret_cast<float*>(sv + C::kVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sp + FQ * FK);
  uint64_t* v_full = q_full + 1;
  uint64_t* full = v_full + 1;

  const int nqt = (a.L + FQ - 1) / FQ;  // B x H folded into grid.x, as the bf16 kernels'
  const int bh = blockIdx.x / nqt, qt = nqt - 1 - blockIdx.x % nqt;
  const int b = bh / a.H, h = bh % a.H;
  const int kv_row = b * a.KV + h / (a.H / a.KV);
  const int q0 = qt * FQ, offs = a.S - a.L;
  const int kend = a.causal ? min(a.S, q0 + FQ + offs) : a.S;
  const int ntiles = (kend + FK - 1) / FK;
  const int col0 = blockIdx.y * PW;
  const int nc = QRES ? 1 : a.D / 64;  // score chunks a tile
  const int nchunks = ntiles * nc;
  const int t = threadIdx.x, ty = t / TR, tx = t % TR;

  if (t == 0) {
    mbar_init(q_full, 1);
    mbar_init(v_full, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    if constexpr (QRES) {
      mbar_expect_tx(q_full, NB * kFBox);
      mbar_expect_tx(&full[0], NB * kFBox);
      for (int bx = 0; bx < NB; ++bx) {
        load_q(sq + bx * kFBox, &map_q, 32 * bx, q0, h, b, a.lhd, q_full);
        tma_load_3d(ring + bx * kFBox, &map_k, 32 * bx, 0, kv_row, &full[0]);
      }
    } else {
      for (int g = 0; g < 2 && g < nchunks; ++g)
        f32_chunk(ring, full, &map_q, &map_k, g, nc, q0, h, b, a.lhd, kv_row);
    }
  }
  __syncthreads();

  // p row r holds key k at 4 (k / 4 ^ psw) + k % 4, psw = 4 (ty & 1): the
  // two row groups of a warp (rows 1 apart, 256 bytes a row) read and write
  // 16 banks apart
  float* sp_row = sp + ty * FK;
  const int psw = (ty % T::kTyWarp) * (8 / T::kTyWarp);
  // V: columns 4 tx .. of key j8 + m at vt + 128 (j8 + m) + voff[m] (box
  // tx / 8, its chunk tx % 8 swizzled by the key's row), + 2 boxes per 64
  // columns
  const unsigned char* vt = sv + (tx >> 3) * kFBox;
  int voff[8];
#pragma unroll
  for (int mm = 0; mm < 8; ++mm) voff[mm] = 16 * ((tx & 7) ^ mm);
  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }
  if constexpr (QRES) mbar_wait(q_full, 0);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int j0 = tile * FK;
    if (t == 0) {  // V's buffer was released by the last tile's closing barrier
      mbar_expect_tx(v_full, NB * kFBox);
      for (int bx = 0; bx < NB; ++bx)
        tma_load_3d(sv + bx * kFBox, &map_v, col0 + 32 * bx, j0, kv_row, v_full);
    }
    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
    if constexpr (QRES) {
      mbar_wait(&full[0], tile & 1);
      qk_f32<RM, TR>(s, sq, ring, NB, ty, tx);
      __syncthreads();  // the K tile is read: the next one may land
      if (t == 0 && tile + 1 < ntiles) {
        mbar_expect_tx(&full[0], NB * kFBox);
        for (int bx = 0; bx < NB; ++bx)
          tma_load_3d(ring + bx * kFBox, &map_k, 32 * bx, j0 + FK, kv_row, &full[0]);
      }
    } else {
      for (int c = 0; c < nc; ++c) {
        const int g = tile * nc + c, st = g & 1;
        mbar_wait(&full[st], (g >> 1) & 1);
        const unsigned char* p = ring + st * C::kStageBytes;
        qk_f32<RM, TR>(s, p, p + 2 * kFBox, 2, ty, tx);
        __syncthreads();  // the stage is read
        if (t == 0 && g + 2 < nchunks)
          f32_chunk(ring, full, &map_q, &map_k, g + 2, nc, q0, h, b, a.lhd, kv_row);
      }
    }

    // online softmax over the 16 threads of a row group; a tile reaching
    // past S or the first row's diagonal has masked entries
    const bool edge = j0 + FK > a.S || (a.causal && j0 + FK - 1 > q0 + offs);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + NTY * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int col = j0 + tx + TR * j;
        float x = s[i][j] * a.sm_scale;
        if (edge && (col >= a.S || (a.causal && col > row + offs))) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = TR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = expf(s[i][j] - mx);
        const int key = tx + TR * j;
        sp_row[NTY * FK * i + 4 * ((key >> 2) ^ psw) + (key & 3)] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    mbar_wait(v_full, tile & 1);
    __syncwarp();  // a row's p is written and read by its own row group

    // keys j8 + m (m < 8): p read as broadcast float4s, V's row j8 + m
#pragma unroll 1
    for (int j8 = 0; j8 < FK; j8 += 8) {
      const unsigned char* vr8 = vt + 128 * j8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 p4[RM];
        const int pc = 4 * (((j8 >> 2) + half) ^ psw);
#pragma unroll
        for (int i = 0; i < RM; ++i)
          p4[i] = *reinterpret_cast<const float4*>(sp_row + NTY * FK * i + pc);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int mm = 4 * half + jj;
          const unsigned char* vk = vr8 + 128 * mm + voff[mm];
          float vr[NC];
#pragma unroll
          for (int n4 = 0; n4 < NC / 4; ++n4) {
            const float4 w = *reinterpret_cast<const float4*>(vk + (TR / 8) * kFBox * n4);
            vr[4 * n4] = w.x;
            vr[4 * n4 + 1] = w.y;
            vr[4 * n4 + 2] = w.z;
            vr[4 * n4 + 3] = w.w;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
            for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p, vr[n], acc[i][n]);
          }
        }
      }
    }
    __syncthreads();  // V and p are read: the next tile's V may land, p be rewritten
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int o = TR / 2; o > 0; o >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
    const int row = q0 + ty + NTY * i;
    if (row >= a.L) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = out + b * a.os.sb + h * a.os.sh + row * a.os.sl + col0;
#pragma unroll
    for (int n4 = 0; n4 < NC / 4; ++n4) {
      const int col = 4 * TR * n4 + 4 * tx;
      if (col0 + col >= a.D) continue;
      *reinterpret_cast<float4*>(orow + col) =
          make_float4(__fdiv_rn(acc[i][4 * n4], li), __fdiv_rn(acc[i][4 * n4 + 1], li),
                      __fdiv_rn(acc[i][4 * n4 + 2], li), __fdiv_rn(acc[i][4 * n4 + 3], li));
    }
  }
}

template <int PW, bool QRES, int RM = 4, int TR = 16>
int launch_f32(const void* q, const void* k, const void* v, void* out, const F32Args& a, int B,
               cudaStream_t stream) {
  using C = F32Smem<PW, QRES>;
  CUtensorMap mq, mk, mv;
  if (!make_q_map(&mq, q, a.lhd, B, a.H, a.L, a.D, true) ||
      !make_kv_map(&mk, k, B * a.KV, a.S, a.D, FK, true) ||
      !make_kv_map(&mv, v, B * a.KV, a.S, a.D, FK, true))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_f32_kernel<PW, QRES, RM, TR>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((a.L + FQ - 1) / FQ) * B * a.H, (a.D + PW - 1) / PW);
  kernel<<<grid, F32Tile<RM, TR>::kThreads, C::kBytes, stream>>>(mq, mk, mv,
                                                                 static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

int attend(const void* q, const void* k, const void* v, void* out, const float* cosb,
           const float* sinb, int is_bf16, int causal, int lhd, int B, int H, int KV, int L,
           int S, int D, float sm_scale, cudaStream_t s) {
  if (static_cast<long long>(B) * H * ((L + FQ - 1) / FQ) > 0x7fffffffLL || KV <= 0 ||
      H % KV || L <= 0 || S <= 0 || D < 64 || D % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pw = pass_width(D);
  if (is_bf16) {
    const FlashArgs a{cosb, sinb, H, KV, L, S, causal, lhd, sm_scale * kLog2e};
    if (D == 128) return launch_wgmma<128>(q, k, v, out, a, B, s);
    if (D == 64) return launch_wgmma<64>(q, k, v, out, a, B, s);
    if (cosb) return static_cast<int>(cudaErrorInvalidValue);  // the route: D 64 / 128
    if (D == 192) return launch_wgmma<192>(q, k, v, out, a, B, s);
    if (D == 256) return launch_wgmma<256>(q, k, v, out, a, B, s);
    if (lhd) return static_cast<int>(cudaErrorInvalidValue);  // the JAX interface only
    const WideArgs w{H, KV, L, S, D, causal, sm_scale * kLog2e};
    return pw == 192 ? launch_wide<192>(q, k, v, out, w, B, s)
                     : launch_wide<256>(q, k, v, out, w, B, s);
  }
  if (cosb) return static_cast<int>(cudaErrorInvalidValue);  // f32 takes q rotated
  const long long LD = static_cast<long long>(L) * D, HD = static_cast<long long>(H) * D;
  const Strides os = lhd ? Strides{L * HD, D, HD} : Strides{H * LD, LD, D};
  const F32Args a{H, KV, L, S, D, causal, lhd, sm_scale, os};
  if (D == 64) return launch_f32<64, true, 8, 16>(q, k, v, out, a, B, s);
  if (D == 128) return launch_f32<128, true>(q, k, v, out, a, B, s);
  if (D == 192) return launch_f32<192, true>(q, k, v, out, a, B, s);
  if (D == 256) return launch_f32<256, true>(q, k, v, out, a, B, s);
  return pw == 192 ? launch_f32<192, false>(q, k, v, out, a, B, s)
                   : launch_f32<256, false>(q, k, v, out, a, B, s);
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
