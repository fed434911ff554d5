// K6: the grouped per-expert w8a8 / w4a8 matmul ("gmm") of the dropless MoE
// chain.
//
// Replaces medtsllm_tpu/ops/pallas/grouped_matmul.py::gmm (_make_kernel,
// w_bits = 8 and 4). Rows of xq [R_pad, K] int8 are packed per expert into
// block_m-aligned groups; visit v covers rows [v * block_m, (v + 1) * block_m)
// and multiplies them by expert visit_e[v]'s weight. Numerics follow the JAX
// kernel op for op (rounded f32 ops, never contracted into an FMA):
//   per-row scales:  y = (float(acc) * x_scale[r]) * w_scale[e][c]
//   chunked scales:  y = ((p_0 + p_1) + ...) * w_scale[e][c],
//                    p_kb = float(acc over K-chunk kb) * x_scale[kb][r]
//   fuse_silu:       t = (y_gate * sigmoid(y_gate)) * y_up,
//                    sigmoid(x) = 1 / (1 + expf(-x))
//   emit_quant:      per (row, block_n-wide N-tile): s = max(amax / 127,
//                    1e-10) (IEEE division), q = round_half_even(t / s)
//                    clipped to +-127 (equal to JAX's unclipped cast
//                    whenever t is finite)
// Invalid visits write zeros; their requantized rows get the 1e-10 scale.
// Integer sums are exact in any order, so every rounding above sees the
// same operands as the plain version's.
//
// What bounds it: at the moe-8x1b serving shape (R_pad 14,848 rows, 13,824
// routed; gate + up K 2048 -> N 2 x 5632, down K 5632 -> N 2048) the two
// calls do ~0.96 TOP per layer against ~0.2 GB: the int8 tensor cores
// (0.32 + 0.16 ms at peak). Only wgmma reaches their rate, so the design is
// K1's pipeline (w8a8.cu), made grouped:
//   - a block owns one 128-row tile of a visit x 128 output columns. One
//     producer thread (its warpgroup gives its registers away with
//     setmaxnreg) reads visit_e / visit_valid and keeps TMA loads in flight
//     into a ring of 192 KB of stages under full / empty mbarriers: per
//     128-byte k step, the visit's 128 x 128-byte activation box and a
//     128 x 128-byte box of each weight. An invalid visit loads nothing and
//     writes zeros.
//   - the TMA maps give the chunks their own dimension: xq is viewed as
//     [R_pad, KB, K / KB] and each weight as [E, N, KB, K / KB], so a box
//     never crosses a chunk's end (TMA's zero fill covers the chunk tail,
//     a ragged K and a ragged N, the expert being a dimension of its own)
//     and a chunk boundary always falls on a stage boundary.
//   - two consumer warpgroups of 64 rows each run, per 32-byte k step, one
//     wgmma m64n128k32 s8 per weight; the gate and up accumulators of one
//     (row, column) then sit in the same thread, so the SwiGLU is done in
//     registers. At a chunk's end a consumer waits for its wgmma group,
//     folds the chunk into the f32 running sum in the order above and
//     zeroes the accumulators.
//   - the epilogue rescales, stages the tile in the free ring and stores it
//     in coalesced 16-byte rows.
// w_bits = 4 (split-halves packed [E, N, K/2]: byte p holds k = p in its
// high nibble and k = p + K/2 in its low one) is K5's operand swap
// (w4a8.cu): the packed weight rows are wgmma's A, read from the TMA-staged
// packed tile straight into registers as 16 x each nibble (the accumulator
// is shifted right by 4 at the end: every term is a multiple of 16, so the
// shift is exact), and the visit's 128 activation rows are B (m64n128k32
// with A from registers). A full-K step stages x's columns [p0, p0 + 128)
// and [K/2 + p0, ...) beside the packed tiles and runs the high nibbles
// against the first, the low ones against the second; a chunk lies wholly
// in one half (an even chunk count), the high nibbles of packed columns
// [kb * ck, ...) or the low ones of [kb * ck - K/2, ...).
//
// Raster: the block index goes through gmm_tile_map, which walks group_m
// row tiles down before it moves to the next 128 columns (group_m = 1: each
// row tile's columns in turn), so a wave of blocks shares a few weight
// column tiles in L2. The wrapper picks group_m per form (16 for gate + up,
// 1 for down: the faster of the two at the served shape on an H100);
// mt_gmm_tile_map exports the mapping for the host's mirror.
//
// emit_quant's requant tile (one scale per row over block_n = 1408
// columns) is wider than a block tile, so the activated f32 tile t goes
// through a workspace [R_pad, N] (written once, read once), then a second
// kernel, one warp per (row, N tile), takes the amax and quantizes.
//
// Weight layout: [E, N, K] int8 (K-major, wgmma's B operand), the
// transpose of the JAX [E, K, N]; scales [E, N] f32.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::hopper;

constexpr int kTile = 128;                         // rows and columns of a block tile
constexpr int kTileBytes = kTile * kSwizzleBytes;  // one staged 128 x 128-byte box
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRingTarget = 192 * 1024;
constexpr int kMaxK = 131072;  // |acc| <= K * 128 * 127 < 2^31 (16 x the nibble at w4)
constexpr uint32_t kHiMask = 0xF0F0F0F0u;

// the ring of a kernel instance: per stage the activation box (two under
// the full-K int4 step: x's hi and lo columns) and one box per weight
template <int NW, bool CHUNKED, bool W4>
struct Ring {
  static constexpr int kXTiles = W4 && !CHUNKED ? 2 : 1;
  static constexpr int kXBytes = kXTiles * kTileBytes;
  static constexpr int kStageBytes = kXBytes + NW * kTileBytes;
  static constexpr int kStages = kRingTarget / kStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // + barriers, + slack to align the ring to the 1024-byte swizzle atom
  static constexpr int kSmem = kRingBytes + 2 * kStages * 8 + 1024;
};

// block index -> row tile * n_cols + column tile: group_m row tiles are
// walked down before the next column tile (the last group may be shorter)
__host__ __device__ inline int gmm_tile_map(int lin, int n_rows, int n_cols, int group_m) {
  const int per_group = group_m * n_cols;
  const int grp = lin / per_group, first = grp * group_m;
  const int rows = n_rows - first < group_m ? n_rows - first : group_m;
  const int in = lin - grp * per_group;
  return (first + in % rows) * n_cols + in / rows;
}

// m64n128k32, s8 x s8 -> s32, A and B from shared memory; d accumulates
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n128k32, s8 x s8 -> s32: A (64 weight rows x 32 k) from registers in
// the m16n8k32 fragment order of each warp, B (128 activation rows,
// K-major) from shared memory; d accumulates
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the accumulators' reads stay after the wgmma wait that precedes them
__device__ __forceinline__ void hold(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the packed words of this thread's m16n8k32 A fragments, for the four k32
// steps of a staged packed tile (rows ra and ra + 8), each nibble as 16 x
// its value: the high nibbles (HI) or the low ones
template <bool HI>
__device__ __forceinline__ void nibble_frags(uint32_t (&a)[4][4], const unsigned char* tile,
                                             int ra, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // m16n8k32 order: (ra, k), (ra + 8, k), then k + 16
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          tile + swizzle128(ra + (i & 1) * 8, kk * 32 + (i >> 1) * 16 + t4 * 4));
      a[kk][i] = HI ? w & kHiMask : (w << 4) & kHiMask;
    }
}

// one int4 batch: the fragments of the packed tile wt (high or low
// nibbles) against the four k32 steps of the activation box dx
__device__ __forceinline__ void w4_batch(int (&d)[64], uint32_t (&a)[4][4],
                                         const unsigned char* wt, int ra, int t4, bool hi,
                                         uint64_t dx) {
  if (hi)
    nibble_frags<true>(a, wt, ra, t4);
  else
    nibble_frags<false>(a, wt, ra, t4);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a[kk], dx + 2 * kk);
  wgmma_commit();
}

__device__ __forceinline__ float silu_f32(float x) {
  return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
}

struct GmmParams {
  const float* xs;  // [R_pad] or [n_chunks, R_pad]
  const float* ws0;  // [E, N]
  const float* ws1;
  const int* visit_e;
  const int* visit_valid;
  void* out0;  // [R_pad, N]
  void* out1;
  int R_pad, N;
  int n_rows, n_cols, tiles_per_visit, group_m;  // block tiles and raster
  int n_chunks;     // K chunks, each with its own scales (1: per-row scales)
  int chunk_steps;  // 128-byte stages per chunk
  int w_chunks;     // chunks of the weight map (int4 chunked: those of one half)
};

// NW weights (1 or 2); CHUNKED: per-(K-chunk, row) activation scales
// (NW == 1); SILU: out0 = silu(y0) * y1 (NW == 2); OUT: 0 = f32, 1 = bf16,
// 2 = raw s32 accumulators (per-row form only); W4: packed int4 weights
template <int NW, bool CHUNKED, bool SILU, int OUT, bool W4>
__global__ void __launch_bounds__(kThreads, 1)
gmm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w0,
           const __grid_constant__ CUtensorMap map_w1, const GmmParams p) {
  using R = Ring<NW, CHUNKED, W4>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kRingBytes);
  uint64_t* empty = full + R::kStages;
  const int tile = gmm_tile_map(blockIdx.x, p.n_rows, p.n_cols, p.group_m);
  const int mt = tile / p.n_cols;
  const int m0 = mt * kTile, n0 = (tile - mt * p.n_cols) * kTile;
  const int v = mt / p.tiles_per_visit;
  const bool ok = p.visit_valid[v] != 0;
  const int e = p.visit_e[v];
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: nothing to load for an invalid visit
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0 && ok) {
      int s = 0, ph = 0;
      for (int kb = 0; kb < p.n_chunks; ++kb) {
        const int wc = kb % p.w_chunks;
        for (int j = 0; j < p.chunk_steps; ++j) {
          const int k = j * kSwizzleBytes;
          mbar_wait(&empty[s], ph ^ 1);  // passes at once on the first lap
          mbar_expect_tx(&full[s], R::kStageBytes);
          unsigned char* st = ring + s * R::kStageBytes;
          tma_load_3d(st, &map_x, k, kb, m0, &full[s]);
          if constexpr (R::kXTiles == 2) tma_load_3d(st + kTileBytes, &map_x, k, 1, m0, &full[s]);
          tma_load_4d(st + R::kXBytes, &map_w0, k, wc, n0, e, &full[s]);
          if constexpr (NW == 2)
            tma_load_4d(st + R::kXBytes + kTileBytes, &map_w1, k, wc, n0, e, &full[s]);
          if (++s == R::kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: w8, warpgroup c owns activation rows [64 c, 64 c + 64) of
  // the tile; w4, weight rows (output columns) [64 c, 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
  const int w = t / 32, g = lane / 4, t4 = lane % 4;
  const int ra = c * 64 + w * 16 + g;  // int4: this thread's fragment rows ra, ra + 8
  int acc[NW][64];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[wi][i] = 0;
  float res[CHUNKED ? 64 : 1];  // CHUNKED: the running sum of the chunk partials
  uint32_t fa[4][4], fb[4][4];  // int4 chunked: the two fragment sets
  if (ok) {
    int s = 0, ph = 0, prev = -1;
    for (int kb = 0; kb < p.n_chunks; ++kb) {
      const bool hi = !CHUNKED || kb < p.w_chunks;  // int4: the chunk's nibble half
      for (int j = 0; j < p.chunk_steps; ++j) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = ring + s * R::kStageBytes;
        const uint64_t dx = smem_desc(st + (W4 ? 0 : c * 64 * kSwizzleBytes));
        if constexpr (!W4) {
          uint64_t dw[NW];
#pragma unroll
          for (int wi = 0; wi < NW; ++wi) dw[wi] = smem_desc(st + R::kXBytes + wi * kTileBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // 32 bytes = 2 descriptor units
#pragma unroll
            for (int wi = 0; wi < NW; ++wi) wgmma_ss(acc[wi], dx + 2 * kk, dw[wi] + 2 * kk);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's batch is done: release it
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        } else if constexpr (CHUNKED) {
          // one batch per stage, the nibbles of the chunk's half; its
          // fragments alternate between two register sets, since the batch
          // before may still read the other
          const unsigned char* wt = st + R::kXBytes;
          if (j & 1)
            w4_batch(acc[0], fb, wt, ra, t4, hi, dx);
          else
            w4_batch(acc[0], fa, wt, ra, t4, hi, dx);
          wgmma_wait<1>();  // the previous stage's batch is done: release it
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        } else {
          // the high nibbles against x's columns [p0, p0 + 128)
          uint32_t a[NW][4][4];
#pragma unroll
          for (int wi = 0; wi < NW; ++wi)
            nibble_frags<true>(a[wi], st + R::kXBytes + wi * kTileBytes, ra, t4);
          wgmma_fence();
#pragma unroll
          for (int wi = 0; wi < NW; ++wi)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[wi], a[wi][kk], dx + 2 * kk);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's low batch is done: release it
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          // the low nibbles against x's columns [K/2 + p0, ...), from the
          // same packed words
          uint32_t b[NW][4][4];
#pragma unroll
          for (int wi = 0; wi < NW; ++wi)
            nibble_frags<false>(b[wi], st + R::kXBytes + wi * kTileBytes, ra, t4);
          const uint64_t dx2 = smem_desc(st + kTileBytes);
          wgmma_fence();
#pragma unroll
          for (int wi = 0; wi < NW; ++wi)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[wi], b[wi][kk], dx2 + 2 * kk);
          wgmma_commit();
          wgmma_wait<1>();  // the high batch is done: its registers are free
        }
        prev = s;
        if (++s == R::kStages) s = 0, ph ^= 1;
      }
      if constexpr (CHUNKED) {
        // the chunk's end: fold its partial into the running sum
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[prev]);
        prev = -1;
        hold(acc[0]);
        const float* xk = p.xs + static_cast<size_t>(kb) * p.R_pad;
        const int r8 = m0 + c * 64 + w * 16 + g;
        const float x_lo = W4 ? 0.f : xk[r8], x_hi = W4 ? 0.f : xk[r8 + 8];
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float xr = W4 ? xk[m0 + (i >> 2) * 8 + t4 * 2 + (i & 1)] : (i & 2) ? x_hi : x_lo;
          const int a = W4 ? acc[0][i] >> 4 : acc[0][i];
          const float part = __fmul_rn(__int2float_rn(a), xr);
          if constexpr (CHUNKED) res[i] = kb == 0 ? part : __fadd_rn(res[i], part);
          acc[0][i] = 0;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) hold(acc[wi]);
  }

  // epilogue: the ring is free once both consumer warpgroups are done.
  // Consumer c stages its slice of the output tile row-major: w8 64 rows x
  // 128 columns; w4 (transposed fragments) 128 rows x 64 columns.
  named_bar(1, 256);
  constexpr int ROWS = W4 ? 128 : 64, COLS = W4 ? 64 : 128;
  constexpr int ES = OUT == 1 ? 2 : 4;                             // output element bytes
  constexpr int PITCH = COLS * ES + (W4 || ES == 2 ? 16 : 32);  // conflict-free fragment stores
  static_assert(2 * ROWS * PITCH <= R::kRingBytes, "the staged tile must fit the ring");
  unsigned char* stile = ring + c * ROWS * PITCH;
  const int row0 = W4 ? m0 : m0 + c * 64, col0 = W4 ? n0 + c * 64 : n0;
  const size_t e_off = static_cast<size_t>(e) * p.N;
  constexpr int n_out = SILU ? 1 : NW;
#pragma unroll
  for (int o = 0; o < n_out; ++o) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      // fragment i: accumulator row (w * 16 + g) + 8 (i & 2), column
      // 8 (i >> 2) + 2 t4 + (i & 1); at w4 the row is the output column
      const int fr = w * 16 + g + ((i & 2) ? 8 : 0), fc = (i >> 2) * 8 + t4 * 2 + (i & 1);
      const int lr = W4 ? fc : fr, lc = W4 ? fr : fc;  // local output row, column
      const int gr = row0 + lr, gc = col0 + lc;
      unsigned char* dst = stile + lr * PITCH + lc * ES;
      if constexpr (OUT == 2) {
        const int a = acc[o][i];
        *reinterpret_cast<int*>(dst) = ok ? (W4 ? a >> 4 : a) : 0;
      } else {
        float y[NW];
        const float xr = CHUNKED ? 0.f : p.xs[gr];
#pragma unroll
        for (int wi = 0; wi < NW; ++wi) {
          if (SILU || wi == o) {
            const float* wsp = wi == 0 ? p.ws0 : p.ws1;
            const float wsc = gc < p.N ? wsp[e_off + gc] : 0.f;
            float base;
            if constexpr (CHUNKED)
              base = res[i];
            else
              base = __fmul_rn(__int2float_rn(W4 ? acc[wi][i] >> 4 : acc[wi][i]), xr);
            y[wi] = __fmul_rn(base, wsc);
          } else {
            y[wi] = 0.f;
          }
        }
        float val = SILU ? __fmul_rn(silu_f32(y[0]), y[NW - 1]) : y[o];
        if (!ok) val = 0.f;
        if constexpr (OUT == 0)
          *reinterpret_cast<float*>(dst) = val;
        else
          *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(val);
      }
    }
    named_bar(2 + c, 128);
    // coalesced stores: 16-byte chunks along the rows; element by element
    // where the chunk crosses N or the rows are not 16-byte aligned
    constexpr int VEC = 16 / ES, CHUNKS = COLS / VEC;
    const bool aligned = (static_cast<size_t>(p.N) * ES) % 16 == 0;
    unsigned char* out = static_cast<unsigned char*>(o == 0 ? p.out0 : p.out1);
    for (int i = t; i < ROWS * CHUNKS; i += 128) {
      const int r = i / CHUNKS, ch = i % CHUNKS;
      const int gr = row0 + r, gc = col0 + ch * VEC;
      if (gc >= p.N) continue;  // gr < R_pad: the grid covers R_pad exactly
      const unsigned char* src = stile + r * PITCH + ch * 16;
      unsigned char* dst = out + (static_cast<size_t>(gr) * p.N + gc) * ES;
      if (aligned && gc + VEC <= p.N) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int x = 0; x < VEC && gc + x < p.N; ++x)
          for (int b = 0; b < ES; ++b) dst[x * ES + b] = src[x * ES + b];
      }
    }
    if (o + 1 < n_out) named_bar(2 + c, 128);  // the staging is read before it is reused
  }
}

constexpr int kRequantWarps = 8;

// emit_quant: one warp per (row, N tile of block_n columns) of the activated
// f32 t: the tile's amax, its scale, the int8 codes; scales [N/bn, R_pad]
__global__ void __launch_bounds__(kRequantWarps * 32)
requant_kernel(const float* __restrict__ t, int8_t* __restrict__ q,
               float* __restrict__ qs, int R_pad, int N, int block_n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRequantWarps + warp, j = blockIdx.y;
  if (row >= R_pad) return;  // the whole warp
  const size_t base = static_cast<size_t>(row) * N + static_cast<size_t>(j) * block_n;
  const float* tr = t + base;
  float amax = 0.f;
  for (int i = lane; i < block_n; i += 32) amax = fmaxf(amax, fabsf(tr[i]));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-10f);
  if (lane == 0) qs[static_cast<size_t>(j) * R_pad + row] = s;
  int8_t* qr = q + base;
  for (int i = lane; i < block_n; i += 32)  // clipped: no wrap on the int8 cast
    qr[i] = static_cast<int8_t>(
        max(-127, min(127, __float2int_rn(__fdiv_rn(tr[i], s)))));
}

template <int NW, bool CHUNKED, bool SILU, int OUT, bool W4>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw0, const CUtensorMap& mw1,
                   const GmmParams& p, cudaStream_t s) {
  using R = Ring<NW, CHUNKED, W4>;
  auto* kernel = gmm_kernel<NW, CHUNKED, SILU, OUT, W4>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<p.n_rows * p.n_cols, kThreads, R::kSmem, s>>>(mx, mw0, mw1, p);
  return cudaGetLastError();
}

// the instances: out_kind 0 / 1 (f32 / bf16) everywhere, 2 (s32) when S32
template <int NW, bool CHUNKED, bool SILU, bool S32, bool W4>
cudaError_t launch_by_out(int out_kind, const CUtensorMap& mx, const CUtensorMap& mw0,
                          const CUtensorMap& mw1, const GmmParams& p, cudaStream_t s) {
  if (out_kind == 0) return launch<NW, CHUNKED, SILU, 0, W4>(mx, mw0, mw1, p, s);
  if (out_kind == 1) return launch<NW, CHUNKED, SILU, 1, W4>(mx, mw0, mw1, p, s);
  if (S32 && out_kind == 2)
    return launch<NW, CHUNKED, SILU, S32 ? 2 : 0, W4>(mx, mw0, mw1, p, s);
  return cudaErrorInvalidValue;
}

template <bool W4>
cudaError_t launch_form(int nw, bool chunked, bool silu, int out_kind, const CUtensorMap& mx,
                        const CUtensorMap& mw0, const CUtensorMap& mw1, const GmmParams& p,
                        cudaStream_t s) {
  if (nw == 1)
    return chunked ? launch_by_out<1, true, false, false, W4>(out_kind, mx, mw0, mw1, p, s)
                   : launch_by_out<1, false, false, true, W4>(out_kind, mx, mw0, mw1, p, s);
  return silu ? launch_by_out<2, false, true, false, W4>(out_kind, mx, mw0, mw1, p, s)
              : launch_by_out<2, false, false, true, W4>(out_kind, mx, mw0, mw1, p, s);
}

}  // namespace

extern "C" {

// xq [V * block_m, K] int8; x_scale [R_pad] or [n_chunks, R_pad] f32; w0/w1
// [E, N, K] int8, or [E, N, K/2] split-halves int4 when w_bits is 4 (w1
// NULL for one weight); ws0/ws1 [E, N] f32; visit_e, visit_valid [V] int32;
// out0/out1 [R_pad, N] (out_kind 0 f32, 1 bf16, 2 s32). block_m % 128 == 0;
// the k extent of a TMA box row (K, K / n_chunks, K / 2 at w_bits 4) a
// multiple of 16; K <= 131072; group_m >= 1 (the raster); xq and the
// weights 16-byte aligned.
int mt_gmm(const void* xq, const void* x_scale, int n_chunks, const void* w0,
           const void* w1, const void* ws0, const void* ws1, const void* visit_e,
           const void* visit_valid, void* out0, void* out1, int out_kind, int fuse_silu,
           int V, int block_m, int E, int N, int K, int w_bits, int group_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = w1 ? 2 : 1;
  const bool chunked = n_chunks > 0, w4 = w_bits == 4;
  const int nck = chunked ? n_chunks : 1;
  if (block_m % kTile || (chunked && nw != 1) || (fuse_silu && nw != 2) ||
      (w_bits != 8 && !w4) || K > kMaxK || K % nck || group_m < 1 ||
      (w4 && (K % 2 || (chunked && n_chunks % 2))))
    return static_cast<int>(cudaErrorInvalidValue);
  // chunk widths in bytes: x's and the weight's (the full-K int4 step
  // stages x's two halves as two chunks against one packed chunk)
  const int cw = w4 && !chunked ? K / 2 : K / nck;
  const int x_chunks = w4 && !chunked ? 2 : nck;
  const int w_chunks = w4 ? (chunked ? nck / 2 : 1) : nck;
  const int KW = w4 ? K / 2 : K;  // bytes of a weight row
  if (cw % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int R_pad = V * block_m;
  const uint32_t box3[3] = {kSwizzleBytes, 1, kTile}, box4[4] = {kSwizzleBytes, 1, kTile, 1};
  const uint64_t xd[3] = {static_cast<uint64_t>(cw), static_cast<uint64_t>(x_chunks),
                          static_cast<uint64_t>(R_pad)};
  const uint64_t xst[2] = {static_cast<uint64_t>(cw), static_cast<uint64_t>(K)};
  const uint64_t wd[4] = {static_cast<uint64_t>(cw), static_cast<uint64_t>(w_chunks),
                          static_cast<uint64_t>(N), static_cast<uint64_t>(E)};
  const uint64_t wst[3] = {static_cast<uint64_t>(cw), static_cast<uint64_t>(KW),
                           static_cast<uint64_t>(N) * KW};
  CUtensorMap mx, mw0, mw1;
  if (!make_map_s8_nd(&mx, xq, 3, xd, xst, box3) || !make_map_s8_nd(&mw0, w0, 4, wd, wst, box4) ||
      !make_map_s8_nd(&mw1, nw == 2 ? w1 : w0, 4, wd, wst, box4))
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams p{static_cast<const float*>(x_scale),
              static_cast<const float*>(ws0),
              static_cast<const float*>(ws1),
              static_cast<const int*>(visit_e),
              static_cast<const int*>(visit_valid),
              out0,
              out1,
              R_pad,
              N,
              R_pad / kTile,
              (N + kTile - 1) / kTile,
              block_m / kTile,
              group_m,
              nck,
              (cw + kSwizzleBytes - 1) / kSwizzleBytes,
              w_chunks};
  return static_cast<int>(w4 ? launch_form<true>(nw, chunked, fuse_silu, out_kind, mx, mw0,
                                                  mw1, p, s)
                             : launch_form<false>(nw, chunked, fuse_silu, out_kind, mx, mw0,
                                                  mw1, p, s));
}

// emit_quant's second pass: t [R_pad, N] f32 (the activated workspace) ->
// q [R_pad, N] int8 and q_scale [N / block_n, R_pad] f32; N % block_n == 0
int mt_gmm_requant(const void* t, void* q, void* q_scale, int R_pad, int N, int block_n,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_n <= 0 || N % block_n) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R_pad + kRequantWarps - 1) / kRequantWarps, N / block_n);
  requant_kernel<<<grid, kRequantWarps * 32, 0, s>>>(
      static_cast<const float*>(t), static_cast<int8_t*>(q), static_cast<float*>(q_scale),
      R_pad, N, block_n);
  return static_cast<int>(cudaGetLastError());
}

// the kernel's raster on the host: block lin -> row tile * n_cols + column
// tile (no stream: nothing launches)
int mt_gmm_tile_map(int lin, int n_rows, int n_cols, int group_m) {
  return gmm_tile_map(lin, n_rows, n_cols, group_m);
}

}  // extern "C"
