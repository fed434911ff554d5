"""K6: the grouped per-expert w8a8 / w4a8 matmul ("gmm") of the dropless MoE
chain (``csrc/grouped_matmul.cu``) and its plain version.

Replaces ``medtsllm_tpu/ops/pallas/grouped_matmul.py::gmm`` (``w_bits`` 8
and 4) with its signature and semantics. Rows of ``xq`` are packed per expert into
tile-aligned groups (``gmm_metadata``): visit v computes row tile v
(``block_m`` rows) against expert ``visit_e[v]``; invalid tail visits write
zeros (and the 1e-10 floor in a scale output). The forms the MoE chain
launches, each with its own launch count per weight width (``GATE_UP``,
``DOWN``, ``PLAIN`` at ``w_bits=8``; ``GATE_UP_W4``, ``DOWN_W4``,
``PLAIN_W4`` at 4):
  (a) gate + up: two weights share the activation sweep, per-row x_scale,
      ``fuse_silu`` + ``emit_quant`` -> (int8 [R_pad, N], per-(row, N-tile)
      scales [N / block_n, 1, R_pad]);
  (b) down: one weight, chunked scales [KB, 1, R_pad] (the contraction
      split into KB chunks, each partial rescaled in f32), f32 out;
  (c) the plain form: 1-2 weights, per-row scales, f32 / bf16 out, or the
      raw s32 accumulators (``out_dtype=torch.int32``).

The kernel is a wgmma + TMA pipeline (K1's, made grouped; K5's operand swap
at ``w_bits=4``) over 128 x 128 block tiles, launched in the raster
``gmm_tile_order`` mirrors; ``emit_quant`` writes the activated f32 tile to a
workspace that a second kernel requantizes (``requant_tiles``). The shapes
it takes are ``kernel_shape_error``'s: the wrapper refuses the others before
the launch.

Layout: the expert weights are ``[E, N, K]`` int8 (K contiguous, K1's B
operand), the transpose of the JAX package's ``[E, K, N]``; ``weights.py``
transposes once. At ``w_bits=4`` they are split-halves packed int4 ``[E, N,
K/2]`` (``w4a8.pack4_split`` per expert row), K even; a chunked form then
needs an even chunk count, so that no chunk straddles the nibble halves.

Operands: the codes, the scales, the visit tables and the expert weights
must be contiguous (the wrapper makes the scales so), the codes and the
weights 16-byte aligned; any other layout raises a ValueError that names
the tensor.

The launches are custom ops (``medtsllm::gmm``, ``medtsllm::requant_tiles``;
the CPU kernel the plain version), which ``torch.export`` records. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .w4a8 import unpack4_split
from .w8a8 import int8_matmul_plain, quantize_rows

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_TILE = 128  # rows and columns of the kernel's block tile: block_m is a multiple
MAX_K = 131072  # the kernel's s32 accumulators cannot wrap up to this K
# the kernel's raster per form, row tiles walked down per column tile (1:
# each row tile's columns in turn): per-row scales (gate + up, the plain
# form) and chunked (down). Each is the faster of 1 and 16 at the served
# shape (chip_smoke.py's [raster] lines).
TILE_GROUP_M = {"rows": 16, "chunked": 1}


class Form:
    """One form of K6; ``launches`` counts its kernel launches."""

    launches = 0


GATE_UP, DOWN, PLAIN = Form(), Form(), Form()
GATE_UP_W4, DOWN_W4, PLAIN_W4 = Form(), Form(), Form()
REQUANT = Form()  # emit_quant's second pass, at either weight width


# --------------------------------------------------------------------------
# metadata (torch ops on the device: no host sync)
# --------------------------------------------------------------------------

def pick_block_n(n: int, target: int = 512) -> int:
    """Largest multiple-of-128 divisor of ``n`` that is <= target (0 when
    none exists: the caller falls back to the capacity path)."""
    best = 0
    for bn in range(128, min(n, target) + 1, 128):
        if n % bn == 0:
            best = bn
    return best


def gmm_visits(n_rows: int, n_groups: int, block_m: int) -> int:
    """Static visit/tile bound: every m-tile plus one tail per group."""
    return -(-n_rows // block_m) + n_groups


def gmm_metadata(counts: torch.Tensor, block_m: int, n_visits: int):
    """counts [E] routed rows per expert -> (visit_e [V], visit_valid [V],
    row_off [E]), all int32 on counts' device. Visit v computes m-tile v of
    the packed row space against expert visit_e[v]; row_off[e] is the first
    packed row of group e (a block_m multiple). Invalid visits (v >= the
    occupied tiles) repeat the last real expert id."""
    i32 = torch.int32
    E = counts.shape[0]
    n_tiles = (counts.to(i32) + block_m - 1) // block_m
    tile_off = torch.cat([torch.zeros(1, dtype=i32, device=counts.device),
                          torch.cumsum(n_tiles, 0).to(i32)])
    t_idx = torch.arange(n_visits, dtype=i32, device=counts.device)
    ve = torch.searchsorted(tile_off[1:].contiguous(), t_idx, right=True,
                            out_int32=True)
    ve = torch.clamp(ve, max=E - 1)  # in bounds even when every group is empty
    n_real = tile_off[-1]
    valid = (t_idx < n_real).to(i32)
    # a 1-element index: indexing by a 0-d tensor reads it back to the host,
    # which a captured CUDA graph cannot do
    last_e = ve[torch.clamp(n_real - 1, min=0).reshape(1)]
    ve = torch.where(valid == 1, ve, last_e)
    return ve, valid, tile_off[:-1] * block_m


def row_quant(x: torch.Tensor):
    """Per-row symmetric int8 quantization (amax / 127, round half to even):
    x [M, K] f32 or bf16 -> (xq [M, K] int8, scale [M, 1] f32). K1's
    quantizer; a bf16 input is read as the JAX ``astype(cd).astype(f32)``
    round trip."""
    xq, xs = quantize_rows(x.contiguous())
    return xq, xs[:, None]


def gmm_tile_order(n_row_tiles: int, n_col_tiles: int, group_m: int):
    """The kernel's raster (``gmm_tile_map`` in ``csrc/grouped_matmul.cu``):
    the (row tile, column tile) of each block in launch order. ``group_m``
    row tiles are walked down before the next column tile; the last group
    may hold fewer."""
    order = []
    for lin in range(n_row_tiles * n_col_tiles):
        grp, inner = divmod(lin, group_m * n_col_tiles)
        first = grp * group_m
        rows = min(n_row_tiles - first, group_m)
        order.append((first + inner % rows, inner // rows))
    return order


def kernel_shape_error(K: int, block_m: int, n_chunks: int, n_weights: int,
                       w_bits: int) -> str | None:
    """Why the kernel refuses a shape that ``gmm``'s arguments allow, or None
    when it takes it. Its block tiles are 128 rows of one visit; its TMA
    boxes read rows of a chunk (K, K / KB, or each half K / 2 of the
    full-K int4 step) that must be 16-byte multiples; its s32 accumulators
    hold K up to ``MAX_K``. N and ragged K tails are free (zero fill)."""
    if block_m % _TILE:
        return f"the kernel tiles {_TILE} rows: block_m % {_TILE} == 0, got {block_m}"
    if n_chunks and n_weights != 1:
        return "the kernel takes chunked scales with one weight (the down gmm)"
    rows = [K] + ([K // n_chunks] if n_chunks else []) + ([K // 2] if w_bits == 4 else [])
    if any(r % 16 for r in rows):
        return (f"the kernel's TMA rows are multiples of 16 bytes: K, K / KB and, at "
                f"w_bits=4, K / 2 (K {K}, {n_chunks} chunks)")
    if K > MAX_K:
        return f"K {K} is past {MAX_K}: the kernel's s32 accumulators could wrap"
    return None


# --------------------------------------------------------------------------
# argument checks shared by the plain version and the kernel
# --------------------------------------------------------------------------

def _check(xq, x_scale, weights, w_scales, visit_e, block_m, block_n, out_dtype,
           fuse_silu, emit_quant, w_bits) -> int:
    """Validate as the JAX ``gmm`` asserts; returns the K-chunk count (0 =
    per-row scales)."""
    if w_bits not in (4, 8):
        raise ValueError(f"w_bits must be 8 or 4, got {w_bits}")
    if not weights or len(weights) != len(w_scales) or len(weights) > 2:
        raise ValueError("gmm takes 1 or 2 weights, one scale each")
    R_pad, K = xq.shape
    if w_bits == 4 and K % 2:
        raise ValueError(f"w_bits=4 needs an even K, got {K}")
    wk = K if w_bits == 8 else K // 2
    E, N, K2 = weights[0].shape
    V = visit_e.shape[0]
    if K2 != wk or R_pad != V * block_m:
        raise ValueError(f"xq {tuple(xq.shape)}, weights [E, N, {wk}] at w_bits={w_bits}: "
                         f"{tuple(weights[0].shape)}, {V} visits of {block_m} rows")
    if N % block_n:
        raise ValueError(f"N {N} is not a multiple of block_n {block_n}")
    for w, s in zip(weights, w_scales):
        if w.shape != (E, N, wk) or w.dtype != torch.int8 or s.shape != (E, N):
            raise ValueError(f"every weight is int8 [E, N, {wk}] with a scale [E, N]")
    if fuse_silu and len(weights) != 2:
        raise ValueError("fuse_silu takes (gate, up)")
    if emit_quant and not fuse_silu:
        raise ValueError("emit_quant rides the SwiGLU path")
    if emit_quant and block_m % 128:
        raise ValueError(f"emit_quant needs block_m % 128 == 0, got {block_m}")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    n_chunks = 0
    if x_scale.dim() == 3:
        n_chunks = x_scale.shape[0]
        if x_scale.shape != (n_chunks, 1, R_pad) or K % n_chunks:
            raise ValueError(f"chunked x_scale {tuple(x_scale.shape)} for K {K}")
    elif x_scale.shape != (R_pad, 1):
        raise ValueError(f"x_scale {tuple(x_scale.shape)}: [R_pad, 1] or [KB, 1, R_pad]")
    if w_bits == 4 and n_chunks % 2:
        raise ValueError(f"w_bits=4 needs an even chunk count (a chunk must not "
                         f"straddle the nibble halves), got {n_chunks}")
    if out_dtype == torch.int32 and (n_chunks or fuse_silu):
        raise ValueError("the s32 accumulators are returned by the plain form only "
                         "(per-row scales, no fuse_silu)")
    return n_chunks


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def gmm_plain(xq, x_scale, weights, w_scales, visit_e, visit_valid, *, block_m=128,
              block_n=512, out_dtype=torch.float32, fuse_silu=False, emit_quant=False,
              w_bits=8):
    """Every form of ``gmm`` in plain PyTorch: per expert, the exact s8 x s8
    products of its valid rows, then JAX's f32 rescale order,
    ``(acc * x_scale) * w_scale``, with chunk partials summed in order. Packed
    int4 weights are unpacked first: a chunk then reads the unpacked columns
    of its half, and a full-K product sums the hi and lo halves in s32, the
    integers of the JAX kernel's nibble dots."""
    n_chunks = _check(xq, x_scale, weights, w_scales, visit_e, block_m, block_n,
                      out_dtype, fuse_silu, emit_quant, w_bits)
    R_pad, K = xq.shape
    if w_bits == 4:
        weights = [unpack4_split(w, K) for w in weights]
    E, N, _ = weights[0].shape
    row_e = visit_e.long().repeat_interleave(block_m)
    row_ok = visit_valid.bool().repeat_interleave(block_m)
    xs = x_scale.float()
    raw = out_dtype == torch.int32
    res = []
    for w, s in zip(weights, w_scales):
        out = torch.zeros(R_pad, N, dtype=torch.int32 if raw else torch.float32,
                          device=xq.device)
        for e in range(E):
            rows = torch.nonzero(row_ok & (row_e == e)).squeeze(1)
            if rows.numel() == 0:
                continue
            x = xq[rows]
            if raw:
                out[rows] = int8_matmul_plain(x, w[e])
                continue
            if n_chunks == 0:
                o = int8_matmul_plain(x, w[e]).float() * xs[rows]
            else:
                ck = K // n_chunks
                o = None
                for kb in range(n_chunks):
                    sl = slice(kb * ck, (kb + 1) * ck)
                    part = (int8_matmul_plain(x[:, sl], w[e][:, sl]).float()
                            * xs[kb, 0, rows][:, None])
                    o = part if o is None else o + part
            out[rows] = o * s[e].float()
        res.append(out)
    if raw:
        return tuple(res)
    if not fuse_silu:
        return tuple(r.to(out_dtype) for r in res)
    t = res[0] * torch.sigmoid(res[0]) * res[1]  # jax.nn.silu(g) * u
    if not emit_quant:
        return (t.to(out_dtype),)
    return requant_tiles_plain(t, block_n)


def requant_tiles_plain(t, block_n):
    """emit_quant's requantization: t [R_pad, N] f32 -> (int8 codes [R_pad,
    N], scales [N / block_n, 1, R_pad]), one scale max(amax / 127, 1e-10) per
    (row, block_n-wide tile), codes rounded half to even and clipped."""
    R_pad, N = t.shape
    tiles = t.reshape(R_pad, N // block_n, block_n)
    amax = tiles.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: true division, as in K1's plain quantizer
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-10)
    # clipped before the int8 cast, which would wrap (JAX casts unclipped:
    # the same codes whenever t is finite)
    q = torch.clamp(torch.round(tiles / scale), -127, 127).to(torch.int8).reshape(R_pad, N)
    return q, scale[..., 0].T.reshape(N // block_n, 1, R_pad).contiguous()


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

@torch.library.custom_op("medtsllm::gmm", mutates_args=(), device_types="cuda")
def _gmm_op(xq: torch.Tensor, x_scale: torch.Tensor, weights: list[torch.Tensor],
            w_scales: list[torch.Tensor], visit_e: torch.Tensor, visit_valid: torch.Tensor,
            block_m: int, out_dtype: torch.dtype, fuse_silu: bool, emit_quant: bool,
            w_bits: int) -> list[torch.Tensor]:
    """K6's launch as a custom op (the wrapper has checked the operands'
    shapes; the addresses are read here) -> one [R_pad, N] output per
    weight, or [silu(out0) * out1]; under ``emit_quant`` that one in f32,
    the workspace ``requant_tiles`` reads."""
    _build.check_aligned((xq, *weights), "xq and the weights must be 16-byte aligned")
    R_pad, K = xq.shape
    E, N, _ = weights[0].shape
    n_chunks = x_scale.shape[0] if x_scale.dim() == 3 else 0
    dev = xq.device
    V = visit_e.shape[0]
    w1 = weights[1] if len(weights) == 2 else None
    s1 = w_scales[1] if len(weights) == 2 else None
    n_out = 1 if fuse_silu else len(weights)
    # emit_quant: the activated f32 tile goes through a workspace, then the
    # per-(row, N-tile) requantization pass
    kind = 0 if emit_quant else _OUT_KIND[out_dtype]
    outs = [torch.empty(R_pad, N, dtype=torch.float32 if emit_quant else out_dtype,
                        device=dev) for _ in range(n_out)]
    _build.launch("mt_gmm", dev, _build.ptr(xq), _build.ptr(x_scale), n_chunks,
                  _build.ptr(weights[0]), _build.ptr(w1), _build.ptr(w_scales[0]),
                  _build.ptr(s1), _build.ptr(visit_e), _build.ptr(visit_valid),
                  _build.ptr(outs[0]), _build.ptr(outs[1] if n_out == 2 else None),
                  kind, int(fuse_silu), V, block_m, E, N, K, w_bits,
                  TILE_GROUP_M["chunked" if n_chunks else "rows"])
    gate_up, down, plain = (GATE_UP, DOWN, PLAIN) if w_bits == 8 else (
        GATE_UP_W4, DOWN_W4, PLAIN_W4)
    (gate_up if emit_quant else down if n_chunks else plain).launches += 1
    return outs


@_gmm_op.register_kernel("cpu")
def _(xq, x_scale, weights, w_scales, visit_e, visit_valid, block_m, out_dtype, fuse_silu,
      emit_quant, w_bits):
    # emit_quant's workspace: the fused product in f32 (``gmm_plain``'s t)
    outs = gmm_plain(xq, x_scale, weights, w_scales, visit_e, visit_valid,
                     block_m=block_m, block_n=weights[0].shape[1],
                     out_dtype=torch.float32 if emit_quant else out_dtype,
                     fuse_silu=fuse_silu, w_bits=w_bits)
    return _build.op_outputs(list(outs), xq, x_scale, weights, w_scales, visit_e,
                             visit_valid)


@_gmm_op.register_fake
def _(xq, x_scale, weights, w_scales, visit_e, visit_valid, block_m, out_dtype, fuse_silu,
      emit_quant, w_bits):
    R_pad, N = xq.shape[0], weights[0].shape[1]
    dtype = torch.float32 if emit_quant else out_dtype
    return [xq.new_empty(R_pad, N, dtype=dtype)
            for _ in range(1 if fuse_silu else len(weights))]


def gmm(xq, x_scale, weights, w_scales, visit_e, visit_valid, *, block_m=128,
        block_n=512, out_dtype=torch.float32, fuse_silu=False, emit_quant=False,
        w_bits=8):
    """Grouped w8a8 / w4a8 matmul(s) over expert-packed rows (the JAX ``gmm``).

    xq [R_pad, K] int8 (R_pad = V * block_m); x_scale [R_pad, 1] f32 or
    chunked [KB, 1, R_pad]; weights: 1 or 2 int8 [E, N, K], or packed int4
    [E, N, K/2] at ``w_bits=4``; w_scales: one
    [E, N] each; visit_e / visit_valid [V] int32 from ``gmm_metadata``.
    Returns a tuple of [R_pad, N] ``out_dtype`` arrays, one per weight (one
    under ``fuse_silu``: silu(out0) * out1), or (int8 [R_pad, N], scales
    [N / block_n, 1, R_pad]) under ``emit_quant``: the product through the
    op ``medtsllm::gmm``, then ``requant_tiles``."""
    n_chunks = _check(xq, x_scale, weights, w_scales, visit_e, block_m, block_n,
                      out_dtype, fuse_silu, emit_quant, w_bits)
    if xq.device.type != "cpu":
        K = xq.shape[1]
        err = kernel_shape_error(K, block_m, n_chunks, len(weights), w_bits)
        if err:
            raise ValueError(err)
        x_scale = x_scale.float().contiguous()
        w_scales = [s.float().contiguous() for s in w_scales]
        if visit_e.dtype != torch.int32 or visit_valid.dtype != torch.int32:
            raise ValueError("visit_e and visit_valid must be int32")
        _build.check_cuda(xq, x_scale, visit_e, visit_valid, *weights, *w_scales,
                          names="xq x_scale visit_e visit_valid " + " ".join(
                              [f"weights[{i}]" for i in range(len(weights))]
                              + [f"w_scales[{i}]" for i in range(len(w_scales))]))
    outs = _gmm_op(xq, x_scale, list(weights), list(w_scales), visit_e, visit_valid,
                   block_m, out_dtype, fuse_silu, emit_quant, w_bits)
    return requant_tiles(outs[0], block_n) if emit_quant else tuple(outs)


@torch.library.custom_op("medtsllm::requant_tiles", mutates_args=(), device_types="cuda")
def _requant_op(t: torch.Tensor, block_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The requantization pass's launch as a custom op (the wrapper has
    checked t)."""
    R_pad, N = t.shape
    q = torch.empty(R_pad, N, dtype=torch.int8, device=t.device)
    scales = torch.empty(N // block_n, 1, R_pad, dtype=torch.float32, device=t.device)
    _build.launch("mt_gmm_requant", t.device, _build.ptr(t), _build.ptr(q), _build.ptr(scales),
                  R_pad, N, block_n)
    REQUANT.launches += 1
    return q, scales


@_requant_op.register_kernel("cpu")
def _(t, block_n):
    return tuple(_build.op_outputs(requant_tiles_plain(t, block_n), t))


@_requant_op.register_fake
def _(t, block_n):
    R_pad, N = t.shape
    return (t.new_empty(R_pad, N, dtype=torch.int8),
            t.new_empty(N // block_n, 1, R_pad, dtype=torch.float32))


def requant_tiles(t, block_n):
    """emit_quant's second pass (``requant_kernel``, the op
    ``medtsllm::requant_tiles``) on the activated f32 workspace t [R_pad,
    N]: ``requant_tiles_plain``'s codes and scales. Counts its launches in
    ``REQUANT``."""
    if t.device.type == "cpu":
        return _requant_op(t, block_n)
    R_pad, N = t.shape
    if t.dtype != torch.float32 or N % block_n:
        raise ValueError(f"requant takes f32 [R_pad, N] with N % block_n == 0: "
                         f"{t.dtype} {tuple(t.shape)}, block_n {block_n}")
    _build.check_cuda(t, names="t")
    return _requant_op(t, block_n)
