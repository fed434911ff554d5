"""K1: the w8a8 projection GEMM (``csrc/w8a8.cu``) and its plain version.

Replaces ``medtsllm_tpu/ops/pallas/smallm_matmul.py::
w8a8_smallm_matmul_pallas`` and the XLA dot of
``models/llm/transformer.py::_act_quant_matmul`` it stands in for:
per-row absmax int8 activation quantization, an s8 x s8 -> s32 product,
then ``acc * (x_scale * w_scale)``. On this card the product is bound by
the int8 tensor cores at the serving shapes: the kernel stages 128 x 256
tiles by TMA into a shared-memory ring and multiplies them with wgmma;
see the CUDA source for the design.

The two row quantizers (the activation rows and the dx's gradient rows)
are bound by bytes and read each row from device memory once: large calls
of bf16 rows (and the dx's) by bulk copies through a ring of shared-memory
stages, the rest into the registers of a group of warps, 16 bytes a load
where the rows and bases allow (else one element). ``quant_plan`` picks
the kernel and its launch from the shape and the operands' addresses
before the launch; ``[0, K]`` rows launch nothing.

Layout: the weight is the transposed int8 kernel ``wq_t [N, K]`` (the JAX
package stores ``kernel_q [K, N]``; ``weights.py`` transposes once).

Training: ``act_quant_matmul`` carries the straight-through backward of
``_act_quant_matmul_bwd`` (``transformer.py:261-285``), so the gradient
reaches the trainable layers below a frozen int8 backbone. With
``llm.int8_backward`` (the caller passes the weight's ``[K, N]`` copy) dx
runs on the int8 tensor cores too (``int8_dx``, the int8 branch at
``:269-278``): the scale-folded gradient quantized per row by
``quantize_grad_rows`` (a CUDA entry of its own), then this GEMM on the
transposed weight with a unit channel scale, bit-equal to JAX's
``acc * g_scale``. wgmma takes 8-bit operands K-major only, so the dx
product (a contraction over N) reads a ``[K, N]`` copy of the frozen
weight, made once by its owner (``kn_weight``).

Shapes: the GEMM reads 16-byte rows by TMA, so its contraction width must
be a multiple of 16. A width that is not (JAX's XLA dot takes any) is
padded with zero columns, the weight once by its owner (``pad_cols``) and
the codes per call; zero columns add nothing to the s32 sums, so the result
is the same bits.

The quantizer and the GEMM are ``torch.library`` custom ops
(``medtsllm::quantize_rows``, ``medtsllm::w8a8_gemm``): the CUDA kernel is
the launch, the CPU kernel the plain version. ``torch.export`` records them
(``runtime/export.py``), and a selective checkpoint policy (``llm.remat =
"dots"``) sees the GEMM and keeps its output. The dx's quantizer
(``quantize_grad_rows``) runs only in training and is no op.

Operands: the kernels read dense rows from raw pointers, so every operand
(x, the codes, the weight, the scales, g) must be contiguous, and the GEMM's
codes and weight 16-byte aligned; the wrappers that take a caller's
activations (``act_quant_matmul``, ``int8_dx``) make them contiguous first.
Any other layout raises a ValueError that names the tensor.

A CPU tensor takes the plain version (the op's CPU kernel; the plain
function itself where autograd records the call); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_KIND_DTYPE = {v: k for k, v in _OUT_KIND.items()}
K_ALIGN = 16  # the GEMM's contraction width: 16-byte TMA rows of int8
# the row quantizers' launch plan (quant_plan; csrc/w8a8.cu)
SMS = 132  # the H100's streaming multiprocessors
TILE_SMEM = 200 * 1024  # the tile kernel's stages (and the dx's scale row) a block
TILE_MIN_BYTES = 16 << 20  # the least input of a call the tile kernel takes
TILE_ROWS = 16  # the most rows a tile: one a consumer warp
TILE_STAGES = 8
ROW_THREADS = 512  # the row-group kernel's most threads a block
VECTOR_LANE = 16  # the elements a lane of its vector instance holds
SCALAR_LANE = 32  # and of its scalar instance


def pad_cols(t: torch.Tensor, mult: int = K_ALIGN) -> torch.Tensor:
    """``t`` with zero columns appended up to a multiple of ``mult`` (itself
    when it has one)."""
    extra = -t.shape[-1] % mult
    return t if not extra else F.pad(t, (0, extra))


def kn_weight(wq_t: torch.Tensor) -> torch.Tensor:
    """The ``[K, N]`` copy of an int8 weight ``wq_t [N, K]`` (or of each
    expert's, [E, N, K] -> [E, K, N]) that the dx GEMM reads K-major (its
    contraction runs over N), N padded to a multiple of 16."""
    return pad_cols(wq_t.transpose(-1, -2).contiguous())


@functools.cache
def unit_scale(n: int, device: torch.device) -> torch.Tensor:
    """Ones [n] f32 on ``device``, made once (the dx GEMM's channel scale: x
    * 1.0 is exact, so the epilogue's ``acc * (g_scale * 1)`` is JAX's
    ``acc * g_scale``); a normal tensor even under inference mode."""
    with torch.inference_mode(False):
        return torch.ones(n, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor):
    """x [M, K] float -> (xq [M, K] int8, x_scale [M] f32): round half to
    even of x / max(amax / 127, 1e-10), as jnp.round does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which can move the scale by an ulp
    x_scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-10)
    xq = torch.round(xf / x_scale).to(torch.int8)
    return xq, x_scale[:, 0]


def int8_matmul_plain(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [N, K]^T -> s32 [M, N], exact. A bare int8 matmul
    returns int8 and wraps, and CUDA has no integer matmul: the CPU widens
    to int32, the card computes in float64 (exact: K * 127^2 << 2^53)."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq_t.to(torch.int32).T
    return (xq.double() @ wq_t.double().T).to(torch.int32)


def int8_gemm_plain(xq, wq_t, x_scale, w_scale, out_dtype=torch.float32):
    """acc * (x_scale * w_scale) in f32, cast to out_dtype; the raw s32
    accumulators when out_dtype is int32."""
    acc = int8_matmul_plain(xq, wq_t)
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * (x_scale[:, None] * w_scale.float()[None, :])).to(out_dtype)


def act_quant_matmul_plain(x, wq_t, w_scale, out_dtype=torch.float32):
    xq, x_scale = quantize_rows_plain(x)
    return int8_gemm_plain(xq, wq_t, x_scale, w_scale, out_dtype)


def quantize_grad_rows_plain(g: torch.Tensor, scale: torch.Tensor, ld: int | None = None):
    """g [M, N] f32 / bf16, scale [N] (or [E, N], one row a block of M / E
    rows) -> (gq [M, ld] int8, g_scale [M] f32): ``quantize_rows_plain`` of
    gs = f32(g) * scale (JAX's ``_act_quant_matmul_bwd`` int8 branch; the
    batched one of ``_act_quant_bmm_bwd``), columns N.. of the codes zero."""
    M, N = g.shape
    s = scale.float().reshape(-1, 1, N)
    gs = (g.float().reshape(s.shape[0], -1, N) * s).reshape(M, N)
    gq, g_scale = quantize_rows_plain(gs)
    return F.pad(gq, (0, (ld or N) - N)), g_scale


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def quant_plan(K: int, rows: int, elem_size: int, addrs=(), ld: int | None = None,
               n_scales: int = 0) -> tuple[int, int, int, int, int]:
    """(R, S, unit, warps, groups): the launch of a row quantizer
    (``csrc/w8a8.cu``) over ``rows`` rows of K elements of ``elem_size``
    bytes, its operands at the byte addresses ``addrs``, the codes' rows
    ``ld`` (default K) bytes apart; ``n_scales`` the dx's scale rows (0 for
    the activation rows). Chosen from the shape and the addresses alone:

    - the tile kernel (R rows a tile, S stages; unit, warps and groups 0)
      for a call of at least ``TILE_MIN_BYTES`` of bf16 rows or of the dx's
      rows, whose rows and bases are 16-byte multiples: R the largest of
      16, 8, .. 1 that leaves every SM a tile (of its scale row) and two
      stages within ``TILE_SMEM``, S as many stages as fit (at most 8);
    - else the row-group kernel (R, S 0): its vector instance (unit 16 /
      elem_size, 16-byte loads) on 16-byte rows and bases, its scalar one
      (unit 1) on any, a row to ceil(K / (32 * lane)) warps (at most 16; a
      lane holds ``VECTOR_LANE`` or ``SCALAR_LANE`` elements, and a wider
      row is read twice), groups enough to spread ``rows`` over the SMs
      within ``ROW_THREADS`` threads a block.

    f32 activation rows stay on the row-group kernel at every size: the
    tile kernel timed slower there (PERF.md, tools/torch_quant_bench.py)."""
    ld = K if ld is None else ld
    vector = K % 16 == 0 and ld % 16 == 0 and all(a % 16 == 0 for a in addrs)
    if vector and rows * K * elem_size >= TILE_MIN_BYTES and (elem_size == 2 or n_scales):
        fixed = K * 4 if n_scales else 0  # the dx's scale row, staged once a block
        row_bytes = K * elem_size
        per_scale = rows // max(n_scales, 1)  # the rows of one scale row
        want = max(1, SMS // max(n_scales, 1))  # its tiles: one an SM
        R = TILE_ROWS
        while R > 1 and (-(-per_scale // R) < want or fixed + 2 * R * row_bytes > TILE_SMEM):
            R //= 2
        S = min(TILE_STAGES, (TILE_SMEM - fixed) // (R * row_bytes))
        if S >= 1:
            return R, S, 0, 0, 0
    unit = 16 // elem_size if vector else 1
    warps = min(16, max(1, -(-K // (32 * (VECTOR_LANE if vector else SCALAR_LANE)))))
    groups = max(1, min(ROW_THREADS // (32 * warps), -(-rows // SMS)))
    return 0, 0, unit, warps, groups


@torch.library.custom_op("medtsllm::quantize_rows", mutates_args=(), device_types="cuda")
def _quantize_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's quantizer launch as a custom op (the wrapper has checked x)."""
    M, K = x.shape
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M:
        plan = quant_plan(K, M, x.element_size(), (x.data_ptr(), xq.data_ptr()))
        _build.launch("mt_act_quant_rows", x.device, _build.ptr(x),
                      int(x.dtype == torch.bfloat16), _build.ptr(xq), _build.ptr(x_scale),
                      M, K, *plan)
        quantize_rows.launches += 1
    return xq, x_scale


@_quantize_op.register_kernel("cpu")
def _(x):
    return tuple(_build.op_outputs(quantize_rows_plain(x), x))


@_quantize_op.register_fake
def _(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(x.shape[:-1], dtype=torch.float32))


def quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization of x [M, K] (f32 or bf16), through the
    op ``medtsllm::quantize_rows``. Counts CUDA launches in
    ``quantize_rows.launches``."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x) if _build.wants_grad(x) else _quantize_op(x)
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be [M, K] f32/bf16, got {tuple(x.shape)} {x.dtype}")
    _build.check_cuda(x, names="x")
    return _quantize_op(x)


quantize_rows.launches = 0


def quantize_grad_rows(g: torch.Tensor, scale: torch.Tensor, ld: int | None = None):
    """The dx's gradient rows: g [M, N] (f32 or bf16) times the channel
    scale [N] in f32, quantized per row -> (gq [M, ld] int8, columns N..
    zero; g_scale [M] f32). ``scale`` [E, N] gives each block of M / E rows
    its own row (the experts of the capacity MoE path). ``ld`` (>= N,
    default N) is the padded width of the GEMM that reads the codes. Counts
    CUDA launches in ``quantize_grad_rows.launches``."""
    M, N = g.shape
    ld = N if ld is None else ld
    n_scales = scale.numel() // N if scale.shape[-1:] == (N,) else 0
    if ld < N or scale.dim() > 2 or not n_scales or M % n_scales:
        raise ValueError(f"g {tuple(g.shape)}, scale {tuple(scale.shape)}, ld {ld}: scale "
                         "must be [N] or [E, N] with E dividing M, and ld >= N")
    if g.device.type == "cpu":
        return quantize_grad_rows_plain(g, scale, ld)
    if g.dtype not in (torch.float32, torch.bfloat16) or scale.dtype != torch.float32:
        raise ValueError(f"g must be f32/bf16 and scale f32, got {g.dtype}, {scale.dtype}")
    _build.check_cuda(g, scale, names="g scale")
    gq = torch.empty((M, ld), dtype=torch.int8, device=g.device)
    g_scale = torch.empty((M,), dtype=torch.float32, device=g.device)
    if M:
        plan = quant_plan(N, M, g.element_size(),
                          (g.data_ptr(), scale.data_ptr(), gq.data_ptr()), ld, n_scales)
        _build.launch("mt_grad_quant_rows", g.device, _build.ptr(g),
                      int(g.dtype == torch.bfloat16), _build.ptr(scale), _build.ptr(gq),
                      _build.ptr(g_scale), M, N, ld, M // n_scales, *plan)
        quantize_grad_rows.launches += 1
    return gq, g_scale


quantize_grad_rows.launches = 0


@torch.library.custom_op("medtsllm::w8a8_gemm", mutates_args=(), device_types="cuda")
def _gemm_op(xq: torch.Tensor, wq_t: torch.Tensor, x_scale: torch.Tensor,
             w_scale: torch.Tensor, out_kind: int) -> torch.Tensor:
    """K1's launch as a custom op (the wrapper has checked its operands'
    shapes; the addresses are read here)."""
    _build.check_aligned((xq, wq_t), "TMA reads rows 16-byte aligned: K % 16 == 0 and "
                         "16-byte aligned operands (pad_cols pads K)")
    M, K = xq.shape
    N = wq_t.shape[0]
    out = torch.empty((M, N), dtype=_KIND_DTYPE[out_kind], device=xq.device)
    _build.launch("mt_w8a8_gemm", xq.device, _build.ptr(xq), _build.ptr(wq_t),
                  _build.ptr(x_scale), _build.ptr(w_scale), _build.ptr(out),
                  out_kind, M, N, K)
    int8_gemm.launches += 1
    return out


@_gemm_op.register_kernel("cpu")
def _(xq, wq_t, x_scale, w_scale, out_kind):
    return _build.op_outputs(int8_gemm_plain(xq, wq_t, x_scale, w_scale,
                                             _KIND_DTYPE[out_kind]), xq, wq_t, x_scale,
                             w_scale)


@_gemm_op.register_fake
def _(xq, wq_t, x_scale, w_scale, out_kind):
    return xq.new_empty((xq.shape[0], wq_t.shape[0]), dtype=_KIND_DTYPE[out_kind])


def int8_gemm(xq, wq_t, x_scale, w_scale, out_dtype=torch.float32):
    """s8 [M, K] x s8 [N, K]^T with the fused rescale -> [M, N] f32/bf16,
    or the raw s32 accumulators when ``out_dtype`` is int32, through the op
    ``medtsllm::w8a8_gemm``. Counts CUDA launches in
    ``int8_gemm.launches``."""
    if xq.device.type == "cpu":
        if out_dtype not in _OUT_KIND or _build.wants_grad(x_scale, w_scale):
            return int8_gemm_plain(xq, wq_t, x_scale, w_scale, out_dtype)
        return _gemm_op(xq, wq_t, x_scale, w_scale, _OUT_KIND[out_dtype])
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    if xq.dtype != torch.int8 or wq_t.dtype != torch.int8:
        raise ValueError("xq and wq_t must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError("scales must be f32")
    _build.check_cuda(xq, wq_t, x_scale, w_scale, names="xq wq_t x_scale w_scale")
    M, K = xq.shape
    N, K2 = wq_t.shape
    if K != K2 or x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(f"shapes xq {tuple(xq.shape)} wq_t {tuple(wq_t.shape)} "
                         f"x_scale {tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)}")
    if K % K_ALIGN:
        raise ValueError("TMA reads rows 16-byte aligned: K % 16 == 0 and "
                         "16-byte aligned operands (pad_cols pads K)")
    return _gemm_op(xq, wq_t, x_scale, w_scale, _OUT_KIND[out_dtype])


int8_gemm.launches = 0


def int8_dx(g: torch.Tensor, w_kn: torch.Tensor, scale: torch.Tensor,
            out_dtype=torch.float32) -> torch.Tensor:
    """The int8 dx of ``llm.int8_backward`` (``_act_quant_matmul_bwd``'s int8
    branch): g [M, N] (f32 or bf16, taken at f32 as JAX's f32 cotangent),
    the weight's ``kn_weight`` copy [K, N16], the channel scale [N] ->
    ``(s32 acc of gq . W over N) * g_scale`` [M, K] at ``out_dtype`` (one
    rounding of JAX's f32 result). Two kernels on a CUDA tensor: the
    gradient rows' quantizer, then K1's GEMM with a unit channel scale."""
    K, ld = w_kn.shape
    gq, g_scale = quantize_grad_rows(g.contiguous(), scale.float().contiguous(), ld)
    return int8_gemm(gq, w_kn, g_scale, unit_scale(K, g.device), out_dtype)


def _act_quant_matmul(x, wq_t, w_scale, out_dtype):
    lead = x.shape[:-1]
    xq, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    if wq_t.shape[1] != xq.shape[1]:  # a weight padded to the GEMM's width
        xq = pad_cols(xq)
    y = int8_gemm(xq, wq_t, x_scale, w_scale.float().contiguous(), out_dtype)
    return y.reshape(*lead, -1)


def _dx(g, x_shape, x_dtype, wq_t, w_scale, w_kn):
    """The input gradient of a w8a8 / w4a8 projection: the int8 dx when the
    caller gave the ``[K, N]`` copy's maker ``w_kn``, else the
    straight-through ``(g * scale) @ W_q`` at g's dtype (``wq_t`` the int8
    [N, K'] weight, K' >= K: columns past K are padding)."""
    K = x_shape[-1]
    if w_kn is not None:
        out = x_dtype if x_dtype in (torch.float32, torch.bfloat16) else torch.float32
        dx = int8_dx(g.reshape(-1, g.shape[-1]), w_kn(), w_scale, out)
        return dx.reshape(x_shape).to(x_dtype)
    dx = (g * w_scale.to(g.dtype)) @ wq_t.to(g.dtype)
    return dx[..., :K].to(x_dtype)


class _ActQuantMatmul(torch.autograd.Function):
    """The custom_vjp of ``transformer.py::_act_quant_matmul``: the forward is
    K1; the backward is the straight-through estimator, the quantization
    taken as identity and the gradient sent through the dequantized weight,
    ``dx = (g * scale) @ W_q`` at g's dtype with the scale folded into g
    (O(M N), not O(K N)), a plain matmul as JAX leaves it to an XLA dot; or,
    given ``w_kn`` (``llm.int8_backward``), the int8 dx (``int8_dx``). The
    int8 weight and its scale are frozen: no gradient."""

    @staticmethod
    def forward(ctx, x, wq_t, w_scale, out_dtype, w_kn):
        ctx.save_for_backward(wq_t, w_scale)
        ctx.x_shape, ctx.x_dtype, ctx.w_kn = x.shape, x.dtype, w_kn
        return _act_quant_matmul(x, wq_t, w_scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        wq_t, w_scale = ctx.saved_tensors
        return _dx(g, ctx.x_shape, ctx.x_dtype, wq_t, w_scale, ctx.w_kn), None, None, None, None


def act_quant_matmul(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                     out_dtype=torch.float32, w_kn=None) -> torch.Tensor:
    """x [..., K] -> [..., N]: quantize rows, int8 GEMM, rescale (the
    transformer's w8a8 projection: two kernels on a CUDA tensor). ``wq_t``
    [N, K] or padded to [N, K16] (``pad_cols``). Differentiable in x when x
    requires grad: the straight-through estimator, or the int8 dx when
    ``w_kn`` (a function returning the weight's ``kn_weight`` copy) is
    given."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ActQuantMatmul.apply(x, wq_t, w_scale, out_dtype, w_kn)
    return _act_quant_matmul(x, wq_t, w_scale, out_dtype)
