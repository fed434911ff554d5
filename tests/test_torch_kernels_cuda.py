"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a card. This file imports only
torch and the port, so it also runs on a machine without jax:
``python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest``.
"""

import pytest
import torch
import torch.nn.functional as F

from medtsllm_tpu_torch.ops.kernels import _build
from medtsllm_tpu_torch.ops.kernels import flash_attention as k4
from medtsllm_tpu_torch.ops.kernels import grouped_matmul as gm
from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
from medtsllm_tpu_torch.ops.kernels import selective_scan as ss
from medtsllm_tpu_torch.ops.kernels import w4a8 as k5
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows_at(x: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of x whose base lies ``off`` elements past a 16-byte
    boundary (2 or 4 bytes for one bf16 / f32 element)."""
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape).copy_(x)


def _special_rows(x: torch.Tensor) -> torch.Tensor:
    """x with row 0 the half-way row (scale 1: 127, 2.5, -3.5, 0.5 -> 127, 2,
    -4, 0, round half to even), row 1 all zero and row 2 near the half-way
    points at another scale (x / scale within a few ulps of k + 0.5), where
    there is room."""
    M, K = x.shape
    if K >= 4:
        x[0] = 0
        x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    if M >= 2:
        x[1] = 0
    if M >= 3:
        j = torch.arange(K, device=x.device, dtype=torch.float32)
        x[2] = (torch.remainder(j * 37, 254) - 127 + 0.5) * 0.0123
        x[2, 0] = 127 * 0.0123
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("M,K,N", [(896, 4096, 4096), (37, 176, 72), (5, 64, 200),
                                   (16 * 48, 768, 768),   # t5 / bart cross k / v: B x P rows
                                   (16 * 32, 2048, 768),  # flan-t5-base's wo: B x L rows
                                   # mamba-130m's x_proj (N 80, under one 256-column
                                   # tile), in_proj, out_proj at B 48 x 144 rows;
                                   # mamba-tiny's x_proj (N 20)
                                   (6912, 1536, 80), (6912, 768, 3072), (6912, 1536, 768),
                                   (37, 128, 20),
                                   # the quantizer's ragged widths and row counts (M 1,
                                   # M not a multiple of a block's row groups); every
                                   # row-group width (K 1024 W - 48: W warps a row);
                                   # rows read twice (K > 16,384)
                                   (1, 1, 16), (133, 37, 24), (133, 40, 16), (1, 11008, 16),
                                   (3, 12288, 16), (3, 22016, 16),
                                   # >= 16 MiB of bf16 rows: the tile kernel, tiles of
                                   # 16, 8, 4, 2 and 1 rows (f32 on the row-group kernel)
                                   (8192, 1024, 16), (2048, 4096, 16), (896, 11008, 16),
                                   (400, 22016, 16), (168, 50000, 16)]
                         + [(137, 1024 * w - 48, 16) for w in range(2, 17)])
def test_w8a8_kernel_bit_equal(cuda, dtype, off, M, K, N):
    """Kernel vs plain on the card: quantizer, s32 and scaled bf16 output
    all bit-equal (same integer math, same f32 epilogue order), f32 and bf16
    rows, on a 16-byte aligned base and one element off it (the quantizer's
    scalar instance), with the half-way row and a zero row; one quantizer
    launch a call. K off 16 pads the weight and the codes with zero
    columns."""
    g = torch.Generator(cuda).manual_seed(0)
    x = _special_rows(torch.randn(M, K, device=cuda, generator=g)).to(dtype)
    x = _rows_at(x, off) if off else x
    wq = torch.randint(-127, 128, (N, K), device=cuda, dtype=torch.int8, generator=g)
    ws = torch.rand(N, device=cuda, generator=g) * 1e-3
    nq = k1.quantize_rows.launches
    xq, xs = k1.quantize_rows(x)
    assert k1.quantize_rows.launches == nq + 1
    R, _, unit, *_ = k1.quant_plan(K, M, x.element_size(), (x.data_ptr(), xq.data_ptr()))
    vector = R > 0 or unit == 16 // x.element_size()  # the tile kernel or 16-byte units
    assert vector == (K % 16 == 0 and not off)
    xq0, xs0 = k1.quantize_rows_plain(x)
    assert torch.equal(xq, xq0) and torch.equal(xs, xs0)
    if K >= 4:
        assert xq[0, :4].tolist() == [127, 2, -4, 0] and xs[0].item() == 1.0
    if M >= 2:
        assert not xq[1].any() and xs[1].item() == pytest.approx(1e-10)
    wp = k1.pad_cols(wq)
    assert torch.equal(k1.int8_gemm(k1.pad_cols(xq), wp, xs, ws, torch.int32),
                       k1.int8_matmul_plain(xq0, wq))
    nq, ng = k1.quantize_rows.launches, k1.int8_gemm.launches
    y = k1.act_quant_matmul(x, wp, ws, torch.bfloat16)
    assert (k1.quantize_rows.launches, k1.int8_gemm.launches) == (nq + 1, ng + 1)
    assert torch.equal(y, k1.act_quant_matmul_plain(x, wq, ws, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 40, 4096])
def test_quantizers_take_empty_rows(cuda, K):
    """[0, K] rows (f32 and bf16) launch nothing and return empty codes and
    scales, as the plain versions do."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.empty(0, K, device=cuda, dtype=dtype)
        nq, ng = k1.quantize_rows.launches, k1.quantize_grad_rows.launches
        xq, xs = k1.quantize_rows(x)
        gq, gs = k1.quantize_grad_rows(x, torch.ones(K, device=cuda), K + 16)
        torch.cuda.synchronize()
        assert (xq.shape, xs.shape, gq.shape, gs.shape) == ((0, K), (0,), (0, K + 16), (0,))
        assert (xq.dtype, gq.dtype, xs.dtype) == (torch.int8, torch.int8, torch.float32)
        assert (k1.quantize_rows.launches, k1.quantize_grad_rows.launches) == (nq, ng)


def _int8_operands(cuda, M, K, N, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    xq = torch.randint(-127, 128, (M, K), device=cuda, dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (N, K), device=cuda, dtype=torch.int8, generator=g)
    xs = torch.rand(M, device=cuda, generator=g) * 1e-2
    ws = torch.rand(N, device=cuda, generator=g) * 1e-3
    return xq, wq, xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (37, 176, 72), (129, 4096, 200),
                                   (896, 11008, 4096), (17024, 4096, 4096), (37, 176, 75),
                                   (2160, 2048, 5632), (2160, 5632, 2048)])
def test_w8a8_gemm_bit_equal_in_every_output_kind(cuda, M, K, N):
    """s32, f32 and bf16 outputs bit-equal to the plain version: K shorter
    than one 128-byte stage and K tails (64, 176), ragged M and N, the
    7B down projection and the long window's M; N 75 leaves output rows
    that are not 16-byte aligned (the epilogue's element-wise stores); the
    moe-8x1b train step's per-expert capacity shape (C = 2160 slots: gate
    and up, then down)."""
    xq, wq, xs, ws = _int8_operands(cuda, M, K, N)
    n = k1.int8_gemm.launches
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        assert torch.equal(k1.int8_gemm(xq, wq, xs, ws, dt),
                           k1.int8_gemm_plain(xq, wq, xs, ws, dt))
    assert k1.int8_gemm.launches == n + 3


@pytest.mark.cuda
def test_w8a8_gemm_on_expert_views_at_an_offset(cuda):
    """act_quant_bmm hands the GEMM per-expert views xq[e] of one [E, M, K]
    tensor, at e * M * K bytes from its start."""
    E, M, K, N = 3, 100, 176, 72
    xq, _, xs, _ = _int8_operands(cuda, E * M, K, N)
    xq = xq.reshape(E, M, K)
    w = [_int8_operands(cuda, 1, K, N, seed=e + 1)[1:4:2] for e in range(E)]
    for e, (wq, ws) in enumerate(w):
        assert xq[e].data_ptr() - xq.data_ptr() == e * M * K
        for dt in (torch.int32, torch.bfloat16):
            assert torch.equal(k1.int8_gemm(xq[e], wq, xs[e * M:(e + 1) * M], ws, dt),
                               k1.int8_gemm_plain(xq[e], wq, xs[e * M:(e + 1) * M], ws, dt))


@pytest.mark.cuda
def test_w8a8_gemm_rows_do_not_depend_on_m(cuda):
    """The first 37 rows of an M 896 product equal the M 37 product bit for
    bit (the cached and uncached serving batches rest on it)."""
    xq, wq, xs, ws = _int8_operands(cuda, 896, 4096, 4096)
    for dt in (torch.int32, torch.bfloat16):
        full = k1.int8_gemm(xq, wq, xs, ws, dt)
        assert torch.equal(full[:37], k1.int8_gemm(xq[:37].contiguous(), wq, xs[:37], ws, dt))


@pytest.mark.cuda
def test_w8a8_kernel_rejects_bad_input(cuda):
    xq = torch.zeros(4, 24, dtype=torch.int8, device=cuda)  # K % 16 != 0
    w = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    s = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        k1.int8_gemm(xq, w, s, torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        k1.quantize_rows(torch.zeros(4, 32, dtype=torch.float16, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(896, 4096, 4096), (896, 11008, 4096), (37, 160, 72),
                                   (5, 64, 200),
                                   # 4-bit mamba-130m (x_proj N 80, in_proj, out_proj)
                                   # and mamba-tiny's x_proj (N 20)
                                   (6912, 1536, 80), (6912, 768, 3072), (6912, 1536, 768),
                                   (37, 128, 20)])
def test_w4a8_kernel_bit_equal(cuda, M, K, N):
    """K5 vs plain on the card: s32, f32 and bf16 outputs bit-equal (the same
    integers, the same f32 epilogue order), and the act-quant chain launches
    K1's quantizer and K5 once each."""
    g = torch.Generator(cuda).manual_seed(0)
    xq = torch.randint(-127, 128, (M, K), device=cuda, dtype=torch.int8, generator=g)
    q = torch.randint(-8, 8, (N, K), device=cuda, dtype=torch.int8, generator=g)
    packed = k5.pack4_split(q)
    xs = torch.rand(M, device=cuda, generator=g) * 1e-2
    ws = torch.rand(N, device=cuda, generator=g) * 1e-2
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        assert torch.equal(k5.w4a8_gemm(xq, packed, xs, ws, dt),
                           k5.w4a8_matmul_plain(xq, packed, xs, ws, dt))
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    nq, n5 = k1.quantize_rows.launches, k5.w4a8_gemm.launches
    y = k5.act_quant_w4a8_matmul(x, packed, ws, torch.bfloat16)
    assert (k1.quantize_rows.launches, k5.w4a8_gemm.launches) == (nq + 1, n5 + 1)
    xq0, xs0 = k1.quantize_rows_plain(x)
    assert torch.equal(y, k5.w4a8_matmul_plain(xq0, packed, xs0, ws, torch.bfloat16))


def _int4_operands(cuda, M, K, N, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    xq = torch.randint(-127, 128, (M, K), device=cuda, dtype=torch.int8, generator=g)
    q = torch.randint(-8, 8, (N, K), device=cuda, dtype=torch.int8, generator=g)
    xs = torch.rand(M, device=cuda, generator=g) * 1e-2
    ws = torch.rand(N, device=cuda, generator=g) * 1e-2
    return xq, k5.pack4_split(q), xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 37, 129, 896, 6912])
@pytest.mark.parametrize("K,N", [(11008, 4096), (2080, 72), (4096, 200)])
def test_w4a8_gemm_bit_equal_in_every_output_kind(cuda, M, K, N):
    """s32, f32 and bf16 outputs bit-equal to the plain version at ragged M
    (one row to the MoE block's 6,912: partial 256-row tiles), N 72 / 200
    (partial 128-row weight tiles; 72 leaves bf16 rows that are not 16-byte
    aligned), the down projection's K / 2 = 5504 and K / 2 = 1040, which is
    not a multiple of the kernel's 128-byte step."""
    xq, packed, xs, ws = _int4_operands(cuda, M, K, N)
    n = k5.w4a8_gemm.launches
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        assert torch.equal(k5.w4a8_gemm(xq, packed, xs, ws, dt),
                           k5.w4a8_matmul_plain(xq, packed, xs, ws, dt))
    assert k5.w4a8_gemm.launches == n + 3


@pytest.mark.cuda
def test_w4a8_gemm_rows_do_not_depend_on_m(cuda):
    """The first 37 rows of an M 896 product equal the M 37 product bit for
    bit, as K1's do."""
    xq, packed, xs, ws = _int4_operands(cuda, 896, 4096, 4096)
    for dt in (torch.int32, torch.bfloat16):
        full = k5.w4a8_gemm(xq, packed, xs, ws, dt)
        assert torch.equal(full[:37], k5.w4a8_gemm(xq[:37].contiguous(), packed, xs[:37],
                                                   ws, dt))


@pytest.mark.cuda
def test_w4a8_kernel_rejects_bad_input(cuda):
    xq = torch.zeros(4, 48, dtype=torch.int8, device=cuda)  # K / 2 % 16 != 0
    w = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    s4, s8 = torch.ones(4, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        k5.w4a8_gemm(xq, w, s4, s8)
    with pytest.raises(ValueError):  # packed width is not K / 2
        k5.w4a8_gemm(torch.zeros(4, 64, dtype=torch.int8, device=cuda), w, s4, s8)
    with pytest.raises(ValueError):  # a view 8 bytes in: TMA needs 16-byte alignment
        big = torch.zeros(5 * 64 + 8, dtype=torch.int8, device=cuda)
        k5.w4a8_gemm(big[8:].view(5, 64)[:4], torch.zeros(8, 32, dtype=torch.int8,
                                                          device=cuda), s4, s8)
    with pytest.raises(ValueError):  # K past the s32 accumulator's range
        K = k5.MAX_K + 32
        k5.w4a8_gemm(torch.zeros(1, K, dtype=torch.int8, device=cuda),
                     torch.zeros(8, K // 2, dtype=torch.int8, device=cuda),
                     torch.ones(1, device=cuda), s8)
    with pytest.raises(ValueError):  # scales must be f32
        k5.w4a8_gemm(torch.zeros(4, 64, dtype=torch.int8, device=cuda),
                     torch.zeros(8, 32, dtype=torch.int8, device=cuda), s4.half(), s8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KV,D,P,PB", [
    (8, 112, 32, 32, 128, 48, 1),  # the 7B serving shape (G 1)
    (2, 40, 8, 2, 64, 13, 2),      # GQA, per-row prefix, P % 16 != 0
    (1, 48, 32, 32, 128, 0, 1),    # prefill: no prefix
    (48, 144, 32, 4, 64, 14, 1),   # the moe-8x1b serving shape (G 8)
    (8, 37, 32, 4, 64, 0, 1),      # the moe-8x1b head prefill (G 8, P 0)
    (3, 17, 16, 2, 64, 5, 3),      # G 8, L 17, PB = B
    (2, 1, 8, 2, 128, 9, 1),       # one query (G 4)
    (2, 15, 8, 8, 64, 0, 1),       # L 15 < one tile, KV = H
    (2, 113, 8, 1, 128, 20, 2),    # G 8, L 113, PB = B; 133 keys: a partial last tile
    (2, 144, 16, 4, 128, 30, 2),   # G 4, PB = B
    (1, 2011, 4, 4, 128, 37, 1),   # 2048 keys, K2's limit
    (1, 1000, 8, 1, 64, 48, 1),    # 1048 keys, G 8
    (16, 64, 32, 32, 128, 32, 16),  # ecgmit-seg.toml's clip shape: per-clip head rows
    # the covariate modes: a row per channel (independent, merge-end on
    # ecgmit-seg's 2 features: the bank's rows repeated, PB = B * C; on
    # bidmc's 3, the constant head), C tokens a patch (interleave)
    (32, 64, 32, 32, 128, 32, 32),
    (48, 64, 32, 32, 128, 14, 1),
    (16, 128, 32, 32, 128, 14, 1),
    (16, 110, 32, 32, 128, 53, 1),  # ecgmit-seg-examples.toml: [prompt | example | post | ts]
])
def test_rope_attention_kernel_vs_plain(cuda, dtype, B, L, H, KV, D, P, PB):
    g = torch.Generator(cuda).manual_seed(0)

    def r(*s):
        return torch.randn(*s, device=cuda, generator=g).to(dtype)

    q, k, v = r(B, L, H, D), r(B, L, KV, D), r(B, L, KV, D)
    pk, pv = (r(PB, KV, P, D), r(PB, KV, P, D)) if P else (None, None)
    cos, sin = k2.rope_tables(torch.arange(P, P + L, device=cuda), D, 10000.0)
    n = k2.rope_attention.launches
    out = k2.rope_attention(q, k, v, cos, sin, pk, pv)
    assert k2.rope_attention.launches == n + 1
    ref = k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)
    assert torch.isfinite(out).all()
    if dtype == torch.float32:  # summation order only
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return
    # bf16: the kernel rounds each rotation once, the plain version after
    # each of its three ops, so q and k differ by a bf16 ulp here and there
    # and scores, probabilities and outputs by a few bf16 ulps (2^-8): every
    # element within 2^-6 (1 + |ref|). That rounding alone moves some rows
    # of a long average past 2^-6 of their own max (the worst row's share is
    # printed), so each query row is also held within 2^-6 x its max against
    # the plain version fed the kernel's once-rounded rotation (an element
    # bound alone would pass a wrong row that averages many keys, as K4's
    # checks found)
    tol = 2 ** -6
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    print(f"worst query row against the plain version at {_row_share(out, ref):.4f} of "
          "2^-6 x its max")
    ones, zeros = torch.ones_like(cos), torch.zeros_like(sin)  # the identity rotation
    ref1 = k2.rope_attention_plain(k4.rope_once(q, cos, sin), k4.rope_once(k, cos, sin), v,
                                   ones, zeros, pk, pv)
    assert _row_share(out, ref1) <= 1


def _row_share(out, ref):
    """The largest, over query rows, of a row's max |out - ref| in 2^-6 x
    max |ref| of that row."""
    err = (out.float() - ref.float()).abs().amax(-1)
    return (err / (2 ** -6 * ref.float().abs().amax(-1)).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KV,D,P", [
    (8, 112, 32, 32, 128, 37),  # the 7B serving shape, fused q|k|v (row pitch 12288)
    (2, 40, 8, 2, 64, 13),      # GQA: [H*D | KV*D | KV*D] unequal slices
    (3, 1, 8, 2, 128, 5),       # one query: the pitch from the batch stride
])
def test_rope_attention_reads_fused_projection_views(cuda, dtype, B, L, H, KV, D, P):
    """q, k and v as column views of one fused projection output [B, L,
    (H + 2 KV) D]: the kernel reads them in place (their row pitch), bit-
    equal to its launch on their dense copies."""
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn(B, L, (H + 2 * KV) * D, device=cuda, generator=g).to(dtype)
    q, k, v = qkv.split((H * D, KV * D, KV * D), dim=-1)
    q, k, v = q.reshape(B, L, H, D), k.reshape(B, L, KV, D), v.reshape(B, L, KV, D)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    pk = torch.randn(1, KV, P, D, device=cuda, generator=g).to(dtype)
    pv = torch.randn(1, KV, P, D, device=cuda, generator=g).to(dtype)
    cos, sin = k2.rope_tables(torch.arange(P, P + L, device=cuda), D, 10000.0)
    n = k2.rope_attention.launches
    out = k2.rope_attention(q, k, v, cos, sin, pk, pv)
    assert k2.rope_attention.launches == n + 1 and out.is_contiguous()
    dense = k2.rope_attention(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin, pk, pv)
    assert torch.equal(out, dense)


@pytest.mark.cuda
def test_rope_attention_refuses_layouts_it_cannot_read(cuda):
    """A layout the kernel cannot read raises a ValueError naming the
    tensor: heads apart (a [B, H, L, D] tensor transposed), a strided head
    dim, a row pitch off 16 bytes, non-contiguous tables or prefix."""
    B, L, H, D = 2, 8, 4, 64
    dense = torch.zeros(B, L, H, D, device=cuda, dtype=torch.bfloat16)
    cos = torch.zeros(L, D // 2, device=cuda)
    heads_apart = torch.zeros(B, H, L, D, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="^q "):
        k2.rope_attention(heads_apart, dense, dense, cos, cos)
    strided_d = torch.zeros(B, L, H, 2 * D, device=cuda, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="^k "):
        k2.rope_attention(dense, strided_d, dense, cos, cos)
    # a column view whose rows are 4 elements (8 bytes) past a 16-byte pitch
    odd = torch.zeros(B, L, H * D + 4, device=cuda, dtype=torch.bfloat16)[..., :H * D]
    with pytest.raises(ValueError, match="^v: .*16 bytes"):
        k2.rope_attention(dense, dense, odd.reshape(B, L, H, D), cos, cos)
    with pytest.raises(ValueError, match="^cos "):
        k2.rope_attention(dense, dense, dense, torch.zeros(D // 2, L, device=cuda).T, cos)
    pk = torch.zeros(1, H, D, 3, device=cuda, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="^pk "):
        k2.rope_attention(dense, dense, dense, cos, cos, pk, pk)


@pytest.mark.cuda
def test_rope_attention_kernel_rejects_bad_input(cuda):
    q = torch.zeros(1, 4, 2, 32, device=cuda)  # D = 32 has no instance
    cos = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError):
        k2.rope_attention(q, q, q, cos, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,L,S,D,causal", [
    (8, 32, 32, 2128, 2165, 128, True),  # the long window: prefix + region
    (8, 32, 32, 2165, 2165, 128, True),  # uncached, L == S
    (2, 32, 4, 300, 2165, 64, True),     # GQA 32 / 4 x 64
    (2, 8, 2, 100, 333, 128, False),     # non-causal, partial last k-tile
    (3, 4, 2, 40, 40, 64, True),         # the first k-tile is partial
    (1, 2, 1, 1, 1, 128, True),          # one query, one key
    (16, 12, 12, 512, 512, 64, True),    # gpt2 at JAX's 512-token gate
    (16, 12, 12, 576, 768, 64, True),    # gpt2's region after a 192-token prefix
    (2, 8, 8, 512, 512, 256, True),      # pythia-1b's heads (d 2048 / 8): 64-key tiles
    (2, 8, 8, 300, 1024, 256, True),     # D 256, a prefix ahead, partial q tile
    (2, 8, 2, 100, 333, 256, False),     # D 256, GQA, non-causal, partial k-tile
    (2, 12, 12, 512, 768, 192, True),    # D 192 (e.g. d 2304 / 12)
    (3, 4, 2, 40, 40, 192, True),        # D 192, the first k-tile partial
    (8, 8, 8, 512, 768, 384, True),      # wide heads: two column passes of 192
    (8, 8, 8, 512, 768, 512, True),
    (2, 8, 2, 100, 333, 512, False),     # D 512, GQA, non-causal, partial k-tile
    (3, 4, 2, 40, 40, 320, True),        # D 320: a short second pass
    (2, 4, 4, 70, 90, 448, True),        # D 448, partial q and k tiles
    (2, 4, 4, 512, 768, 576, True),      # D 576: three 192-column passes
    (2, 8, 2, 100, 333, 640, False),     # D 640, GQA, non-causal, partial k-tile
    (2, 4, 4, 70, 90, 768, True),        # D 768, partial q and k tiles
    (1, 4, 1, 200, 520, 1024, True),     # D 1024, GQA 4 / 1, a prefix, partial tiles
])
def test_flash_attention_kernel_vs_plain(cuda, dtype, B, H, KV, L, S, D, causal):
    g = torch.Generator(cuda).manual_seed(0)

    def r(*s):
        return torch.randn(*s, device=cuda, generator=g).to(dtype)

    q, k, v = r(B, H, L, D), r(B, KV, S, D), r(B, KV, S, D)
    n = k4.flash_attention.launches
    out = k4.flash_attention(q, k, v, causal)
    assert k4.flash_attention.launches == n + 1
    ref = k4.flash_attention_plain(q, k, v, causal)
    assert torch.isfinite(out).all()
    # f32: summation order and the online softmax; bf16: the kernel
    # normalises after PV, the plain version before the cast: a bf16 ulp or
    # so of the row's largest output, so each query row within 2^-6 x max
    # |ref| of that row (a row that sees few keys has outputs tens of times
    # larger than one that averages thousands: one bound for the tensor
    # would pass a wrong row of the second kind)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err = (out.float() - ref.float()).abs().amax(-1)
        assert (err <= 2 ** -6 * ref.float().abs().amax(-1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,S,causal,route", [
    (512, 512, True, "k4"),      # bart's decoder self-attention at 512 patches
    (512, 48, False, "plain"),   # its cross-attention into a 48-token prompt
    (512, 256, False, "k4"),     # into a 256-token prompt: JAX's gate sends it to K4
    (256, 512, False, "k4"),     # a 512-token encoder read by 256 decoder rows
])
def test_dispatch_attention_at_encdec_shapes(cuda, dtype, L, S, causal, route):
    """The encoder-decoders' attention through JAX's dispatcher at bart-base's
    heads (B 16, H 12, D 64): K4 where the gate sends it, causal or not,
    against the plain version (f32 1e-5; bf16 per query row, 2^-6 x its
    max); with t5's additive bias never K4 (JAX's reference path)."""
    g = torch.Generator(cuda).manual_seed(5)
    q = torch.randn(16, 12, L, 64, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(16, 12, S, 64, device=cuda, generator=g).to(dtype) for _ in range(2))
    assert k4.attention_route(L, S, 64, causal) == route
    n = k4.flash_attention.launches
    out = k4.dispatch_attention(q, k, v, causal=causal)
    assert k4.flash_attention.launches == n + (route != "plain")
    ref = k4.flash_attention_plain(q, k, v, causal)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert _row_share(out, ref) <= 1
    bias = torch.randn(1, 12, L, S, device=cuda, generator=g)
    n = k4.flash_attention.launches
    out = k4.dispatch_attention(q, k, v, causal=causal, sm_scale=1.0, bias=bias)
    assert k4.flash_attention.launches == n
    assert torch.equal(out, k4.flash_attention_plain(q, k, v, causal, 1.0, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [192, 256, 320, 384, 448, 512, 576, 1024])
def test_dispatch_attention_takes_k4_at_wide_heads(cuda, D):
    """Every head dim JAX's gate sends to its kernel runs on K4: D 192 to
    1024 from 512 tokens launch K4 (f32 and bf16) and agree with the plain
    version (f32 1e-5; bf16 per query row, 2^-6 x its max)."""
    g = torch.Generator(cuda).manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 4, 512, D, device=cuda, generator=g).to(dtype)
                   for _ in range(3))
        assert k4.attention_route(512, 512, D, True) == "k4"
        n = k4.flash_attention.launches
        out = k4.dispatch_attention(q, k, v, causal=True)
        assert k4.flash_attention.launches == n + 1
        ref = k4.flash_attention_plain(q, k, v, True)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        else:
            assert _row_share(out, ref) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("L,route", [(1000, "k4-padded"), (1024, "k4"), (300, "plain")])
def test_dispatch_attention_routes_on_the_card(cuda, L, route):
    """JAX's dispatcher as ported, at gpt2's head dim: K4 launched on the
    padded (1000 -> 1024) and the aligned route, not below 512 tokens; f32
    within 1e-5 of the plain version."""
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 12, L, 64, device=cuda, generator=g) for _ in range(3))
    assert k4.attention_route(L, L, 64, True) == route
    n = k4.flash_attention.launches
    out = k4.dispatch_attention(q, k, v, causal=True)
    assert k4.flash_attention.launches == n + (route != "plain")
    torch.testing.assert_close(out, k4.flash_attention_plain(q, k, v, True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_act_quant_bmm_trains_through_k1(cuda):
    """The capacity experts' matmul with a gradient: K1's quantizer once and
    its GEMM per expert, bit-equal to the plain forward; the backward the
    straight-through ``(g * scale) @ W_q``."""
    from medtsllm_tpu_torch.models.llm.transformer import act_quant_bmm

    g = torch.Generator(cuda).manual_seed(3)
    E, C, K, N = 8, 2160, 2048, 256
    h = torch.randn(E, C, K, device=cuda, generator=g).requires_grad_()
    wq = torch.randint(-127, 128, (E, N, K), device=cuda, dtype=torch.int8, generator=g)
    scale = torch.rand(E, N, device=cuda, generator=g) * 1e-3
    nq, ng = k1.quantize_rows.launches, k1.int8_gemm.launches
    y = act_quant_bmm(h, wq, scale)
    assert (k1.quantize_rows.launches, k1.int8_gemm.launches) == (nq + 1, ng + E)
    with torch.no_grad():
        xq, xs = k1.quantize_rows_plain(h.reshape(E * C, K))
        want = torch.stack([k1.int8_gemm_plain(xq.reshape(E, C, K)[e], wq[e],
                                               xs.reshape(E, C)[e], scale[e])
                            for e in range(E)])
    assert torch.equal(y, want)
    cot = torch.randn(E, C, N, device=cuda, generator=g)
    y.backward(cot)
    assert torch.equal(h.grad, torch.bmm(cot * scale[:, None, :], wq.float()))


@pytest.mark.cuda
def test_flash_attention_kernel_reads_its_own_batch_row(cuda):
    """GQA indexing: NaN in batch 1's K/V must not reach batch 0."""
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(2, 8, 70, 64, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 2, 130, 64, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 2, 130, 64, device=cuda, generator=g).to(torch.bfloat16)
    k[1], v[1] = float("nan"), float("nan")
    out = k4.flash_attention(q, k, v)
    assert torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[:1], k4.flash_attention(q[:1], k[:1], v[:1]),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_bad_input(cuda):
    z = torch.zeros
    with pytest.raises(ValueError, match="D % 64"):  # head dim 80: no multiple of 64
        k4.flash_attention(z(1, 2, 4, 80, device=cuda), z(1, 2, 4, 80, device=cuda),
                           z(1, 2, 4, 80, device=cuda))
    with pytest.raises(ValueError):  # mixed dtypes
        k4.flash_attention(z(1, 2, 4, 64, device=cuda),
                           z(1, 2, 4, 64, device=cuda, dtype=torch.bfloat16),
                           z(1, 2, 4, 64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # 3 kv heads do not divide 4
        k4.flash_attention(z(1, 4, 4, 64, device=cuda), z(1, 3, 4, 64, device=cuda),
                           z(1, 3, 4, 64, device=cuda))
    with pytest.raises(ValueError):  # not contiguous
        q = z(1, 4, 2, 64, device=cuda).transpose(1, 2)
        k4.flash_attention(q, z(1, 2, 4, 64, device=cuda), z(1, 2, 4, 64, device=cuda))
    with pytest.raises(ValueError):  # causal with more queries than keys
        k4.flash_attention(z(1, 2, 8, 64, device=cuda), z(1, 2, 4, 64, device=cuda),
                           z(1, 2, 4, 64, device=cuda))


# (B, L, H, KV, D, P, PB): the long window's served shape (cached, 39-token
# head) and its uncached form (L == S); GQA 32 / 4 x 64 with the head; a
# per-row prefix (PB = B); L and S no multiple of 64 or 128; one query
_ROUTE_SHAPES = [(8, 2128, 32, 32, 128, 39, 1),
                 (8, 2167, 32, 32, 128, 0, 1),
                 (2, 300, 32, 4, 64, 37, 1),
                 (3, 130, 8, 2, 128, 13, 3),
                 (2, 45, 8, 4, 64, 37, 2),
                 (1, 1, 2, 1, 128, 0, 1)]


def _route_operands(cuda, dtype, B, L, H, KV, D, P, PB, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)

    def r(*s):
        return torch.randn(*s, device=cuda, generator=g).to(dtype)
    q, k, v = r(B, L, H, D), r(B, L, KV, D), r(B, L, KV, D)
    pk, pv = (r(PB, KV, P, D), r(PB, KV, P, D)) if P else (None, None)
    cos, sin = k2.rope_tables(torch.arange(P, P + L, device=cuda), D, 10000.0)
    return q, k, v, cos, sin, pk, pv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KV,D,P,PB", _ROUTE_SHAPES)
def test_rope_flash_attention_kernel_vs_plain(cuda, dtype, B, L, H, KV, D, P, PB):
    """The long-window route (pre-pass + K4 with q rotated at load) in three
    parts: the rotation (the pre-pass's keys and values bit-equal to its
    plain version, one rounding; the route's output bit-equal to the JAX
    interface's K4 fed q rotated the same way, so q's in-kernel rotation is
    that rotation), the attention on those rotated inputs (each query row
    within 2^-6 x its max against the plain version), and the whole route
    against its plain version, which rotates with torch's bf16 ops (three
    roundings): K2's bound, 2^-6 x the output's max. f32: 1e-5."""
    q, k, v, cos, sin, pk, pv = _route_operands(cuda, dtype, B, L, H, KV, D, P, PB)
    n = (k4.rope_flash_attention.launches, k4.rope_flash_keys.launches)
    out = k4.rope_flash_attention(q, k, v, cos, sin, pk, pv)
    assert (k4.rope_flash_attention.launches, k4.rope_flash_keys.launches) == (n[0] + 1,
                                                                               n[1] + 1)
    assert out.shape == (B, L, H, D) and out.is_contiguous() and torch.isfinite(out).all()
    keys, values = k4.rope_flash_keys(k, v, cos, sin, pk, pv)
    keys0, values0 = k4.rope_flash_keys_plain(k, v, cos, sin, pk, pv)
    assert torch.equal(keys, keys0) and torch.equal(values, values0)
    ref = k4.rope_flash_attention_plain(q, k, v, cos, sin, pk, pv)
    if dtype == torch.float32:  # summation order and the online softmax only
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return
    qr = k4.rope_once(q, cos, sin).transpose(1, 2).contiguous()
    same = k4.flash_attention(qr, keys, values).transpose(1, 2)
    assert torch.equal(out, same)
    ref1 = k4.flash_attention_plain(qr, keys, values).transpose(1, 2)
    print(f"worst query row at {_row_share(out, ref1):.4f} of 2^-6 x its max against the "
          f"plain attention on the same rotation, {_row_share(out, ref):.4f} against the "
          "plain route")
    assert _row_share(out, ref1) <= 1
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_flash_attention_prefill_returns_the_attended_bits(cuda, dtype):
    """A prefill on the fused route returns the pre-pass's own rotated keys
    and values, so a batch served from that cache attends with the bits the
    uncached call did: its query rows are bit-equal to the same rows of the
    uncached call over [head | region]."""
    B, P, L, H, KV, D = 2, 37, 200, 8, 2, 128
    ops = _route_operands(cuda, dtype, B, P + L, H, KV, D, 0, 1, seed=3)[:5]
    full = k4.rope_flash_attention(*ops)
    head_ops = [t[:, :P].contiguous() for t in ops[:3]] + [t[:P].contiguous() for t in ops[3:]]
    tail_ops = [t[:, P:].contiguous() for t in ops[:3]] + [t[P:].contiguous() for t in ops[3:]]
    head, (kh, vh) = k4.rope_flash_attention(*head_ops, return_kv=True)
    keys, values = k4.rope_flash_keys(*head_ops[1:])
    assert torch.equal(kh, keys) and torch.equal(vh, values)
    assert kh.shape == (B, KV, P, D)
    tail, (kt, vt) = k4.rope_flash_attention(*tail_ops, kh, vh, return_kv=True)
    keys, values = k4.rope_flash_keys(*tail_ops[1:], kh, vh)
    assert torch.equal(kt, keys[:, :, P:]) and torch.equal(vt, values[:, :, P:])
    assert torch.equal(head, full[:, :P]) and torch.equal(tail, full[:, P:])


@pytest.mark.cuda
def test_rope_flash_attention_kernel_rejects_bad_input(cuda):
    q, k, v, cos, sin, pk, pv = _route_operands(cuda, torch.bfloat16, 2, 40, 8, 2, 64, 5, 1)
    with pytest.raises(ValueError):  # a transposed (strided) q
        k4.rope_flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, cos,
                                sin)
    with pytest.raises(ValueError):  # q off the 16-byte boundary
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
        k4.rope_flash_attention(buf[1:].view(q.shape), k, v, cos, sin)
    with pytest.raises(ValueError):  # bf16 tables
        k4.rope_flash_attention(q, k, v, cos.bfloat16(), sin.bfloat16())
    with pytest.raises(ValueError):  # a prefix of 3 rows for a batch of 2
        k4.rope_flash_attention(q, k, v, cos, sin, pk.expand(3, -1, -1, -1).contiguous(),
                                pv.expand(3, -1, -1, -1).contiguous())
    with pytest.raises(ValueError):  # head dim 80 has no instance
        z = torch.zeros(1, 4, 2, 80, device=cuda, dtype=torch.bfloat16)
        k4.rope_flash_attention(z, z, z, torch.zeros(4, 40, device=cuda),
                                torch.zeros(4, 40, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,E,S", [
    (8, 32, 8, 128, 1024), (3, 20, 4, 64, 100), (2, 7, 2, 32, 33),
    (8, 32, 8, 128, 1025),    # llama rows, nine splits, the last holding one key
    (48, 32, 8, 64, 1024),    # Mamba and MoE: two splits
    (8, 2048, 8, 128, 1024),  # the long window: no split
    (5, 13, 8, 128, 1024),    # B * L = 65 rows: a partial row tile, 16 splits
    (3, 7, 2, 32, 100),       # a partial second key tile, two splits
    (7, 9, 8, 64, 1025),
    (16, 14, 8, 64, 1024),    # ecgmit-seg-examples.toml's example: 14 patches
    (32, 32, 8, 64, 1024),    # a row per channel: B * C = 16 x 2
])
def test_reprogramming_kernel_vs_plain(cuda, B, L, H, E, S):
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(B, L, H, E, device=cuda, generator=g)
    k = torch.randn(S, H, E, device=cuda, generator=g)
    v = torch.randn(S, H, E, device=cuda, generator=g)
    n = k3.reprogramming_attention.launches
    out = k3.reprogramming_attention(q, k, v)
    assert k3.reprogramming_attention.launches == n + 1
    # f32: online vs two-pass softmax and summation order
    torch.testing.assert_close(out, k3.reprogramming_attention_plain(q, k, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_reprogramming_split_rule_matches_the_kernels(cuda):
    """The launcher's split count (which sizes the wrapper's scratch) is
    split_plan's, the CPU reference's rule: across the 264-block edge, one
    key tile to many, the serving shapes."""
    lib = _build.library()
    for rows in (1, 14, 64, 65, 256, 1056, 1057, 1536, 2112, 16384):
        for heads in (1, 2, 8, 32):
            for keys in (1, 33, 64, 100, 1000, 1024, 1025, 4096):
                assert lib.mt_reprogramming_splits(rows, heads, keys) == \
                    k3.split_plan(rows, heads, keys)[0], (rows, heads, keys)


@pytest.mark.cuda
def test_reprogramming_kernel_rejects_misaligned_views(cuda):
    """q, k and v are read as 16-byte vectors: a contiguous view one float
    from an aligned start raises instead of faulting on the card."""
    B, L, H, E, S = 2, 3, 2, 32, 40
    q = torch.randn(B, L, H, E, device=cuda)
    k = torch.randn(S, H, E, device=cuda)

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, device=cuda)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    for args in ((shifted(q), k, k), (q, shifted(k), k), (q, k, shifted(k))):
        assert args[0].is_contiguous() and args[1].is_contiguous()
        with pytest.raises(ValueError):
            k3.reprogramming_attention(*args)
    torch.testing.assert_close(k3.reprogramming_attention(q, k, k),
                               k3.reprogramming_attention_plain(q, k, k), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,E,N,h0_rows,final", [
    (48, 144, 1536, 16, 1, False),  # the Mamba serving shape, cached head
    (48, 158, 1536, 16, 0, False),  # the same, uncached
    (1, 14, 1536, 16, 0, True),     # the prefill of the prompt head
    (2, 37, 128, 4, 0, False),
    (2, 37, 200, 8, 2, True),       # E not a multiple of the block, batch-B h0
    (3, 1, 128, 8, 1, True),        # L = 1
])
def test_selective_scan_kernel_vs_plain(cuda, B, L, E, N, h0_rows, final):
    g = torch.Generator(cuda).manual_seed(0)

    def r(*s):
        return torch.randn(*s, device=cuda, generator=g)

    dt, xs = r(B, L, E).abs() * 0.1, r(B, L, E)
    A_T, Bs, Cs, D = -r(N, E).abs(), r(B, L, N), r(B, L, N), r(E)
    h0 = r(h0_rows, N, E) if h0_rows else None
    y0, hf0 = ss.selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, D, h0)
    counts = (ss.selective_ssm.launches, ss.selective_ssm_h0.launches,
              ss.selective_ssm_final.launches)
    if final:
        y, hf = ss.selective_ssm_final(dt, A_T, Bs, Cs, xs, D, h0)
        assert ss.selective_ssm_final.launches == counts[2] + 1
        torch.testing.assert_close(hf, hf0, rtol=1e-5, atol=1e-5 * hf0.abs().max().item())
    elif h0 is not None:
        y = ss.selective_ssm_h0(dt, A_T, Bs, Cs, xs, D, h0)
        assert ss.selective_ssm_h0.launches == counts[1] + 1
    else:
        y = ss.selective_ssm(dt, A_T, Bs, Cs, xs, D)
        assert ss.selective_ssm.launches == counts[0] + 1
    assert sum((ss.selective_ssm.launches, ss.selective_ssm_h0.launches,
                ss.selective_ssm_final.launches)) == sum(counts) + 1
    # f32 with expf: fused multiply-adds and the order of the N-sum only
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5 * y0.abs().max().item())


@pytest.mark.cuda
def test_selective_scan_kernel_rejects_bad_input(cuda):
    def z(*s, dtype=torch.float32):
        return torch.zeros(*s, device=cuda, dtype=dtype)

    with pytest.raises(ValueError, match="state size"):  # N = 5 has no instance
        ss.selective_ssm(z(1, 4, 32), z(5, 32), z(1, 4, 5), z(1, 4, 5), z(1, 4, 32), z(32))
    with pytest.raises(ValueError, match="f32"):
        ss.selective_ssm(z(1, 4, 32, dtype=torch.bfloat16), z(4, 32), z(1, 4, 4),
                         z(1, 4, 4), z(1, 4, 32), z(32))
    with pytest.raises(ValueError, match="h0"):
        ss.selective_ssm_h0(z(2, 4, 32), z(4, 32), z(2, 4, 4), z(2, 4, 4), z(2, 4, 32),
                            z(32), z(3, 4, 32))


def _scan_operands(cuda, B, L, E, N, h0_rows):
    g = torch.Generator(cuda).manual_seed(0)

    def r(*s):
        return torch.randn(*s, device=cuda, generator=g)

    dt, xs = r(B, L, E).abs() * 0.1, r(B, L, E)
    A_T, Bs, Cs, D = -r(N, E).abs() * N, r(B, L, N), r(B, L, N), r(E)
    h0 = r(h0_rows, N, E) if h0_rows else None
    return dt, A_T, Bs, Cs, xs, D, h0, r(B, L, E)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,E,N,h0_rows,chunk", [
    (48, 144, 1536, 16, 1, 16),  # the Mamba train shape, cached head
    (48, 158, 1536, 16, 0, 16),  # the same, uncached
    (2, 37, 200, 8, 2, 8),       # E not a multiple of the block, batch-B h0
    (3, 5, 128, 4, 0, 16),       # one partial chunk
])
def test_selective_scan_bounds_and_bwd_vs_plain(cuda, B, L, E, N, h0_rows, chunk):
    """K9 (y and the chunk-start states) and K10 (all five outputs) against
    their plain versions at 1e-4 x max |plain| (f32 with expf: the order of
    the sums over n and e, and fused multiply-adds)."""
    dt, A_T, Bs, Cs, xs, D, h0, g = _scan_operands(cuda, B, L, E, N, h0_rows)
    n9, n10 = ss.selective_ssm_bounds.launches, ss.selective_ssm_bwd.launches
    y, hb = ss.selective_ssm_bounds(dt, A_T, Bs, Cs, xs, D, h0, chunk)
    y0, hb0 = ss.selective_ssm_bounds_plain(dt, A_T, Bs, Cs, xs, D, h0, chunk)
    assert hb.shape == (B, -(-L // chunk), N, E)
    for got, want in ((y, y0), (hb, hb0)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())
    got = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb0, chunk)
    want = ss.selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, g, hb0, chunk)
    assert (ss.selective_ssm_bounds.launches, ss.selective_ssm_bwd.launches) == (n9 + 1, n10 + 1)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())
    # A frozen: the kernel skips dA_T and the rest is unchanged; bit-stable
    again = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb0, chunk, need_dA=False)
    assert again[4] is None
    for a, b in zip(again[:4], got[:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,E,N,chunk", [
    (4, 1, 200, 16, 16),    # one token
    (4, 15, 200, 8, 16),    # under one sub-chunk
    (4, 17, 96, 4, 16),     # one token past it
    (48, 144, 1536, 16, 16),  # the Mamba train shape
    (3, 40, 72, 16, 32),    # a recorded chunk longer than the kernel's sub-chunk
    (2, 37, 200, 8, 8),     # a short recorded chunk
])
def test_selective_scan_bwd_edges_and_bits(cuda, B, L, E, N, chunk):
    """K10 against its plain version (1e-4 x max |plain| per output) at the
    sequence edges of its 16-token sub-chunks, E no multiple of its block
    (512 / N channels), N 4 / 8 / 16, with and without dA_T; two calls give
    the same bits (no float atomics); the slab count the C side reports
    matches the Python rule."""
    dt, A_T, Bs, Cs, xs, D, h0, g = _scan_operands(cuda, B, L, E, N, 1)
    _, hb = ss.selective_ssm_bounds_plain(dt, A_T, Bs, Cs, xs, D, h0, chunk)
    got = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb, chunk)
    want = ss.selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, g, hb, chunk)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())
    again = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb, chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    frozen = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb, chunk, need_dA=False)
    assert frozen[4] is None and all(torch.equal(a, b) for a, b in zip(got[:4], frozen[:4]))
    assert _build.library().mt_selective_scan_bwd_slabs(E, N) == -(-E // ss.bwd_block_channels(N))


@pytest.mark.cuda
def test_selective_scan_autograd_on_card(cuda):
    """selective_ssm_h0 with grad enabled runs K9 forward and K10 backward,
    not K8, and its six gradients match autograd of the plain loop."""
    dt, A_T, Bs, Cs, xs, D, h0, g = _scan_operands(cuda, 4, 40, 256, 16, 1)
    ins = [t.clone().requires_grad_() for t in (dt, A_T, Bs, Cs, xs, D)]
    counts = (ss.selective_ssm_h0.launches, ss.selective_ssm_bounds.launches,
              ss.selective_ssm_bwd.launches)
    ss.selective_ssm_h0(*ins, h0).backward(g)
    assert (ss.selective_ssm_h0.launches, ss.selective_ssm_bounds.launches,
            ss.selective_ssm_bwd.launches) == (counts[0], counts[1] + 1, counts[2] + 1)
    ref = [t.clone().requires_grad_() for t in (dt, A_T, Bs, Cs, xs, D)]
    ss.selective_ssm_plain(*ref, h0).backward(g)
    for a, b in zip(ins, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0,
                                   atol=1e-4 * b.grad.abs().max().item())


def _gated_operands(cuda, B, L, E, N, R, h0_rows, dtype, seed=0):
    """The gated form's operands as the mixer holds them: dt_raw (dt_proj's
    output, softplus inputs around -3), A_log = log(1..N) + noise and D at
    the dtype, Bs / Cs column slices of an x_proj-shaped [B, L, R + 2N]
    buffer, z the second half of an in_proj-shaped [B, L, 2E] one; h0 f32."""
    g = torch.Generator(cuda).manual_seed(seed)

    def r(*s):
        return torch.randn(*s, device=cuda, generator=g)

    xdbc, xz = r(B, L, R + 2 * N).to(dtype), r(B, L, 2 * E).to(dtype)
    A_log = (torch.log(torch.arange(1, N + 1, device=cuda, dtype=torch.float32))
             + 0.1 * r(E, N)).to(dtype)
    ops = ((r(B, L, E) - 3).to(dtype), A_log, xdbc[..., R:R + N], xdbc[..., R + N:],
           r(B, L, E).to(dtype), r(E).to(dtype), xz[..., E:])
    return ops, (r(h0_rows, N, E) if h0_rows else None)


def _gated_bf16_bound(ops, h0, plain):
    """The bf16 gated output's per-element bound against its plain version.
    The kernel's f32 y differs from the plain loop's by FMA order and 2^x
    (the f32 tolerance, 1e-5 x max |y|), and that can flip round(y) by one
    bf16 step (at most 2^-7 |y|); both reach the output times
    |round(silu(z))|; the product's own rounding can then move it by one
    more step, 2^-7 |plain|."""
    y = ss._plain_scan(*ss.scan_operands(*ops[:6]), h0, 0)[0]
    s = F.silu(ops[6]).float().abs()
    return s * (1e-5 * y.abs().max() + 2.0 ** -7 * y.abs()) + 2.0 ** -7 * plain.float().abs()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,E,N,R,h0_rows,final", [
    (48, 144, 1536, 16, 48, 1, False),  # the Mamba serving shape, cached head
    (48, 158, 1536, 16, 48, 0, False),  # the same, uncached
    (1, 14, 1536, 16, 48, 0, True),     # the prefill of the prompt head
    (2, 37, 200, 8, 4, 2, True),        # E off the block, batch-B h0; B/C 4-byte rows
    (3, 1, 128, 4, 5, 1, False),        # L = 1, N 4; bf16 B/C at odd offsets
    (2, 37, 202, 16, 48, 1, True),      # rows of 4-byte multiples, not 16
    (2, 21, 201, 8, 48, 0, False),      # E odd: bf16 z at an odd offset
])
def test_selective_scan_gated_kernel_vs_plain(cuda, B, L, E, N, R, h0_rows, final, dtype):
    """The gated form against ``selective_ssm_gated_plain`` on strided
    views: f32 at the raw form's 1e-5, bf16 each element within
    ``_gated_bf16_bound``; h_final f32 at 1e-5; the form's counter counts
    the launch; two calls give the same bits."""
    ops, h0 = _gated_operands(cuda, B, L, E, N, R, h0_rows, dtype)
    assert not ops[2].is_contiguous() and not ops[6].is_contiguous()
    counter = ss.selective_ssm_final if final else ss.selective_ssm_h0 if h0_rows else \
        ss.selective_ssm
    n = counter.launches
    got = ss.selective_ssm_gated(*ops, h0, final)
    assert counter.launches == n + 1
    want = ss.selective_ssm_gated_plain(*ops, h0, final)
    again = ss.selective_ssm_gated(*ops, h0, final)
    if final:
        (got, got_h), (want, want_h), (again, again_h) = got, want, again
        torch.testing.assert_close(got_h, want_h, rtol=1e-5,
                                   atol=1e-5 * want_h.abs().max().item())
        assert torch.equal(got_h, again_h)
    assert got.dtype == dtype and got.shape == (B, L, E) and torch.equal(got, again)
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    else:
        err = (got.float() - want.float()).abs()
        # a NaN share stays NaN (max() propagates it) and fails the assert
        share = torch.where(err == 0, 0.0, err / _gated_bf16_bound(ops, h0, want)).max().item()
        print(f"gated bf16 B={B} L={L} E={E} N={N}: worst element at {share:.3f} of its "
              f"bound, {(err > 2.0 ** -8 * want.float().abs()).float().mean().item():.2e} "
              f"of the elements past 2^-8 |plain|")
        assert share <= 1


@pytest.mark.cuda
def test_selective_scan_gated_rejects_bad_input(cuda):
    ops, h0 = _gated_operands(cuda, 2, 9, 64, 8, 4, 1, torch.bfloat16)
    dt_raw, A_log, Bs, Cs, xs, D, z = ops
    with pytest.raises(ValueError, match="one dtype"):  # x at f32, the rest bf16
        ss.selective_ssm_gated(dt_raw, A_log, Bs, Cs, xs.float(), D, z, h0)
    with pytest.raises(ValueError, match="one dtype"):  # A_log and D disagree
        ss.selective_ssm_gated(dt_raw, A_log, Bs, Cs, xs, D.float(), z, h0)
    with pytest.raises(ValueError, match="row stride"):  # B, C from two buffers
        ss.selective_ssm_gated(dt_raw, A_log, Bs, Cs.contiguous(), xs, D, z, h0)
    with pytest.raises(ValueError, match="rows"):  # a column-strided view
        ss.selective_ssm_gated(dt_raw, A_log, Bs, Cs, xs[..., ::2].repeat(1, 1, 2), D,
                               z.transpose(0, 1).contiguous().transpose(0, 1), h0)
    with pytest.raises(ValueError, match="h0"):
        ss.selective_ssm_gated(dt_raw, A_log, Bs, Cs, xs, D, z, h0.bfloat16())
    with pytest.raises(ValueError, match="state size"):
        ss.selective_ssm_gated(dt_raw, A_log[:, :5], Bs[..., :5], Cs[..., :5], xs, D, z)
    with pytest.raises(ValueError, match="serving form"):
        ss.selective_ssm_gated(dt_raw.float().requires_grad_(), A_log, Bs, Cs, xs, D, z)


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True])
def test_selective_scan_raw_forms_repeat_their_bits(cuda, final):
    """The raw forms (K8, the prefill; K9) give the same bits call to call,
    and the kernel splits a channel's states into the groups the CPU mirror
    ``selective_ssm_split`` assumes."""
    dt, A_T, Bs, Cs, xs, D, h0, _ = _scan_operands(cuda, 8, 40, 512, 16, 1)
    fn = ss.selective_ssm_final if final else ss.selective_ssm_h0
    one, two = fn(dt, A_T, Bs, Cs, xs, D, h0), fn(dt, A_T, Bs, Cs, xs, D, h0)
    assert all(torch.equal(a, b) for a, b in zip(one, two)) if final else torch.equal(one, two)
    k9 = [ss.selective_ssm_bounds(dt, A_T, Bs, Cs, xs, D, h0) for _ in range(2)]
    assert torch.equal(k9[0][0], k9[1][0]) and torch.equal(k9[0][1], k9[1][1])
    assert [_build.library().mt_selective_scan_groups(n) for n in ss.STATE_SIZES] == \
        [ss.fwd_groups(n) for n in ss.STATE_SIZES]


@pytest.mark.cuda
def test_mamba_f32_slice_ignores_cudnn_tf32(cuda):
    """With ``torch.backends.cudnn.allow_tf32`` on (PyTorch's default), the
    2-layer mamba-130m f32 slice on the card against the CPU at chip_smoke
    phase 7's tolerance, and its first block at 1e-5 (TF32 keeps ~3
    digits); the flag is on again after."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import mamba_config
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.tasks import get_trainer

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        small = mamba_config(Config, n_points=512, batch=2, history=64, dtype="float32",
                             llm_layers=2)
        gpu = get_trainer("tf32", small, device=cuda)
        cpu = get_trainer("tf32", small, device="cpu")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
        batch = next(iter(gpu.test_pipeline))
        out_gpu, out_cpu = gpu.eval_dispatch(batch).cpu(), cpu.eval_dispatch(batch)
        err = (out_gpu - out_cpu).abs().max().item()
        assert err <= 1e-3 * max(1.0, out_cpu.abs().max().item())
        x = torch.randn(2, 40, gpu.model.llm.cfg.d_model,
                        generator=torch.Generator().manual_seed(0))
        block_g, block_c = gpu.model.llm.blocks[0], cpu.model.llm.blocks[0]
        with torch.no_grad():
            yg, yc = block_g(x.to(cuda)).cpu(), block_c(x)
        torch.testing.assert_close(yg, yc, rtol=1e-5, atol=1e-5 * yc.abs().max().item())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _gmm_operands(cuda, counts, K, N, n_weights, n_chunks=0, block_m=128, w_bits=8):
    """Expert-packed int8 rows for ``counts`` routed rows per expert, with
    their visit list (invalid tail visits included), weights [E, N, K] (or
    packed int4 [E, N, K/2] at ``w_bits=4``) and scales."""
    g = torch.Generator(cuda).manual_seed(0)
    E = len(counts)
    V = gm.gmm_visits(sum(counts), E, block_m)
    ve, valid, _ = gm.gmm_metadata(torch.tensor(counts, dtype=torch.int32, device=cuda),
                                   block_m, V)
    R = V * block_m
    xq = torch.randint(-127, 128, (R, K), device=cuda, dtype=torch.int8, generator=g)
    shape = (n_chunks, 1, R) if n_chunks else (R, 1)
    xs = torch.rand(*shape, device=cuda, generator=g) * 1e-2
    lo, hi = (-127, 128) if w_bits == 8 else (-8, 8)
    w = [torch.randint(lo, hi, (E, N, K), device=cuda, dtype=torch.int8, generator=g)
         for _ in range(n_weights)]
    if w_bits == 4:
        w = [k5.pack4_split(a) for a in w]
    ws = [torch.rand(E, N, device=cuda, generator=g) * 1e-3 for _ in range(n_weights)]
    return xq, xs, w, ws, ve, valid


# the moe-8x1b serving shape (13824 routed rows of a batch of 48 x 144 tokens,
# top-2 of 8 experts), a skewed routing (every row on two experts), one expert
# holding every row while the others are empty, and small shapes with ragged
# tiles and invalid tail visits
_ROUTED = [1650, 1800, 1700, 1777, 1733, 1711, 1690, 1763]
_SKEWED = [0, 6912, 0, 0, 6912, 0, 0, 0]
_ONE = [0, 0, 0, 13824, 0, 0, 0, 0]


_W_BITS = pytest.mark.parametrize("w_bits", [8, 4])


def _assert_tail_zero(outs, valid, block_m):
    """Rows of invalid tail visits are zero (a scale output: the 1e-10 floor)."""
    n_real = int(valid.sum()) * block_m
    for o in outs:
        if o.dim() == 3:
            assert bool((o[..., n_real:] == 1e-10).all())
        else:
            assert not o[n_real:].any()


@pytest.mark.cuda
@_W_BITS
@pytest.mark.parametrize("counts,K,N,block_n,block_m", [
    (_ROUTED, 2048, 5632, 1408, 128), (_SKEWED, 2048, 5632, 1408, 128),
    ([200, 0, 37, 90], 256, 512, 256, 128), (_ONE, 2048, 5632, 1408, 128),
    ([300, 0, 129, 1000], 256, 512, 256, 256),
], ids=["serving", "skewed", "small", "one-expert", "block_m-256"])
def test_gmm_gate_up_kernel_vs_plain(cuda, counts, K, N, block_n, block_m, w_bits):
    """(a) gate + up, fused SwiGLU and per-(row, N-tile) requant: codes at
    most 1 apart in at most 1e-3 of them (silu's expf may differ in the last
    bit from the plain version's), scales 1e-6 relative."""
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, counts, K, N, 2, block_m=block_m,
                                             w_bits=w_bits)
    form = gm.GATE_UP if w_bits == 8 else gm.GATE_UP_W4
    n = form.launches
    kw = dict(block_m=block_m, block_n=block_n, fuse_silu=True, emit_quant=True, w_bits=w_bits)
    q, s = gm.gmm(xq, xs, w, ws, ve, valid, **kw)
    assert form.launches == n + 1
    q0, s0 = gm.gmm_plain(xq, xs, w, ws, ve, valid, **kw)
    dq = (q.int() - q0.int()).abs()
    assert dq.max().item() <= 1 and (dq > 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
    _assert_tail_zero((q, s), valid, block_m)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits,K", [(8, 208), (8, 336), (4, 224), (4, 352)])
def test_gmm_k_tail_kernel_vs_plain(cuda, w_bits, K):
    """K tails short of a 128-byte stage (w8 K 208 / 336; w4 halves of 112 /
    176 packed bytes): the zero-filled box tail adds nothing. The gate+up
    form held as above, the plain form's s32 bit-equal."""
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [200, 0, 37, 90], K, 384, 2, w_bits=w_bits)
    kw = dict(block_n=128, fuse_silu=True, emit_quant=True, w_bits=w_bits)
    q, s = gm.gmm(xq, xs, w, ws, ve, valid, **kw)
    q0, s0 = gm.gmm_plain(xq, xs, w, ws, ve, valid, **kw)
    dq = (q.int() - q0.int()).abs()
    assert dq.max().item() <= 1 and (dq > 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
    kw = dict(block_n=384, out_dtype=torch.int32, w_bits=w_bits)
    for got, want in zip(gm.gmm(xq, xs, w, ws, ve, valid, **kw),
                         gm.gmm_plain(xq, xs, w, ws, ve, valid, **kw)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@_W_BITS
@pytest.mark.parametrize("counts,K,N,n_chunks,block_n", [
    (_ROUTED, 5632, 2048, 4, 1024), (_SKEWED, 5632, 2048, 4, 1024),
    ([200, 0, 37, 90], 96, 200, 2, 200),  # chunks of 48: a stage's box past the chunk's end
    (_ONE, 5632, 2048, 4, 1024),
    ([200, 0, 37, 90], 2816, 256, 2, 256),  # chunks of 1408 in two halves
    ([200, 0, 37, 90], 832, 256, 4, 256),  # chunks of 208: ragged chunk tails
], ids=["serving", "skewed", "small", "one-expert", "two-chunks", "chunk-tails"])
def test_gmm_down_kernel_vs_plain(cuda, counts, K, N, n_chunks, block_n, w_bits):
    """(b) chunked scales, f32 out: the same rounded f32 ops in the same
    order, held within 1e-5 x max; invalid tail visits zero."""
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, counts, K, N, 1, n_chunks, w_bits=w_bits)
    form = gm.DOWN if w_bits == 8 else gm.DOWN_W4
    n = form.launches
    (y,) = gm.gmm(xq, xs, w, ws, ve, valid, block_n=block_n, w_bits=w_bits)
    assert form.launches == n + 1
    (y0,) = gm.gmm_plain(xq, xs, w, ws, ve, valid, block_n=block_n, w_bits=w_bits)
    torch.testing.assert_close(y, y0, rtol=0, atol=1e-5 * y0.abs().max().item())
    _assert_tail_zero((y,), valid, 128)


@pytest.mark.cuda
@_W_BITS
@pytest.mark.parametrize("n_weights,K,N,block_m", [(1, 2048, 5632, 128), (2, 256, 200, 256),
                                                   (2, 2048, 1408, 128)])
def test_gmm_rows_kernel_vs_plain(cuda, n_weights, K, N, block_m, w_bits):
    """(c) the plain form: s32 accumulators bit-equal; f32 and bf16 outputs
    equal (the same integers, the same f32 rescale order)."""
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [300, 0, 129, 1000], K, N, n_weights,
                                             block_m=block_m, w_bits=w_bits)
    kw = dict(block_m=block_m, block_n=N, w_bits=w_bits)
    form = gm.PLAIN if w_bits == 8 else gm.PLAIN_W4
    n = form.launches
    for got, want in zip(gm.gmm(xq, xs, w, ws, ve, valid, out_dtype=torch.int32, **kw),
                         gm.gmm_plain(xq, xs, w, ws, ve, valid, out_dtype=torch.int32, **kw)):
        assert torch.equal(got, want)
    for dt in (torch.float32, torch.bfloat16):
        for got, want in zip(gm.gmm(xq, xs, w, ws, ve, valid, out_dtype=dt, **kw),
                             gm.gmm_plain(xq, xs, w, ws, ve, valid, out_dtype=dt, **kw)):
            assert torch.equal(got, want)
    assert form.launches == n + 3


@pytest.mark.cuda
@pytest.mark.parametrize("group_m", [1, 2, 3, 8, 16])
def test_gmm_tile_map_matches_host_mirror(cuda, group_m):
    """The kernel's raster (``mt_gmm_tile_map``) equals ``gmm_tile_order``
    block for block, at row-tile counts that leave a short last group."""
    lib = _build.library()
    for n_rows, n_cols in [(1, 1), (116, 44), (116, 16), (7, 3), (25, 5)]:
        want = [r * n_cols + c for r, c in gm.gmm_tile_order(n_rows, n_cols, group_m)]
        got = [lib.mt_gmm_tile_map(i, n_rows, n_cols, group_m) for i in range(n_rows * n_cols)]
        assert got == want


@pytest.mark.cuda
def test_gmm_kernel_rejects_bad_input(cuda):
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], 64, 128, 1, block_m=64)
    with pytest.raises(ValueError, match="block_m"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_m=64, block_n=128)
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], 72, 128, 1)
    with pytest.raises(ValueError, match="16"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_n=128)
    # int4: K / 2 % 16 != 0, and an odd chunk count
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], 48, 128, 1, w_bits=4)
    with pytest.raises(ValueError, match="16"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_n=128, w_bits=4)
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], 192, 128, 1, 3, w_bits=4)
    with pytest.raises(ValueError, match="even chunk count"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_n=128, w_bits=4)
    # a chunk whose rows are not 16-byte multiples (K 96 in 4 chunks of 24)
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], 96, 128, 1, 4)
    with pytest.raises(ValueError, match="16"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_n=128)
    # K past the s32 accumulators' reach
    K = gm.MAX_K + 16
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], K, 128, 1)
    with pytest.raises(ValueError, match="past"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_n=128)
    # chunked scales with two weights
    xq, xs, w, ws, ve, valid = _gmm_operands(cuda, [5, 0], 256, 128, 2, 2)
    with pytest.raises(ValueError, match="one weight"):
        gm.gmm(xq, xs, w, ws, ve, valid, block_n=128)


# --------------------------------------------------------------------------
# the captured serving step (runtime/graph.py)
# --------------------------------------------------------------------------

def _served_trainer(cuda, path):
    """A 2-layer cut of a served configuration at its published widths,
    batch 4, a few test batches; ``nf4`` is the llama cut with nf4 weights
    (the codebook table). (llama-tiny and mixtral-tiny-128 have head dims
    16 and 32, which K2 refuses on the card; llama-1b and moe-8x1b have
    64.)"""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import bench_config, mamba_config, moe_config
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.tasks import get_trainer

    cfg = {"llama": lambda: bench_config(Config, llm="llama-1b", batch=4, history=64,
                                         n_points=512, num_tokens=128, d_ff=64,
                                         llm_layers=2),
           "nf4": lambda: bench_config(Config, llm="llama-1b", batch=4, history=64,
                                       n_points=512, num_tokens=128, d_ff=64, llm_layers=2,
                                       quant_type="nf4"),
           "mamba": lambda: mamba_config(Config, n_points=768, batch=4, history=64,
                                         llm_layers=2),
           "moe": lambda: moe_config(Config, n_points=1536, batch=4, llm_layers=2)}[path]()
    return get_trainer(f"graph-{path}", cfg, device=cuda)


def _eager_then_graphed(tr, counters):
    """Every test batch through the eager step, then through the graphed
    one (after ``test()`` captured): bit-equal outputs, equal launches."""
    from medtsllm_tpu_torch.runtime.graph import read_counts

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        return out, read_counts(counters)
    prepared = [tr.eval_prepare(b) for b in tr.test_pipeline]
    eager = [counted(lambda: tr.eval_step_eager(a)) for _, a in prepared]
    graphed = [counted(lambda: tr.eval_dispatch(prepared=p)) for p in prepared]
    for (out_e, n_e), (out_g, n_g) in zip(eager, graphed):
        assert torch.equal(out_g, out_e)
        assert n_g == n_e and any(n_e.values())
    return [out for out, _ in graphed]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["llama", "nf4", "mamba", "moe"])
def test_graphed_step_bit_equal_to_eager(cuda, path):
    """The replay equals ``eval_step_eager`` bit for bit on every test batch
    and launches what it launches: after ``test()`` captured, after a
    second pass (the prompt-head cache refilled in place) and after
    ``load_state_dict`` of new weights, with no capture past the first."""
    from medtsllm_tpu_torch.runtime.graph import launch_counters

    counters = launch_counters()
    tr = _served_trainer(cuda, path)
    assert len(tr.test_pipeline) >= 2
    for batch in tr.test_pipeline:  # settle the prompt buckets (host only)
        tr.model_inputs(batch)
    tr.test()
    graphs = tr.step_graphs
    n = len(graphs)
    assert n >= 1
    (kv,) = tr._prefix_kv_store.values()
    ptrs = [t.data_ptr() for layer in kv for t in layer]
    before = _eager_then_graphed(tr, counters)
    tr.test()  # a second pass
    _eager_then_graphed(tr, counters)
    g = torch.Generator(cuda).manual_seed(1)
    state = {k: v + 0.05 * v.abs().amax() * torch.randn(v.shape, device=cuda, generator=g
                                                          ).to(v.dtype)
             if v.is_floating_point() else v for k, v in tr.model.state_dict().items()}
    tr.load_state_dict(state)
    after = _eager_then_graphed(tr, counters)
    assert not any(torch.equal(a, b) for a, b in zip(after, before))
    assert [t.data_ptr() for layer in kv for t in layer] == ptrs
    assert tr._prefix_kv_store[next(iter(tr._prefix_kv_store))] is kv
    assert len(graphs) == n


@pytest.mark.cuda
def test_graphed_banked_step_bit_equal_to_eager(cuda):
    """The banked step (per-clip head rows gathered from the KV bank inside
    the graph) on a 2-layer cut of ecgmit-seg.toml with 12 clips through a
    bank of 8 rows: each batch, prepared in turn (its misses prefilled into
    the bank, evicting), replayed equals the eager step bit for bit with its
    launches, in two passes and after ``load_state_dict``; the bank's
    tensors stay where they are and nothing is captured anew; the banked
    step agrees with the same batch with its head embedded (2^-6 x max)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import ECG_SEG_TOML, task_config
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.runtime.graph import launch_counters, read_counts
    from medtsllm_tpu_torch.tasks import get_trainer

    counters = launch_counters()
    tr = get_trainer("graph-clip", task_config(Config, ECG_SEG_TOML, n_points=12 * 128,
                                               llm="llama-1b", llm_layers=2, history=64,
                                               batch=4, n_clips=12), device=cuda)
    for batch in tr.test_pipeline:  # settle the prompt buckets (host only)
        tr.model_inputs(batch)
    tr.test()
    n = len(tr.step_graphs)
    (key, bank), = [(k, v) for k, v in tr._prefix_kv_store.items() if k[0] == "clip_bank"]
    ptrs = [t.data_ptr() for layer in bank for t in layer]

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        return out, read_counts(counters)

    def one_pass():
        tr._prefix_kv_cache.clear()
        outs = []
        for batch in tr.test_pipeline:
            prepared = tr.eval_prepare(batch)
            assert prepared[0] == "banked"
            out_e, n_e = counted(lambda: tr.eval_step_eager(prepared[1]))
            out_g, n_g = counted(lambda: tr.eval_dispatch(prepared=prepared))
            assert torch.equal(out_g, out_e) and n_g == n_e and n_e["rope_attention"] == 2
            outs.append(out_g)
        assert tr._prefix_kv_cache[key]["evictions"] > 0
        return outs

    before = one_pass()
    assert all(torch.equal(a, b) for a, b in zip(one_pass(), before))
    first = next(iter(tr.test_pipeline))
    embedded = tr.eval_step_eager(tr._to_device(tr.model_inputs(first))).float()
    tr._prefix_kv_cache.clear()
    banked = tr.eval_step(tr.eval_prepare(first)[1]).float()
    assert (banked - embedded).abs().max() <= 2 ** -6 * embedded.abs().max()
    g = torch.Generator(cuda).manual_seed(1)
    tr.load_state_dict({k: v + 0.05 * v.abs().amax() * torch.randn(
        v.shape, device=cuda, generator=g).to(v.dtype) if v.is_floating_point() else v
        for k, v in tr.model.state_dict().items()})
    after = one_pass()
    assert not any(torch.equal(a, b) for a, b in zip(after, before))
    assert tr._prefix_kv_store[key] is bank
    assert [t.data_ptr() for layer in bank for t in layer] == ptrs
    assert len(tr.step_graphs) == n


@pytest.mark.cuda
def test_graphed_step_alternates_two_buckets(cuda):
    """Two prompt buckets, two graphs on one memory pool, replayed in turn:
    each replay equals the eager step on its own inputs."""
    tr = _served_trainer(cuda, "llama")
    _, arrays = tr.eval_prepare(next(iter(tr.test_pipeline)))
    ids = arrays["prompt_ids"]
    pad = torch.full((ids.shape[0], 16), tr.preprocessor.pad_id, dtype=ids.dtype, device=cuda)
    wide = dict(arrays, prompt_ids=torch.cat([pad, ids], dim=1))
    want = [tr.eval_step_eager(a) for a in (arrays, wide)]
    assert not torch.equal(want[0], want[1])
    for i in range(6):
        assert torch.equal(tr.eval_step(wide if i % 2 else arrays), want[i % 2])
    assert len(tr.step_graphs) == 2


@pytest.mark.cuda
def test_graph_capture_that_cannot_succeed_raises(cuda):
    """A forward that reads a value back to the host runs as the warm-up,
    then its capture raises: no graph is kept, the counters and the current
    stream are as before."""
    from types import SimpleNamespace

    from medtsllm_tpu_torch.runtime.graph import StepGraphs

    class ReadsBack(torch.nn.Module):
        def forward(self, arrays):
            counter.launches += 1
            x = arrays["x"]
            return x * x.sum().item()

    counter = SimpleNamespace(launches=0)
    graphs = StepGraphs(ReadsBack(), cuda, {"fake": counter})
    stream = torch.cuda.current_stream(cuda)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        graphs({"x": x})
    assert len(graphs) == 0 and counter.launches == 1  # the warm-up only
    assert torch.cuda.current_stream(cuda) == stream
    assert torch.equal(x * 2, torch.full((4,), 2.0, device=cuda))


# --------------------------------------------------------------------------
# the captured train step (runtime/graph.py::TrainGraphs)
# --------------------------------------------------------------------------

def _train_trainer(cuda, path, optimizer):
    """A 2-layer cut of a trained configuration at its published widths,
    batch 4, dropout 0.1, ``optimizer`` with a cosine schedule over 4
    epochs and a global-norm clip of 0.5: ``llama`` the w8a8 finetune
    (K1's STE backward, K2's), ``mamba`` mamba-130m (K9 / K10), ``mixed``
    bidmc.toml's segmentation under mixed (the casts through
    ``functional_call``, the bf16 train cache), ``moe`` moe-8x1b (the
    capacity path: K1 per expert with its straight-through backward, the
    router's aux loss at 0.01). (llama-tiny's head dim 16
    is one K2 refuses on the card: the llama cuts are llama-1b's.)"""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import BIDMC_TOML, bench_config, mamba_config, moe_config, task_config
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.tasks import get_trainer

    cfg = {"llama": lambda: bench_config(Config, llm="llama-1b", batch=4, history=64,
                                         n_points=512, num_tokens=128, d_ff=64,
                                         llm_layers=2),
           "mamba": lambda: mamba_config(Config, n_points=768, batch=4, history=64,
                                         llm_layers=2),
           "mixed": lambda: task_config(Config, BIDMC_TOML, n_points=512, llm="llama-1b",
                                        llm_layers=2, history=64, batch=4),
           "moe": lambda: moe_config(Config, n_points=768, batch=4,
                                     llm_layers=2)}[path]().to_dict()
    cfg["training"].update(optimizer=optimizer, lr_scheduler="cosine", epochs=4,
                           grad_clip_norm=0.5, dropout=0.1, learning_rate=1e-3)
    if path == "moe":  # the capacity path and the router's loss, at history 64
        cfg.update(history_len=64, pred_len=64)
        cfg["data"]["step"] = 32
        cfg["training"]["router_aux_coef"] = 0.01
    return get_trainer(f"train-graph-{path}", Config(cfg), device=cuda)


def _train_run(tr, step, batches, counters):
    """``step`` on each batch, the epoch's LR set to epoch 0's before the
    first and to epoch 2's before the third: (the losses, each step's
    launches, the train state, the gradients, the generator's state)."""
    from chip_smoke import train_state
    from medtsllm_tpu_torch.runtime.graph import read_counts

    losses, counts = [], []
    for i, a in enumerate(batches):
        if i in (0, 2):
            tr.optimizer.set_epoch(i)
        for c in counters.values():
            c.launches = 0
        losses.append(step(a, a["valid"]))
        counts.append(read_counts(counters))
    grads = [None if p.grad is None else p.grad.clone() for p in tr.optimizer.params]
    return (torch.stack(losses), counts, [t.clone() for t in train_state(tr.optimizer)], grads,
            tr.dropout_generator.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("path,optimizer", [("llama", "adam"), ("mamba", "adamw"),
                                            ("mixed", "adam"), ("mixed", "sgd"),
                                            ("moe", "adam")])
def test_graphed_train_step_bit_equal_to_eager(cuda, path, optimizer):
    """After one captured step (the warm-up, a real step), 4 replays across
    one ``set_epoch`` change equal 4 eager steps from the same state (the
    parameters, the optimizer's state and the dropout generator restored in
    place) bit for bit: the losses, every trainable parameter, the
    optimizer's state, the last step's gradients and the generator's state;
    each replay launches what the eager step launches; nothing is captured
    anew; the backbone does not move. Under mixed, the eval graph captured
    before training then replays the trained weights bit-equal to the
    eager eval step."""
    import itertools

    from medtsllm_tpu_torch.runtime.graph import launch_counters

    counters = launch_counters()
    tr = _train_trainer(cuda, path, optimizer)
    from chip_smoke import train_state
    pipe = itertools.chain.from_iterable(itertools.repeat(tr.train_pipeline))
    batches = [tr.train_model_inputs(b) for b in itertools.islice(pipe, 5)]
    _, eval_arrays = tr.eval_prepare(next(iter(tr.test_pipeline)))
    before_eval = tr.eval_step(eval_arrays)  # the eval graph's warm-up and capture
    frozen = {n: t.clone() for n, t in tr.model.state_dict().items() if n.startswith("llm.")}
    tr.train_step(batches[0], batches[0]["valid"])
    assert len(tr.train_graphs) == 1
    snap = [t.clone() for t in train_state(tr.optimizer)]
    gen = tr.dropout_generator.get_state()
    graphed = _train_run(tr, tr.train_step, batches[1:], counters)
    for t, s in zip(train_state(tr.optimizer), snap):
        t.copy_(s)
    tr.dropout_generator.set_state(gen)
    eager = _train_run(tr, tr.train_step_eager, batches[1:], counters)
    assert torch.equal(graphed[0], eager[0]) and bool(torch.isfinite(eager[0]).all())
    assert graphed[1] == eager[1] and any(eager[1][0].values())
    for g, e in zip(graphed[2] + graphed[3], eager[2] + eager[3]):
        assert (g is None and e is None) or torch.equal(g, e)
    assert torch.equal(graphed[4], eager[4]) and not torch.equal(gen, eager[4])
    assert not all(torch.equal(s, t) for s, t in zip(snap, eager[2]))
    assert len(tr.train_graphs) == 1
    assert all(torch.equal(tr.model.state_dict()[n], t) for n, t in frozen.items())
    if path == "mixed":
        after = tr.eval_step(eval_arrays)
        assert torch.equal(after, tr.eval_step_eager(eval_arrays))
        assert not torch.equal(after, before_eval)


@pytest.mark.cuda
def test_graphed_train_steps_alternate_two_signatures(cuda):
    """The Mamba cut's train step with the prompt head cached and with it
    embedded: two graphs on the train pool, replayed in turn; each call
    (the two warm-ups included) equals the eager step from the same
    state."""
    tr = _train_trainer(cuda, "mamba", "adam")
    from chip_smoke import train_state
    batch = next(iter(tr.train_pipeline))
    cached = tr.train_model_inputs(batch)
    embedded = tr._to_device(tr.model_inputs(batch))
    assert "prefix_kv" in cached and "prefix_ids" in embedded
    tr.train_step_eager(cached, cached["valid"])  # the optimizer's state
    for i in range(6):
        a = embedded if i % 2 else cached
        snap = [t.clone() for t in train_state(tr.optimizer)]
        gen = tr.dropout_generator.get_state()
        loss_e = tr.train_step_eager(a, a["valid"])
        want = [t.clone() for t in train_state(tr.optimizer)]
        for t, s in zip(train_state(tr.optimizer), snap):
            t.copy_(s)
        tr.dropout_generator.set_state(gen)
        loss_g = tr.train_step(a, a["valid"])  # a warm-up and capture at i < 2
        assert torch.equal(loss_g, loss_e)
        assert all(torch.equal(t, w) for t, w in zip(train_state(tr.optimizer), want))
    assert len(tr.train_graphs) == 2


@pytest.mark.cuda
def test_train_capture_that_cannot_succeed_raises(cuda):
    """A train step that reads its loss back to the host runs as the
    warm-up (its update applied), then its capture raises: no graph is
    kept, the counters, the current stream and the generators the capture
    registered are as before, and the generators draw again."""
    from types import SimpleNamespace

    from medtsllm_tpu_torch.runtime.graph import TrainGraphs

    w = torch.nn.Parameter(torch.ones(4, device=cuda))
    counter = SimpleNamespace(launches=0)

    def step(arrays):
        counter.launches += 1
        w.grad = None
        loss = (w * arrays["x"]).sum()
        loss.backward()
        with torch.no_grad():
            w.sub_(w.grad * loss.item())
        return loss.detach()

    gen = torch.Generator(cuda).manual_seed(5)
    graphs = TrainGraphs(step, cuda, [w], (gen,), {"fake": counter})
    stream = torch.cuda.current_stream(cuda)
    state, default = gen.get_state(), torch.cuda.get_rng_state(cuda)
    with pytest.raises(RuntimeError):
        graphs({"x": torch.ones(4, device=cuda)})
    assert len(graphs) == 0 and counter.launches == 1  # the warm-up only
    assert torch.cuda.current_stream(cuda) == stream
    assert torch.equal(w.detach(), torch.full((4,), -3.0, device=cuda))
    # the registered generator and the default one draw again, from where
    # they were
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(torch.cuda.get_rng_state(cuda), default)
    first = torch.rand(8, generator=gen, device=cuda)
    assert torch.equal(first, torch.rand(8, generator=torch.Generator(cuda).manual_seed(5),
                                         device=cuda))
    torch.rand(8, device=cuda)


@pytest.mark.cuda
def test_graphed_train_step_moves_loaded_group_after_unfreeze(cuda, tmp_path):
    """Finetuning with ``frozen_epochs = 1`` on a 2-layer bidmc cut under
    mixed (Adam): the train graph captured in the frozen epoch (the loaded
    group's LR tensor at 0) leaves the loaded tensors bit-equal to the
    pretraining checkpoint's; after ``set_epoch(1)`` writes that tensor in
    place, a replay (no new capture) moves them, and equals the eager step
    from the same state bit for bit."""
    import itertools
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import BIDMC_TOML, task_config, train_state
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.runtime.checkpoint import load_checkpoint
    from medtsllm_tpu_torch.tasks import get_trainer

    raw = task_config(Config, BIDMC_TOML, n_points=512, llm="llama-1b", llm_layers=2,
                      history=64, batch=4).to_dict()
    raw.update(DEBUG=False, paths={"logdir": str(tmp_path)})
    raw["training"]["epochs"] = 2
    pre = get_trainer("pre", Config(raw), device=cuda)
    pre.logger.save_state("latest", async_=False)
    del pre
    saved, _ = load_checkpoint(tmp_path / "pre" / "checkpoints" / "latest.ckpt")
    raw["finetuning"] = {"enabled": True, "pretrained_id": "pre", "pretrained_ckpt": "latest",
                         "frozen_epochs": 1}
    tr = get_trainer("ft", Config(raw), device=cuda)
    loaded = set(tr.loaded_params)
    params = dict(tr.model.named_parameters())
    assert loaded and not any(n.startswith("output_projection") for n in loaded)
    pipe = itertools.chain.from_iterable(itertools.repeat(tr.train_pipeline))
    batches = [tr.train_model_inputs(b) for b in itertools.islice(pipe, 3)]
    tr.optimizer.set_epoch(0)
    assert tr.optimizer.loaded_lr.item() == 0.0
    for a in batches[:2]:  # the warm-up and the capture, then a replay
        tr.train_step(a, a["valid"])
    assert len(tr.train_graphs) == 1
    assert all(torch.equal(params[n].detach().cpu(), saved[n]) for n in loaded)
    tr.optimizer.set_epoch(1)
    assert tr.optimizer.loaded_lr.item() == pytest.approx(raw["training"]["learning_rate"])
    snap = [t.clone() for t in train_state(tr.optimizer)]
    gen = tr.dropout_generator.get_state()
    tr.train_step(batches[2], batches[2]["valid"])
    graphed = [t.clone() for t in train_state(tr.optimizer)]
    assert len(tr.train_graphs) == 1
    moved = [n for n in loaded if not torch.equal(params[n].detach().cpu(), saved[n])]
    assert len(moved) >= len(loaded) - 1  # the key bias's gradient is ~0
    for t, s in zip(train_state(tr.optimizer), snap):
        t.copy_(s)
    tr.dropout_generator.set_state(gen)
    tr.train_step_eager(batches[2], batches[2]["valid"])
    assert all(torch.equal(g, e) for g, e in zip(graphed, train_state(tr.optimizer)))


@pytest.mark.cuda
@pytest.mark.parametrize("toml,model", [("configs/baseline-models/msl-timesnet.toml", "timesnet"),
                                        ("configs/baseline-models/msl-fedformer.toml",
                                         "fedformer"),
                                        ("configs/baseline-models/dreams.toml", "gpt4ts")])
def test_graphed_baseline_train_step_bit_equal_to_eager(cuda, toml, model):
    """A baseline's captured train step (TimesNet: the periods stay device
    tensors, the folded conv's backward a GEMM; FEDformer: the shared
    Fourier block; GPT4TS: gpt2 at full width, its dropout from the
    registered generator, plain attention at 128 tokens), the shipped file
    cut to one layer: after the warm-up
    step, 4 replays across one ``set_epoch`` change equal 4 eager steps
    from the same state bit for bit (the losses, the parameters, Adam's
    state, the gradients, the dropout generator's state); nothing is
    captured anew; then the eval graph replays the trained weights
    bit-equal to the eager eval step."""
    import itertools
    import tomllib
    from pathlib import Path

    from chip_smoke import train_state
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.runtime.graph import launch_counters
    from medtsllm_tpu_torch.tasks import get_trainer

    raw = tomllib.loads((Path(__file__).resolve().parents[1] / toml).read_text())
    raw["models"][model]["gpt_layers" if model == "gpt4ts" else "e_layers"] = 1
    raw["training"].update(batch_size=4, epochs=4, lr_scheduler="cosine")
    tr = get_trainer(f"baseline-graph-{model}", Config(dict(raw, DEBUG=True)), device=cuda)
    pipe = itertools.chain.from_iterable(itertools.repeat(tr.train_pipeline))
    batches = [tr.train_model_inputs(b) for b in itertools.islice(pipe, 5)]
    tr.train_step(batches[0], batches[0]["valid"])
    assert len(tr.train_graphs) == 1
    snap = [t.clone() for t in train_state(tr.optimizer)]
    gen = tr.dropout_generator.get_state()
    counters = launch_counters()
    graphed = _train_run(tr, tr.train_step, batches[1:], counters)
    for t, s in zip(train_state(tr.optimizer), snap):
        t.copy_(s)
    tr.dropout_generator.set_state(gen)
    eager = _train_run(tr, tr.train_step_eager, batches[1:], counters)
    assert torch.equal(graphed[0], eager[0]) and bool(torch.isfinite(eager[0]).all())
    assert graphed[1] == eager[1] and not any(eager[1][0].values())  # no kernel of the port
    for g, e in zip(graphed[2] + graphed[3], eager[2] + eager[3]):
        assert (g is None and e is None) or torch.equal(g, e)
    assert torch.equal(graphed[4], eager[4]) and not torch.equal(gen, eager[4])
    assert len(tr.train_graphs) == 1
    _, arrays = tr.eval_prepare(next(iter(tr.test_pipeline)))
    tr.eval_step(arrays)  # the eval graph's warm-up and capture
    assert torch.equal(tr.eval_step(arrays), tr.eval_step_eager(arrays))


@pytest.mark.cuda
def test_deleted_trainer_releases_its_device_memory(cuda):
    """A trainer's device memory goes with it: after a first trainer (the
    shared capture stream's cuBLAS workspaces made), a second one of the
    same configuration, built, trained and served through its captured
    steps, then deleted, leaves ``memory_allocated`` where it was."""
    import gc

    def run():
        tr = _train_trainer(cuda, "llama", "adam")
        for batch, _ in zip(tr.train_pipeline, range(3)):
            a = tr.train_model_inputs(batch)
            tr.train_step(a, a["valid"])
        for batch, _ in zip(tr.test_pipeline, range(3)):
            tr.eval_dispatch(batch)
        assert len(tr.train_graphs) == 1 and len(tr.step_graphs) >= 1
        torch.cuda.synchronize()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(cuda)

    first = run()
    assert run() == first



# --------------------------------------------------------------------------
# the int8 dx of llm.int8_backward: the gradient rows' quantizer and K1's
# GEMM on the [K, N] copy, each against its plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (896, 4096, 4096), (896, 4096, 11008), (896, 11008, 4096),  # a 7B block at B 8
    (1664, 768, 2304), (1664, 3072, 768),                       # gpt2 at B 16
    (37, 40, 24), (5, 64, 200),                                 # K, N off 16
    # the quantizer's ragged widths, M 1, rows read twice (N > 16,384)
    (1, 32, 1), (111, 16, 37), (111, 32, 40), (6, 48, 176), (3, 32, 11008),
    (111, 16, 12288), (3, 16, 22016),
    # >= 16 MiB: the tile kernel, tiles of 16 / 8 (bf16) and 16 / 4 rows (f32)
    (8448, 16, 1024), (2112, 16, 4096)])
def test_int8_dx_bit_equal(cuda, dtype, M, K, N):
    """``int8_dx``: the scale-folded gradient rows quantized (a bf16
    gradient taken at f32) and K1's GEMM on the weight's [K, N16] copy with
    a unit channel scale, bit-equal to the plain version, row for row; N off
    16 pads the codes' rows and the copy with zeros. The quantizer alone:
    three [E, N] scale rows (M / 3 rows each: a block's rows never span two),
    16 more zero columns (ld > N), and g one element off a 16-byte boundary
    (the scalar instance); one launch a call."""
    g = torch.Generator(cuda).manual_seed(M + K + N)
    grad = torch.randn(M, N, device=cuda, generator=g).to(dtype)
    wq_t = torch.randint(-127, 128, (N, K), device=cuda, dtype=torch.int8, generator=g)
    scale = torch.rand(N, device=cuda, generator=g) * 1e-2 + 1e-4
    w_kn = k1.kn_weight(wq_t)
    assert w_kn.shape == (K, N + (-N % 16))
    nq, ng = k1.quantize_grad_rows.launches, k1.int8_gemm.launches
    gq, gs = k1.quantize_grad_rows(grad, scale, w_kn.shape[1])
    rq, rs = k1.quantize_grad_rows_plain(grad.cpu(), scale.cpu(), w_kn.shape[1])
    assert torch.equal(gq.cpu(), rq) and torch.equal(gs.cpu(), rs)
    for out_dtype in (torch.float32, torch.bfloat16):
        dx = k1.int8_dx(grad, w_kn, scale, out_dtype)
        ref = k1.int8_gemm_plain(rq.to(cuda), w_kn, rs.to(cuda),
                                 torch.ones(K, device=cuda), out_dtype)
        assert torch.equal(dx, ref)
    assert k1.quantize_grad_rows.launches == nq + 3 and k1.int8_gemm.launches == ng + 2
    E = 3 if M % 3 == 0 else 1
    scales = torch.rand(E, N, device=cuda, generator=g) * 1e-2 + 1e-4
    ld = w_kn.shape[1] + 16
    for gr in (grad, _rows_at(grad, 1)):
        nq = k1.quantize_grad_rows.launches
        gq, gs = k1.quantize_grad_rows(gr, scales, ld)
        assert k1.quantize_grad_rows.launches == nq + 1
        rq, rs = k1.quantize_grad_rows_plain(gr.cpu(), scales.cpu(), ld)
        assert torch.equal(gq.cpu(), rq) and torch.equal(gs.cpu(), rs)
        assert not gq[:, N:].any()


@pytest.mark.cuda
def test_int8_dh_bit_equal_at_moe_shape(cuda):
    """The capacity MoE path's batched dh at one moe-8x1b layer (E 8, C
    2160, K 2048, N 5632): one quantizer launch over the E * C rows with
    each expert's scale row, then K1 per expert."""
    from medtsllm_tpu_torch.models.llm import transformer as ttf
    E, C, K, N = 8, 2160, 2048, 5632
    g = torch.Generator(cuda).manual_seed(8)
    grad = torch.randn(E, C, N, device=cuda, generator=g)
    wq = torch.randint(-127, 128, (E, N, K), device=cuda, dtype=torch.int8, generator=g)
    scale = torch.rand(E, N, device=cuda, generator=g) * 1e-2
    w_kn = k1.kn_weight(wq)
    nq = k1.quantize_grad_rows.launches
    dh = ttf.int8_dh(grad, w_kn, scale)
    assert k1.quantize_grad_rows.launches == nq + 1
    rq, rs = k1.quantize_grad_rows_plain(grad.reshape(E * C, N).cpu(), scale.cpu(), N)
    rq, rs = rq.reshape(E, C, N).to(cuda), rs.reshape(E, C).to(cuda)
    ones = torch.ones(K, device=cuda)
    for e in (0, 3, 7):
        assert torch.equal(dh[e], k1.int8_gemm_plain(rq[e], w_kn[e], rs[e], ones))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,K", [(8, 40), (8, 4104), (4, 40), (4, 4112)])
def test_quant_linear_pads_k_on_the_card(cuda, bits, K):
    """A contraction width off the GEMMs' rows (K % 16, K / 2 % 16 at 4
    bits), which JAX's XLA dot takes: the card pads the weight once
    (``pad_copy``) and the codes per call, bit-equal to the plain version
    forward, and the int8 dx bit-equal to its plain version."""
    from medtsllm_tpu_torch.models.llm import transformer as ttf
    g = torch.Generator(cuda).manual_seed(K)
    N = 48
    lin = ttf.QuantLinear(K, N, None, bits, act_quant="int8_bwd").to(cuda)
    lo, hi = (-127, 128) if bits == 8 else (-7, 8)
    q = torch.randint(lo, hi, (N, K), device=cuda, dtype=torch.int8, generator=g)
    lin.weight_q.copy_(q if bits == 8 else k5.pack4_split(q))
    lin.scale.data.copy_(torch.rand(N, device=cuda, generator=g) * 1e-2)
    x = torch.randn(7, K, device=cuda, generator=g, requires_grad=True)
    y = lin(x)
    assert "pad_copy" in dict(lin.named_buffers())
    want = k1.act_quant_matmul_plain(x.detach().cpu(), q.cpu(), lin.scale.detach().cpu())
    assert torch.equal(y.detach().cpu(), want) if bits == 8 else torch.allclose(
        y.detach().cpu(), want, rtol=1e-6, atol=0)  # w4a8 rescales (acc * xs) * ws
    grad = torch.randn(7, N, device=cuda, generator=g)
    y.backward(grad)
    rq, rs = k1.quantize_grad_rows_plain(grad.cpu(), lin.scale.detach().cpu(), N + (-N % 16))
    ref = k1.int8_gemm_plain(rq, k1.kn_weight(q.cpu()), rs, torch.ones(K))
    assert torch.equal(x.grad.cpu(), ref)


@pytest.mark.cuda
def test_reprogramming_takes_the_plain_route_off_its_widths(cuda):
    """E 48 has no K3 instance: the call takes the plain version, decided by
    shape before any launch, as JAX sends it to its einsum."""
    q = torch.randn(2, 8, 4, 48, device=cuda)
    k = torch.randn(100, 4, 48, device=cuda)
    assert k3.reprogramming_route(48) == "plain" and k3.reprogramming_route(128) == "k3"
    n = k3.reprogramming_attention.launches
    out = k3.reprogramming_attention(q, k, k)
    assert k3.reprogramming_attention.launches == n
    assert torch.equal(out, k3.reprogramming_attention_plain(q, k, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_past_65535_batch_heads(cuda, dtype):
    """B * H = 65,600 (> grid.y's 65535): B x H folded into grid.x; every
    (batch, head) against the plain version at the K4 tests' bounds."""
    B, H, L, D = 4100, 16, 8, 64
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(B, H, L, D, device=cuda, generator=g).to(dtype) for _ in range(3))
    out = k4.flash_attention(q, k, v, True)
    ref = k4.flash_attention_plain(q, k, v, True)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err = (out.float() - ref.float()).abs().amax(-1)
        assert (err <= 2 ** -6 * ref.float().abs().amax(-1)).all()
