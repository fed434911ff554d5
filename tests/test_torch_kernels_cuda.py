"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a card. This file imports only
torch and the port, so it also runs on a machine without jax:
``python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest``.
"""

import pytest
import torch

from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
from medtsllm_tpu_torch.ops.kernels import selective_scan as ss
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(896, 4096, 4096), (37, 176, 72), (5, 64, 200)])
def test_w8a8_kernel_bit_equal(cuda, M, K, N):
    """Kernel vs plain on the card: quantizer, s32 and scaled bf16 output
    all bit-equal (same integer math, same f32 epilogue order)."""
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (N, K), device=cuda, dtype=torch.int8, generator=g)
    ws = torch.rand(N, device=cuda, generator=g) * 1e-3
    xq, xs = k1.quantize_rows(x)
    xq0, xs0 = k1.quantize_rows_plain(x)
    assert torch.equal(xq, xq0) and torch.equal(xs, xs0)
    assert torch.equal(k1.int8_gemm(xq, wq, xs, ws, torch.int32),
                       k1.int8_matmul_plain(xq0, wq))
    nq, ng = k1.quantize_rows.launches, k1.int8_gemm.launches
    y = k1.act_quant_matmul(x, wq, ws, torch.bfloat16)
    assert (k1.quantize_rows.launches, k1.int8_gemm.launches) == (nq + 1, ng + 1)
    assert torch.equal(y, k1.act_quant_matmul_plain(x, wq, ws, torch.bfloat16))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KV,D,P,PB", [
    (8, 112, 32, 32, 128, 48, 1),  # the serving shape
    (2, 40, 8, 2, 64, 13, 2),      # GQA, per-row prefix, P % 16 != 0
    (1, 48, 32, 32, 128, 0, 1),    # prefill: no prefix
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
    # f32: summation order only; bf16: the kernel rounds each rotation once,
    # the plain version after each of its ops, so a few bf16 ulps (2^-8)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_rope_attention_kernel_rejects_bad_input(cuda):
    q = torch.zeros(1, 4, 2, 32, device=cuda)  # D = 32 has no instance
    cos = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError):
        k2.rope_attention(q, q, q, cos, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,E,S", [(8, 32, 8, 128, 1024), (3, 20, 4, 64, 100),
                                       (2, 7, 2, 32, 33)])
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
