"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a card. This file imports only
torch and the port, so it also runs on a machine without jax:
``python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest``.
"""

import pytest
import torch

from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
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
