"""The port's kernel modules against the JAX functions they replace.

Each kernel's plain PyTorch version (what a CPU tensor takes) runs against
the JAX function, on the same numpy inputs made from a seed. The CUDA
kernels against their plain versions: tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.models.llm import transformer as jax_tf
from medtsllm_tpu.ops.pallas import reprogramming as jax_repro
from medtsllm_tpu.ops.pallas import rope_attention as jax_rope
from medtsllm_tpu.ops.pallas.flash_attention import _attention_reference
from medtsllm_tpu.ops.pallas.smallm_matmul import w8a8_smallm_matmul_pallas
from medtsllm_tpu_torch.ops.kernels import _build
from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# K1: w8a8 GEMM
# --------------------------------------------------------------------------

def _w8a8_inputs(seed, M=10, K=64, N=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    # a row whose scale is exactly 1.0 with x / scale on .5 ties: round half
    # to even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0), as jnp.round does
    x[0] = 0.0
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[1] = 0.0  # an all-zero row: scale 1e-10, all codes 0
    wq = rng.integers(-127, 128, size=(K, N), dtype=np.int8)
    ws = (rng.random(N) * 1e-2 + 1e-3).astype(np.float32)
    return x, wq, ws


@pytest.mark.parametrize("seed", [0, 1])
def test_w8a8_quantizer_and_s32_bit_equal(seed):
    """xq, x_scale and the s32 accumulators equal JAX's bit for bit
    (transformer._act_quant_matmul's quantization and integer dot)."""
    x, wq, ws = _w8a8_inputs(seed)
    xf = jnp.asarray(x)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    x_scale = jnp.maximum(amax / 127.0, 1e-10)
    xq_j = jnp.round(xf / x_scale).astype(jnp.int8)
    acc_j = jax.lax.dot_general(xq_j, jnp.asarray(wq), (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    xq, xs = k1.quantize_rows(_t(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(x_scale)[:, 0])
    np.testing.assert_array_equal(xq.numpy()[0, :4], [127, 2, -4, 0])
    acc = k1.int8_gemm(xq, _t(wq.T), xs, _t(ws), torch.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_w8a8_matches_act_quant_matmul(in_dtype):
    """The scaled output is within 1 ulp (f32) of _act_quant_matmul (the
    XLA path) and within 2 of the Pallas kernel in interpret mode, which
    rounds acc * x_scale before the channel scale (two roundings, each
    half an ulp, against ours of x_scale * w_scale)."""
    x, wq, ws = _w8a8_inputs(2)
    if in_dtype == "bfloat16":  # o_proj/down_proj see bf16; JAX casts to f32
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        xt = _t(x).to(torch.bfloat16)
    else:
        xt = _t(x)
    y = k1.act_quant_matmul(xt, _t(wq.T), _t(ws)).numpy()
    y_xla = np.asarray(jax_tf._act_quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                                jnp.asarray(ws), 8))
    np.testing.assert_array_max_ulp(y, y_xla, maxulp=1)
    xf = jnp.asarray(x)
    x_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-10)
    xq = jnp.round(xf / x_scale).astype(jnp.int8)
    y_pallas = np.asarray(w8a8_smallm_matmul_pallas(
        xq, jnp.asarray(wq), x_scale, jnp.asarray(ws), block_n=128,
        interpret=True))
    np.testing.assert_array_max_ulp(y, y_pallas, maxulp=2)


def test_w8a8_bf16_output_and_leading_dims():
    x, wq, ws = _w8a8_inputs(3, M=12)
    x3 = _t(x).reshape(3, 4, -1)
    y = k1.act_quant_matmul(x3, _t(wq.T), _t(ws), torch.bfloat16)
    assert y.shape == (3, 4, 128) and y.dtype == torch.bfloat16
    y32 = k1.act_quant_matmul(_t(x), _t(wq.T), _t(ws))
    torch.testing.assert_close(y.reshape(12, -1), y32.to(torch.bfloat16), rtol=0, atol=0)




# --------------------------------------------------------------------------
# K2: fused RoPE + prefix + causal attention
# --------------------------------------------------------------------------

def _rope_inputs(seed, B, L, H, KV, D, P, PB, dtype):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(dtype)

    q, k, v = arr(B, L, H, D), arr(B, L, KV, D), arr(B, L, KV, D)
    pk, pv = (arr(PB, KV, P, D), arr(PB, KV, P, D)) if P else (None, None)
    cos, sin = jax_rope.rope_tables(P + jnp.arange(L), D, 10000.0)
    return q, k, v, cos, sin, pk, pv


def _torch(a):
    if a is None:
        return None
    return _t(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


# bf16: JAX (XLA on the CPU) rounds the rotation once, the plain version
# after each of its three ops, so q/k may differ by a bf16 ulp and the
# bf16 probabilities by one rounding: a few bf16 ulps (2^-8) of the output
_ROPE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2 ** -6, atol=2 ** -6)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,PB", [(0, 1), (5, 1), (21, 2)])
def test_rope_attention_matches_jax(dtype, P, PB):
    """Against rope_attention._reference and the Pallas kernel in interpret
    mode: no prefix; batch-1 and batch-B prefixes; P not a multiple of 16."""
    B, L, H, D = 2, 16, 16, 64
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v, cos, sin, pk, pv = _rope_inputs(P + PB, B, L, H, H, D, P, PB, jdt)
    scale = 1.0 / np.sqrt(D)
    ref = jax_rope._reference(q, k, v, cos, sin, pk, pv, scale)
    pallas = jax_rope._pallas_forward(q, k, v, cos, sin, pk, pv, scale,
                                      interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    args = [_torch(t) for t in (q, k, v)]
    args = [t.to(tdt) for t in args] + [_torch(cos), _torch(sin)]
    pre = [None if t is None else _torch(t).to(tdt) for t in (pk, pv)]
    out = k2.rope_attention(*args, *pre, scale).float().numpy()
    for want in (ref, pallas):
        np.testing.assert_allclose(out, np.asarray(want.astype(jnp.float32)),
                                   **_ROPE_TOL[dtype])


@pytest.mark.parametrize("KV", [1, 2])
def test_rope_attention_gqa_matches_flash_reference(KV):
    """KV < H (the JAX kernel gated it off): against the XLA attention the
    JAX decoder runs, flash_attention._attention_reference, over rotated q/k
    and a concatenated prefix."""
    B, L, H, D, P = 2, 12, 4, 64, 7
    q, k, v, cos, sin, pk, pv = _rope_inputs(KV, B, L, H, KV, D, P, 1, jnp.float32)
    pos = P + jnp.arange(L)
    qr = jax_tf.rotary_embedding(q, pos, 10000.0, seq_axis=1).transpose(0, 2, 1, 3)
    kr = jax_tf.rotary_embedding(k, pos, 10000.0, seq_axis=1).transpose(0, 2, 1, 3)
    kk = jnp.concatenate([jnp.broadcast_to(pk, (B,) + pk.shape[1:]), kr], axis=2)
    vv = jnp.concatenate([jnp.broadcast_to(pv, (B,) + pv.shape[1:]),
                          v.transpose(0, 2, 1, 3)], axis=2)
    ref = _attention_reference(qr, kk, vv, True, 1.0 / np.sqrt(D))
    out = k2.rope_attention(*[_torch(t) for t in (q, k, v, cos, sin, pk, pv)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.transpose(0, 2, 1, 3)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,P,PB", [
    (2, 17, 16, 2, 0, 1),   # the head prefill: no prefix, G 8
    (3, 17, 16, 2, 6, 3),   # a per-row prefix (PB = B), G 8
    (2, 17, 8, 8, 11, 2),   # KV = H, PB = B
])
def test_rope_attention_plain_matches_jax_at_the_tiling_edges(dtype, B, L, H, KV, P, PB):
    """The plain version (what the card's bf16 kernel is held to) against
    JAX's XLA attention at the shapes the kernel's tiling must cover: 64-row
    tiles drawn from all G heads of a KV group (G 8: 136 rows, a partial
    last tile), no prefix, a per-row prefix, L 17. Against
    _attention_reference over JAX's rotary and the concatenated prefix, and
    against rope_attention._reference where KV = H."""
    D = 64
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v, cos, sin, pk, pv = _rope_inputs(B * 10 + P, B, L, H, KV, D, P, PB, jdt)
    scale = 1.0 / np.sqrt(D)
    pos = P + jnp.arange(L)
    qr = jax_tf.rotary_embedding(q, pos, 10000.0, seq_axis=1).transpose(0, 2, 1, 3)
    kr = jax_tf.rotary_embedding(k, pos, 10000.0, seq_axis=1).transpose(0, 2, 1, 3)
    vv = v.transpose(0, 2, 1, 3)
    if P:
        kr = jnp.concatenate([jnp.broadcast_to(pk, (B,) + pk.shape[1:]), kr], axis=2)
        vv = jnp.concatenate([jnp.broadcast_to(pv, (B,) + pv.shape[1:]), vv], axis=2)
    refs = [_attention_reference(qr, kr, vv, True, scale).transpose(0, 2, 1, 3)]
    if KV == H:
        refs.append(jax_rope._reference(q, k, v, cos, sin, pk, pv, scale))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    args = [_torch(t).to(tdt) for t in (q, k, v)] + [_torch(cos), _torch(sin)]
    pre = [None if t is None else _torch(t).to(tdt) for t in (pk, pv)]
    out = k2.rope_attention_plain(*args, *pre, scale).float().numpy()
    for want in refs:
        np.testing.assert_allclose(out, np.asarray(want.astype(jnp.float32)),
                                   **_ROPE_TOL[dtype])


def test_rope_tables_match_jax():
    pos = np.arange(40, 57)
    cj, sj = jax_rope.rope_tables(jnp.asarray(pos), 128, 10000.0)
    ct, st = k2.rope_tables(torch.from_numpy(pos), 128, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2e-6)




# --------------------------------------------------------------------------
# K3: reprogramming cross-attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,L,H,E,S", [(2, 8, 4, 16, 32), (3, 5, 2, 64, 40)])
def test_reprogramming_matches_jax(B, L, H, E, S):
    """Against reprogramming_attention (on the CPU, its jnp reference);
    f32, summation order only."""
    rng = np.random.default_rng(E)
    q = rng.standard_normal((B, L, H, E)).astype(np.float32)
    k = rng.standard_normal((S, H, E)).astype(np.float32)
    v = rng.standard_normal((S, H, E)).astype(np.float32)
    scale = float(1.0 / np.sqrt(E))
    ref = jax_repro.reprogramming_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), scale)
    out = k3.reprogramming_attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,heads,keys,want", [
    (256, 8, 1024, (8, 2)),      # llama: 32 row blocks, 16 key tiles
    (256, 8, 1025, (9, 2)),      # the last split holds one key
    (1536, 8, 1024, (2, 8)),     # Mamba and MoE: 192 row blocks
    (16384, 8, 1024, (1, 16)),   # the long window: 2048 row blocks, no split
    (14, 2, 33, (1, 1)),         # one key tile
    (65, 8, 1024, (16, 1)),      # rows not a multiple of the row tile
])
def test_reprogramming_split_plan(rows, heads, keys, want):
    """The kernel's split rule: no split from two blocks per SM (264) up,
    else about that many blocks, never more splits than key tiles, every
    split non-empty and the tiles all covered."""
    splits, per = k3.split_plan(rows, heads, keys)
    assert (splits, per) == want
    tiles = -(-keys // k3.KEY_TILE)
    base = heads * -(-rows // k3.ROW_TILE)
    assert 1 <= splits <= tiles and per * (splits - 1) < tiles <= per * splits
    if base >= 2 * k3.SMS:
        assert splits == 1
    else:  # the tiles per split that the wanted count needs
        assert per == -(-tiles // min(tiles, -(-2 * k3.SMS // base)))


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_reprogramming_split_merge_matches_jax(splits):
    """The kernel's algorithm (key ranges of whole tiles, each with its
    unnormalised acc, row max and sum, then the exact merge) against
    reprogramming.py's _reference at several split counts; 300 keys are
    five tiles, the last partial. f32, summation order only."""
    rng = np.random.default_rng(splits)
    B, L, H, E, S = 3, 7, 4, 32, 300
    q = rng.standard_normal((B, L, H, E)).astype(np.float32)
    k = rng.standard_normal((S, H, E)).astype(np.float32)
    v = rng.standard_normal((S, H, E)).astype(np.float32)
    scale = float(1.0 / np.sqrt(E))
    ref = jax_repro._reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out = k3.reprogramming_attention_split(_t(q), _t(k), _t(v), scale, splits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # the default takes split_plan's count
    torch.testing.assert_close(k3.reprogramming_attention_split(_t(q), _t(k), _t(v), scale),
                               k3.reprogramming_attention_split(_t(q), _t(k), _t(v), scale,
                                                                k3.split_plan(B * L, H, S)[0]))




# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------

def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails leaves no library behind and raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list(tmp_path.iterdir())


def test_sources_define_every_entry_point():
    """Every C signature bound in _build.py is defined in csrc/."""
    text = "".join(p.read_text() for p in _build.sources())
    for name in list(_build.SIGNATURES) + ["mt_error_string"]:
        assert f" {name}(" in text, name
