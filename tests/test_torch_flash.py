"""K4, the flash-attention kernel, on the CPU: its plain version against the
JAX package's ``_attention_reference`` and against the TPU kernel's own
body (``_flash_kernel``) run through a test-side ``pl.pallas_call`` in
interpret mode with the specs of ``_flash_attention_pallas`` and small
blocks (16 x 32), so that partial k-tiles, partial q-tiles and skipped
causal blocks occur; the long-window route's plain version
(``rope_flash_attention_plain``, with its prefill cache and the pre-pass's
plain version) against JAX's own route, rotary in the projection layout,
the transposes and the prefix concat, then the reference or the Pallas
kernel; then the decoder on the K4 route (``K4_MIN_KEYS`` set low) against
the JAX decoder, the MedTsLLM slice on that route against the JAX trainer,
and the route's rules.

Tolerances: f32 differs only in summation order and the online against
the two-pass softmax: rtol = atol = 1e-5. bf16 rounds the probabilities to
bf16 before PV (2^-8 relative each) at points that differ between the
three forms (normalised before the cast in the reference and the plain
version, after PV in the kernel), so outputs may differ by a bf16 ulp or so:
compared in f32, each query row within 2^-6 x the largest |reference| of
that row (K2's bound, taken per row: a row that sees few keys has outputs
tens of times larger than one that averages thousands). The decoder and
slice tolerances are tests/test_torch_medtsllm.py's: dense f32 1e-5, int8
projections 2e-3 (an activation's last bit can flip one int8 rounding).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS
from medtsllm_tpu.ops.pallas.flash_attention import _attention_reference, _flash_kernel
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import PRESETS
from medtsllm_tpu_torch.ops.kernels import flash_attention as k4
from medtsllm_tpu_torch.ops.kernels.rope_attention import MAX_KEYS, rope_tables
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pallas_flash(q, k, v, causal, sm_scale, block_q=16, block_k=32):
    """``_flash_attention_pallas`` (flash_attention.py:152-193) with its
    grid, BlockSpecs and VMEM scratch, run in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, H, L, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    block_q, block_k = min(block_q, L), min(block_k, S)
    kernel = functools.partial(_flash_kernel, sm_scale=sm_scale, causal=causal,
                               block_q=block_q, block_k=block_k, q_len=L, kv_len=S)
    out = pl.pallas_call(
        kernel,
        grid=(B * H, pl.cdiv(L, block_q), pl.cdiv(S, block_k)),
        in_specs=[pl.BlockSpec((1, block_q, D), lambda b, i, j: (b, i, 0)),
                  pl.BlockSpec((1, block_k, D), lambda b, i, j: (b // G, j, 0)),
                  pl.BlockSpec((1, block_k, D), lambda b, i, j: (b // G, j, 0))],
        out_specs=pl.BlockSpec((1, block_q, D), lambda b, i, j: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((B * H, L, D), q.dtype),
        scratch_shapes=[pltpu.VMEM((block_q, 1), jnp.float32),
                        pltpu.VMEM((block_q, 1), jnp.float32),
                        pltpu.VMEM((block_q, D), jnp.float32)],
        interpret=True,
    )(q.reshape(B * H, L, D), k.reshape(B * KV, S, D), v.reshape(B * KV, S, D))
    return out.reshape(B, H, L, D)


def _qkv(seed, B, H, KV, L, S, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, L, D), (B, KV, S, D), (B, KV, S, D))]


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _row_share(got, want):
    """The largest share, over query rows, of a row's max |got - want| in
    2^-6 x max |want| of that row (at most 1 passes)."""
    err = np.abs(got - want).max(-1)
    return float((err / np.maximum(2.0 ** -6 * np.abs(want).max(-1), 1e-30)).max())


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _row_share(got, want) <= 1


# (B, H, KV, L, S, D, causal): a prefix (L < S, partial k- and q-tiles,
# skipped blocks), L == S, non-causal, GQA with KV 1, 2 and 4 of H 8, D 64
# and 128; D 576 (past 512, GQA 2 / 1, a prefix, partial tiles)
_CASES = [(1, 4, 2, 40, 72, 64, True),
          (2, 8, 8, 48, 48, 64, True),
          (1, 8, 4, 24, 56, 128, False),
          (2, 8, 1, 20, 45, 64, True),
          (1, 8, 2, 33, 33, 128, True),
          (1, 8, 4, 16, 100, 64, False),
          (1, 2, 1, 20, 40, 576, True)]

# the JAX side compiled once per shape (eager dispatch of the reference's and
# the interpreter's ops costs more than the compile at these sizes)
_jit_reference = jax.jit(_attention_reference, static_argnums=(3, 4))
_jit_pallas = jax.jit(_pallas_flash, static_argnums=(3, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,L,S,D,causal", _CASES)
def test_plain_matches_reference_and_tpu_kernel(B, H, KV, L, S, D, causal, dtype):
    qn, kn, vn = _qkv(L * S + D, B, H, KV, L, S, D)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = (jnp.asarray(a).astype(JDT[dtype]) for a in (qn, kn, vn))
    ref = _jit_reference(jq, jk, jv, causal, scale)
    kern = _jit_pallas(jq, jk, jv, causal, scale)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (qn, kn, vn))
    got = k4.flash_attention_plain(tq, tk, tv, causal, scale)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, L, D)
    _close(_f32(got), _f32(ref), dtype)
    _close(_f32(got), _f32(kern), dtype)
    # the wrapper takes the plain version for a CPU tensor and counts no launch
    n = k4.flash_attention.launches
    np.testing.assert_array_equal(_f32(k4.flash_attention(tq, tk, tv, causal, scale)),
                                  _f32(got))
    assert k4.flash_attention.launches == n


def _jax_route(q, k, v, positions, theta, pk, pv, scale, attend):
    """JAX's long-window route (transformer.py:591-633): rotary in the
    projection layout, the head transposes, the prefix ahead of k/v, then
    ``attend`` (end-aligned causal), the output back in [B, L, H, D]."""
    qr = jtf.rotary_embedding(q, positions, theta, seq_axis=1).transpose(0, 2, 1, 3)
    kr = jtf.rotary_embedding(k, positions, theta, seq_axis=1).transpose(0, 2, 1, 3)
    vt = v.transpose(0, 2, 1, 3)
    if pk is not None:
        B = q.shape[0]
        kr = jnp.concatenate([jnp.broadcast_to(pk, (B,) + pk.shape[1:]), kr], axis=2)
        vt = jnp.concatenate([jnp.broadcast_to(pv, (B,) + pv.shape[1:]), vt], axis=2)
    return attend(qr, kr, vt, True, scale).transpose(0, 2, 1, 3), kr, vt


# theta, scale and the attention function static
_jit_route = jax.jit(_jax_route, static_argnums=(4, 7, 8))


# (B, L, H, KV, D, P, PB): no prefix; the served 37-token head shared by the
# batch (PB 1) and per row (PB = B); GQA with KV 4, 2 and 1; L and S = P + L
# no multiple of 64 or 128 (S 146 leaves a partial second 128-key tile)
_ROUTE_CASES = [(2, 50, 4, 4, 64, 0, 1),
                (2, 70, 8, 2, 128, 37, 1),
                (2, 45, 8, 4, 64, 37, 2),
                (1, 133, 4, 1, 128, 13, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,D,P,PB", _ROUTE_CASES)
def test_route_plain_matches_jax_route(B, L, H, KV, D, P, PB, dtype):
    """``rope_flash_attention_plain`` against JAX's route on the reference
    and on the Pallas kernel, its prefill cache against JAX's ``new_kv``,
    and the pre-pass's plain version: the same keys and values, rotated
    with one rounding (equal to torch's rope in f32, within a bf16 ulp of
    it in bf16)."""
    rng = np.random.default_rng(B * L + D + P)

    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    qn, kn, vn = mk(B, L, H, D), mk(B, L, KV, D), mk(B, L, KV, D)
    pkn, pvn = (mk(PB, KV, P, D), mk(PB, KV, P, D)) if P else (None, None)
    theta, scale = 10000.0, 1.0 / np.sqrt(D)

    def j(a):
        return None if a is None else jnp.asarray(a).astype(JDT[dtype])

    def t(a):
        return None if a is None else torch.from_numpy(a).to(TDT[dtype])
    positions = jnp.arange(P, P + L)
    jargs = (j(qn), j(kn), j(vn), positions, theta, j(pkn), j(pvn), scale)
    ref, jk, jv = _jit_route(*jargs, _attention_reference)
    kern = _jit_route(*jargs, _pallas_flash)[0]
    cos, sin = rope_tables(torch.arange(P, P + L), D, theta)
    targs = (t(qn), t(kn), t(vn), cos, sin, t(pkn), t(pvn), scale)
    got, (kr, vt) = k4.rope_flash_attention_plain(*targs, return_kv=True)
    assert got.shape == (B, L, H, D) and got.dtype == TDT[dtype]
    _close(_f32(got), _f32(ref), dtype)
    _close(_f32(got), _f32(kern), dtype)
    # the prefill's cache is the region's rotated k and v, as JAX's new_kv
    # (the sin/cos tables of the two frameworks may differ in an f32 ulp,
    # which can move a bf16 rounding by one ulp, 2^-8 relative)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_f32(kr), _f32(jk[:, :, P:]), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_f32(vt), _f32(jv[:, :, P:]))
    # the wrapper takes the plain version for a CPU tensor and counts no launch
    n = (k4.rope_flash_attention.launches, k4.rope_flash_keys.launches)
    np.testing.assert_array_equal(_f32(k4.rope_flash_attention(*targs)), _f32(got))
    assert (k4.rope_flash_attention.launches, k4.rope_flash_keys.launches) == n
    # the pre-pass: [prefix | keys rotated once] and [prefix | values]
    keys, values = k4.rope_flash_keys(t(kn), t(vn), cos, sin, t(pkn), t(pvn))
    assert keys.shape == values.shape == (B, KV, P + L, D)
    np.testing.assert_array_equal(_f32(values), _f32(jv))
    np.testing.assert_array_equal(_f32(keys[:, :, :P]), _f32(jk[:, :, :P]))
    if dtype == "float32":  # one rounding is torch's rounding in f32
        np.testing.assert_array_equal(_f32(keys[:, :, P:]), _f32(kr))
    else:  # one rounding against torch's three: a bf16 ulp (2^-8) apart at most
        np.testing.assert_allclose(_f32(keys[:, :, P:]), _f32(kr), rtol=2.0 ** -7,
                                   atol=2.0 ** -7)


def test_wrapper_route_raises_on_grad():
    q = torch.zeros(1, 4, 2, 64, requires_grad=True)
    k = torch.zeros(1, 4, 2, 64)
    cos, sin = rope_tables(torch.arange(4), 64, 10000.0)
    with pytest.raises(NotImplementedError, match="no backward"):
        k4.rope_flash_attention(q, k, k, cos, sin)
    with torch.no_grad():
        assert k4.rope_flash_attention(q, k, k, cos, sin).shape == q.shape


def test_row_bound_catches_a_dropped_partial_k_tile():
    """At the long window's layout (39 head tokens, 2128 queries, 2167 keys:
    a last k-tile of 64 holds only the 55 keys past 2112), an output that
    leaves out that partial tile misses the per-row bf16 bound in the rows
    that see it, while the plain version's bf16 output meets the bound
    against its f32 form on the same inputs."""
    P, L, D, block_k = 39, 2128, 64, 64
    S = P + L
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _qkv(7, 1, 2, 2, L, S, D))
    ref = k4.flash_attention_plain(tq.float(), tk.float(), tv.float())
    good = k4.flash_attention_plain(tq, tk, tv)
    keep = torch.ones(L, S, dtype=torch.bool).tril(S - L)
    keep[:, S // block_k * block_k:] = False
    scores = (tq.float() @ tk.float().transpose(-1, -2)) * D ** -0.5
    dropped = (scores.masked_fill(~keep, -1e30).softmax(-1) @ tv.float()).to(torch.bfloat16)
    assert _row_share(_f32(good), _f32(ref)) <= 1
    assert _row_share(_f32(dropped), _f32(ref)) > 1


def test_check_dims_takes_every_multiple_of_64():
    """The kernel's shape rule is JAX's dispatcher's: every D % 64 == 0 (D 576
    and 1024 past the widest shipped head), not D 80; the route's entry
    keeps its own head dims (64, 128)."""
    f32 = (torch.float32,) * 3
    for D in (64, 320, 576, 1024):
        k4._check_dims(1, 4, 2, D, f32)
        assert k4.attention_route(512, 512, D, True) == "k4"
    with pytest.raises(ValueError, match="D % 64"):
        k4._check_dims(1, 4, 2, 80, f32)
    with pytest.raises(ValueError, match="this entry"):
        k4._check_dims(1, 4, 2, 576, f32, (64, 128))
    with pytest.raises(ValueError, match="must divide"):
        k4._check_dims(1, 4, 3, 576, f32)


def test_wrapper_raises_on_grad():
    q = torch.zeros(1, 2, 4, 64, requires_grad=True)
    k = torch.zeros(1, 2, 4, 64)
    with pytest.raises(NotImplementedError, match="no backward"):
        k4.flash_attention(q, k, k)
    with torch.no_grad():
        assert k4.flash_attention(q, k, k).shape == q.shape


# --------------------------------------------------------------------------
# the route in Attention.forward
# --------------------------------------------------------------------------

class _Spy:
    """Counts the calls of the attention functions the decoder module uses
    (K2, and K4's route)."""

    def __init__(self, monkeypatch):
        self.k2 = self.k4 = 0
        k2_fn, k4_fn = ttf.rope_attention, ttf.rope_flash_attention

        def k2(*a, **kw):
            self.k2 += 1
            return k2_fn(*a, **kw)

        def k4_(*a, **kw):
            self.k4 += 1
            return k4_fn(*a, **kw)
        monkeypatch.setattr(ttf, "rope_attention", k2)
        monkeypatch.setattr(ttf, "rope_flash_attention", k4_)


# llama-tiny at head dim 64 (d 128, 2 heads): the head dims K2 and the K4
# route have (llama-tiny's own 16 takes JAX's default path, rotation then the
# attention dispatcher)
D64 = dict(d_model=128, n_heads=2)


def _cfgs(gqa):
    over = dict(D64, n_kv_heads=1) if gqa else D64
    return (dataclasses.replace(JAX_PRESETS["llama-tiny"], **over),
            dataclasses.replace(PRESETS["llama-tiny"], **over))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("quantize", [0, 8])
@pytest.mark.parametrize("gqa", [False, True])
def test_decoder_on_k4_route_matches_jax(monkeypatch, quantize, gqa):
    """The 2-layer llama-tiny decoder (at head dim 64) with every attention on K4 (prefill
    included): the uncached forward, the prefill's rotated K/V and the
    forward over the suffix with the prefix K/V, against the JAX decoder."""
    monkeypatch.setattr(ttf, "K4_MIN_KEYS", 1)
    spy = _Spy(monkeypatch)
    jc, tc = _cfgs(gqa)
    x = jnp.asarray(_x(11, 2, 14, tc.d_model))
    jm = jtf.TransformerDecoder(jc, quantize=quantize)
    params = jax.jit(lambda key, x: jm.init(key, x))(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (jnp.asarray(rng.uniform(2e-4, 1e-3, leaf.shape), jnp.float32)
                            if jax.tree_util.keystr(path).endswith("['scale']") else leaf),
        params)
    tm = ttf.TransformerDecoder(tc, quantize)
    tm.load_state_dict(from_flax(jax.device_get(params)))
    tx = torch.from_numpy(np.array(x))
    t = 2e-3 if quantize else 1e-5
    tol = dict(rtol=t, atol=3 * t)

    def apply(*args, **kw):
        return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kw))(params, *args)

    with torch.inference_mode():
        np.testing.assert_allclose(_f32(tm(tx)), _f32(apply(x)), **tol)
        assert (spy.k4, spy.k2) == (tc.n_layers, 0)
        kv_j = apply(x[:1, :6], method=jtf.TransformerDecoder.prefill)
        kv_t = tm.prefill(tx[:1, :6])
        for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
            np.testing.assert_allclose(_f32(kt), _f32(kj), **tol)
            np.testing.assert_allclose(_f32(vt), _f32(vj), **tol)
        want = jax.jit(lambda p, x, kv: jm.apply({"params": p}, x, prefix_kv=kv))(
            params, x[:, 6:], kv_j)
        got = tm(tx[:, 6:], prefix_kv=kv_t)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
        assert (spy.k4, spy.k2) == (3 * tc.n_layers, 0)
        # K2 and K4 compute the same function: the default route agrees
        monkeypatch.setattr(ttf, "K4_MIN_KEYS", MAX_KEYS + 1)
        np.testing.assert_allclose(_f32(tm(tx[:, 6:], prefix_kv=kv_t)), _f32(got),
                                   rtol=1e-5, atol=1e-5)
        assert spy.k2 == tc.n_layers


def _attention():
    cfg = dataclasses.replace(PRESETS["llama-tiny"], d_model=256, n_heads=4, n_kv_heads=2)
    torch.manual_seed(0)
    m = ttf.Attention(cfg)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    return m, cfg


@pytest.mark.parametrize("prefix,k4_min", [(2040, 10 ** 9), (0, 10 ** 9), (30, 40), (30, 50)])
def test_route_by_key_count(monkeypatch, prefix, k4_min):
    """K4 past K2's 2048 keys whatever K4_MIN_KEYS is, and from K4_MIN_KEYS
    keys; K2 below. The two routes agree."""
    m, cfg = _attention()
    L = 2050 if prefix == 0 else 10
    D = cfg.head_dim
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, L, cfg.d_model)).astype(np.float32))
    pk = torch.from_numpy(rng.standard_normal((1, cfg.kv_heads, prefix, D)).astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal((1, cfg.kv_heads, prefix, D)).astype(np.float32))
    kv = (pk, pv) if prefix else None
    monkeypatch.setattr(ttf, "K4_MIN_KEYS", k4_min)
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        out, new_kv = m(x, kv, prefix, return_kv=True)
    keys = prefix + L
    want_k4 = keys > MAX_KEYS or keys >= k4_min
    assert (spy.k4, spy.k2) == ((1, 0) if want_k4 else (0, 1))
    if keys <= MAX_KEYS:  # the other route gives the same output and cache
        monkeypatch.setattr(ttf, "K4_MIN_KEYS", 1 if not want_k4 else MAX_KEYS + 1)
        with torch.no_grad():
            out2, kv2 = m(x, kv, prefix, return_kv=True)
        np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=1e-5, atol=1e-5)
        for a, b in zip(kv2, new_kv):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gradient_keeps_k2_and_raises_past_its_limit(monkeypatch):
    m, cfg = _attention()
    monkeypatch.setattr(ttf, "K4_MIN_KEYS", 1)
    spy = _Spy(monkeypatch)
    D = cfg.head_dim
    x = torch.randn(1, 10, cfg.d_model, requires_grad=True)
    pk = torch.randn(1, cfg.kv_heads, 30, D)
    m(x, (pk, pk), 30).sum().backward()  # 40 keys: K2 and its backward
    assert (spy.k2, spy.k4) == (1, 0) and x.grad is not None
    big = torch.randn(1, cfg.kv_heads, MAX_KEYS, D)
    with pytest.raises(NotImplementedError, match="flash-attention kernel"):
        m(x, (big, big), MAX_KEYS)


# --------------------------------------------------------------------------
# the slice as a whole on the K4 route
# --------------------------------------------------------------------------

_TOL = {(0, "float32"): 1e-5, (8, "float32"): 2e-3}
LLAMA_D64 = "llama-tiny-d64"


@pytest.fixture
def slice_preset(monkeypatch):
    """llama-tiny at head dim 64 under its own id, in both packages' presets."""
    monkeypatch.setitem(JAX_PRESETS, LLAMA_D64,
                        dataclasses.replace(JAX_PRESETS["llama-tiny"], **D64))
    monkeypatch.setitem(PRESETS, LLAMA_D64, dataclasses.replace(PRESETS["llama-tiny"], **D64))


def _slice_cfg(tmp_path, quant, dtype):
    """tests/test_torch_medtsllm.py's llama-tiny serving config, over
    ``LLAMA_D64`` (llama-tiny at head dim 64, ``slice_preset``)."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 384
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": LLAMA_D64, "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False,
                "load_in_8bit": quant == 8},
    }}
    return cfg


@pytest.mark.parametrize("quant,dtype", sorted(_TOL))
def test_slice_on_k4_route_matches_jax(monkeypatch, slice_preset, tmp_path, quant, dtype):
    """MedTsLLM's eval_dispatch on every test batch against JAX's eval_step,
    and test() scores, with every decoder attention on K4 (the prefill of
    the prompt head included)."""
    monkeypatch.setattr(ttf, "K4_MIN_KEYS", 1)
    spy = _Spy(monkeypatch)
    cfg = _slice_cfg(tmp_path, quant, dtype)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    tol = _TOL[(quant, dtype)]
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    n_layers = tt.model.llm_cfg.n_layers  # every batch and the prefill
    assert spy.k2 == 0 and spy.k4 == n_layers * (len(tt.test_pipeline) + 1)
    want, got = jt.test(), tt.test()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=tol)
