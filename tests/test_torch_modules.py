"""Each ported module against its JAX module, with the flax parameters
copied by ``weights.from_flax`` and the same numpy inputs made from a seed.

Tolerances: f32 with dense projections differs only in summation order
(1e-5). With int8 projections (quantize=8) the integer math is exact, but a
last-bit difference in an activation can flip one int8 rounding, which
moves outputs by about one quantization step: 2e-3 relative. bf16 storage
differs by bf16 roundings (2^-8 each): 3e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS
from medtsllm_tpu.ops import embed as jembed
from medtsllm_tpu.ops import revin as jrevin
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import PRESETS, DecoderConfig
from medtsllm_tpu_torch.ops import embed as tembed
from medtsllm_tpu_torch.ops import revin as trevin
from medtsllm_tpu_torch.ops.kernels.rope_attention import rope, rope_tables
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype="float32", quantize=0, scale=1.0):
    if dtype == "bfloat16":
        t = 3e-2
    else:
        t = 2e-3 if quantize else 1e-5
    return dict(rtol=t, atol=t * scale)


def _cfgs(gqa=False):
    jc, tc = JAX_PRESETS["llama-tiny"], PRESETS["llama-tiny"]
    if gqa:
        import dataclasses
        jc, tc = (dataclasses.replace(jc, n_kv_heads=2),
                  dataclasses.replace(tc, n_kv_heads=2))
    return jc, tc


def _params(module, *args, storage="float32", seed=0, **kw):
    """flax init; per-channel int8 scales randomised (the init's constant
    scale would hide a channel-order bug); float leaves cast to the
    storage dtype as the trainers do."""
    params = jax.jit(lambda k, *a: module.init(k, *a, **kw))(
        jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            leaf = jnp.asarray(rng.uniform(2e-4, 1e-3, leaf.shape), jnp.float32)
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            leaf = leaf.astype(JDT[storage])
        return leaf
    return jax.tree_util.tree_map_with_path(fix, params)


def _load(module, params, storage="float32"):
    module.to(TDT[storage])
    module.load_state_dict(from_flax(jax.device_get(params)))
    return module


def _apply(module, params, *args, method=None, **static):
    """flax apply under jit (one compile instead of op-by-op dispatch)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method,
                                              **static))(params, *args)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# time-series front end
# --------------------------------------------------------------------------

def test_revin_norm_denorm():
    x = _x(0, 3, 32, 4) * 3 + 1
    xn_j, st_j = jrevin.revin_norm(jnp.asarray(x))
    xn_t, st_t = trevin.revin_norm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(xn_t), _np(xn_j), rtol=1e-5, atol=1e-5)
    for k in ("center", "stdev"):
        np.testing.assert_allclose(_np(st_t[k]), _np(st_j[k]), rtol=1e-6)
    y = _x(1, 3, 32, 4)
    np.testing.assert_allclose(
        _np(trevin.revin_denorm(torch.from_numpy(y), st_t)),
        _np(jrevin.revin_denorm(jnp.asarray(y), st_j)), rtol=1e-5, atol=1e-5)


def test_patch_unfold():
    x = _x(2, 2, 3, 37)
    np.testing.assert_array_equal(
        _np(tembed.patch_unfold(torch.from_numpy(x), 8, 4)),
        _np(jembed.patch_unfold(jnp.asarray(x), 8, 4)))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_patch_embedding(storage):
    x = _x(3, 2, 3, 64)
    jm = jembed.PatchEmbedding(16, 16, 8, 0.0, pos_embed=False)
    p = _params(jm, jnp.asarray(x), storage=storage)
    want, n_vars = _apply(jm, p, jnp.asarray(x))
    tm = _load(tembed.PatchEmbedding(16, 16, 8), p, storage)
    got = tm(torch.from_numpy(x))
    assert n_vars == 3 and got.dtype == torch.float32  # promoted, as flax
    # f32 compute over (possibly bf16-stored) weights: summation order only
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# decoder pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_rmsnorm(storage):
    x = _x(4, 2, 5, 64)
    jm = jtf.RMSNorm(eps=1e-5, param_dtype=JDT[storage])
    p = _params(jm, jnp.asarray(x), storage=storage)
    p = jax.tree.map(lambda w: w * 1.5, p)
    tm = _load(ttf.RMSNorm(64, 1e-5), p, storage)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               _np(_apply(jm, p, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary(dtype):
    x = jnp.asarray(_x(5, 2, 9, 4, 16)).astype(JDT[dtype])
    pos = 7 + jnp.arange(9)
    want = jtf.rotary_embedding(x, pos, 10000.0, seq_axis=1)
    got = rope(torch.from_numpy(_np(x)).to(TDT[dtype]),
               *rope_tables(torch.arange(7, 16), 16, 10000.0))
    # bf16: XLA may round the rotation once, torch after each op
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, scale=2.0))


def _jax_attention(cfg, quantize, dtype):
    dt = None if dtype == "float32" else JDT[dtype]
    return jtf.Attention(cfg, dtype=dt, param_dtype=JDT[dtype], quantize=quantize)


@pytest.mark.parametrize("quantize", [0, 8])
@pytest.mark.parametrize("gqa", [False, True])
def test_attention_with_and_without_prefix(quantize, gqa):
    """Plain forward, return_kv (the prefill cache) and the prefix_kv path
    at position_offset; cached == uncached within the port."""
    jc, tc = _cfgs(gqa)
    x = jnp.asarray(_x(6, 2, 12, 64))
    jm = _jax_attention(jc, quantize, "float32")
    p = _params(jm, x)
    tm = _load(ttf.Attention(tc, quantize), p)
    tx = torch.from_numpy(np.asarray(x))
    tol = _tol(quantize=quantize)

    want = _apply(jm, p, x)
    np.testing.assert_allclose(_np(tm(tx)), _np(want), **tol)

    # prefill the first 5 tokens, then the suffix attends them as prefix
    want_h, (kj, vj) = _apply(jm, p, x[:1, :5], return_kv=True)
    got_h, (kt, vt) = tm(tx[:1, :5], return_kv=True)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **tol)
    np.testing.assert_allclose(_np(kt), _np(kj), **tol)
    np.testing.assert_allclose(_np(vt), _np(vj), **tol)
    want_s = jax.jit(lambda p, x, kv: jm.apply({"params": p}, x, prefix_kv=kv,
                                              position_offset=5))(p, x[:, 5:], (kj, vj))
    got_s = tm(tx[:, 5:], prefix_kv=(kt, vt), position_offset=5)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **tol)
    full = tm(torch.cat([tx[:1, :5].expand(2, -1, -1), tx[:, 5:]], dim=1))
    np.testing.assert_allclose(_np(got_s), _np(full[:, 5:]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [0, 8])
def test_mlp(quantize):
    jc, tc = _cfgs()
    x = jnp.asarray(_x(7, 2, 6, 64))
    jm = jtf.MLP(jc, quantize=quantize)
    p = _params(jm, x)
    tm = _load(ttf.MLP(tc, quantize), p)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(np.asarray(x)))),
                               _np(_apply(jm, p, x)),
                               **_tol(quantize=quantize, scale=0.1))


@pytest.mark.parametrize("storage,quantize", [("float32", 0), ("float32", 8),
                                              ("bfloat16", 8)])
def test_block(storage, quantize):
    jc, tc = _cfgs()
    x = jnp.asarray(_x(8, 2, 10, 64))
    dt = None if storage == "float32" else JDT[storage]
    jm = jtf.Block(jc, dtype=dt, param_dtype=JDT[storage], quantize=quantize)
    p = _params(jm, x, storage=storage)
    tm = _load(ttf.Block(tc, quantize, None if dt is None else TDT[storage]), p, storage)
    got = tm(torch.from_numpy(np.asarray(x)))
    want = _apply(jm, p, x)
    assert got.dtype == torch.float32  # the residual stream stays f32
    np.testing.assert_allclose(_np(got), _np(want), **_tol(storage, quantize, 3.0))


@pytest.mark.parametrize("quantize", [0, 8])
def test_decoder_prefill_and_cached_forward(quantize):
    """prefill() caches per-layer rotated K/V equal to JAX's; the cached
    forward over the suffix equals JAX's and the port's uncached one."""
    jc, tc = _cfgs(gqa=True)
    x = jnp.asarray(_x(9, 2, 14, 64))
    jm = jtf.TransformerDecoder(jc, quantize=quantize)
    p = _params(jm, x)
    tm = _load(ttf.TransformerDecoder(tc, quantize), p)
    tx = torch.from_numpy(np.asarray(x))
    tol = _tol(quantize=quantize, scale=3.0)
    np.testing.assert_allclose(_np(tm(tx)), _np(_apply(jm, p, x)), **tol)

    kv_j = _apply(jm, p, x[:1, :6], method=jtf.TransformerDecoder.prefill)
    kv_t = tm.prefill(tx[:1, :6])
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        np.testing.assert_allclose(_np(kt), _np(kj), **tol)
        np.testing.assert_allclose(_np(vt), _np(vj), **tol)
    want = jax.jit(lambda p, x, kv: jm.apply({"params": p}, x, prefix_kv=kv))(
        p, x[:, 6:], kv_j)
    got = tm(tx[:, 6:], prefix_kv=kv_t)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    full = tm(torch.cat([tx[:1, :6].expand(2, -1, -1), tx[:, 6:]], dim=1))
    np.testing.assert_allclose(_np(got), _np(full[:, 6:]), rtol=1e-5, atol=1e-5)


def test_decoder_config_matches_presets():
    for name, tc in PRESETS.items():
        jc = JAX_PRESETS[name]
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
                  "max_position", "rope_theta", "norm_eps", "bos_token_id",
                  "eos_token_id"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert (tc.head_dim, tc.kv_heads) == (jc.head_dim, jc.kv_heads)
    assert isinstance(tc, DecoderConfig)
