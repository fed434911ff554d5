"""The LayerNorm decoder families (gpt2, opt, neox) and llama at a head dim
other than 64 and 128, in the port against the JAX package on the CPU, at
the tiny presets (d 64, 4 heads x 16; llama-tiny cut to 2 heads x 32).

  (a) ``Attention`` (plain, ``return_kv``, then ``prefix_kv`` at its
      offset), ``MLP`` and ``Block`` (neox: the parallel residual) on
      ``from_flax`` weights;
  (b) ``TransformerDecoder``: the plain forward, ``prefill``'s per-layer
      K/V and the cached forward over the suffix (opt's learned positions
      from row 2 + P, neox's partial rotary at offset P), cached = the
      port's own uncached forward;
  (c) MedTsLLM over each family through the trainers: the prompt ids equal
      to JAX's, ``eval_dispatch`` against JAX's ``eval_step`` on every test
      batch, cached = uncached (JAX's ``test_cached_equals_uncached``
      bound: rtol 1e-4, atol 1e-5), test() scores; each family dense, opt
      at w8a8, gpt2 with ``load_in_4bit`` (K5's plain version);
  (d) the route: an ln-family call of 512+ keys at head dim 64 takes K4
      through ``dispatch_attention`` (a spy on the CPU's plain version), as
      does llama at head dim 192, never K2.

Tolerances are tests/test_torch_modules.py's: dense f32 1e-5; w8a8 2e-3
relative (a last-bit activation difference flips an int8 rounding, ROADMAP
queue 3); int4 likewise.
"""

import contextlib
import dataclasses
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import PRESETS
from medtsllm_tpu_torch.ops.kernels import flash_attention as k4
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax
from test_torch_modules import _apply, _load, _np, _params, _tol, _x

torch.set_num_threads(1)

FAMILIES = ("gpt2-tiny", "opt-tiny", "neox-tiny")


@contextlib.contextmanager
def jitted_flax_init():
    """flax ``Module.init`` under ``jax.jit`` while a JAX trainer is built
    (one compile in place of one per op; the same parameters)."""
    eager = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, a: eager(self, r, *a, **kwargs))(rngs, args)
    fnn.Module.init = init
    try:
        yield
    finally:
        fnn.Module.init = eager


def _cfgs(name):
    """(JAX config, port config); "llama-d32" is llama-tiny at 2 heads x 32."""
    if name == "llama-d32":
        return (dataclasses.replace(JAX_PRESETS["llama-tiny"], n_heads=2),
                dataclasses.replace(PRESETS["llama-tiny"], n_heads=2))
    return JAX_PRESETS[name], PRESETS[name]


# --------------------------------------------------------------------------
# (a) the modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,quantize", [(n, 0) for n in FAMILIES + ("llama-d32",)]
                         + [("gpt2-tiny", 8), ("opt-tiny", 8), ("llama-d32", 8)])
def test_attention_with_and_without_prefix(name, quantize):
    jc, tc = _cfgs(name)
    x = jnp.asarray(_x(1, 2, 12, 64))
    jm = jtf.Attention(jc, quantize=quantize)
    p = _params(jm, x)
    tm = _load(ttf.Attention(tc, quantize), p).eval()
    tx = torch.from_numpy(np.asarray(x))
    tol = _tol(quantize=quantize)
    np.testing.assert_allclose(_np(tm(tx)), _np(_apply(jm, p, x)), **tol)
    want_h, (kj, vj) = _apply(jm, p, x[:1, :5], return_kv=True)
    got_h, (kt, vt) = tm(tx[:1, :5], return_kv=True)
    for got, want in ((got_h, want_h), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    want_s = jax.jit(lambda p, x, kv: jm.apply({"params": p}, x, prefix_kv=kv,
                                              position_offset=5))(p, x[:, 5:], (kj, vj))
    got_s = tm(tx[:, 5:], prefix_kv=(kt, vt), position_offset=5)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **tol)
    full = tm(torch.cat([tx[:1, :5].expand(2, -1, -1), tx[:, 5:]], dim=1))
    np.testing.assert_allclose(_np(got_s), _np(full[:, 5:]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [0, 8])
@pytest.mark.parametrize("name", FAMILIES)
def test_mlp_and_block(name, quantize):
    """The biased c_fc / c_proj with the family's activation (gpt2 tanh
    GELU, opt relu, neox exact GELU); the block's LayerNorms and, for neox,
    the parallel residual."""
    jc, tc = _cfgs(name)
    x = jnp.asarray(_x(2, 2, 10, 64))
    jm = jtf.MLP(jc, quantize=quantize)
    p = _params(jm, x)
    tm = _load(ttf.MLP(tc, quantize), p).eval()
    np.testing.assert_allclose(_np(tm(torch.from_numpy(np.asarray(x)))),
                               _np(_apply(jm, p, x)), **_tol(quantize=quantize, scale=0.1))
    jb = jtf.Block(jc, quantize=quantize)
    p = _params(jb, x)
    tb = _load(ttf.Block(tc, quantize), p).eval()
    assert set(from_flax(jax.device_get(p))) == set(tb.state_dict())
    np.testing.assert_allclose(_np(tb(torch.from_numpy(np.asarray(x)))),
                               _np(_apply(jb, p, x)), **_tol(quantize=quantize, scale=3.0))


# --------------------------------------------------------------------------
# (b) the decoder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,quantize", [(n, 0) for n in FAMILIES + ("llama-d32",)]
                         + [("gpt2-tiny", 8), ("neox-tiny", 8)])
def test_decoder_prefill_and_cached_forward(name, quantize):
    jc, tc = _cfgs(name)
    x = jnp.asarray(_x(3, 2, 14, 64))
    jm = jtf.TransformerDecoder(jc, quantize=quantize)
    p = _params(jm, x)
    tm = _load(ttf.TransformerDecoder(tc, quantize), p).eval()
    if tc.learned_positions:
        assert tm.wpe.shape[0] == tc.max_position + tc.pos_offset
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


# --------------------------------------------------------------------------
# (c) MedTsLLM through the trainers
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm, quant=0):
    """tests/test_prefix_cache.py's serving config over ``llm``."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 384
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1, "prefix_cache": True,
                "load_in_4bit": quant == 4, "load_in_8bit": quant == 8},
    }}
    return cfg


# (backbone, quantize): each family dense, opt at w8a8, gpt2 at int4
_PAIRS = [("gpt2-tiny", 0), ("opt-tiny", 0), ("neox-tiny", 0), ("opt-tiny", 8),
          ("gpt2-tiny", 4)]


@pytest.fixture(scope="module", params=_PAIRS, ids=[f"{n}-q{q}" for n, q in _PAIRS])
def pair(request, tmp_path_factory):
    llm, quant = request.param
    cfg = _cfg(tmp_path_factory.mktemp("logs"), llm, quant)
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt, 1e-5 if quant == 0 else 2e-3


def test_medtsllm_eval_matches_jax(pair):
    """The prompt ids, eval_dispatch against JAX's eval_step on every test
    batch, cached = uncached in the port, and test() scores."""
    jt, tt, tol = pair
    assert tt.model.supports_prefix_cache
    # (gpt2's presets have backbone dropout 0.1: its train step embeds the head)
    assert tt.model.train_prefix_cache_safe == (tt.model.llm_cfg.dropout == 0.0)
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
        assert ja["prefix_ids"].ndim == 1
        for k in ("prefix_ids", "prompt_ids"):
            np.testing.assert_array_equal(ja[k], ta[k])
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_model_inputs(batch)
    assert "prefix_kv" in cached and "prefix_ids" not in cached
    np.testing.assert_allclose(tt.eval_step(cached).float().numpy(),
                               tt.eval_step(tt._to_device(tt.model_inputs(batch)))
                               .float().numpy(), rtol=1e-4, atol=1e-5)
    want, got = jt.test(), tt.test()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol)


# --------------------------------------------------------------------------
# (d) the route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES + ("llama-tiny",))
def test_attention_route_by_keys(name, monkeypatch):
    """At one head of 64 (the ln family) or 192 (llama at d 192: no K2
    instance), 512 keys and up ([prefix | region], S a multiple of 256)
    take JAX's gate's K4 route through ``dispatch_attention`` (the CPU runs
    K4's plain version under its name); below that the plain attention; K2
    is never reached."""
    _, tc = _cfgs(name)
    d = 192 if name == "llama-tiny" else 64
    tm = ttf.Attention(dataclasses.replace(tc, d_model=d, n_heads=1)).eval()
    calls = []
    plain = k4.flash_attention_plain
    monkeypatch.setattr(k4, "flash_attention",
                        lambda q, k, v, causal=True, sm_scale=None:
                        calls.append((q.shape[2], k.shape[2])) or plain(q, k, v, causal, sm_scale))
    monkeypatch.setattr(ttf, "rope_attention", None)  # K2 must not be reached
    x = torch.from_numpy(_x(4, 1, 512, d))
    with torch.no_grad():
        _, kv = tm(x[:, :256], return_kv=True)
        tm(x[:, 256:], prefix_kv=kv, position_offset=256)  # L 256, S 512: K4
        tm(x[:, 256:300], prefix_kv=kv, position_offset=256)  # S 300: plain
    assert calls == [(256, 512)]
