"""Quantized Mamba (``load_in_8bit`` / ``load_in_4bit``) in the port against
the JAX package on the CPU, at ``mamba-tiny`` (d 64, E 128, N 8, dt rank 4:
``x_proj`` K 128 -> N 20).

  (a) ``MambaBackbone(quantize=...)`` against JAX's on ``from_flax``
      weights at 8 bits and at 4 bits with the absmax, nf4 and fp4
      codebooks: the block's ``x_proj`` against JAX's ``QuantDense`` on the
      same input (the integer routes' activation codes bit-equal, the
      output within 1e-6: the same s32 sums, the f32 rescale within an
      ulp of XLA's), the state-dict keys of ``from_flax``, the forward,
      and (8 bits, absmax int4) the prefill's states against JAX's and the
      cached forward against the uncached one;
  (b) under bf16 the quantized projections emit what ``Linear`` emits, so
      the gated scan's operands keep their dtypes; ``dt_proj`` stays dense;
  (c) ``init_random_`` draws the three projections by JAX's rule while
      ``dt_proj``, ``A_log`` and ``D`` keep theirs;
  (d) a quantized snapshot: ``hf_to_tree`` bit-equal to JAX's
      ``_hf_to_tree``, merged into the quantized backbone by
      ``load_snapshot_``;
  (e) MedTsLLM through the trainers at absmax int4 (K1's quantizer and
      K5's plain version; one JAX trainer for the module): eval cached =
      uncached and against JAX's ``eval_step``, then one epoch of SGD in
      ``train()`` against JAX's (losses 1e-3, each trainable tensor at the
      w8a8 bounds).

JAX's MambaConfig has no ``quant4_codebook`` field (its ``MambaBlock``
reads it with ``getattr`` and the "absmax" default), so its trainer cannot
build a nf4 / fp4 Mamba; (a) gives JAX's backbone a config that carries the
field. Tolerances: dense f32 1e-5; an int8 code that flips on a last-bit
activation difference moves an output by a step (ROADMAP queue 3): 2e-3
relative end to end, as tests/test_torch_modules.py holds w8a8.
"""

import contextlib
import dataclasses
import json
import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import mamba as jmamba
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import _hf_to_tree, _mamba_presets
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.models.llm import mamba as tmamba
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import MAMBA_PRESETS
from medtsllm_tpu_torch.models.llm.loader import hf_to_tree, load_snapshot_
from medtsllm_tpu_torch.models.llm.safetensors import save_safetensors
from medtsllm_tpu_torch.ops.kernels import selective_scan as kss
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import S_INIT, S_INIT4, from_flax, init_random_
from test_torch_modules import _apply, _load, _np, _params, _x

torch.set_num_threads(1)


@dataclasses.dataclass(frozen=True)
class _JaxMambaConfig(jmamba.MambaConfig):
    """JAX's MambaConfig with the codebook field its block reads by getattr."""
    quant4_codebook: str = "absmax"


MODES = [(8, "absmax"), (4, "absmax"), (4, "nf4"), (4, "fp4")]
IDS = ["q8", "int4", "nf4", "fp4"]


def _cfgs(codebook="absmax"):
    jc = _JaxMambaConfig(**dataclasses.asdict(_mamba_presets()["mamba-tiny"]),
                         quant4_codebook=codebook)
    return jc, dataclasses.replace(MAMBA_PRESETS["mamba-tiny"], quant4_codebook=codebook)


def _backbones(q, codebook, x):
    jc, tc = _cfgs(codebook)
    jm = jmamba.MambaBackbone(jc, quantize=q)
    p = _params(jm, x)
    return jm, p, _load(tmamba.MambaBackbone(tc, q), p).eval()


# --------------------------------------------------------------------------
# (a) the backbone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q,codebook", MODES, ids=IDS)
def test_backbone_matches_jax(q, codebook):
    x = jnp.asarray(_x(0, 2, 14, 64))
    jm, p, tm = _backbones(q, codebook, x)
    tx = torch.from_numpy(np.asarray(x))
    tol = dict(rtol=2e-3, atol=2e-3 * 4.0)
    block = tm.blocks[0]
    for name in ("in_proj", "x_proj", "out_proj"):
        proj = getattr(block, name)
        assert isinstance(proj, ttf.QuantLinear) and proj.bits == q
        assert proj.codebook == (codebook if q == 4 else "absmax")
    assert isinstance(block.dt_proj, ttf.Linear)
    assert set(from_flax(jax.device_get(p))) == set(tm.state_dict())
    # x_proj alone (K 128 -> N 20) on one input: JAX's QuantDense
    xs = _x(1, 2, 14, 128)
    dense = jtf.QuantDense(20, use_bias=False, bits=q, codebook=codebook)
    want = _apply(dense, {"kernel_q": p["h_0"]["x_proj"]["kernel_q"],
                          "scale": p["h_0"]["x_proj"]["scale"]}, jnp.asarray(xs))
    with torch.no_grad():
        got = block.x_proj(torch.from_numpy(xs))
    if codebook == "absmax":  # the activation codes of the integer routes
        rows = xs.reshape(-1, 128)
        codes = jax.jit(lambda v: jnp.round(v / jnp.maximum(
            jnp.max(jnp.abs(v), -1, keepdims=True) / 127.0, 1e-10)).astype(jnp.int8))(rows)
        np.testing.assert_array_equal(k1.quantize_rows_plain(torch.from_numpy(rows))[0].numpy(),
                                      np.asarray(codes))
    # exact s32 sums; the f32 rescale within an ulp of XLA's (the codebooks'
    # float matmul too)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(_np(tm(tx)), _np(_apply(jm, p, x)), **tol)
    if codebook != "absmax":  # the cached path is the integer routes' code
        return
    with torch.no_grad():
        # the prompt-state cache: prefill the head, then the region from it
        states = tm.prefill(tx[:1, :5])
        cached = tm(tx[:, 5:], prefix_kv=tuple(
            (c.expand(2, -1, -1), h.expand(2, -1, -1)) for c, h in states))
        full = tm(torch.cat([tx[:1, :5].expand(2, -1, -1), tx[:, 5:]], dim=1))
    np.testing.assert_allclose(_np(cached), _np(full[:, 5:]), **tol)
    jstates = _apply(jm, p, x[:1, :5], method="prefill")
    for (ct, ht), (cj, hj) in zip(states, jstates):
        np.testing.assert_allclose(_np(ct), _np(cj), **tol)
        np.testing.assert_allclose(_np(ht), _np(hj), **tol)


# --------------------------------------------------------------------------
# (b) the scan's operands
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q,codebook", [(8, "absmax"), (4, "nf4")], ids=["q8", "nf4"])
def test_scan_operands_keep_their_dtypes(q, codebook, monkeypatch):
    """bf16 compute: x_proj's quantized output is bf16 as the dense one
    was, so the gated scan (serving) gets dt_raw, Bs, Cs, xs and z at bf16,
    and A_log / D at the parameters' dtype."""
    _, tc = _cfgs(codebook)
    seen = []

    def spy(*args, **kw):
        seen.append([None if t is None else t.dtype for t in args[:7]])
        return kss.selective_ssm_gated(*args, **kw)
    monkeypatch.setattr(tmamba, "selective_ssm_gated", spy)
    for quantize in (0, q):
        m = tmamba.MambaBackbone(tc, quantize, torch.bfloat16).eval()
        init_random_(m, torch.Generator().manual_seed(0))
        with torch.no_grad():
            m(torch.from_numpy(_x(2, 2, 9, 64)))
    bf, f32 = torch.bfloat16, torch.float32
    assert seen[:2] == seen[2:] == [[bf, f32, bf, bf, bf, f32, bf]] * 2


# --------------------------------------------------------------------------
# (c) the weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q,codebook", [(8, "absmax"), (4, "absmax"), (4, "nf4")],
                         ids=["q8", "int4", "nf4"])
def test_from_flax_and_random_init(q, codebook):
    _, tc = _cfgs(codebook)
    m = tmamba.MambaBackbone(tc, q)
    init_random_(m, torch.Generator().manual_seed(0))
    scale = S_INIT if q == 8 else S_INIT4[codebook]
    for block in m.blocks:
        for name in ("in_proj", "x_proj", "out_proj"):
            proj = getattr(block, name)
            assert torch.all(proj.scale == scale) and proj.weight_q.abs().sum() > 0
        # dt_proj lecun-normal with a zero bias, A_log = log(1..N), D = 1
        assert block.dt_proj.bias.abs().sum() == 0
        assert 0.1 < block.dt_proj.weight.std() < 1.0
        torch.testing.assert_close(block.A_log[7], torch.log(torch.arange(1.0, 9.0)))
        assert torch.all(block.D == 1)


# --------------------------------------------------------------------------
# (d) a quantized snapshot
# --------------------------------------------------------------------------

def _hf_mamba_tensors(cfg, seed=0):
    rng = np.random.default_rng(seed)
    E, N, R, K, d = cfg.d_inner, cfg.d_state, cfg.rank, cfg.d_conv, cfg.d_model

    def mk(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)
    t = {"embeddings.weight": mk(cfg.vocab_size, d), "norm_f.weight": 1 + mk(d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}.mixer."
        t[f"layers.{i}.norm.weight"] = 1 + mk(d)
        t.update({p + "A_log": mk(E, N), p + "D": mk(E), p + "conv1d.weight": mk(E, 1, K),
                  p + "conv1d.bias": mk(E), p + "in_proj.weight": mk(2 * E, d),
                  p + "x_proj.weight": mk(R + 2 * N, E), p + "out_proj.weight": mk(d, E),
                  p + "dt_proj.weight": mk(E, R), p + "dt_proj.bias": mk(E)})
    return t


@pytest.mark.parametrize("q,codebook", [(8, "absmax"), (4, "absmax"), (4, "nf4"), (4, "fp4")],
                         ids=IDS)
def test_snapshot_tree_matches_jax_and_loads(q, codebook, tmp_path):
    jc, tc = _cfgs(codebook)
    tensors = _hf_mamba_tensors(tc)
    want = jax.tree_util.tree_flatten_with_path(_hf_to_tree(jc, tensors, q))[0]
    got = jax.tree_util.tree_flatten_with_path(hf_to_tree(tc, tensors, q))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    save_safetensors(tmp_path / "model.safetensors",
                     {"backbone." + k: v for k, v in tensors.items()})
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "mamba"}))
    m = tmamba.MambaBackbone(tc, q)
    loaded = load_snapshot_(m, tc, tmp_path, q)
    assert set(loaded) == set(m.state_dict())
    state = from_flax(_hf_to_tree(jc, tensors, q))
    assert all(torch.equal(m.state_dict()[k], v) for k, v in state.items())


# --------------------------------------------------------------------------
# (e) MedTsLLM through the trainers
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _jitted_flax_init():
    """flax ``Module.init`` under ``jax.jit`` while a JAX trainer is built."""
    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, a: eager(self, r, *a, **kwargs))(rngs, args)
    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


def _cfg(tmp_path, llm_kw):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.epochs = 1
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    cfg.datasets.synthetic.n_points = 120
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": dict({"enabled": True, "llm": "mamba-tiny", "llm_layers": -1,
                     "prefix_cache": True, "load_in_4bit": False, "load_in_8bit": False},
                    **llm_kw)}}
    return cfg


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("logs"), {"load_in_4bit": True})
    with _jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


def test_trainer_eval_cached_and_against_jax(pair):
    jt, tt = pair
    proj = tt.model.llm.blocks[0].x_proj
    assert proj.bits == 4 and proj.codebook == "absmax"
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_step(tt.eval_model_inputs(batch)).float().numpy()
    uncached = tt.eval_step(tt._to_device(tt.model_inputs(batch))).float().numpy()
    tol = 2e-3
    np.testing.assert_allclose(cached, uncached, rtol=tol, atol=tol * np.abs(uncached).max())
    want = np.asarray(jt.eval_step(jt.params, jt.model_inputs(next(iter(jt.test_pipeline)))))
    np.testing.assert_allclose(uncached, want, rtol=tol, atol=tol * np.abs(want).max())


def test_trainer_train_epoch_matches_jax(pair):
    """One epoch of SGD through ``train()`` of both trainers on the same
    shuffled batches (the gradient through the straight-through backward of
    each quantized projection and K9 / K10's plain versions): the losses
    within 1e-3, every trainable tensor within the w8a8 bounds, the
    quantized backbone unmoved."""
    jt, tt = pair
    frozen = {k: v.clone() for k, v in tt.model.state_dict().items() if k.startswith("llm.")}
    jax_losses = []
    log_step = jt.log_step
    jt.log_step = lambda loss, n: (jax_losses.append(loss), log_step(loss, n))
    with contextlib.redirect_stdout(None):
        jt.train()
        tt.train()
    assert len(tt.losses) == len(jax_losses) == len(tt.train_pipeline) >= 2
    np.testing.assert_allclose(tt.losses, jax_losses, rtol=1e-3)
    want, got = from_flax(jax.device_get(jt.params)), tt.model.state_dict()
    for k, p in tt.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=5e-4,
                                       err_msg=k)
    assert all(torch.equal(got[k], v) for k, v in frozen.items())
