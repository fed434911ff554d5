"""LoRA in the port against the JAX package on the CPU.

  (a) ``LoRALinear`` against JAX's ``LoRADense`` on ``from_flax`` weights
      (``lora_b`` drawn at random: its zero init would hide the delta),
      over a dense and a w8a8 base, rslora and plain scaling, with and
      without gpt2's ``lora_out_mask`` (a masked third has a zero delta
      and a zero gradient): the output f32 within 1e-5 (w8a8 2e-3) and
      the adapters' gradients against ``jax.grad`` within 1e-5;
  (b) MedTsLLM with ``[models.medtsllm.lora]`` over llama-tiny, gpt2-tiny
      (its dropout-0 copy, registered in both packages), opt-tiny and
      neox-tiny: the trainable names are the ones JAX's ``param_labels``
      marks "new" (``lora_a`` / ``lora_b`` and the fusion layers); three
      SGD steps against JAX's ``train_step`` on the same shuffled batches
      (test_torch_train.py's bounds: dense loss rtol 1e-5, each tensor
      rtol 1e-4, atol 1e-5; w8a8 through K1's straight-through dx, loss
      1e-3, tensors atol 5e-4), the rest of the backbone unmoved; the
      prompt head embedded in the train step (the adapters move its K/V)
      and refilled after the step in eval;
      under ``mixed``: JAX's storage dtypes (the adapters f32), eval within
      2^-6 of JAX's mixed trainer, a bf16 step moving every ``lora_b``;
  (c) JAX's ``test_lora_trains_and_is_checkpointed``: ``train()`` moves
      ``lora_b`` and not the base weight; the checkpoint holds the adapters
      and no base weight; ``from_run_id`` restores them bit for bit;
  (d) LoRA over ``load_in_4bit`` built (QLoRA); the refusals that stay:
      LoRA over Mamba (JAX's ValueError), ``lora.layers`` other than
      "auto".
"""

import contextlib
import dataclasses
import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.models.llm import loader as jax_loader
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.models.llm import config as port_llm_config
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import LoraSpec
from medtsllm_tpu_torch.runtime.checkpoint import wait_for_saves
from medtsllm_tpu_torch.tasks import get_trainer, task_lookup
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)
NODROP = "gpt2-tiny-nodrop"


@pytest.fixture(scope="module", autouse=True)
def nodrop_preset():
    """gpt2-tiny with dropout 0 under its own id, in both packages' presets
    for this file's life (the masks of the two packages' generators differ)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_loader.PRESETS, NODROP,
                   dataclasses.replace(jax_loader.PRESETS["gpt2-tiny"], dropout=0.0))
        mp.setitem(port_llm_config.PRESETS, NODROP,
                   dataclasses.replace(port_llm_config.PRESETS["gpt2-tiny"], dropout=0.0))
        yield


@contextlib.contextmanager
def jitted_flax_init():
    """flax ``Module.init`` under ``jax.jit`` while a JAX trainer is built
    (one compile in place of one per op; the same parameters)."""
    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, a: eager(self, r, *a, **kwargs))(rngs, args)
    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# --------------------------------------------------------------------------
# (a) LoRALinear
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [0, 8])
@pytest.mark.parametrize("rslora", [True, False])
@pytest.mark.parametrize("mask", [None, "q", "kv"])
def test_lora_linear_matches_lora_dense(mask, rslora, quantize):
    d, rank = 24, 4
    n_out = 3 * d if mask else d
    out_mask = None if mask is None else np.repeat(
        np.array([float(t in mask) for t in "qkv"], np.float32), d)
    spec = jtf.LoraSpec(rank=rank, alpha=8, rslora=rslora)
    jm = jtf.LoRADense(n_out, use_bias=True, lora=spec, quantize=quantize,
                       lora_out_mask=out_mask)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["lora_b"] = rng.standard_normal((rank, n_out)).astype(np.float32) * 0.1
    params["base"]["bias"] = rng.standard_normal(n_out).astype(np.float32) * 0.1
    base = ttf.projection(d, n_out, quantize, None, bias=True)
    tm = ttf.LoRALinear(base, d, n_out, LoraSpec(rank=rank, alpha=8, rslora=rslora),
                        None if out_mask is None else torch.from_numpy(out_mask)).eval()
    state = from_flax(params)
    assert set(state) == set(tm.state_dict()) and "base.bias" in state
    tm.load_state_dict(state)
    tx = torch.from_numpy(x).requires_grad_(quantize == 0)
    got = tm(tx)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tol = 1e-5 if quantize == 0 else 2e-3
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)

    # the adapters' gradients of sum(y * c) against jax.grad
    c = rng.standard_normal(got.shape).astype(np.float32)
    (got * torch.from_numpy(c)).sum().backward()

    def loss(la, lb):
        p = dict(params, lora_a=la, lora_b=lb)
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * c)
    ga, gb = jax.grad(loss, argnums=(0, 1))(params["lora_a"], params["lora_b"])
    np.testing.assert_allclose(_np(tm.lora_a.grad), _np(ga), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tm.lora_b.grad), _np(gb), rtol=1e-5, atol=1e-5)
    if out_mask is not None:
        assert not tm.lora_b.grad[:, out_mask == 0].any()


def test_lora_dropout_draws_from_the_generator():
    """Adapter dropout in train mode only, its masks from the generator."""
    spec = LoraSpec(rank=4, alpha=8, dropout=0.5)
    tm = ttf.LoRALinear(ttf.Linear(16, 8), 16, 8, spec)
    torch.nn.init.normal_(tm.lora_a)
    torch.nn.init.normal_(tm.lora_b)
    x = torch.randn(3, 16)
    y_eval = tm.eval()(x)
    tm.train()
    a = tm(x, torch.Generator().manual_seed(1))
    b = tm(x, torch.Generator().manual_seed(1))
    c = tm(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, y_eval)


# --------------------------------------------------------------------------
# (b) MedTsLLM with LoRA against JAX's trainer
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm, quant=False, lora_dropout=0.0):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.epochs = 1
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    cfg.datasets.synthetic.n_points = 200
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": quant},
        "lora": {"enabled": True, "rank": 4, "alpha": 8, "dropout": lora_dropout,
                 "layers": "auto"},
    }}
    return cfg


# backbone -> (llm, w8a8, loss rtol, parameter rtol, parameter atol)
_BACKBONES = {"llama-tiny": ("llama-tiny", False, 1e-5, 1e-4, 1e-5),
              "gpt2-tiny": (NODROP, False, 1e-5, 1e-4, 1e-5),
              "opt-tiny": ("opt-tiny", False, 1e-5, 1e-4, 1e-5),
              "neox-tiny": ("neox-tiny", False, 1e-5, 1e-4, 1e-5),
              "gpt2-tiny-w8a8": (NODROP, True, 1e-3, 1e-4, 5e-4)}


@pytest.fixture(scope="module", params=sorted(_BACKBONES))
def pair(request, tmp_path_factory):
    llm, quant, *tol = _BACKBONES[request.param]
    cfg = _cfg(tmp_path_factory.mktemp("logs"), llm, quant)
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return cfg, jt, tt, tol


def _labelled(tree: dict, labels: dict, label: str) -> dict:
    """The leaves of a flax tree that ``labels`` (its ``param_labels``)
    marks ``label``, as a tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _labelled(v, labels[k], label)
            if sub:
                out[k] = sub
        elif labels[k] == label:
            out[k] = v
    return out


def test_lora_train_steps_match_jax_trainer(pair):
    cfg, jt, tt, (loss_rtol, rtol, atol) = pair
    new = set(from_flax(_labelled(jax.device_get(jt.params),
                                  jt.model.param_labels(jt.params), "new")))
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert trainable == new
    lora = {n for n in trainable if n.startswith("llm.")}
    assert lora and all(n.rsplit(".", 1)[1] in ("lora_a", "lora_b") for n in lora)
    assert not tt.model.train_prefix_cache_safe

    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    frozen = {k: v.clone() for k, v in tt.model.state_dict().items()
              if k.startswith("llm.") and k not in lora}
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert "prefix_ids" in ja and "prefix_ids" in ta  # embedded: the head moves
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=loss_rtol)
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        for k in trainable:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol, atol=atol,
                                       err_msg=f"step {step}: {k}")
    got = tt.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in frozen.items())
    assert not all(torch.equal(got[k], torch.zeros_like(got[k])) for k in lora
                   if k.endswith("lora_b"))
    # eval after the steps: the head's cache is prefilled with the moved
    # adapters, so cached = embedded
    batch = next(iter(tt.test_pipeline))
    np.testing.assert_allclose(tt.eval_step(tt.eval_model_inputs(batch)).numpy(),
                               tt.eval_step(tt._to_device(tt.model_inputs(batch))).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_lora_dropout_trains_from_the_trainers_generator(tmp_path):
    """Adapter dropout 0.1: two trainers of one config take the same step;
    the generator advances."""
    cfg = _cfg(tmp_path, "llama-tiny", lora_dropout=0.1)
    a, b = (get_trainer(n, cfg, device="cpu") for n in "ab")
    batch = next(iter(a.train_pipeline))
    arrays = a.train_model_inputs(batch)
    gen = a.dropout_generator.get_state()
    assert float(a.train_step(arrays, arrays["valid"])) == float(
        b.train_step(arrays, arrays["valid"]))
    assert not torch.equal(a.dropout_generator.get_state(), gen)


@pytest.mark.parametrize("llm", [NODROP, "neox-tiny"])
def test_lora_under_mixed_matches_jax(tmp_path, llm):
    """``setup.dtype = "mixed"``: the storage dtypes are JAX's (the adapters
    trainable at f32 beside the bf16 backbone); eval within 2^-6 of JAX's
    mixed trainer (tests/test_torch_mixed.py's bound; the ln family's
    LayerNorms emit bf16, as flax's with ``dtype``); a bf16 train step
    moves every ``lora_b``."""
    cfg = _cfg(tmp_path, llm)
    cfg.setup.dtype = "mixed"
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    want = from_flax(jax.device_get(jt.params))
    tt.load_state_dict(want)
    for k, v in tt.model.state_dict().items():
        assert v.dtype == want[k].dtype, k
        if "lora_" in k:
            assert v.dtype == torch.float32 and tt.model.get_parameter(k).requires_grad
    pj, pt = jt.test_pipeline, tt.test_pipeline
    want, got = jt.run_eval(pj)["pred"], tt.run_eval(pt)["pred"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    before = {k: v.clone() for k, v in tt.model.state_dict().items() if k.endswith("lora_b")}
    batch = next(iter(tt.train_pipeline))
    arrays = tt.train_model_inputs(batch)
    assert np.isfinite(float(tt.train_step(arrays, arrays["valid"])))
    after = tt.model.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())


# --------------------------------------------------------------------------
# (c) the checkpoint round trip
# --------------------------------------------------------------------------

def test_lora_trains_and_is_checkpointed(tmp_path):
    cfg = _cfg(tmp_path, "opt-tiny")
    cfg.setup.logger = "print"
    cfg["DEBUG"] = False
    tt = get_trainer("lora-run", cfg, device="cpu")
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    tt.train()
    after = tt.model.state_dict()
    lb = "llm.blocks.0.attn.q_proj.lora_b"
    assert not torch.equal(before[lb], after[lb]), "lora_b should train"
    assert torch.equal(before["llm.blocks.0.attn.q_proj.base.weight"],
                       after["llm.blocks.0.attn.q_proj.base.weight"])
    ckpt = tt.checkpoint_params()
    llm = [k for k in ckpt if k.startswith("llm.")]
    assert llm and all(k.rsplit(".", 1)[1] in ("lora_a", "lora_b") for k in llm)
    assert not any(".base." in k for k in ckpt) and "mapping_layer.weight" in ckpt
    tt.log_end()
    wait_for_saves()
    again = task_lookup[cfg.task].from_run_id("lora-run", basepath=tmp_path / "logs",
                                              device="cpu")
    got = again.model.state_dict()
    for k in ckpt:
        assert torch.equal(got[k], after[k]), k
    assert again.test() == tt.test()


# --------------------------------------------------------------------------
# (d) the refusals that stay
# --------------------------------------------------------------------------

def test_lora_refusals(tmp_path):
    # LoRA over load_in_4bit (QLoRA) is ported: the adapters wrap the 4-bit
    # projections and train above their straight-through dx
    # (tests/test_torch_quant_train.py holds train() to JAX's)
    cfg = _cfg(tmp_path, "gpt2-tiny")
    cfg.models.medtsllm.llm.load_in_4bit = True
    tt = get_trainer("x", cfg, device="cpu")
    c_attn = tt.model.llm.blocks[0].attn.c_attn
    assert isinstance(c_attn, ttf.LoRALinear) and c_attn.base.bits == 4
    cfg = _cfg(tmp_path, "mamba-tiny")
    with pytest.raises(ValueError, match="mamba backbone has none"):
        get_trainer("x", cfg, device="cpu")
    cfg = _cfg(tmp_path, "llama-tiny")
    cfg.models.medtsllm.lora.layers = [0]
    with pytest.raises(ValueError, match="lora.layers"):
        get_trainer("x", cfg, device="cpu")
