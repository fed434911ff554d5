"""MoE training in the port against the JAX package, on the CPU, at
mixtral-tiny-128 (d 128, 4 experts top-2, d_ff 256).

  (a) ``act_quant_bmm``'s backward (the straight-through estimator, ``dh =
      (g * scale) @ W_q`` per expert) against ``jax.vjp`` of JAX's
      ``_act_quant_bmm``, f32, within 1e-6 x max; the forward bit-equal;
  (b) ``router_aux_loss`` against JAX's within two f32 ulps;
  (c) one w8 ``MoEMLP`` in train mode (the capacity path, with and without
      drops) against JAX's with ``deterministic=False``: the output and the
      gradients of the input and of the router ``gate`` (through the
      renormalized top-k weights and the aux loss), within 2e-3 x max: the
      w8a8 path turns a last-bit difference of silu into an int8 flip of
      the down projection's input (ROADMAP queue 3), the flip-sized
      tolerance of tests/test_torch_moe.py's trainer slice;
  (d) three SGD steps (momentum 0.9, nesterov, lr 1e-2, dropout 0) of
      configs/ablation/moe-backbone.toml, cut small (mixtral-tiny-128 at
      f32 compute, batch 4, a larger ``data.step``, the ventilator
      stand-in), against JAX's trainer, with ``training.router_aux_coef``
      0 and 0.5: the w8a8 bounds of tests/test_torch_train.py (loss rtol
      1e-3, parameters rtol 1e-4, atol 5e-4), the backbone unmoved;
  (e) ``router_aux_coef`` on a model without a MoE layer raises JAX's
      error; ``train()`` / ``test()`` of the cut file with the coefficient
      set.
"""

import contextlib
import dataclasses
import math
import tomllib
import warnings
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.config import Config as JaxConfig
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.models.llm.loader import resolve_config as jax_resolve_config
from medtsllm_tpu.models.llm.transformer import MoEMLP as JaxMoEMLP
from medtsllm_tpu.models.llm.transformer import QuantDense, _act_quant_bmm
from medtsllm_tpu.models.llm.transformer import router_aux_loss as jax_router_aux_loss
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.models.llm.config import resolve_config
from medtsllm_tpu_torch.models.llm.transformer import MoEMLP, act_quant_bmm, router_aux_loss
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MOE_TOML = ROOT / "configs" / "ablation" / "moe-backbone.toml"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, scale_tol):
    """|got - want| <= scale_tol x max |want|."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=scale_tol * max(float(np.abs(want).max()), 1e-30))


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


# --------------------------------------------------------------------------
# (a) the STE backward, (b) the aux loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,K,N", [(4, 24, 128, 256), (8, 40, 256, 128)])
def test_act_quant_bmm_backward_matches_jax_vjp(E, C, K, N):
    """(a) the integers of the forward are JAX's; dh within 1e-6 x max; the
    int8 weight and its scale get no gradient."""
    rng = np.random.default_rng(E * C)
    h = rng.standard_normal((E, C, K)).astype(np.float32)
    kq = rng.integers(-127, 128, (E, K, N)).astype(np.int8)  # JAX's [E, K, N]
    scale = (rng.random((E, N)) * 1e-2).astype(np.float32)
    g = rng.standard_normal((E, C, N)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: _act_quant_bmm(v, jnp.asarray(kq), jnp.asarray(scale)),
                       jnp.asarray(h))
    (dh_j,) = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).requires_grad_()
    wq = torch.from_numpy(np.ascontiguousarray(kq.transpose(0, 2, 1)))
    y_t = act_quant_bmm(ht, wq, torch.from_numpy(scale))
    y_t.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(y_t), np.asarray(y_j))
    _close(ht.grad, dh_j, 1e-6)


@pytest.mark.parametrize("T,E,k", [(37, 4, 2), (300, 8, 2), (64, 8, 1)])
def test_router_aux_loss_matches_jax(T, E, k):
    """(b) within two f32 ulps of JAX's (the loss is ~k, k at perfect
    balance, where an ulp is 2.4e-7; the two frameworks sum the T
    probabilities in different orders)."""
    rng = np.random.default_rng(T)
    probs = rng.random((T, E)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    top_i = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    want = float(jax_router_aux_loss(jnp.asarray(probs), jnp.asarray(top_i), E))
    got = float(router_aux_loss(torch.from_numpy(probs), torch.from_numpy(top_i), E))
    assert abs(got - want) <= 2 * np.finfo(np.float32).eps * want and 0 < got < E


# --------------------------------------------------------------------------
# (c) one MoE layer in train mode
# --------------------------------------------------------------------------

def _w8_params(cfg, x, seed):
    """f32-init MoEMLP parameters, quantized expert by expert (the JAX
    tests' ``_w8a8_params``)."""
    pf = jax.jit(JaxMoEMLP(cfg).init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    qp = {"gate": pf["gate"]}
    for name in ("w_gate", "w_up", "w_down"):
        qs = [QuantDense.quantize(np.asarray(pf[name][e]), bits=8)
              for e in range(cfg.n_experts)]
        qp[name + "_q"] = jnp.stack([jnp.asarray(q) for q, _ in qs])
        qp[name + "_scale"] = jnp.stack([jnp.asarray(s) for _, s in qs])
    return qp


@pytest.mark.parametrize("capacity", [1.25, 0.25, 0.0])
def test_moe_layer_gradients_match_jax(capacity):
    """(c) output, dx and d gate of sum(out * cot) + aux within 2e-3 x max;
    the capacity path even where ``moe_grouped`` is on (K6 has no
    backward)."""
    jcfg = dataclasses.replace(jax_resolve_config("mixtral-tiny-128")[0],
                               expert_capacity=capacity)
    rng = np.random.default_rng(int(capacity * 100))
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    params = _w8_params(jcfg, x, 5)
    layer = JaxMoEMLP(jcfg, quantize=8)

    def f(gate, v):
        out, state = layer.apply({"params": dict(params, gate=gate)}, v, deterministic=False,
                                 mutable=["intermediates"])
        aux = state["intermediates"]["router_aux_loss"][0]
        return jnp.sum(out * cot) + aux, out
    (_, want), (dgate_j, dx_j) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params["gate"], jnp.asarray(x))

    moe = MoEMLP(dataclasses.replace(resolve_config("mixtral-tiny-128"),
                                     expert_capacity=capacity, moe_grouped=True), 8).train()
    moe.load_state_dict(from_flax(jax.device_get(params)))
    moe.gate.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out = moe(xt)
    (torch.sum(out * torch.from_numpy(cot)) + moe.router_aux).backward()
    _close(out, want, 2e-3)
    _close(xt.grad, dx_j, 2e-3)
    _close(moe.gate.grad, dgate_j, 2e-3)
    assert moe.w_gate_q.grad is None and moe.w_gate_scale.grad is None
    moe.eval()
    assert moe(xt.detach()).shape == x.shape and moe.router_aux is None


# --------------------------------------------------------------------------
# (d) the trainer, (e) the coefficient
# --------------------------------------------------------------------------

def _raw(logdir, aux_coef=0.0) -> dict:
    """The test's copy of configs/ablation/moe-backbone.toml:
    mixtral-tiny-128, f32, batch 4, data.step 2048, one epoch, the print
    logger under ``logdir``; dropout 0 and SGD at lr 1e-2 for (d)."""
    raw = tomllib.loads(MOE_TOML.read_text())
    raw["models"]["timellm"]["llm"]["llm"] = "mixtral-tiny-128"
    raw["data"]["step"] = 2048
    raw["training"].update(epochs=1, batch_size=4, dropout=0.0, optimizer="sgd",
                           learning_rate=1e-2, router_aux_coef=aux_coef)
    raw["setup"].update(dtype="float32", logger="print")
    raw["paths"] = {"logdir": str(logdir)}
    return raw


@pytest.mark.parametrize("aux_coef", [0.0, 0.5])
def test_train_steps_match_jax(tmp_path, aux_coef):
    """(d) three SGD steps on the same shuffled batches; the frozen backbone
    (its router included) does not move."""
    raw = _raw(tmp_path / "logs", aux_coef)
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", JaxConfig(raw))
        tt = get_trainer("port", Config(raw), device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    backbone = {k: v.clone() for k, v in tt.model.state_dict().items() if k.startswith("llm.")}
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    jpipe = JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=raw["setup"]["seed"])
    steps = 0
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        for k in got:
            if not k.startswith("llm."):
                np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=5e-4,
                                           err_msg=f"step {step}: {k}")
        steps += 1
    assert steps == 3
    assert all(torch.equal(tt.model.state_dict()[k], v) for k, v in backbone.items())
    assert all(m.router_aux is None for m in tt.model.modules() if isinstance(m, MoEMLP))


def test_router_aux_coef_needs_a_moe_layer(tmp_path):
    """(e) JAX's error, at the first train step, for a dense backbone."""
    raw = _raw(tmp_path / "logs", 0.5)
    raw["models"]["timellm"]["llm"]["llm"] = "llama-tiny"
    del raw["models"]["timellm"]["llm"]["expert_capacity"]  # a MoE key
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = get_trainer("dense", Config(raw), device="cpu")
    arrays = tt.train_model_inputs(next(iter(tt.train_pipeline)))
    with pytest.raises(ValueError, match="sowed no router_aux_loss"):
        tt.train_step(arrays, arrays["valid"])


def test_train_and_test_with_aux_coef(tmp_path):
    """(e) the cut file with ``router_aux_coef`` and its own dropout and Adam
    through ``train()`` (one epoch, then ``val()``) and ``test()``."""
    raw = _raw(tmp_path / "logs", 0.01)
    raw["training"].update(dropout=0.1, optimizer="adam", learning_rate=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = get_trainer("moe-train", Config(raw), device="cpu")
    tt.train()
    assert len(tt.losses) == len(tt.train_pipeline) > 0 and all(map(math.isfinite, tt.losses))
    scores = tt.test()
    assert set(scores) == {"test/mse", "test/mae"} and all(map(math.isfinite, scores.values()))
