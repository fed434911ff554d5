"""GPT4TS and its GPT-2 backbone in the port against the JAX package, on
the CPU, at gpt2-tiny (d 64, 4 heads x 16) cut to 2 layers: the modules.
(The four shipped files through the trainers and the CLIs, and the
refusals, are tests/test_torch_gpt4ts_tasks.py's.)

  (a) the gpt2 decoder (learned positions, pre-LN blocks, the fused
      ``c_attn``, tanh GELU, ``ln_f``) against JAX's ``TransformerDecoder``
      on ``from_flax`` weights, f32, within 1e-5 x max(1, max |JAX|), its
      state dict the keys and shapes of the flax tree's;
  (b) GPT4TS's forward for each of its seven tasks in eval against JAX's
      module on ``from_flax`` weights, f32, 1e-5 x max(1, max |JAX|);
  (c) the trainable parameters: the names JAX's ``param_labels`` marks
      "new", with ``train_mlp`` off and on;
  (e) the attention gate: at each (L, S, D, causal), the route JAX's
      ``flash_attention`` takes with its ``_use_pallas()`` true (its
      reference, the kernel, or the kernel on q/k/v padded to a multiple of
      256) is ``attention_route``'s, and the port's CPU output equals JAX's
      within 1e-5 x max; K4's route raises under a gradient, naming its
      item by title.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.models.gpt4ts import GPT4TS as JaxGPT4TS
from medtsllm_tpu.models.llm import loader as jax_loader
from medtsllm_tpu.models.llm.transformer import TransformerDecoder as JaxDecoder
from medtsllm_tpu_torch.models.gpt4ts import GPT4TS
from medtsllm_tpu_torch.models.llm import config as port_llm_config
from medtsllm_tpu_torch.models.llm.transformer import TransformerDecoder
from medtsllm_tpu_torch.ops.kernels.flash_attention import attention_route, dispatch_attention
from medtsllm_tpu_torch.weights import from_flax

# the module (the package exports its function under the same name)
jfa = importlib.import_module("medtsllm_tpu.ops.pallas.flash_attention")
torch.set_num_threads(2)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, scale_tol):
    """|got - want| <= scale_tol x max(1, max |want|)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=scale_tol * max(1.0, float(np.abs(want).max())))


# --------------------------------------------------------------------------
# (a) the decoder, (b) the seven tasks, (c) the trainable names
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [37, 128, 512])
def test_gpt2_decoder_matches_jax(L):
    """(a) 512 tokens is JAX's kernel gate; on the CPU both take the plain
    attention (JAX's reference, the port's K4 wrapper's plain version)."""
    cfg = jax_loader.resolve_config("gpt2-tiny")[0]
    x = np.random.default_rng(L).standard_normal((2, L, cfg.d_model)).astype(np.float32)
    dec = JaxDecoder(cfg)
    params = jax.jit(lambda r, e: dec.init(r, inputs_embeds=e))(
        jax.random.PRNGKey(L), jnp.asarray(x))["params"]
    want = jax.jit(lambda p, e: dec.apply({"params": p}, inputs_embeds=e))(params, jnp.asarray(x))
    port = TransformerDecoder(port_llm_config.resolve_config("gpt2-tiny")).eval()
    state = from_flax(jax.device_get(params))
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, 1e-5)


# task -> (n features, n classes, segmentation mode)
_TASKS = {"forecasting": (3, 0, None), "imputation": (3, 0, None),
          "reconstruction": (3, 0, None), "anomaly_detection": (2, 0, None),
          "classification": (3, 3, None), "semantic_segmentation": (2, 3, None),
          "semantic_segmentation-binary": (2, 2, None),
          "segmentation": (1, 0, "boundary-prediction")}


def _modules(task, train_mlp=False):
    """JAX's GPT4TS and the port's with the same arguments: history 48,
    pred 16 (forecasting), d_model 16, d_ff 32, patch 4 / stride 4."""
    C, n_classes, seg_mode = _TASKS[task]
    task = task.split("-")[0]
    kw = dict(task=task, seq_len=48, pred_len=16 if task == "forecasting" else 0,
              enc_in=C, c_out=C, num_class=n_classes, d_model=16, d_ff=32,
              llm_id="gpt2-tiny", gpt_layers=2, train_mlp=train_mlp, patch_size=4, stride=4,
              dropout=0.1, seg_mode=seg_mode)
    return JaxGPT4TS(**kw), GPT4TS(**kw).eval()


@pytest.mark.parametrize("task", sorted(_TASKS))
def test_gpt4ts_forward_matches_jax(task):
    """(b) eval: the sigmoid / softmax heads included."""
    jm, tm = _modules(task)
    rng = np.random.default_rng(sorted(_TASKS).index(task))
    inputs = {"x_enc": rng.standard_normal((3, 48, _TASKS[task][0])).astype(np.float32)}
    if task == "imputation":
        inputs["mask"] = (rng.random((3, 48, 3)) > 0.25).astype(np.float32)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jin)["params"]
    want = jax.jit(jm.apply)({"params": params}, jin)
    state = from_flax(jax.device_get(params))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("train_mlp", [False, True])
def test_trainable_names_match_param_labels(train_mlp):
    """(c) the port's ``requires_grad`` set is the names JAX labels "new"."""
    jm, tm = _modules("forecasting", train_mlp)
    x = jnp.zeros((1, 48, 3))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), {"x_enc": x}))["params"]
    labels = jm.param_labels(params)
    new = from_flax(jax.tree.map(lambda lb: np.float32(lb == "new"), labels))
    want = {k for k, v in new.items() if float(v) == 1.0}
    got = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert got == want
    assert any(".mlp." in n for n in got) == train_mlp
    assert "gpt2.wpe" in got and "gpt2.wte" not in got


# --------------------------------------------------------------------------
# (e) the attention gate
# --------------------------------------------------------------------------

# (L, S, D, causal) -> the route JAX takes
_GATE = [(128, 128, 64, True, "plain"), (511, 511, 64, True, "plain"),
         (512, 512, 64, True, "k4"), (512, 512, 64, False, "k4"),
         (256, 768, 64, True, "k4"), (512, 512, 32, True, "plain"),
         (520, 520, 64, True, "plain"), (1000, 1000, 64, True, "k4-padded"),
         (1000, 1000, 64, False, "plain"), (1000, 1024, 64, True, "k4"),
         (512, 512, 384, True, "k4")]


@pytest.mark.parametrize("L,S,D,causal,route", _GATE)
def test_attention_gate_matches_jax(monkeypatch, L, S, D, causal, route):
    """(e) JAX's pick, read through spies on its kernel and reference with
    ``_use_pallas()`` true, is ``attention_route``'s; the port's CPU output
    is JAX's within 1e-5 x max."""
    reference = jfa._attention_reference
    picks = []

    def kernel(q, k, v, causal, sm_scale, block_q, block_k):
        picks.append("k4" if q.shape[2] == L else "k4-padded")
        return reference(q, k, v, causal, sm_scale)

    def plain(*a, **kw):
        picks.append("plain")
        return reference(*a, **kw)
    monkeypatch.setattr(jfa, "_use_pallas", lambda: True)
    monkeypatch.setattr(jfa, "_flash_attention_pallas", kernel)
    monkeypatch.setattr(jfa, "_attention_reference", plain)
    rng = np.random.default_rng(L + S + D)
    q = rng.standard_normal((1, 2, L, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, S, D)).astype(np.float32) for _ in range(2))
    want = jfa.flash_attention(*(jnp.asarray(t) for t in (q, k, v)), causal=causal)
    assert picks == [route]
    assert attention_route(L, S, D, causal) == route
    got = dispatch_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))


def test_k4_route_refuses_a_gradient():
    """(e) 512 tokens of gpt2 (one head of 64, gpt2's head dim) take K4,
    which has no backward: a train-mode forward that needs a gradient
    raises, naming its item by title."""
    cfg = dataclasses.replace(port_llm_config.resolve_config("gpt2-tiny"), n_heads=1)
    assert attention_route(512, 512, cfg.head_dim, True) == "k4"
    dec = TransformerDecoder(cfg).train()
    dec.blocks[0].ln_1.scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match='"Training on the served backbones"'):
        dec(torch.zeros(1, 512, 64))
    with torch.no_grad():
        assert dec.eval()(torch.zeros(1, 512, 64)).shape == (1, 512, 64)
