"""``llm.remat`` in the port, on the CPU.

  (a) The decoder and the Mamba stack with ``remat`` True / "full" /
      "dots" against the same module without it, in train mode with
      gradients: the output, the input's gradient and every parameter's
      gradient bit-equal, each block run twice (the recompute) and the
      dropout generator advanced as far as without remat. Cases: llama-tiny
      w8a8 (``int8_backward``), gpt2-tiny with its dropout 0.1 and LoRA
      adapters (dropout 0.1), mixtral-tiny-128 w8a8 (the capacity path,
      "dots" keeping the batched expert matmuls) and mamba-tiny.
  (b) The same decoders against JAX's remat'd ``TransformerDecoder``
      (``_remat_block_call``) on ``from_flax`` weights: the gradients of
      the input and of every parameter within 1e-5 x max (w8a8 2e-3), with
      dropout off on both sides (the two frameworks draw different masks).
  (c) "dots" keeps the projections' outputs: its backward runs fewer
      matrix products than "full"'s; a prefix K/V (the cached path) or no
      gradient calls the blocks plainly; MedTsLLM's trainer passes
      ``llm.remat`` to its backbone, and two train steps of gpt2 with
      dropout and LoRA are bit-equal under the three settings.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_config
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import MAMBA_PRESETS, PRESETS, LoraSpec
from medtsllm_tpu_torch.models.llm.mamba import MambaBackbone
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax, init_random_

torch.set_num_threads(1)

CASES = {  # name -> (preset, quantize, act_quant, lora)
    "llama-w8a8-int8bwd": ("llama-tiny", 8, "int8_bwd", None),
    "gpt2-dropout-lora": ("gpt2-tiny", 0, True, LoraSpec(rank=4, alpha=8, dropout=0.1,
                                                         targets=("q",))),
    "mixtral-w8a8": ("mixtral-tiny-128", 8, True, None),
    "mamba": ("mamba-tiny", 0, True, None),
}


def _module(name, remat):
    preset, quantize, act_quant, lora = CASES[name]
    if preset.startswith("mamba"):
        m = MambaBackbone(MAMBA_PRESETS[preset], remat=remat)
    else:
        m = ttf.TransformerDecoder(PRESETS[preset], quantize, None, lora, act_quant, remat)
    init_random_(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in m.named_parameters():
            if "lora_b" in n:
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    for n, p in m.named_parameters():
        p.requires_grad_("wte" not in n)
    return m.train()


def _run(m, x, seed=3):
    """Output, the input's gradient, every parameter's gradient, the block
    calls and the generator's state after the step."""
    calls = []
    hooks = [b.register_forward_pre_hook(lambda *_: calls.append(1)) for b in m.blocks]
    gen = torch.Generator().manual_seed(seed)
    xt = x.clone().requires_grad_()
    y = m(xt, generator=gen)
    (y.square().mean() + y.mean()).backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
    return y.detach(), xt.grad, grads, len(calls), gen.get_state()


@pytest.mark.parametrize("remat", [True, "full", "dots"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_is_bit_equal(name, remat):
    m0, m1 = _module(name, False), _module(name, remat)
    x = torch.randn(2, 12, m0.cfg.d_model, generator=torch.Generator().manual_seed(2))
    y0, dx0, g0, calls0, gen0 = _run(m0, x)
    y1, dx1, g1, calls1, gen1 = _run(m1, x)
    assert torch.equal(y0, y1) and torch.equal(dx0, dx1)
    assert g0.keys() == g1.keys() and len(g0) > 1
    assert all(torch.equal(g0[k], g1[k]) for k in g0), [k for k in g0
                                                         if not torch.equal(g0[k], g1[k])]
    assert calls0 == len(m0.blocks) and calls1 == 2 * len(m1.blocks)
    assert torch.equal(gen0, gen1)  # the masks drawn once, as without remat


@pytest.mark.parametrize("preset,quantize,remat", [
    ("llama-tiny", 0, "full"), ("llama-tiny", 8, "dots"), ("gpt2-tiny", 0, "dots"),
    ("mixtral-tiny-128", 8, "dots")])
def test_remat_matches_jax(preset, quantize, remat):
    jc = dataclasses.replace(JAX_PRESETS[preset], dropout=0.0)
    tc = dataclasses.replace(PRESETS[preset], dropout=0.0)
    jm = jtf.TransformerDecoder(jc, quantize=quantize, remat=remat)
    x = np.random.default_rng(4).standard_normal((2, 12, jc.d_model)).astype(np.float32)
    p = jax.jit(lambda k, a: jm.init(k, inputs_embeds=a))(jax.random.PRNGKey(0),
                                                          jnp.asarray(x))["params"]
    c = np.random.default_rng(5).standard_normal((2, 12, jc.d_model)).astype(np.float32)

    def loss(params, xx):
        return jnp.sum(jm.apply({"params": params}, inputs_embeds=xx,
                                deterministic=False) * c)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1), allow_int=True))(p, jnp.asarray(x))
    gp = jax.tree.map(lambda g, w: np.zeros(w.shape, w.dtype)
                      if g.dtype == jax.dtypes.float0 else g, gp, p)
    tm = ttf.TransformerDecoder(tc, quantize, None, None, True, remat).train()
    tm.load_state_dict(from_flax(jax.device_get(p)))
    for prm in tm.parameters():
        prm.requires_grad_(prm.is_floating_point())
    xt = torch.from_numpy(x).requires_grad_()
    (tm(xt) * torch.from_numpy(c)).sum().backward()
    t = 1e-5 if not quantize else 2e-3
    want = from_flax(jax.device_get(gp))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=t * np.abs(np.asarray(gx)).max())
    checked = 0
    for n, prm in tm.named_parameters():
        if prm.grad is None or n not in want or not want[n].is_floating_point():
            continue
        w = want[n].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), w, rtol=0,
                                   atol=t * max(np.abs(w).max(), 1e-6), err_msg=n)
        checked += 1
    assert checked >= 4


class _CountMM(TorchDispatchMode):
    """Counts the projections' products: mm / addmm, and K1's GEMM, a
    custom op on every device (its CPU kernel's matmul is inside it)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += str(func) in ("aten.mm.default", "aten.addmm.default",
                                "medtsllm.w8a8_gemm.default")
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_projections():
    x = torch.randn(2, 12, PRESETS["llama-tiny"].d_model)
    counts = {}
    for remat in (False, "full", "dots"):
        m = _module("llama-w8a8-int8bwd", remat)
        y = m(x.clone().requires_grad_())
        with _CountMM() as mode:
            y.sum().backward()
        counts[remat] = mode.n
    # full recomputes every projection's product in the backward; dots none
    assert counts["dots"] == counts[False] < counts["full"], counts


def test_remat_off_the_training_forward():
    """The cached path (a prefix) and a forward without gradients call the
    blocks plainly, as JAX's decoder does."""
    m = _module("gpt2-dropout-lora", "full").eval()
    x = torch.randn(1, 10, m.cfg.d_model)
    calls = []
    hooks = [b.register_forward_pre_hook(lambda *_: calls.append(1)) for b in m.blocks]
    kv = m.prefill(x[:, :4])
    y = m(x[:, 4:].clone().requires_grad_(), prefix_kv=kv)
    y.sum().backward()
    with torch.no_grad():
        m(x)
    assert len(calls) == 3 * len(m.blocks)
    for h in hooks:
        h.remove()


def _trainer(tmp_path, remat):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / f"logs{remat}")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 120
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": "gpt2-tiny", "llm_layers": -1, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": True, "remat": remat},
        "lora": {"enabled": True, "rank": 4, "alpha": 8, "dropout": 0.1, "layers": "auto"}}}
    with contextlib.redirect_stdout(io.StringIO()):
        return get_trainer("r", cfg, device="cpu")


def test_trainer_steps_bit_equal_under_remat(tmp_path):
    """gpt2-tiny (dropout 0.1) w8a8 with LoRA (dropout 0.1): the embedded
    head, so the decoder's forward has no prefix and remat applies. Two
    train steps: losses, every parameter and gradient bit-equal."""
    runs = []
    for remat in (False, True, "dots"):
        tt = _trainer(tmp_path, remat)
        assert tt.model.llm.remat == remat and not tt.model.train_prefix_cache_safe
        losses = []
        for step, batch in enumerate(tt.train_pipeline):
            if step == 2:
                break
            arrays = tt.train_model_inputs(batch)
            losses.append(tt.train_step(arrays, arrays["valid"]))
        runs.append((losses, {n: (p.detach().clone(), p.grad) for n, p in
                              tt.model.named_parameters() if p.requires_grad}))
    (l0, s0), *rest = runs
    for losses, state in rest:
        assert all(torch.equal(a, b) for a, b in zip(l0, losses))
        for n, (p, g) in s0.items():
            assert torch.equal(p, state[n][0]) and torch.equal(g, state[n][1]), n
