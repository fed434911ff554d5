"""``llm.fuse_projections`` in the port (``DecoderConfig.fused_projections``:
one ``qkv_proj`` [H*D | KV*D | KV*D] and one ``gateup_proj`` [gate | up]
a llama block) against the separate layout and against the JAX package on
the CPU, at ``llama-tiny`` with GQA (4 query heads, 2 KV heads, D 16).

  (a) fused against separate on the same weights (``fuse_state_dict``:
      the separate leaves concatenated along the output rows): at w8a8 and
      absmax int4 the forward, the prefill's K/V and the cached forward are
      bit-equal (the same row codes, exact s32 sums, the same per-element
      rescale); dense f32 within 2e-5 / 1e-6 (a wider GEMM sums in another
      order);
  (b) the fused decoder against JAX's fused ``TransformerDecoder`` on
      ``from_flax`` weights, dense, w8a8 and int4;
  (c) LoRA on the fused ``qkv_proj`` with targets q and v: the forward
      against JAX's fused ``Attention`` with the same adapters, and the
      adapter's gradient exactly 0 on the k slice (the out mask);
  (d) ``hf_to_tree`` fused bit-equal to JAX's ``_hf_to_tree`` at 0, 8 and 4
      bits (absmax, nf4): q|k|v and gate|up concatenated before the
      quantizer, so the per-channel scales concatenate; the tree loads into
      the fused backbone;
  (e) ``MedTsLLM.from_config``: JAX's ``ValueError`` for a style other than
      llama, word for word;
  (f) MedTsLLM through the trainers, fused w8a8: the state dict's keys =
      ``from_flax`` of JAX's tree, eval cached = uncached and against
      JAX's fused trainer.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS, _hf_to_tree
from medtsllm_tpu.models.llm.transformer import LoraSpec as JaxLoraSpec
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import PRESETS, LoraSpec
from medtsllm_tpu_torch.models.llm.loader import fuse_state_dict, hf_to_tree, load_snapshot_
from medtsllm_tpu_torch.models.llm.safetensors import save_safetensors
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax, init_random_
from test_torch_families import jitted_flax_init
from test_torch_modules import _apply, _load, _np, _params, _tol, _x

torch.set_num_threads(1)

QUANT = [(0, "absmax"), (8, "absmax"), (4, "absmax")]
QIDS = ["dense", "q8", "int4"]


def _cfgs(fused=True, codebook="absmax"):
    kw = dict(n_kv_heads=2, fused_projections=fused, quant4_codebook=codebook)
    return (dataclasses.replace(JAX_PRESETS["llama-tiny"], **kw),
            dataclasses.replace(PRESETS["llama-tiny"], **kw))


# --------------------------------------------------------------------------
# (a) fused against separate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q,codebook", QUANT, ids=QIDS)
def test_fused_matches_separate(q, codebook):
    _, sep_cfg = _cfgs(False, codebook)
    _, fus_cfg = _cfgs(True, codebook)
    sep = ttf.TransformerDecoder(sep_cfg, q).eval()
    init_random_(sep, torch.Generator().manual_seed(0))
    fused = ttf.TransformerDecoder(fus_cfg, q).eval()
    fused.load_state_dict(fuse_state_dict(sep.state_dict()))  # strict: every key
    attn, mlp = fused.blocks[0].attn, fused.blocks[0].mlp
    assert not hasattr(attn, "q_proj") and not hasattr(mlp, "gate_proj")
    rows = (attn.qkv_proj.weight_q if q else attn.qkv_proj.weight).shape[0]
    assert rows == 16 * (4 + 2 + 2)  # [H*D | KV*D | KV*D]
    x = torch.from_numpy(_x(0, 2, 12, 64))
    with torch.no_grad():
        pairs = [(fused(x), sep(x))]
        kv_f, kv_s = fused.prefill(x[:1, :5]), sep.prefill(x[:1, :5])
        pairs += [(a, b) for lf, ls in zip(kv_f, kv_s) for a, b in zip(lf, ls)]
        pairs.append((fused(x[:, 5:], prefix_kv=kv_f), sep(x[:, 5:], prefix_kv=kv_s)))
    for got, want in pairs:
        if q:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)


# --------------------------------------------------------------------------
# (b) against JAX's fused decoder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q,codebook", QUANT, ids=QIDS)
def test_fused_decoder_matches_jax(q, codebook):
    jc, tc = _cfgs(True, codebook)
    x = jnp.asarray(_x(1, 2, 12, 64))
    jm = jtf.TransformerDecoder(jc, quantize=q)
    p = _params(jm, x)
    assert "qkv_proj" in p["h_0"]["attn"] and "gateup_proj" in p["h_0"]["mlp"]
    tm = _load(ttf.TransformerDecoder(tc, q), p).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(np.asarray(x)))
    np.testing.assert_allclose(_np(got), _np(_apply(jm, p, x)), **_tol(quantize=q, scale=3.0))


# --------------------------------------------------------------------------
# (c) LoRA on the fused projection
# --------------------------------------------------------------------------

def test_fused_lora_mask():
    jc, tc = _cfgs(True)
    x = jnp.asarray(_x(2, 2, 10, 64))
    jm = jtf.Attention(jc, lora=JaxLoraSpec(rank=4, alpha=8, targets=("q", "v")))
    p = _params(jm, x)
    # lora_b is zero at init: draw it, so the adapter moves the output
    rng = np.random.default_rng(0)
    lb = p["qkv_proj"]["lora_b"]
    p["qkv_proj"]["lora_b"] = jnp.asarray(rng.standard_normal(lb.shape) * 0.1, lb.dtype)
    tm = _load(ttf.Attention(tc, lora=LoraSpec(rank=4, alpha=8, targets=("q", "v"))), p)
    tm.eval()
    mask = tm.qkv_proj.lora_out_mask
    assert mask.tolist() == [1.0] * 64 + [0.0] * 32 + [1.0] * 32
    tx = torch.from_numpy(np.asarray(x))
    out = tm(tx)
    np.testing.assert_allclose(_np(out), _np(_apply(jm, p, x)), **_tol())
    out.square().sum().backward()
    g = tm.qkv_proj.lora_b.grad
    assert torch.all(g[:, 64:96] == 0)
    assert g[:, :64].abs().sum() > 0 and g[:, 96:].abs().sum() > 0


# --------------------------------------------------------------------------
# (d) the snapshot layout
# --------------------------------------------------------------------------

def _hf_llama_tensors(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, f, H, KV, D = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def mk(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)
    t = {"embed_tokens.weight": mk(cfg.vocab_size, d), "norm.weight": 1 + mk(d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        t.update({p + "input_layernorm.weight": 1 + mk(d),
                  p + "post_attention_layernorm.weight": 1 + mk(d),
                  p + "self_attn.q_proj.weight": mk(H * D, d),
                  p + "self_attn.k_proj.weight": mk(KV * D, d),
                  p + "self_attn.v_proj.weight": mk(KV * D, d),
                  p + "self_attn.o_proj.weight": mk(d, H * D),
                  p + "mlp.gate_proj.weight": mk(f, d), p + "mlp.up_proj.weight": mk(f, d),
                  p + "mlp.down_proj.weight": mk(d, f)})
    return t


@pytest.mark.parametrize("q,codebook", QUANT + [(4, "nf4")], ids=QIDS + ["nf4"])
def test_snapshot_tree_matches_jax_and_loads(q, codebook, tmp_path):
    jc, tc = _cfgs(True, codebook)
    tensors = _hf_llama_tensors(tc)
    want = jax.tree_util.tree_flatten_with_path(_hf_to_tree(jc, tensors, q))[0]
    got = jax.tree_util.tree_flatten_with_path(hf_to_tree(tc, tensors, q))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    save_safetensors(tmp_path / "model.safetensors",
                     {"model." + k: v for k, v in tensors.items()})
    m = ttf.TransformerDecoder(tc, q)
    assert set(load_snapshot_(m, tc, tmp_path, q)) == set(m.state_dict())
    # the fused tree is the separate one's leaves concatenated
    _, sep_cfg = _cfgs(False, codebook)
    sep = from_flax(hf_to_tree(sep_cfg, tensors, q))
    assert all(torch.equal(m.state_dict()[k], v) for k, v in fuse_state_dict(sep).items())


# --------------------------------------------------------------------------
# (e) the configuration's checks
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm="llama-tiny", **llm_kw):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 192
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": dict({"enabled": True, "llm": llm, "llm_layers": -1, "prefix_cache": True,
                     "load_in_4bit": False, "load_in_8bit": True,
                     "fuse_projections": True}, **llm_kw)}}
    return cfg


def test_fuse_projections_refused_as_jax_refuses(tmp_path):
    cfg = _cfg(tmp_path, llm="gpt2-tiny")
    errors = []
    for build in (lambda: jax_get_trainer("jax", cfg),
                  lambda: get_trainer("port", cfg, device="cpu")):
        with warnings.catch_warnings(), pytest.raises(ValueError) as e:
            warnings.simplefilter("ignore")
            build()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "fuse_projections supports llama-style decoders" in errors[1]
    # a disabled backbone reads neither key, as in JAX
    off = _cfg(tmp_path, llm="gpt2-tiny", enabled=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert not getattr(get_trainer("port", off, device="cpu").model.llm_cfg,
                           "fused_projections")


# --------------------------------------------------------------------------
# (f) MedTsLLM through the trainers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("logs"))
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    state = from_flax(jax.device_get(jt.params))
    assert set(state) == set(tt.model.state_dict())
    tt.load_state_dict(state)
    return jt, tt


def test_fused_trainer_eval_cached_and_against_jax(pair):
    jt, tt = pair
    assert tt.model.llm_cfg.fused_projections
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_step(tt.eval_model_inputs(batch)).float().numpy()
    uncached = tt.eval_step(tt._to_device(tt.model_inputs(batch))).float().numpy()
    tol = 2e-3
    np.testing.assert_allclose(cached, uncached, rtol=tol, atol=tol * np.abs(uncached).max())
    want = np.asarray(jt.eval_step(jt.params, jt.model_inputs(next(iter(jt.test_pipeline)))))
    np.testing.assert_allclose(uncached, want, rtol=tol, atol=tol * np.abs(want).max())
