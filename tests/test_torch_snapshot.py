"""A local HF snapshot's weights in the port (``models/llm/safetensors.py``,
``models/llm/loader.py``) against the JAX package's loader, on the CPU.
Every snapshot is built here with ``transformers`` and ``safetensors`` at
tiny widths (nothing is downloaded), as tests/test_hf_parity.py builds its
own: gpt2, opt, gpt_neox, llama, mistral, mixtral, mamba, t5 (relu and
gated-gelu) and bart.

  (a) the port's reader against ``safe_open(framework="numpy")`` (JAX's
      ``_load_safetensors``) over two shards: the same names after the
      prefix stripping, every tensor bit for bit at its dtype; the port's
      writer read back by ``safe_open``; BF16 read as JAX's reader reads
      it where jax is imported (ml_dtypes' bfloat16; the port returns the
      same values at f32, exactly), FP8 refused by both;
  (b) ``hf_to_tree`` against JAX's ``_hf_to_tree``, leaf for leaf,
      bit-equal, at quantize 0, 8 and 4 (absmax, nf4, fp4), every family;
  (c) MedTsLLM trainers on ``paths.llm_path``: the port's backbone
      tensors bit-equal to JAX's trainer's (``from_flax`` of its ``llm``
      tree), dense and w8a8; with JAX's fusion layers copied in, eval equal
      to JAX's within 1e-5 (f32); a LoRA model keeps its adapters' init;
  (d) GPT4TS loads its ``gpt_layers`` blocks of a deeper gpt2 snapshot;
  (e) a snapshot found but unreadable or unmappable raises (a truncated
      file, a missing tensor, a shape the config does not give, FP8),
      never falling back to the random backbone; a config.json without
      weights keeps the init with JAX's warning.
"""

import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import loader as jax_loader
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.models.llm import loader
from medtsllm_tpu_torch.models.llm.config import config_from_hf_json
from medtsllm_tpu_torch.models.llm.safetensors import load_safetensors, save_safetensors
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax
from test_torch_families import jitted_flax_init

torch.set_num_threads(1)


def _hf_models():
    """family -> (HF model class, its config), tiny widths."""
    import transformers as tf
    small = dict(vocab_size=96, max_position_embeddings=256)
    llama = dict(small, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2)
    t5 = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
              num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
              relative_attention_max_distance=20, dropout_rate=0.0)
    return {
        "gpt2": (tf.GPT2Model, tf.GPT2Config(vocab_size=96, n_positions=256, n_embd=32,
                                              n_layer=3, n_head=4)),
        "opt": (tf.OPTModel, tf.OPTConfig(hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                                          num_attention_heads=4, word_embed_proj_dim=32,
                                          dropout=0.0, **small)),
        "neox": (tf.GPTNeoXModel, tf.GPTNeoXConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            rotary_pct=0.25, hidden_act="gelu", **small)),
        "llama": (tf.LlamaModel, tf.LlamaConfig(**llama)),
        "mistral": (tf.MistralModel, tf.MistralConfig(sliding_window=4096, **llama)),
        "mixtral": (tf.MixtralModel, tf.MixtralConfig(num_local_experts=4,
                                                      num_experts_per_tok=2, **llama)),
        "mamba": (tf.MambaModel, tf.MambaConfig(vocab_size=96, hidden_size=32,
                                                num_hidden_layers=2, state_size=8,
                                                time_step_rank=4)),
        "t5": (tf.T5Model, tf.T5Config(feed_forward_proj="relu", **t5)),
        "t5-gated": (tf.T5Model, tf.T5Config(feed_forward_proj="gated-gelu", **t5)),
        "bart": (tf.BartModel, tf.BartConfig(
            d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, dropout=0.0,
            activation_function="gelu", **small)),
    }


def _write(root, name, model, cfg, shards=1):
    """config.json + the model's state dict as ``shards`` safetensors files
    (names split round-robin), each tensor cloned (t5's tied embeddings)."""
    from safetensors.torch import save_file
    snap = root / name
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(cfg.to_dict()))
    items = [(k, v.clone().contiguous()) for k, v in model.state_dict().items()]
    for s in range(shards):
        save_file(dict(items[s::shards]), str(snap / f"model-{s:05d}.safetensors"))
    return snap


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    root = tmp_path_factory.mktemp("snaps")
    out = {}
    for i, (name, (cls, cfg)) in enumerate(_hf_models().items()):
        torch.manual_seed(i)
        out[name] = _write(root, name, cls(cfg).eval(), cfg, shards=2 if i % 2 else 1)
    return out


# --------------------------------------------------------------------------
# (a) the reader
# --------------------------------------------------------------------------

def _same(got: dict, want: dict):
    assert list(sorted(got)) == list(sorted(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reader_matches_safe_open(tmp_path):
    """Two shards, the three prefixes (one name with two of them), every
    dtype both readers read; then the port's writer."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(0)
    snap = tmp_path / "snap"
    snap.mkdir()
    save_file({"model.a": rng.normal(size=(3, 5)).astype(np.float32),
               "transformer.b": rng.normal(size=(7,)).astype(np.float16),
               "backbone.c": rng.integers(-9, 9, (2, 2, 2)).astype(np.int64),
               "model.transformer.d": rng.normal(size=(4,)),
               "e": np.array([True, False])}, str(snap / "b.safetensors"))
    save_file({"model.f": rng.integers(-128, 127, (6, 3)).astype(np.int8),
               "g": rng.integers(0, 255, (5,)).astype(np.uint8),
               "h": rng.integers(-99, 99, (2, 3)).astype(np.int32),
               "model.a": np.zeros((1,), np.float32)},  # a later shard's wins
              str(snap / "a.safetensors"))
    want = jax_loader._load_safetensors(snap)
    got = load_safetensors(snap)
    _same(got, want)
    assert set(got) == {"a", "b", "c", "d", "e", "f", "g", "h"} and got["a"].shape == (3, 5)
    out = tmp_path / "out"
    out.mkdir()
    save_safetensors(out / "w.safetensors", {"model.x": got["a"], "y": got["c"], "z": got["e"]})
    _same(jax_loader._load_safetensors(out), {"x": got["a"], "y": got["c"], "z": got["e"]})
    _same(load_safetensors(out), {"x": got["a"], "y": got["c"], "z": got["e"]})


def test_reader_bf16_and_fp8(tmp_path):
    from safetensors.torch import save_file
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    save_file({"model.w": w}, str(tmp_path / "m.safetensors"))
    want = jax_loader._load_safetensors(tmp_path)["w"]
    got = load_safetensors(tmp_path)["w"]
    assert want.dtype.name == "bfloat16" and got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got, w.float().numpy())
    save_file({"f8": torch.ones(3, dtype=torch.float8_e4m3fn)}, str(tmp_path / "n.safetensors"))
    with pytest.raises(AttributeError, match="float8"):
        jax_loader._load_safetensors(tmp_path)
    with pytest.raises(ValueError, match="'f8' has dtype F8_E4M3"):
        load_safetensors(tmp_path)


# --------------------------------------------------------------------------
# (b) the tree
# --------------------------------------------------------------------------

def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


_QUANTS = [(0, "absmax"), (8, "absmax"), (4, "absmax"), (4, "nf4"), (4, "fp4")]


@pytest.mark.parametrize("quantize,codebook", _QUANTS, ids=[f"q{q}-{c}" for q, c in _QUANTS])
def test_hf_to_tree_matches_jax(snaps, quantize, codebook):
    for name, snap in snaps.items():
        tensors = jax_loader._load_safetensors(snap)
        jc, tc = jax_loader.config_from_hf_json(snap), config_from_hf_json(snap)
        if name != "mamba":
            jc = dataclasses.replace(jc, quant4_codebook=codebook)
            tc = dataclasses.replace(tc, quant4_codebook=codebook)
        elif codebook != "absmax":
            continue
        want = dict(_flat(jax_loader._hf_to_tree(jc, tensors, quantize=quantize)))
        got = dict(_flat(loader.hf_to_tree(tc, load_safetensors(snap), quantize)))
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")


# --------------------------------------------------------------------------
# (c) the trainers
# --------------------------------------------------------------------------

def _cfg(tmp_path, snap, quant=False, lora=False, mode="concat"):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs"), "llm_path": str(snap)}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 128
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": mode, "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "hf-snapshot", "llm_layers": -1,
                "load_in_8bit": quant}}}
    if lora:
        cfg.models.medtsllm["lora"] = {"enabled": True, "rank": 4, "alpha": 8,
                                       "dropout": 0.0, "layers": "auto"}
    return cfg


def _trainers(cfg):
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # no "no local weights" warning
        warnings.filterwarnings("ignore", message=".*(synthetic|not writable).*")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    return jt, tt


_LOADED = [("llama", False), ("t5-gated", False), ("bart", False), ("mamba", False),
           ("t5", True)]


@pytest.mark.parametrize("name,quant", _LOADED,
                         ids=[f"{n}-{'w8a8' if q else 'dense'}" for n, q in _LOADED])
def test_trainer_loads_the_snapshot_as_jax(tmp_path, snaps, name, quant):
    cfg = _cfg(tmp_path, snaps[name], quant)
    jt, tt = _trainers(cfg)
    want = {f"llm.{k}": v for k, v in from_flax(jax.device_get(jt.params["llm"])).items()}
    got = {k: v for k, v in tt.model.state_dict().items() if k.startswith("llm.")}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # the HF tensors themselves, not a second init: the token table
    hf = load_safetensors(snaps[name])
    table = {"mamba": "embeddings.weight", "llama": "embed_tokens.weight"}.get(
        name, "shared.weight")
    np.testing.assert_array_equal(got["llm.wte"].numpy(), hf[table])
    # JAX's fusion layers in the port: the same model, eval within 1e-5
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    tol = 2e-3 if quant else 1e-5
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        want_y = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got_y = tt.eval_dispatch(tb).float().numpy()
        np.testing.assert_allclose(got_y, want_y, rtol=tol, atol=tol * np.abs(want_y).max())


def test_lora_keeps_its_init_over_a_snapshot(tmp_path, snaps):
    """The adapters are absent from the snapshot: their init stays (the
    port's own: lora_a drawn, lora_b 0), every base weight is the snapshot's."""
    cfg = _cfg(tmp_path, snaps["bart"], lora=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = get_trainer("port", cfg, device="cpu")
    state = tt.model.state_dict()
    tree = loader.hf_to_tree(config_from_hf_json(snaps["bart"]), load_safetensors(snaps["bart"]))
    base = from_flax(tree)
    q = "llm.enc_blocks.0.attn.q_proj"
    assert f"{q}.base.weight" in state and f"{q[4:]}.weight" in base
    assert torch.equal(state[f"{q}.base.weight"], base[f"{q[4:]}.weight"])
    assert torch.count_nonzero(state[f"{q}.lora_a"]) > 0
    assert torch.count_nonzero(state[f"{q}.lora_b"]) == 0


# --------------------------------------------------------------------------
# (d) GPT4TS
# --------------------------------------------------------------------------

def test_gpt4ts_loads_gpt_layers_blocks(tmp_path, snaps):
    """gpt_layers 2 of the 3-layer snapshot: the first two blocks, the
    token and position tables, ln_f; equal to JAX's trainer's."""
    cfg = make_config(task="reconstruction", model="gpt4ts", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs"), "llm_path": str(snaps["gpt2"])}
    cfg.datasets.synthetic.n_points = 128
    cfg["models"] = {"gpt4ts": {"llm": "gpt2", "d_model": 32, "d_ff": 32, "gpt_layers": 2,
                                "train_mlp": False, "patching": {"patch_len": 8, "stride": 4}}}
    jt, tt = _trainers(cfg)
    assert tt.model.gpt2.cfg.d_model == 32 and len(tt.model.gpt2.blocks) == 2
    want = {f"gpt2.{k}": v for k, v in from_flax(jax.device_get(jt.params["gpt2"])).items()}
    got = {k: v for k, v in tt.model.state_dict().items() if k.startswith("gpt2.")}
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    hf = load_safetensors(snaps["gpt2"])
    np.testing.assert_array_equal(got["gpt2.blocks.1.mlp.c_fc.weight"].numpy(),
                                  hf["h.1.mlp.c_fc.weight"].T)
    np.testing.assert_array_equal(got["gpt2.wpe"].numpy(), hf["wpe.weight"])


# --------------------------------------------------------------------------
# (e) what raises
# --------------------------------------------------------------------------

def _broken(tmp_path, snaps, how):
    import shutil
    snap = tmp_path / "broken"
    shutil.copytree(snaps["llama"], snap)
    f = snap / "model-00000.safetensors"
    if how == "truncated":
        f.write_bytes(f.read_bytes()[:200])
    elif how == "missing":
        t = load_safetensors(snap)
        del t["norm.weight"]
        for old in snap.glob("*.safetensors"):
            old.unlink()
        save_safetensors(f, t)
    elif how == "shape":
        hf = json.loads((snap / "config.json").read_text())
        (snap / "config.json").write_text(json.dumps(dict(hf, intermediate_size=96)))
    elif how == "fp8":
        from safetensors.torch import save_file
        save_file({"model.norm.weight": torch.ones(32, dtype=torch.float8_e4m3fn)},
                  str(snap / "z.safetensors"))
    return snap


@pytest.mark.parametrize("how,error,match", [
    ("truncated", ValueError, "cannot be read"), ("missing", ValueError, "norm.weight"),
    ("shape", ValueError, "Shape mismatch"), ("fp8", ValueError, "F8_E4M3")])
def test_broken_snapshot_raises(tmp_path, snaps, how, error, match):
    cfg = _cfg(tmp_path, _broken(tmp_path, snaps, how))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(error, match=match):
            get_trainer("port", cfg, device="cpu")


def test_config_without_weights_keeps_the_init(tmp_path, snaps):
    """A snapshot of config.json alone sets the shapes; the seeded init
    stays, with JAX's warning, as in JAX."""
    snap = tmp_path / "cfgonly"
    snap.mkdir()
    (snap / "config.json").write_text((snaps["t5"] / "config.json").read_text())
    with pytest.warns(UserWarning, match="no local weights found"):
        tt = get_trainer("port", _cfg(tmp_path, snap), device="cpu")
    assert tt.model.llm_cfg.style == "t5" and tt.model.llm_cfg.d_model == 32
