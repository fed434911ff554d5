"""``config_from_hf_json`` (a local snapshot's config.json -> the backbone's
shapes) in the port against the JAX package's, on the CPU.

  (a) the published config.json fields of gpt2, opt-125m, pythia-160m
      (gpt_neox), Llama-2-7b, Mistral-7B, Mixtral-8x7B and mamba-130m, and
      variants of each (HF defaults left out, other activations): every
      field of the port's config equal to JAX's, the derived head dim,
      kv heads, learned positions, position offset and rotary dims too;
  (b) the refusals JAX makes, made alike: an unmapped activation, OPT's
      projection (350m) and post-LN variants, a bart whose encoder and
      decoder differ in heads or FFN width, an unknown model_type; and the
      encoder-decoders' published config.json (flan-t5-base, mt5-small,
      bart-base), each field equal to JAX's;
  (c) ``resolve_config`` reads a snapshot directory before the presets
      (``paths.llm_path`` as its cache dir) and cuts it to ``llm_layers``;
      MedTsLLM builds over an opt and a gpt_neox config.json of tiny widths
      and serves a test batch.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import loader as jax_loader
from medtsllm_tpu_torch.models.llm.config import (DecoderConfig, MambaConfig,
                                                  config_from_hf_json, resolve_config)
from medtsllm_tpu_torch.tasks import get_trainer

torch.set_num_threads(1)

# the published config.json entries the readers look at
GPT2 = {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 768, "n_layer": 12,
        "n_head": 12, "n_inner": None, "n_positions": 1024, "layer_norm_epsilon": 1e-5,
        "resid_pdrop": 0.1, "activation_function": "gelu_new", "bos_token_id": 50256,
        "eos_token_id": 50256}
OPT_125M = {"model_type": "opt", "vocab_size": 50272, "hidden_size": 768,
            "num_hidden_layers": 12, "num_attention_heads": 12, "ffn_dim": 3072,
            "max_position_embeddings": 2048, "do_layer_norm_before": True,
            "word_embed_proj_dim": 768, "dropout": 0.1, "activation_function": "relu",
            "bos_token_id": 2, "eos_token_id": 2, "pad_token_id": 1}
PYTHIA_160M = {"model_type": "gpt_neox", "vocab_size": 50304, "hidden_size": 768,
               "num_hidden_layers": 12, "num_attention_heads": 12,
               "intermediate_size": 3072, "max_position_embeddings": 2048,
               "rotary_pct": 0.25, "rotary_emb_base": 10000, "use_parallel_residual": True,
               "hidden_act": "gelu", "layer_norm_eps": 1e-5, "hidden_dropout": 0.0,
               "bos_token_id": 0, "eos_token_id": 0}
LLAMA_7B = {"model_type": "llama", "vocab_size": 32000, "hidden_size": 4096,
            "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
            "intermediate_size": 11008, "max_position_embeddings": 4096,
            "rms_norm_eps": 1e-5, "bos_token_id": 1, "eos_token_id": 2}
MISTRAL_7B = {"model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
              "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
              "intermediate_size": 14336, "max_position_embeddings": 32768,
              "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "bos_token_id": 1,
              "eos_token_id": 2}
MIXTRAL_8X7B = dict(MISTRAL_7B, model_type="mixtral", rope_theta=1e6, num_local_experts=8,
                    num_experts_per_tok=2)
MAMBA_130M = {"model_type": "mamba", "vocab_size": 50280, "hidden_size": 768,
              "num_hidden_layers": 24, "state_size": 16, "conv_kernel": 4, "expand": 2,
              "time_step_rank": "auto", "layer_norm_epsilon": 1e-5, "use_bias": False,
              "use_conv_bias": True, "bos_token_id": 0, "eos_token_id": 0}


# the encoder-decoders: google/flan-t5-base, google/mt5-small, facebook/bart-base
FLAN_T5_BASE = {"model_type": "t5", "vocab_size": 32128, "d_model": 768, "d_kv": 64,
                "d_ff": 2048, "num_layers": 12, "num_decoder_layers": 12, "num_heads": 12,
                "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
                "dropout_rate": 0.1, "layer_norm_epsilon": 1e-6,
                "feed_forward_proj": "gated-gelu", "is_encoder_decoder": True,
                "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0}
MT5_SMALL = dict(FLAN_T5_BASE, model_type="mt5", vocab_size=250112, d_model=512, d_ff=1024,
                 num_layers=8, num_decoder_layers=8, num_heads=6)
BART_BASE = {"model_type": "bart", "vocab_size": 50265, "d_model": 768, "encoder_layers": 6,
             "decoder_layers": 6, "encoder_attention_heads": 12,
             "decoder_attention_heads": 12, "encoder_ffn_dim": 3072, "decoder_ffn_dim": 3072,
             "max_position_embeddings": 1024, "activation_function": "gelu", "dropout": 0.1,
             "scale_embedding": False, "is_encoder_decoder": True, "bos_token_id": 0,
             "eos_token_id": 2, "pad_token_id": 1}
ENCDEC = {"t5": FLAN_T5_BASE, "mt5": MT5_SMALL, "bart": BART_BASE}


def _strip(hf, *keys):
    return {k: v for k, v in hf.items() if k not in keys}


CASES = {
    "gpt2": GPT2, "gpt2-defaults": _strip(GPT2, "layer_norm_epsilon", "resid_pdrop",
                                          "activation_function"),
    "gpt2-n_inner": dict(GPT2, n_inner=2048),
    "opt-125m": OPT_125M, "opt-gelu": dict(OPT_125M, activation_function="gelu"),
    "opt-defaults": _strip(OPT_125M, "max_position_embeddings", "dropout",
                           "activation_function", "word_embed_proj_dim",
                           "do_layer_norm_before"),
    "pythia-160m": PYTHIA_160M, "pythia-1b": dict(PYTHIA_160M, hidden_size=2048,
                                                   num_attention_heads=8,
                                                   intermediate_size=8192),
    "neox-sequential": dict(PYTHIA_160M, use_parallel_residual=False, rotary_pct=1.0),
    "neox-defaults": _strip(PYTHIA_160M, "rotary_pct", "rotary_emb_base",
                            "use_parallel_residual", "hidden_act", "layer_norm_eps",
                            "hidden_dropout"),
    "llama-2-7b": LLAMA_7B, "llama-defaults": _strip(LLAMA_7B, "num_key_value_heads",
                                                    "max_position_embeddings",
                                                    "rms_norm_eps"),
    "mistral-7b": MISTRAL_7B, "mixtral-8x7b": MIXTRAL_8X7B,
    "mixtral-small": dict(MIXTRAL_8X7B, intermediate_size=512),
    "mamba-130m": MAMBA_130M, "mamba-rank": dict(MAMBA_130M, time_step_rank=24),
}


def _write(tmp_path, name, hf) -> object:
    path = tmp_path / name
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf))
    return path


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_matches_jax_field_by_field(tmp_path, case):
    """(a)"""
    path = _write(tmp_path, case, CASES[case])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jax_loader.config_from_hf_json(path)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = config_from_hf_json(path)
    # the same warnings (mixtral's capacity default), by their opening words
    assert [str(w.message)[:60] for w in tw] == [str(w.message)[:60] for w in jw]
    assert type(got).__name__ == type(want).__name__
    for field in dataclasses.fields(got):
        # the port's MambaConfig carries the 4-bit codebook, which JAX's
        # MambaBlock reads by getattr with the "absmax" default
        default = ("absmax",) if field.name == "quant4_codebook" else ()
        assert getattr(got, field.name) == getattr(want, field.name, *default), field.name
    if isinstance(got, DecoderConfig):
        for prop in ("head_dim", "kv_heads", "ln_family", "learned_positions",
                     "pos_offset", "rotary_dims"):
            assert getattr(got, prop) == getattr(want, prop), prop
    else:
        assert isinstance(got, MambaConfig) and (got.d_inner, got.rank) == (want.d_inner,
                                                                         want.rank)


@pytest.mark.parametrize("hf,error,match", [
    (dict(GPT2, activation_function="gelu_10"), NotImplementedError, "gelu_10"),
    (dict(OPT_125M, word_embed_proj_dim=512), NotImplementedError, "word_embed_proj_dim"),
    (dict(OPT_125M, do_layer_norm_before=False), NotImplementedError, "do_layer_norm_before"),
    (dict(PYTHIA_160M, hidden_act="tanh"), NotImplementedError, "tanh"),
    (dict(BART_BASE, decoder_attention_heads=16), NotImplementedError, "asymmetric"),
    (dict(BART_BASE, decoder_ffn_dim=4096), NotImplementedError, "asymmetric"),
    ({"model_type": "bert"}, ValueError, "bert"),
])
def test_refusals_match_jax(tmp_path, hf, error, match):
    """(b) the refusals both make."""
    path = _write(tmp_path, "snap", hf)
    for read in (jax_loader.config_from_hf_json, config_from_hf_json):
        with pytest.raises(error, match=match):
            read(path)


@pytest.mark.parametrize("model_type", ["t5", "mt5", "bart"])
def test_encoder_decoders_refused_by_title(tmp_path, model_type):
    """(b) flan-t5-base's, mt5-small's and bart-base's config.json: every
    field equal to JAX's, and the derived head dim, post-LN order and
    position offset; again with the HF defaults left out."""
    hf = ENCDEC[model_type]
    lean = _strip(hf, "num_decoder_layers", "relative_attention_num_buckets",
                  "relative_attention_max_distance", "layer_norm_epsilon", "dropout_rate",
                  "feed_forward_proj", "decoder_layers", "decoder_attention_heads",
                  "decoder_ffn_dim", "max_position_embeddings", "activation_function",
                  "dropout", "scale_embedding")
    for i, fields in enumerate((hf, lean)):
        path = _write(tmp_path, f"snap{i}", fields)
        got, want = config_from_hf_json(path), jax_loader.config_from_hf_json(path)
        assert got.is_encoder_decoder and got.style == ("bart" if model_type == "bart"
                                                        else "t5")
        for field in dataclasses.fields(got):
            assert getattr(got, field.name) == getattr(want, field.name), field.name
        for prop in ("head_dim", "kv_heads", "ln_family", "post_ln", "pos_offset"):
            assert getattr(got, prop) == getattr(want, prop), prop


def test_resolve_config_reads_the_snapshot_first(tmp_path):
    """(c) a directory under the cache dir beats the preset of the same id."""
    _write(tmp_path, "gpt2", dict(GPT2, n_layer=3))
    assert resolve_config("gpt2").n_layers == 12  # the preset
    got = resolve_config("gpt2", -1, str(tmp_path))
    want, snap = jax_loader.resolve_config("gpt2", str(tmp_path))
    assert snap == tmp_path / "gpt2"
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.n_layers == 3 and resolve_config("gpt2", 2, str(tmp_path)).n_layers == 2
    with pytest.raises(ValueError, match="no built-in preset"):
        resolve_config("no-such-model")


# tiny widths of each family's published layout, read as a snapshot
_TINY = {"opt": dict(OPT_125M, vocab_size=512, hidden_size=64, word_embed_proj_dim=64,
                     num_hidden_layers=2, num_attention_heads=4, ffn_dim=128, dropout=0.0),
         "gpt_neox": dict(PYTHIA_160M, vocab_size=512, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128)}


@pytest.mark.parametrize("model_type", sorted(_TINY))
def test_medtsllm_builds_over_a_snapshot_config(tmp_path, model_type):
    """(c) MedTsLLM over a config.json: the family's modules, the prompt head
    cached, a finite test batch equal to the embedded head's."""
    path = _write(tmp_path, model_type, _TINY[model_type])
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 256
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": str(path), "llm_layers": -1, "load_in_8bit": True}}}
    tt = get_trainer("snap", cfg, device="cpu")
    lc = tt.model.llm_cfg
    assert lc == config_from_hf_json(path) and lc.style == {"opt": "opt",
                                                            "gpt_neox": "neox"}[model_type]
    state = tt.model.state_dict()
    assert "llm.blocks.0.attn.q_proj.bias" in state and "llm.ln_f.scale" in state
    assert ("llm.wpe" in state) == (model_type == "opt")
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_step(tt.eval_model_inputs(batch)).numpy()
    embedded = tt.eval_step(tt._to_device(tt.model_inputs(batch))).numpy()
    assert np.isfinite(cached).all()
    np.testing.assert_allclose(cached, embedded, rtol=1e-4, atol=1e-5)
