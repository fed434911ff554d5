"""Backbone configurations and the presets the port serves.

Port of ``medtsllm_tpu/models/llm/transformer.py::DecoderConfig`` (the
llama, gpt2, opt and neox decoder fields, the mixtral-style MoE ones and
the encoder-decoders': t5's explicit head dim, decoder depth, relative
buckets and gated FFN, bart's embedding scale), ``LoraSpec``,
``models/llm/mamba.py::MambaConfig`` and the ``PRESETS`` /
``_mamba_presets`` / ``config_from_hf_json`` / ``resolve_config`` of
``models/llm/loader.py``. A local snapshot's ``config.json`` sets the shapes
(``config_from_hf_json``); its ``*.safetensors`` weights, where it has them,
replace the random init (``loader.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import warnings
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """Low-rank adapters on the attention projections named by ``targets``
    (``q``, ``k``, ``v``, ``o``): ``y = base(x) + scaling (x A) B``."""
    rank: int = 8
    alpha: int = 16
    dropout: float = 0.0
    rslora: bool = True
    targets: tuple = ("q", "v")

    @property
    def scaling(self) -> float:
        return self.alpha / math.sqrt(self.rank) if self.rslora else self.alpha / self.rank


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    style: str  # "llama", "gpt2", "opt", "neox", "t5" or "bart"
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    n_kv_heads: int | None = None
    max_position: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dropout: float = 0.0
    bos_token_id: int | None = None
    eos_token_id: int | None = None
    pad_token_id: int | None = None
    is_encoder_decoder: bool = False
    # t5: an explicit head dim, the decoder's depth (None: n_layers), the
    # relative-position buckets and the gated-gelu FFN (t5 v1.1)
    d_head: int | None = None
    n_dec_layers: int | None = None
    rel_buckets: int = 32
    rel_max_distance: int = 128
    t5_gated: bool = False
    # mixtral-style sparse MoE FFN (n_experts > 1): top-k routed SwiGLU
    # experts; expert_capacity is the GShard capacity factor (0 = dropless)
    n_experts: int = 0
    n_experts_per_tok: int = 2
    expert_capacity: float = 0.0
    # the dropless grouped-GEMM expert chain (K6) in place of the capacity
    # bmm; resolved from models.<m>.llm.moe_grouped by MedTsLLM.from_config
    moe_grouped: bool = False
    # q|k|v and gate|up as one wide projection each (llama style, the
    # decoder's self-attention and its dense MLP; a MoE block's experts stay
    # apart): qkv_proj [H*D | KV*D | KV*D] and gateup_proj [gate | up], the
    # column-concat of the separate kernels with their per-channel scales,
    # so the numerics are the separate path's. Set by MedTsLLM.from_config
    # from models.<m>.llm.fuse_projections; presets and config.json leave it
    # off
    fused_projections: bool = False
    # 4-bit weights (quantize=4): "absmax" (linear int4, the w4a8 kernels)
    # or a bnb codebook, "nf4" / "fp4" (table dequant, then a matmul at the
    # compute dtype); resolved from models.<m>.llm.quant_type
    quant4_codebook: str = "absmax"
    # opt / neox: the MLP's activation (the snapshot's activation_function /
    # hidden_act; "" = the style's own), neox's rotating share of each head
    # and its parallel attention + FFN residual
    act_fn: str = ""
    rotary_pct: float = 1.0
    parallel_residual: bool = False
    # bart: token embeddings times sqrt(d_model), on the input_ids path only
    scale_embedding: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ln_family(self) -> bool:
        """LayerNorm + biased projections (gpt2, opt, neox, bart), vs the
        RMSNorm bias-free llama family (llama, t5)."""
        return self.style in ("gpt2", "opt", "neox", "bart")

    @property
    def learned_positions(self) -> bool:
        return self.style in ("gpt2", "opt")

    @property
    def pos_offset(self) -> int:
        """opt's and bart's learned positions start at row 2 (HF
        OPTLearnedPositionalEmbedding / BartLearnedPositionalEmbedding)."""
        return 2 if self.style in ("opt", "bart") else 0

    @property
    def post_ln(self) -> bool:
        """bart's blocks: each LayerNorm after its residual add."""
        return self.style == "bart"

    @property
    def rotary_dims(self) -> int:
        """The leading head dims that rotate (neox's rotary_pct; all for
        llama), even."""
        d = int(self.head_dim * self.rotary_pct)
        return d - (d % 2)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # None -> ceil(d_model / 16) (HF "auto")
    norm_eps: float = 1e-5
    use_bias: bool = False  # in/out projection bias (HF use_bias)
    use_conv_bias: bool = True
    style: str = "mamba"
    bos_token_id: int | None = 0
    eos_token_id: int | None = 0
    # the 4-bit codebook of the quantized projections (DecoderConfig's);
    # JAX's MambaBlock reads it with getattr and the same default
    quant4_codebook: str = "absmax"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)


PRESETS = {
    "gpt2": DecoderConfig(style="gpt2", vocab_size=50257, d_model=768,
                          n_layers=12, n_heads=12, d_ff=3072,
                          max_position=1024, dropout=0.1,
                          bos_token_id=50256, eos_token_id=50256),
    "gpt2-tiny": DecoderConfig(  # test-sized gpt2-style backbone
        style="gpt2", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, max_position=512, dropout=0.1,
        bos_token_id=0, eos_token_id=0),
    "opt-tiny": DecoderConfig(  # test-sized OPT-style backbone
        style="opt", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, max_position=512, act_fn="relu",
        bos_token_id=2, eos_token_id=2, pad_token_id=1),
    "neox-tiny": DecoderConfig(  # test-sized GPT-NeoX / pythia backbone
        style="neox", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, max_position=512, rotary_pct=0.25,
        parallel_residual=True, act_fn="gelu",
        bos_token_id=0, eos_token_id=0),
    "encdec-tiny": DecoderConfig(  # test-sized encoder-decoder (llama style)
        style="llama", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, max_position=512, bos_token_id=1,
        eos_token_id=2, is_encoder_decoder=True),
    "t5-tiny": DecoderConfig(  # test-sized t5-style encoder-decoder
        style="t5", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, d_head=16, max_position=512,
        norm_eps=1e-6, pad_token_id=0, eos_token_id=1,
        is_encoder_decoder=True),
    "bart-tiny": DecoderConfig(  # test-sized BART encoder-decoder
        style="bart", vocab_size=512, d_model=64, n_layers=2,
        n_dec_layers=2, n_heads=4, d_ff=128, max_position=512,
        act_fn="gelu", is_encoder_decoder=True,
        bos_token_id=0, eos_token_id=2, pad_token_id=1),
    "meta-llama/Llama-2-7b-hf": DecoderConfig(
        style="llama", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, d_ff=11008, max_position=4096, norm_eps=1e-5,
        bos_token_id=1, eos_token_id=2),
    "llama-1b": DecoderConfig(  # TinyLlama-1.1B shape (GQA)
        style="llama", vocab_size=32000, d_model=2048, n_layers=22,
        n_heads=32, n_kv_heads=4, d_ff=5632, max_position=2048,
        norm_eps=1e-5, bos_token_id=1, eos_token_id=2),
    "llama-tiny": DecoderConfig(  # test-sized llama-style backbone
        style="llama", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, max_position=512, bos_token_id=1,
        eos_token_id=2),
    "mixtral-tiny": DecoderConfig(  # test-sized mixtral-style sparse MoE
        style="llama", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, max_position=512, bos_token_id=1,
        eos_token_id=2, n_experts=4, n_experts_per_tok=2),
    "mixtral-tiny-128": DecoderConfig(  # MoE tiny at 128-multiple widths:
        # the smallest shape the grouped-GEMM chain tiles
        style="llama", vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, d_ff=256, max_position=512, bos_token_id=1,
        eos_token_id=2, n_experts=4, n_experts_per_tok=2),
    "moe-8x1b": DecoderConfig(  # 8-expert MoE on the TinyLlama-1.1B shape
        # (~6.4B stored / ~1.8B active parameters, top-2 routing)
        style="llama", vocab_size=32000, d_model=2048, n_layers=22,
        n_heads=32, n_kv_heads=4, d_ff=5632, max_position=2048,
        norm_eps=1e-5, bos_token_id=1, eos_token_id=2,
        n_experts=8, n_experts_per_tok=2, expert_capacity=1.25),
}

MAMBA_PRESETS = {
    "mamba-130m": MambaConfig(  # state-spaces/mamba-130m-hf shape
        vocab_size=50280, d_model=768, n_layers=24),
    "mamba-tiny": MambaConfig(  # test-sized mamba backbone
        vocab_size=512, d_model=64, n_layers=2, d_state=8, dt_rank=4),
}


# the ln family's hidden activations the MLP maps (transformer.py's ACTS)
KNOWN_LN_ACTS = ("gelu", "gelu_tanh", "gelu_new", "gelu_fast", "gelu_pytorch_tanh",
                 "quick_gelu", "relu", "silu", "swish")


def config_from_hf_json(path: Path) -> DecoderConfig | MambaConfig:
    """The backbone's shapes from a local snapshot's ``config.json``
    (``loader.py::config_from_hf_json`` of the JAX package) for the
    ``model_type``s the port builds: gpt2, opt, gpt_neox, llama, mistral,
    mixtral and mamba, with the JAX function's refusals (an unmapped
    activation, OPT's projection and post-LN variants)."""
    hf = json.loads((Path(path) / "config.json").read_text())
    model_type = hf.get("model_type", "gpt2")
    act = hf.get("activation_function", hf.get("hidden_act"))
    if (model_type in ("gpt2", "opt", "bart", "gpt_neox")
            and act is not None and act not in KNOWN_LN_ACTS):
        raise NotImplementedError(f"{model_type} snapshot uses hidden activation {act!r}; "
                                  f"supported: {KNOWN_LN_ACTS}")
    if model_type == "gpt2":
        return DecoderConfig(
            style="gpt2", vocab_size=hf["vocab_size"], d_model=hf["n_embd"],
            n_layers=hf["n_layer"], n_heads=hf["n_head"],
            d_ff=hf.get("n_inner") or 4 * hf["n_embd"], max_position=hf["n_positions"],
            norm_eps=hf.get("layer_norm_epsilon", 1e-5), dropout=hf.get("resid_pdrop", 0.1),
            bos_token_id=hf.get("bos_token_id"), eos_token_id=hf.get("eos_token_id"))
    if model_type in ("t5", "mt5"):
        return DecoderConfig(
            style="t5", vocab_size=hf["vocab_size"], d_model=hf["d_model"],
            n_layers=hf["num_layers"], n_heads=hf["num_heads"], d_ff=hf["d_ff"],
            d_head=hf.get("d_kv"), n_dec_layers=hf.get("num_decoder_layers"),
            rel_buckets=hf.get("relative_attention_num_buckets", 32),
            rel_max_distance=hf.get("relative_attention_max_distance", 128),
            norm_eps=hf.get("layer_norm_epsilon", 1e-6), dropout=hf.get("dropout_rate", 0.1),
            t5_gated="gated" in str(hf.get("feed_forward_proj", "relu")),
            is_encoder_decoder=True, bos_token_id=hf.get("bos_token_id"),
            eos_token_id=hf.get("eos_token_id"), pad_token_id=hf.get("pad_token_id"))
    if model_type == "mamba":
        rank = hf.get("time_step_rank", "auto")
        return MambaConfig(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], d_state=hf.get("state_size", 16),
            d_conv=hf.get("conv_kernel", 4), expand=hf.get("expand", 2),
            dt_rank=None if rank == "auto" else int(rank),
            norm_eps=hf.get("layer_norm_epsilon", 1e-5), use_bias=hf.get("use_bias", False),
            use_conv_bias=hf.get("use_conv_bias", True),
            bos_token_id=hf.get("bos_token_id"), eos_token_id=hf.get("eos_token_id"))
    if model_type in ("llama", "mistral", "mixtral"):
        moe = {}
        if model_type == "mixtral":
            moe = dict(n_experts=hf.get("num_local_experts", 8),
                       n_experts_per_tok=hf.get("num_experts_per_tok", 2))
            if hf["intermediate_size"] >= 1024:
                # a production-size snapshot: the GShard 1.25 bound, as the
                # moe-8x1b preset (models.<m>.llm.expert_capacity overrides)
                moe["expert_capacity"] = 1.25
                warnings.warn("mixtral snapshot: defaulting expert_capacity to 1.25 (GShard "
                              "bound; set models.<m>.llm.expert_capacity = 0 for exact "
                              "dropless dispatch at much higher memory)")
        return DecoderConfig(
            style="llama", vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            n_kv_heads=hf.get("num_key_value_heads"), d_ff=hf["intermediate_size"],
            max_position=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 10000.0), norm_eps=hf.get("rms_norm_eps", 1e-5),
            bos_token_id=hf.get("bos_token_id"), eos_token_id=hf.get("eos_token_id"), **moe)
    if model_type == "opt":
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
            raise NotImplementedError("OPT word_embed_proj_dim != hidden_size (the 350m "
                                      "projection variant) is not supported")
        if not hf.get("do_layer_norm_before", True):
            raise NotImplementedError("OPT do_layer_norm_before=false (the 350m post-LN "
                                      "variant) is not supported")
        return DecoderConfig(
            style="opt", vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            d_ff=hf["ffn_dim"], max_position=hf.get("max_position_embeddings", 2048),
            norm_eps=1e-5, dropout=hf.get("dropout", 0.1),
            act_fn=hf.get("activation_function", "relu"),
            bos_token_id=hf.get("bos_token_id"), eos_token_id=hf.get("eos_token_id"),
            pad_token_id=hf.get("pad_token_id"))
    if model_type == "bart":
        if (hf.get("decoder_attention_heads", hf["encoder_attention_heads"])
                != hf["encoder_attention_heads"]
                or hf.get("decoder_ffn_dim", hf["encoder_ffn_dim"]) != hf["encoder_ffn_dim"]):
            raise NotImplementedError("BART with asymmetric encoder/decoder head or FFN sizes "
                                      "is not supported (DecoderConfig carries one set)")
        return DecoderConfig(
            style="bart", vocab_size=hf["vocab_size"], d_model=hf["d_model"],
            n_layers=hf["encoder_layers"],
            n_dec_layers=hf.get("decoder_layers", hf["encoder_layers"]),
            n_heads=hf["encoder_attention_heads"], d_ff=hf["encoder_ffn_dim"],
            max_position=hf.get("max_position_embeddings", 1024), norm_eps=1e-5,
            dropout=hf.get("dropout", 0.1), act_fn=hf.get("activation_function", "gelu"),
            scale_embedding=hf.get("scale_embedding", False), is_encoder_decoder=True,
            bos_token_id=hf.get("bos_token_id"), eos_token_id=hf.get("eos_token_id"),
            pad_token_id=hf.get("pad_token_id"))
    if model_type == "gpt_neox":
        return DecoderConfig(
            style="neox", vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            d_ff=hf["intermediate_size"], max_position=hf.get("max_position_embeddings", 2048),
            rope_theta=hf.get("rotary_emb_base", 10000.0),
            rotary_pct=hf.get("rotary_pct", 0.25),
            parallel_residual=hf.get("use_parallel_residual", True),
            act_fn=hf.get("hidden_act", "gelu"), norm_eps=hf.get("layer_norm_eps", 1e-5),
            dropout=hf.get("hidden_dropout", 0.0),
            bos_token_id=hf.get("bos_token_id"), eos_token_id=hf.get("eos_token_id"))
    raise ValueError(f"Unsupported HF model_type {model_type!r}")


def resolve_config(llm_id: str, llm_layers: int = -1,
                   cache_dir: str | None = None) -> DecoderConfig | MambaConfig:
    """The backbone's configuration for ``llm_id``: a local snapshot's
    ``config.json`` (``find_snapshot``) first, else the preset (a
    MambaConfig for the ``mamba`` ids), cut to ``llm_layers`` blocks when
    0 < llm_layers < n_layers (medtsllm.py:145-146 of the reference; an
    encoder-decoder's decoder to at most as many, as JAX's ``_truncate``)."""
    presets = {**PRESETS, **MAMBA_PRESETS}
    snap = find_snapshot(llm_id, cache_dir)
    if snap is not None:
        cfg = config_from_hf_json(snap)
    elif llm_id in presets:
        cfg = presets[llm_id]
    else:
        raise ValueError(f"No local snapshot for {llm_id!r} and no built-in preset; set "
                         f"paths.llm_path or use one of {sorted(presets)}")
    if llm_layers and 0 < llm_layers < cfg.n_layers:
        extra = {}
        if getattr(cfg, "n_dec_layers", None):
            extra["n_dec_layers"] = min(llm_layers, cfg.n_dec_layers)
        cfg = dataclasses.replace(cfg, n_layers=llm_layers, **extra)
    return cfg


def find_snapshot(llm_id: str, cache_dir: str | None) -> Path | None:
    """A local HF snapshot directory for ``llm_id`` (the tokenizer's first
    choice), as ``medtsllm_tpu/models/llm/loader.py::find_snapshot``."""
    candidates = [Path(llm_id)]
    if cache_dir:
        candidates.append(Path(cache_dir) / llm_id)
        candidates.append(Path(cache_dir))
    candidates.append(Path.home() / ".cache" / "huggingface" / "hub"
                      / f"models--{llm_id.replace('/', '--')}" / "snapshots")
    for cand in candidates:
        if not cand.exists():
            continue
        if (cand / "config.json").exists():
            return cand
        for sub in sorted(cand.glob("*/")):
            if (sub / "config.json").exists():
                return sub
    return None
