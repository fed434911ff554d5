"""Backbone configurations and the presets the port serves.

Port of ``medtsllm_tpu/models/llm/transformer.py::DecoderConfig`` (llama
and mixtral-style MoE fields), ``models/llm/mamba.py::MambaConfig`` and the ``PRESETS`` /
``_mamba_presets`` / ``resolve_config`` of ``models/llm/loader.py``. The
backbone is random-initialised with the preset's shapes (weights.py);
local snapshots are not loaded yet.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    style: str  # "llama" only in this port
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
    # mixtral-style sparse MoE FFN (n_experts > 1): top-k routed SwiGLU
    # experts; expert_capacity is the GShard capacity factor (0 = dropless)
    n_experts: int = 0
    n_experts_per_tok: int = 2
    expert_capacity: float = 0.0
    # the dropless grouped-GEMM expert chain (K6) in place of the capacity
    # bmm; resolved from models.<m>.llm.moe_grouped by MedTsLLM.from_config
    moe_grouped: bool = False
    # 4-bit weights (quantize=4): "absmax" (linear int4, the w4a8 kernels)
    # or a bnb codebook, "nf4" / "fp4" (table dequant, then a matmul at the
    # compute dtype); resolved from models.<m>.llm.quant_type
    quant4_codebook: str = "absmax"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


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

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)


PRESETS = {
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


def resolve_config(llm_id: str, llm_layers: int = -1) -> DecoderConfig | MambaConfig:
    """The preset for ``llm_id`` (a MambaConfig for the ``mamba`` ids), cut
    to ``llm_layers`` blocks when 0 < llm_layers < n_layers
    (medtsllm.py:145-146 of the reference)."""
    presets = {**PRESETS, **MAMBA_PRESETS}
    if llm_id not in presets:
        raise NotImplementedError(
            f"backbone {llm_id!r}: the port has the presets {sorted(presets)}; "
            "other backbones are ROADMAP queue 1, \"Other backbone families and LoRA\", "
            "and snapshot loading \"Llama decoder, open parts\"")
    cfg = presets[llm_id]
    if llm_layers and 0 < llm_layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=llm_layers)
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
