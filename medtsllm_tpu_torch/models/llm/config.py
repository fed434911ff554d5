"""Decoder configuration and the llama presets the port serves.

Port of ``medtsllm_tpu/models/llm/transformer.py::DecoderConfig`` (llama
fields only) and the ``PRESETS`` / ``resolve_config`` of
``models/llm/loader.py``. The backbone is random-initialised with the
preset's shapes (weights.py); local snapshots are not loaded yet.
"""

from __future__ import annotations

import dataclasses
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

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


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
}


def resolve_config(llm_id: str, llm_layers: int = -1) -> DecoderConfig:
    """The preset for ``llm_id``, cut to ``llm_layers`` blocks when
    0 < llm_layers < n_layers (medtsllm.py:145-146 of the reference)."""
    if llm_id not in PRESETS:
        raise NotImplementedError(
            f"backbone {llm_id!r}: the port has the presets {sorted(PRESETS)}; "
            "other backbones and snapshot loading are ROADMAP queue 1 item 8")
    cfg = PRESETS[llm_id]
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
