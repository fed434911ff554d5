"""The ops library (port of ``medtsllm_tpu/ops``): decomposition, RevIN,
embeddings, the attention family, Autoformer's and the transformer's
stacks, Crossformer's two-stage layer, the basis DFT, the Fourier and
multiwavelet blocks, TimesNet's inception blocks, the masks and the head,
beside the hand-written kernels (``ops/kernels``).

Every name that ``medtsllm_tpu/ops/__init__.py`` exports is exported here,
under the same name; none stays out. They load on first access (PEP 562),
not when the package is imported: ``models/llm/transformer.py`` imports
``ops.kernels``, which runs this file first, and most modules here import
``models/llm/transformer.py`` (its Dense, LayerNorm and dropout), so an
eager import here would be a cycle. ``ReformerLayer`` and
``lsh_attention``, which JAX's package exports from their modules only,
stay in ``ops.attention`` and ``ops.lsh_attention``.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "decomp": ("moving_avg", "my_layernorm_bias_correction", "series_decomp",
               "series_decomp_multi"),
    "revin": ("revin_norm", "revin_denorm", "RevINAffine"),
    "embed": ("positional_embedding", "TokenEmbedding", "FixedEmbedding", "TemporalEmbedding",
              "TimeFeatureEmbedding", "DataEmbedding", "DataEmbedding_wo_pos",
              "DataEmbedding_wo_time", "PatchEmbedding", "patch_unfold"),
    "attention": ("AttentionLayer", "DSAttention", "FullAttention", "ProbAttention"),
    "autocorr": ("AutoCorrelation", "AutoCorrelationLayer"),
    "autoformer": ("AutoformerDecoder", "AutoformerDecoderLayer", "AutoformerEncoder",
                   "AutoformerEncoderLayer", "MyLayerNorm"),
    "crossformer": ("TwoStageAttentionLayer",),
    "dft": ("irfft", "irfft_ri", "rfft", "rfft_ri"),
    "fourier": ("FourierBlock", "FourierCrossAttention"),
    "heads": ("FlattenHead",),
    "inception": ("InceptionBlockV1", "InceptionBlockV2", "fft_for_period", "fold_conv2d"),
    "masks": ("prob_mask", "triangular_causal_mask"),
    "transformer": ("ConvLayer", "Decoder", "DecoderLayer", "Encoder", "EncoderLayer"),
    "wavelets": ("MultiWaveletCross", "MultiWaveletTransform", "MWT_CZ1d", "get_filter"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
