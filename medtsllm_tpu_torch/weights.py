"""Parameters: conversion from the JAX package's flax tree, and random
initialisation on the device with the JAX init's distributions.

State-dict names follow the flax paths: ``/`` becomes ``.``, the decoder's
``h_{i}`` becomes ``blocks.{i}``, and the wrapper scopes ``base`` (LoRADense)
and ``Conv_0`` are dropped. Layouts differ where PyTorch's do:
  - Dense ``kernel`` [in, out] -> ``weight`` [out, in] (nn.Linear);
  - int8 ``kernel_q`` [K, N] -> ``weight_q`` [N, K] (the w8a8 kernel's B
    operand, transposed once here); packed int4 [ceil(K/2), N] -> [N,
    ceil(K/2)] alike (each byte keeps its nibble pair);
  - int8 MoE experts ``w_{gate,up,down}_q`` [E, K, N] -> [E, N, K] (the
    grouped kernel's layout, under the same names), packed int4 [E,
    ceil(K/2), N] -> [E, N, ceil(K/2)]; the router ``gate``
    [D, E], the scales [E, N] and dense experts [E, K, N] keep theirs;
  - Conv ``kernel`` [k, in, out] -> ``weight`` [out, in, k] (Conv1d);
  - the Mamba block's depthwise ``conv_kernel`` [K, 1, E] -> [E, 1, K]
    (F.conv1d with groups=E), under its own name.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from .models.llm.mamba import MambaBackbone, MambaBlock
from .models.llm.transformer import MoEMLP, QuantLinear, RMSNorm, TransformerDecoder
from .models.medtsllm import LayerNorm, WordEmbeddings
from .ops.embed import TokenEmbedding
from .ops.kernels.w4a8 import CODEBOOKS, pack4_split

# QuantDense random init: one fixed quantization scale, 3.5 sigma of the
# N(0, 0.02) init mapped to qmax, 127 for int8 and 7 for absmax int4; a
# 4-bit codebook maps 3.5 sigma to its table's 1.0 (transformer.py:376-407,
# 1040-1070 of the JAX package)
S_INIT = 3.5 * 0.02 / 127.0
S_INIT4 = {"absmax": 3.5 * 0.02 / 7.0, "nf4": 3.5 * 0.02, "fp4": 3.5 * 0.02}
# jax.nn.initializers.truncated_normal's std correction for the [-2, 2] cut
_TRUNC_STD = 0.87962566103423978


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as jax.device_get returns
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax parameter tree (numpy leaves) -> torch state dict."""
    state = {}
    for path, value in _flatten(params):
        parts = []
        for part in path.split("/"):
            if part in ("base", "Conv_0"):
                continue
            m = re.fullmatch(r"h_(\d+)", part)
            parts += ["blocks", m.group(1)] if m else [part]
        arr = np.asarray(value)
        leaf = parts[-1]
        if leaf == "kernel_q":
            leaf, arr = "weight_q", arr.T
        elif leaf == "kernel":
            leaf, arr = "weight", (arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T)
        elif leaf == "conv_kernel":
            arr = arr.transpose(2, 1, 0)
        elif re.fullmatch(r"w_(gate|up|down)_q", leaf):
            arr = arr.transpose(0, 2, 1)
        state[".".join(parts[:-1] + [leaf])] = _to_torch(arr)
    return state


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init in place, on the model's device, drawing from
    ``generator`` (on that device) with the JAX init's distributions:
    word embeddings N(0, 0.02); RMSNorm ones; int8 projections
    clip(round(N(0, 0.02) / S_INIT), +-127) with scale S_INIT; int4 ones
    clip(round(w / S_INIT4), +-7) (absmax) or the nearest table entry of
    w / S_INIT4 (nf4, fp4: the first on ties, so fp4's -0 is never drawn)
    minus 8, packed, with scale S_INIT4; Dense
    lecun-normal kernels and zero biases; the MoE router N(0, 0.02), int8
    experts as the int8 projections (drawn expert by expert, so the f32
    temporaries stay one expert's size) and dense experts lecun-normal over
    each expert's fan-in (transformer.py:1040-1083); the conv patch embedding
    N(0, 2 / fan_in); the Mamba block's depthwise conv lecun-normal (fan_in
    = K), its conv bias 0, ``A_log = log(1..N)`` and ``D = 1``
    (mamba.py:104-143 of the JAX package); LayerNorm (``llm_replacement``'s)
    scale 1, bias 0. The values differ from JAX's
    (another generator)."""
    def int8_(wq: torch.Tensor) -> None:
        w = torch.randn(wq.shape, generator=generator, device=wq.device) * 0.02
        wq.copy_(torch.clamp(torch.round(w / S_INIT), -127, 127))

    def int4_(wq: torch.Tensor, n_in: int, codebook: str) -> None:
        """One packed [N, ceil(n_in/2)] weight, drawn in slices of rows (the
        codebook's [rows, n_in, 16] distances stay small)."""
        s = S_INIT4[codebook]
        for r in range(0, wq.shape[0], 512):
            w = torch.randn(min(512, wq.shape[0] - r), n_in, generator=generator,
                            device=wq.device) * 0.02
            if codebook == "absmax":
                q = torch.clamp(torch.round(w / s), -7, 7)
            else:
                table = torch.tensor(CODEBOOKS[codebook], device=wq.device)
                q = torch.argmin((w[..., None] / s - table).abs(), dim=-1) - 8
            wq[r:r + 512] = pack4_split(q.to(torch.int8))

    def quant_(wq: torch.Tensor, bits: int, n_in: int, codebook: str) -> float:
        """Draw one quantized weight in place; returns its scale."""
        if bits == 8:
            int8_(wq)
            return S_INIT
        int4_(wq, n_in, codebook)
        return S_INIT4[codebook]

    for module in model.modules():
        if isinstance(module, QuantLinear):
            module.scale.fill_(quant_(module.weight_q, module.bits, module.d_in,
                                      module.codebook))
        elif isinstance(module, MoEMLP):
            module.gate.normal_(0.0, 0.02, generator=generator)
            cfg = module.cfg
            for name, n_in in (("w_gate", cfg.d_model), ("w_up", cfg.d_model),
                               ("w_down", cfg.d_ff)):
                if module.quantize:
                    for wq in getattr(module, name + "_q"):
                        s = quant_(wq, module.quantize, n_in, cfg.quant4_codebook)
                    getattr(module, name + "_scale").fill_(s)
                else:
                    w = getattr(module, name)
                    _lecun_normal_(w, w.shape[1], generator)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, TokenEmbedding):
            fan_in = module.weight.shape[1] * module.weight.shape[2]
            module.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        elif isinstance(module, MambaBlock):
            _lecun_normal_(module.conv_kernel, module.cfg.d_conv, generator)
            if module.conv_bias is not None:
                module.conv_bias.zero_()
            N = module.cfg.d_state
            module.A_log.copy_(torch.log(torch.arange(
                1, N + 1, dtype=torch.float32, device=module.A_log.device)).expand(
                    module.A_log.shape))
            module.D.fill_(1.0)
        elif isinstance(module, (TransformerDecoder, MambaBackbone, WordEmbeddings)):
            module.wte.normal_(0.0, 0.02, generator=generator)
