"""Parameters: conversion from the JAX package's flax tree, and random
initialisation on the device with the JAX init's distributions.

State-dict names follow the flax paths: ``/`` becomes ``.``, the decoder's
``h_{i}`` becomes ``blocks.{i}``, and the wrapper scopes ``base`` (LoRADense)
and ``Conv_0`` are dropped. Layouts differ where PyTorch's do:
  - Dense ``kernel`` [in, out] -> ``weight`` [out, in] (nn.Linear);
  - int8 ``kernel_q`` [K, N] -> ``weight_q`` [N, K] (the w8a8 kernel's B
    operand, transposed once here);
  - Conv ``kernel`` [k, in, out] -> ``weight`` [out, in, k] (Conv1d).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from .models.llm.transformer import QuantLinear, RMSNorm, TransformerDecoder
from .ops.embed import TokenEmbedding

# QuantDense random init: one fixed quantization scale, 3.5 sigma of the
# N(0, 0.02) init mapped to 127 (transformer.py:381-407 of the JAX package)
S_INIT = 3.5 * 0.02 / 127.0
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
    clip(round(N(0, 0.02) / S_INIT), +-127) with scale S_INIT; Dense
    lecun-normal kernels and zero biases; the conv patch embedding
    N(0, 2 / fan_in). The values differ from JAX's (another generator)."""
    for module in model.modules():
        if isinstance(module, QuantLinear):
            w = torch.randn(module.weight_q.shape, generator=generator,
                            device=module.weight_q.device) * 0.02
            module.weight_q.copy_(torch.clamp(torch.round(w / S_INIT), -127, 127))
            module.scale.fill_(S_INIT)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
        elif isinstance(module, TokenEmbedding):
            fan_in = module.weight.shape[1] * module.weight.shape[2]
            module.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        elif isinstance(module, TransformerDecoder):
            module.wte.normal_(0.0, 0.02, generator=generator)
