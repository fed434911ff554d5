"""``FlattenHead`` (port of ``medtsllm_tpu/ops/heads.py``): the ops library's
head. The port's models keep their own heads (MedTsLLM's and PatchTST's,
which JAX's models also write apart)."""

from __future__ import annotations

from torch import nn

from ..models.llm.transformer import Linear, dropout


class FlattenHead(nn.Module):
    """Flatten the last two axes, then a Dense to ``target_window``
    (``linear``): [..., d, n] -> [..., target_window], d x n = ``d_in``;
    dropout ``p`` in training."""

    def __init__(self, d_in: int, target_window: int, p: float = 0.0):
        super().__init__()
        self.p = p
        self.linear = Linear(d_in, target_window)

    def forward(self, x, generator=None):
        x = self.linear(x.flatten(-2))
        return dropout(x, self.p, generator) if self.training else x
