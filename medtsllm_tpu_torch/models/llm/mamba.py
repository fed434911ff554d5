"""The Mamba (selective SSM) backbone (port of
``medtsllm_tpu/models/llm/mamba.py``: MambaBlock and MambaBackbone).

Same surface as TransformerDecoder (``wte``, ``embed``, ``forward(
inputs_embeds, prefix_kv=...)``, ``prefill``), so MedTsLLM's fusion path and
its prompt-head cache work unchanged: the "KV" of a layer is its
(conv tail [1, K-1, E], SSM state [1, N, E]).

Dtypes follow the JAX module's: projections emit ``dtype`` (None for f32,
else the compute dtype); the conv runs at the parameters' dtype, then
``+ conv_bias``; softplus(dt) and the scan run in f32 (``A = -exp(A_log)``
in f32); y rounds back to the projections' dtype before the ``silu(z)``
gate; the residual stream keeps the input embeddings' f32. With
``quantize`` 8 or 4 (``load_in_8bit`` / ``load_in_4bit``) ``in_proj``,
``x_proj`` and ``out_proj`` are ``QuantLinear`` as JAX's ``QuantDense``
(K1; K1's quantizer and K5 at 4-bit absmax; the table dequant for the
config's ``quant4_codebook`` nf4 / fp4; weight-only under ``act_quant``
False), rounded to the compute dtype as ``Linear`` is, so the scan's
operands keep their dtypes; ``dt_proj`` stays a dense ``Linear``, as in
JAX (the step size is bias-dominated and tiny). The scan goes
through the hand-written kernel (csrc/selective_scan.cu): when no operand
needs a gradient (serving, the prefill) as ``selective_ssm_gated``, which
takes dt_proj's output, A_log, the x_proj / in_proj outputs' views and the
conv output as they are and does the softplus, the casts and the gate
itself; in training as ``selective_ssm`` / ``selective_ssm_h0`` behind the
PyTorch glue, whose autograd covers the softplus and the gate. The
depthwise conv and the dense projections are PyTorch's, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.selective_scan import (_wants_grad, scan_operands, selective_ssm,
                                           selective_ssm_final, selective_ssm_gated,
                                           selective_ssm_h0)
from .config import MambaConfig
from .transformer import Linear, RMSNorm, projection, remat_call


@contextlib.contextmanager
def _f32_conv_flags(w: torch.Tensor):
    """cuDNN runs f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), the mixer's channels-last
    depthwise conv among them; the f32 conv keeps f32 whatever the global
    flag says, as the JAX package's does. Only that flag is turned off, and
    restored after."""
    cudnn = torch.backends.cudnn
    if w.dtype != torch.float32 or not w.is_cuda or not cudnn.allow_tf32:
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


class MambaBlock(nn.Module):
    """RMSNorm -> mixer -> residual (HF MambaBlock + MambaMixer)."""

    def __init__(self, cfg: MambaConfig, dtype=None, quantize: int = 0,
                 act_quant: bool | str = True):
        super().__init__()
        self.cfg = cfg
        E, N, R = cfg.d_inner, cfg.d_state, cfg.rank

        def proj(d_in, d_out, bias):  # JAX's ``dense``: QuantDense when quantized
            return projection(d_in, d_out, quantize, dtype, cfg.quant4_codebook, bias,
                              act_quant)
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.in_proj = proj(cfg.d_model, 2 * E, cfg.use_bias)
        # depthwise conv weight in F.conv1d's layout [E, 1, K] (flax [K, 1, E])
        self.conv_kernel = nn.Parameter(torch.zeros(E, 1, cfg.d_conv))
        self.conv_bias = nn.Parameter(torch.zeros(E)) if cfg.use_conv_bias else None
        self.x_proj = proj(E, R + 2 * N, False)
        self.dt_proj = Linear(R, E, bias=True, dtype=dtype)
        self.A_log = nn.Parameter(torch.zeros(E, N))
        self.D = nn.Parameter(torch.ones(E))
        self.out_proj = proj(E, cfg.d_model, cfg.use_bias)

    def forward(self, x, prefix_state=None, return_state: bool = False):
        """``prefix_state`` (serving) = (conv_ctx [1|B, K-1, E], h0 [1|B, N,
        E]): resume the conv and the recurrence from the cached prompt
        head. ``return_state`` (prefill) also returns this segment's (conv
        tail, final SSM state)."""
        cfg = self.cfg
        E, N, R, K = cfg.d_inner, cfg.d_state, cfg.rank, cfg.d_conv
        residual = x
        xz = self.in_proj(self.norm(x))  # [B, L, 2E]
        xs, z = xz.chunk(2, dim=-1)
        B = xs.shape[0]
        if return_state:
            # tail of the RAW pre-activation xs, zero-padded like the conv's
            # own left context when the segment is shorter than K-1
            conv_tail = F.pad(xs, (0, 0, K - 1, 0))[:, -(K - 1):]
        if prefix_state is not None:
            ctx = prefix_state[0].to(xs.dtype).expand(B, K - 1, E)
            conv_in = torch.cat([ctx, xs], dim=1)
        else:
            conv_in = F.pad(xs, (0, 0, K - 1, 0))
        w = self.conv_kernel
        # the depthwise conv over [B, E, 1, L] in channels-last memory, which
        # is conv_in's own [B, L, E] layout: cuDNN reads it and writes xc
        # row-major [B, L, E], the layout x_proj and the scan read, where
        # F.conv1d would copy its input to [B, E, L] and its output back
        # (the same bits)
        with _f32_conv_flags(w):
            xc = F.conv2d(conv_in.to(w.dtype).unsqueeze(1).permute(0, 3, 1, 2), w.unsqueeze(2),
                          groups=E).permute(0, 2, 3, 1).squeeze(1).contiguous()
        if self.conv_bias is not None:
            xc = xc + self.conv_bias
        xs = F.silu(xc).to(xz.dtype)

        dt, Bs, Cs = self.x_proj(xs).split([R, N, N], dim=-1)
        dt = self.dt_proj(dt)
        h0 = None if prefix_state is None else prefix_state[1]
        if not _wants_grad(dt, Bs, Cs, xs, z, self.A_log, self.D):
            # serving and the prefill: the glue runs inside the kernel
            y = selective_ssm_gated(dt, self.A_log, Bs, Cs, xs, self.D, z, h0, return_state)
            if return_state:
                y, h_final = y
        else:
            args = scan_operands(dt, self.A_log, Bs, Cs, xs, self.D)
            if return_state:
                y, h_final = selective_ssm_final(*args)
            elif h0 is not None:
                y = selective_ssm_h0(*args, h0)
            else:
                y = selective_ssm(*args)
            y = y.to(xz.dtype) * F.silu(z)
        out = residual + self.out_proj(y)
        if return_state:
            return out, (conv_tail, h_final)
        return out


class MambaBackbone(nn.Module):
    """Embedding + n_layers MambaBlocks + final RMSNorm; returns the last
    hidden state (no LM head), like TransformerDecoder. ``quantize`` and
    ``act_quant`` are the blocks' (JAX's ``setup``). ``remat``
    (``llm.remat``) recomputes each block in the backward of a forward
    with no prefix state that needs gradients, as JAX's backbone does
    (``mamba.py:205``)."""

    def __init__(self, cfg: MambaConfig, quantize: int = 0, dtype=None,
                 remat: bool | str = False, act_quant: bool | str = True):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model),
                                requires_grad=False)
        self.blocks = nn.ModuleList(MambaBlock(cfg, dtype, quantize, act_quant)
                                    for _ in range(cfg.n_layers))
        self.norm_f = RMSNorm(cfg.d_model, cfg.norm_eps)

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.wte[token_ids]

    def word_embeddings(self) -> torch.Tensor:
        return self.wte

    def forward(self, inputs_embeds: torch.Tensor, prefix_kv=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``prefix_kv``: per-layer (conv tail, SSM state) from ``prefill``,
        the SSM's counterpart of a KV cache, O(1) in the head's length.
        ``generator`` is the decoders' interface: the backbone has no
        dropout."""
        x = inputs_embeds
        if self.remat and prefix_kv is None and torch.is_grad_enabled():
            for block in self.blocks:
                x = remat_call(lambda h, g, b=block: b(h), x, generator, self.remat)
        else:
            for i, block in enumerate(self.blocks):
                x = block(x, None if prefix_kv is None else prefix_kv[i])
        return self.norm_f(x)

    def prefill(self, inputs_embeds: torch.Tensor) -> tuple:
        """Per-layer (conv tail [1, K-1, E], SSM state [1, N, E]) of a prompt
        prefix [1, P, d]."""
        x = inputs_embeds
        states = []
        for block in self.blocks:
            x, state = block(x, return_state=True)
            states.append(state)
        return tuple(states)
