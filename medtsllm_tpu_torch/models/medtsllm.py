"""MedTsLLM on a llama or Mamba backbone (port of
``medtsllm_tpu/models/medtsllm.py``: ReprogrammingLayer, MedTsLLM and the
host-side PromptBuilder).

RevIN -> patch unfold -> conv patch embedding -> vocab-mapped reprogramming
cross-attention (kernel K3) -> [prompt embeds | ts embeds] -> the backbone
(llama: kernels K1, K2; Mamba: the selective-scan kernel) -> d_ff
downsample -> FlattenHead -> the task's head: RevIN denorm
(reconstruction, anomaly detection, pretraining, forecasting's
``pred_len`` steps past the window, imputation), classification's one row
of ``n_classes`` logits (no activation: the task softmaxes on the host) or
the per-step scores of
segmentation (one logit) and semantic segmentation (one logit, or one per
class past two), with the sigmoid / softmax in eval. Imputation's RevIN
statistics cover the observed points only (``inputs["mask"]``,
``masked_window_norm``). The constant prompt
head is prefilled once and served as per-layer prefix K/V (llama) or
per-layer (conv tail, SSM state) (Mamba); on a clip dataset with a llama
backbone the head also holds the clip's description, one row per window
([B, P] ``prefix_ids``, served from the task's per-clip KV bank). The
pretraining mixture's rows each carry their own dataset prompt: no head is
cached and the whole prompt goes through the step.

Training (``model.train()``): the backbone is frozen (``requires_grad =
False`` under ``llm``, ``param_labels`` of the JAX model) and every fusion
layer trains; dropout ``p`` acts after the patch embedding and on the
reprogramming attention weights, with masks from the generator ``forward``
is given. The reprogramming attention then runs the plain einsum/softmax
graph, as JAX does (K3 has no backward).

The covariate modes (``covariate_mode``, the seven of the JAX model):
``concat`` folds the C features into each patch's query (C * d_model
wide); every other mode runs K3 on B * C rows of d_model-wide queries,
then ``add`` averages the C rows, ``weighted-average`` mixes them with
``feature_weighting`` (a Dense over C), ``interleave`` lays them out as C
tokens a patch (the region is P * C tokens long), and ``independent`` /
``merge-end`` send each channel through the backbone as a row of its own
(the prompt and a per-row prefix repeated C times, a one-row prefix
broadcast), the head then averaging the C rows or mixing them with
``feature_weighting``. The backbone's output goes from d_llm to d_ff by
``embedding_downsample_mode``: a Dense (``linear``), its first d_ff columns
(``truncate``) or the mean of d_llm / d_ff groups (``average``). With
``llm.enabled = false`` a small MLP (``llm_replacement``: Dense, exact
GELU, Dense, LayerNorm) takes the place of the backbone and the
downsample; the backbone then holds its word embeddings only (the
reprogramming basis), as JAX's lazily built tree does, and no prompt is
built. In-context examples (``prompting.examples``): the example's text
ends the prompt's first part, and the example series, cropped or tiled to
one length fixed from the dataset's pool, goes through ``encode_ts`` (K3 a
second time) between that part and the rest of the prompt.

Scope: an llama (dense or mixtral-style MoE, served on one device) or
dense Mamba backbone, or none; anything else raises NotImplementedError
naming its ROADMAP item. The tasks are those of ``tasks.task_lookup``, all
eight of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embed import PatchEmbedding, dropout
from ..ops.kernels.reprogramming import reprogramming_attention
from ..ops.revin import masked_window_norm, revin_denorm, revin_norm
from .llm.config import resolve_config
from .llm.mamba import MambaBackbone
from .llm.tokenizer import get_tokenizer
from .llm.transformer import Linear, TransformerDecoder

# batch keys that enter the model as arrays (medtsllm_tpu/utils.py)
ARRAY_BATCH_KEYS = ("x_enc", "y", "labels", "index", "valid")

# the task prompts (medtsllm_tpu/models/medtsllm.py:926-950), by task; formatted
# with the history ``seq`` and the prediction length ``pred``
TASK_DESCRIPTIONS = {
    "forecasting": "Forecast the next {pred} steps given the previous {seq} steps of data.",
    "pretraining": "Forecast the next {pred} steps given the previous {seq} steps of data.",
    "reconstruction": "Reconstruct the past {seq} steps of data as accurately as possible "
                      "using the following information.",
    "anomaly_detection": "Reconstruct the past {seq} steps of data as accurately as "
                         "possible using the following information.",
    "semantic_segmentation": "Classify the past {seq} steps of data as accurately as "
                             "possible using the following information.",
    "segmentation": "Identify the change points in the past {seq} steps of data to segment "
                    "the sequence.",
    "classification": "Classify the past {seq} steps of data into a single category using "
                      "the following information.",
    "imputation": "Fill in the missing values in the past {seq} steps of data using the "
                  "following information.",
}
# the tasks whose head is RevIN-denormalized (medtsllm.py:669-670)
DENORM_TASKS = ("forecasting", "reconstruction", "anomaly_detection", "pretraining",
                "imputation")

# the covariate modes the JAX model knows (medtsllm_tpu/models/medtsllm.py:242)
COVARIATE_MODES = ("univariate", "independent", "concat", "interleave", "add",
                   "weighted-average", "merge-end")
# the modes that send each channel through the backbone as a row of its own
# (medtsllm_tpu/models/medtsllm.py:618-626)
PER_CHANNEL_MODES = ("independent", "merge-end")

# models.<m>.llm.quant_type under load_in_4bit -> the 4-bit codebook
# (medtsllm_tpu/models/medtsllm.py:259-267)
QUANT4_CODEBOOKS = {"int4": "absmax", "linear": "absmax", "nf4": "nf4", "fp4": "fp4"}

# [setup] dtype -> the dtype of every float parameter and of the compute
# (the JAX package's Precision, medtsllm_tpu/utils.py:45-82)
_f32, _bf16, _f16 = torch.float32, torch.bfloat16, torch.float16
DTYPES = {"bfloat16": _bf16, "bf16": _bf16, "float16": _f16, "half": _f16, "fp16": _f16,
          "16": _f16, 16: _f16, "float32": _f32, "float": _f32, "fp32": _f32, "32": _f32,
          32: _f32}
# [setup] dtype -> the backbone's compute dtype (the JAX model's llm_dtype,
# medtsllm_tpu/models/medtsllm.py:414-419): bf16 under "mixed"; the names
# it lacks, "16" and 16 among them, compute at f32
LLM_DTYPES = {"bfloat16": _bf16, "bf16": _bf16, "mixed": _bf16, "float16": _f16,
              "half": _f16, "fp16": _f16}


class Precision:
    """``param_dtype``: where parameters are stored; ``compute_dtype``: the
    train step's. "mixed" stores trainable parameters at f32 and the frozen
    backbone at bf16, and runs the train step at bf16 over bf16 casts of
    the parameters and of the float inputs; eval runs in the parameters'
    own precision."""

    def __init__(self, name: str | int = "float32"):
        self.mixed = name == "mixed"
        if self.mixed:
            self.param_dtype, self.compute_dtype = _f32, _bf16
        elif name in DTYPES:
            self.param_dtype = self.compute_dtype = DTYPES[name]
        else:
            raise ValueError(f"Invalid dtype selection: {name}")

    @classmethod
    def from_config(cls, config) -> "Precision":
        return cls(config.setup.get("dtype", "float32"))

    def storage(self, frozen: bool) -> torch.dtype:
        """The storage dtype of a float parameter."""
        return _bf16 if self.mixed and frozen else self.param_dtype


def llm_dtype(config) -> torch.dtype:
    return LLM_DTYPES.get(str(config.setup.get("dtype", "float32")), _f32)


class ReprogrammingLayer(nn.Module):
    """Cross-attention from patch embeddings (queries) into the compressed
    text-token basis (keys/values): K3 in eval, the einsum graph with
    dropout ``p`` on the attention weights in training."""

    def __init__(self, d_in: int, n_heads: int, d_keys: int, d_llm: int, p: float = 0.0):
        super().__init__()
        self.n_heads, self.d_keys, self.p = n_heads, d_keys, p
        self.query_projection = Linear(d_in, d_keys * n_heads)
        self.key_projection = Linear(d_llm, d_keys * n_heads)
        self.value_projection = Linear(d_llm, d_keys * n_heads)
        self.out_projection = Linear(d_keys * n_heads, d_llm)

    def forward(self, target, source, value, generator=None):
        B, L, _ = target.shape
        S, H, E = source.shape[0], self.n_heads, self.d_keys
        q = self.query_projection(target).reshape(B, L, H, E)
        k = self.key_projection(source).reshape(S, H, E)
        v = self.value_projection(value).reshape(S, H, E)
        # the einsum in JAX promotes to q's type (f32): so does the kernel
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        scale = 1.0 / math.sqrt(E)
        if self.training:
            attn = torch.softmax(scale * torch.einsum("blhe,she->bhls", q, k), dim=-1)
            attn = dropout(attn, self.p, generator)
            out = torch.einsum("bhls,she->blhe", attn, v)
        else:
            out = reprogramming_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                          scale)
        return self.out_projection(out.reshape(B, L, H * E))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6, parameters ``scale`` and
    ``bias``): the statistics in f32 as E[x^2] - E[x]^2 clipped at 0, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, emitted at the
    promoted type of the input and the parameters."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(-1, keepdim=True) - mean.square(), 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale.float()) + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class LLMReplacement(nn.Module):
    """The ablation's MLP in place of the backbone and the downsample
    (``llm_replacement``, flax ``nn.Sequential``: ``layers_0`` Dense(d_llm),
    ``layers_1`` the exact-erf GELU, ``layers_2`` Dense(d_ff), ``layers_3``
    LayerNorm)."""

    def __init__(self, d_llm: int, d_ff: int):
        super().__init__()
        self.layers_0 = Linear(d_llm, d_llm)
        self.layers_2 = Linear(d_llm, d_ff)
        self.layers_3 = LayerNorm(d_ff)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_3(self.layers_2(F.gelu(self.layers_0(x))))


class WordEmbeddings(nn.Module):
    """The backbone under ``llm.enabled = false``: its word embeddings only
    (``wte``, the reprogramming layer's basis), as JAX's tree holds them;
    no decoder block is built."""

    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.wte = nn.Parameter(torch.zeros(vocab_size, d_model), requires_grad=False)


class MedTsLLM(nn.Module):
    def __init__(self, *, seq_len, pred_len, n_features, d_model, d_ff, n_heads,
                 num_tokens, patch_len, stride, llm_cfg, llm_id, quantize=0,
                 llm_dtype=torch.float32, prefix_cache=True, cache_dir=None,
                 dropout=0.0, task="reconstruction", n_classes=0, seg_mode=None,
                 covariate_mode="concat", embedding_downsample_mode="linear",
                 llm_enabled=True):
        super().__init__()
        self.seq_len, self.pred_len, self.n_features = seq_len, pred_len, n_features
        self.d_model, self.d_ff = d_model, d_ff
        self.patch_len, self.stride = patch_len, stride
        self.llm_cfg, self.llm_id, self.cache_dir = llm_cfg, llm_id, cache_dir
        self.prefix_cache = prefix_cache
        self.task, self.n_classes, self.seg_mode = task, n_classes, seg_mode
        self.covariate_mode = covariate_mode
        self.embedding_downsample_mode = embedding_downsample_mode
        self.llm_enabled = llm_enabled
        # medtsllm_tpu/models/medtsllm.py:161-181
        self.n_outputs_per_step = {
            "segmentation": 1,
            "semantic_segmentation": n_classes if n_classes > 2 else 1,
            "classification": n_classes,
        }.get(task, n_features)
        if llm_enabled:
            backbone = MambaBackbone if llm_cfg.style == "mamba" else TransformerDecoder
            self.llm = backbone(
                llm_cfg, quantize, None if llm_dtype == torch.float32 else llm_dtype)
        else:
            self.llm = WordEmbeddings(llm_cfg.vocab_size, llm_cfg.d_model)
        self.llm.requires_grad_(False)  # the frozen backbone (param_labels)
        self.patch_embedding = PatchEmbedding(d_model, patch_len, stride, dropout)
        self.mapping_layer = Linear(llm_cfg.vocab_size, num_tokens)
        self.reprogramming_layer = ReprogrammingLayer(
            n_features * d_model if covariate_mode == "concat" else d_model, n_heads, d_ff,
            self.d_llm, dropout)
        self.output_projection = Linear(d_ff * self.n_patches,
                                        self.n_outputs_per_step * self.head_steps)
        # the layers JAX's tree holds (medtsllm.py:494-509): the downsample's
        # Dense only where the backbone's output is downsampled by it
        if embedding_downsample_mode == "average" and self.d_llm % d_ff:
            raise ValueError(f"embedding_downsample_mode \"average\" needs d_ff {d_ff} to "
                             f"divide d_llm {self.d_llm}")
        if llm_enabled and embedding_downsample_mode not in ("linear", "truncate", "average"):
            raise ValueError(f"Unknown embedding downsample mode {embedding_downsample_mode}")
        if llm_enabled and embedding_downsample_mode == "linear":
            self.embedding_downsample_layer = Linear(self.d_llm, d_ff)
        if covariate_mode == "merge-end":
            self.feature_weighting = Linear(self.n_outputs_per_step * n_features,
                                            self.n_outputs_per_step)
        elif covariate_mode == "weighted-average":
            self.feature_weighting = Linear(n_features, 1)
        if not llm_enabled:
            self.llm_replacement = LLMReplacement(self.d_llm, d_ff)

    @classmethod
    def model_config(cls, config):
        models = config.models
        return models.medtsllm if "medtsllm" in models else models.timellm

    @classmethod
    def from_config(cls, config, dataset, device):
        """``device`` is where the model will run: it resolves
        ``llm.moe_grouped = "auto"``."""
        mc = cls.model_config(config)
        unported = []
        task = config.task
        seg_mode = config.tasks.segmentation.mode if task == "segmentation" else None
        if seg_mode not in (None, "boundary-prediction", "steps-to-boundary"):
            raise ValueError(f"Segmentation mode {seg_mode} not supported")
        covariate_mode = mc.covariate_mode
        if covariate_mode not in COVARIATE_MODES:
            raise ValueError(f"Unknown covariate_mode {covariate_mode!r}; "
                             f"expected one of {COVARIATE_MODES}")
        if covariate_mode == "univariate" and dataset.n_features != 1:
            raise ValueError(f"covariate_mode \"univariate\" needs one feature, not "
                             f"{dataset.n_features}")
        enabled = bool(mc.llm.enabled)
        in4, in8 = mc.llm.get("load_in_4bit", False), mc.llm.get("load_in_8bit", False)
        codebook = "absmax"
        if in4:
            qt = str(mc.llm.get("quant_type", "int4")).lower()
            codebook = QUANT4_CODEBOOKS.get(qt)
            if codebook is None:
                raise ValueError(f"models.llm.quant_type must be int4/nf4/fp4; got {qt!r}")
        if str(mc.llm.llm).startswith("mamba") and (in8 or in4):
            unported.append("quantized Mamba (ROADMAP queue 1, \"Mamba, open parts\")")
        if ((in4 and codebook == "absmax") or (in8 and not in4)) and not mc.llm.get(
                "int8_matmul", True):
            unported.append("weight-only int8 / int4, int8_matmul = false (ROADMAP queue "
                            "1, \"Llama decoder, open parts\")")
        if mc.llm.get("int8_backward", False):
            unported.append("llm.int8_backward, the int8 dx GEMM of the STE backward "
                            "(ROADMAP queue 1, \"Training on the served backbones\")")
        # (JAX reads these two only for an enabled backbone)
        if mc.llm.get("fuse_projections", False) and enabled:
            unported.append("llm.fuse_projections (ROADMAP queue 1, \"Llama decoder, open "
                            "parts\")")
        if "lora" in mc and mc.lora.enabled and enabled:
            unported.append("LoRA (ROADMAP queue 1, \"Other backbone families and LoRA\")")
        for key in ("pipeline_parallel", "tensor_parallel", "expert_parallel"):
            if int(config.setup.get(key, 1) or 1) > 1:
                unported.append(f"setup.{key} (ROADMAP queue 1, \"Parallelism\")")
        if config.setup.get("tp_overlap", False):
            unported.append("setup.tp_overlap (ROADMAP queue 1, \"Parallelism\")")
        if unported:
            raise NotImplementedError("not ported yet: " + "; ".join(unported))
        cache_dir = config.get("paths", {}).get("llm_path") or None
        if cache_dir in ("", "none"):
            cache_dir = None
        quantize = 4 if in4 else 8 if in8 else 0  # 4 wins, as in JAX
        llm_cfg = resolve_config(mc.llm.llm, mc.llm.get("llm_layers", -1))
        if quantize == 4:
            llm_cfg = dataclasses.replace(llm_cfg, quant4_codebook=codebook)
        llm_cfg = _resolve_moe(llm_cfg, mc.llm, quantize, torch.device(device))
        return cls(
            seq_len=config.history_len, pred_len=config.pred_len,
            n_features=dataset.n_features, d_model=mc.d_model, d_ff=mc.d_ff,
            n_heads=mc.n_heads, num_tokens=mc.num_tokens,
            patch_len=mc.patching.patch_len, stride=mc.patching.stride,
            llm_cfg=llm_cfg, llm_id=mc.llm.llm, quantize=quantize,
            llm_dtype=llm_dtype(config),
            prefix_cache=bool(mc.llm.get("prefix_cache", True)),
            cache_dir=cache_dir,
            dropout=float(config.training.get("dropout", 0.0) or 0.0),
            task=task, n_classes=(dataset.n_classes if task in (
                "classification", "semantic_segmentation") else 0),
            seg_mode=seg_mode, covariate_mode=covariate_mode,
            embedding_downsample_mode=mc.embedding_downsample_mode, llm_enabled=enabled)

    # derived sizes (reference medtsllm.py:52,71-87)
    @property
    def base_n_patches(self) -> int:
        return int((self.seq_len - self.patch_len) / self.stride + 2)

    @property
    def n_patches(self) -> int:
        """The region's tokens: the patches, C a patch under ``interleave``."""
        n = self.base_n_patches
        return n * self.n_features if self.covariate_mode == "interleave" else n

    @property
    def d_llm(self) -> int:
        return self.llm_cfg.d_model

    @property
    def head_steps(self) -> int:
        """The steps the FlattenHead emits: ``pred_len``, but one row for
        classification's per-window label."""
        return 1 if self.task == "classification" else self.pred_len

    @property
    def supports_prefix_cache(self) -> bool:
        """The prompt head is prefilled and served from a cache: an enabled
        backbone with ``llm.prefix_cache``."""
        return self.llm_enabled and self.prefix_cache

    @property
    def train_prefix_cache_safe(self) -> bool:
        """The train step may serve the prompt head from the cache when the
        cached values are constants of the optimization: a frozen backbone
        (always, here: LoRA is not ported) without dropout. Gradients of
        every trainable parameter are then those of the embedded head."""
        return self.supports_prefix_cache and getattr(self.llm_cfg, "dropout", 0.0) == 0.0

    def encode_ts(self, x_enc, source, generator=None, mask=None):
        """RevIN -> patch embed -> reprogramming (K3) against ``source`` (the
        mapping layer over the word embeddings, [num_tokens, d_llm]) -> the
        covariate mode's merge. Returns (enc, the RevIN stats): enc [B, P,
        d_llm], [B, P * C, d_llm] under ``interleave``, [B * C, P, d_llm]
        under the per-channel modes. With ``mask`` (imputation) the
        statistics cover the observed points only."""
        B, L, C = x_enc.shape
        if mask is None:
            xn, stats = revin_norm(x_enc)
        else:
            xn, means, stdev = masked_window_norm(x_enc, mask)
            stats = {"center": means, "stdev": stdev}
        enc = self.patch_embedding(xn.transpose(1, 2), generator)  # [B*C, P, d_model]
        P, mode = enc.shape[1], self.covariate_mode
        if mode == "concat":  # univariate: C == 1, [B, P, d_model]
            enc = enc.reshape(B, C, P, self.d_model).transpose(1, 2).reshape(
                B, P, C * self.d_model)
        enc = self.reprogramming_layer(enc, source, source, generator)
        if mode == "add":
            enc = enc.reshape(B, C, P, self.d_llm).mean(1)
        elif mode == "weighted-average":
            enc = self.feature_weighting(
                enc.reshape(B, C, P, self.d_llm).permute(0, 2, 3, 1)).squeeze(-1)
        elif mode == "interleave":
            enc = enc.reshape(B, C, P, self.d_llm).transpose(1, 2).reshape(B, P * C, self.d_llm)
        return enc, stats

    def _downsample(self, dec_out: torch.Tensor) -> torch.Tensor:
        """d_llm -> d_ff (medtsllm.py:352-367)."""
        mode = self.embedding_downsample_mode
        if mode == "truncate":
            return dec_out[:, :, :self.d_ff]
        if mode == "average":
            return dec_out.reshape(dec_out.shape[0], self.n_patches, self.d_ff, -1).mean(-1)
        return self.embedding_downsample_layer(dec_out)

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training. The prompt is
        [head | prompt_ids | example | post_prompt_ids], then the series."""
        x_enc = inputs["x_enc"]
        B, _, C = x_enc.shape
        example_ts = inputs.get("example_ts")
        if example_ts is not None and self.covariate_mode in PER_CHANNEL_MODES:
            raise ValueError("in-context examples require a batch-preserving covariate "
                             f"mode, not {self.covariate_mode!r}")
        mask = inputs.get("mask") if self.task == "imputation" else None
        source = self.mapping_layer(self.llm.wte.T).T  # once for both encodings
        ts_emb, stats = self.encode_ts(x_enc, source, generator, mask)

        parts = []
        prefix_kv = inputs.get("prefix_kv")
        prefix_ids = inputs.get("prefix_ids")
        if prefix_ids is not None:
            # uncached: the prompt head embedded at positions 0..P-1, 1-D
            # (constant) or [B, P] (per clip, left-padded to its bucket)
            assert prefix_kv is None
            pe = self.llm.embed(prefix_ids).to(ts_emb.dtype)
            parts.append(pe[None].expand(B, -1, -1) if prefix_ids.dim() == 1 else pe)
        prompt_ids = inputs.get("prompt_ids")
        if prompt_ids is not None:
            parts.append(self.llm.embed(prompt_ids).to(ts_emb.dtype))
        if example_ts is not None:
            parts.append(self.encode_ts(example_ts.to(x_enc.dtype), source, generator)[0])
        post_ids = inputs.get("post_prompt_ids")
        if post_ids is not None:
            parts.append(self.llm.embed(post_ids).to(ts_emb.dtype))
        if parts and self.covariate_mode in PER_CHANNEL_MODES:
            # a row per channel: the prompt repeated C times; a per-row
            # prefix too, while a one-row (constant) prefix broadcasts
            parts = [torch.cat(parts, dim=1).repeat_interleave(C, dim=0)]
            if prefix_kv is not None:
                prefix_kv = tuple(tuple(t.repeat_interleave(C, dim=0) if t.shape[0] > 1
                                        else t for t in layer) for layer in prefix_kv)
        enc = torch.cat(parts + [ts_emb], dim=1)
        if self.llm_enabled:
            dec_out = self.llm(enc, prefix_kv=prefix_kv)
            dec_out = self._downsample(dec_out[:, -self.n_patches:, :])
        else:  # the ablation's MLP in place of the backbone and the downsample
            dec_out = self.llm_replacement(enc)[:, -self.n_patches:, :]

        # FlattenHead (medtsllm.py:541-552) on [B', d_ff, P]
        dec_out = dec_out.transpose(1, 2).reshape(dec_out.shape[0], -1)
        dec_out = self.output_projection(dec_out)
        steps, n_out = self.head_steps, self.n_outputs_per_step
        if self.covariate_mode == "independent":
            dec_out = dec_out.reshape(B, C, steps, n_out).mean(1)
        elif self.covariate_mode == "merge-end":
            # [B, steps, n_out * C], C fastest, as JAX flattens it
            dec_out = self.feature_weighting(
                dec_out.reshape(B, C, steps, n_out).permute(0, 2, 3, 1).reshape(B, steps, -1))
        else:
            dec_out = dec_out.reshape(B, steps, n_out)
        # the task's head (medtsllm.py:667-681)
        if self.task == "classification":
            return dec_out[:, 0]  # [B, n_classes] logits
        if self.task in DENORM_TASKS:
            return revin_denorm(dec_out, stats)
        if dec_out.shape[-1] == 1:
            dec_out = dec_out.squeeze(-1)
        if not self.training:  # the scores, in eval only
            if self.task == "semantic_segmentation":
                dec_out = (torch.softmax(dec_out, dim=-1) if self.n_classes > 2
                           else torch.sigmoid(dec_out))
            elif self.seg_mode == "boundary-prediction":
                dec_out = torch.sigmoid(dec_out)
        return dec_out

    def prefill(self, prefix_ids: torch.Tensor, embed_dtype=torch.float32):
        """Per-layer (k, v) of a prompt head: the constant 1-D head (once per
        eval pass) or [N, P] per-clip head rows (once per clip, banked by
        the task); ``embed_dtype`` is what ``forward`` feeds the LLM
        (ts_emb's dtype, f32) so cached and uncached paths agree."""
        emb = self.llm.embed(prefix_ids).to(embed_dtype)
        return self.llm.prefill(emb[None] if prefix_ids.dim() == 1 else emb)

    # -- checkpoints (medtsllm_tpu/models/medtsllm.py:757-774) -------------

    @staticmethod
    def checkpoint_tree(state: dict) -> dict:
        """The entries of a state dict a checkpoint keeps: every one but the
        frozen backbone (``llm.*``, its word embeddings included), which a
        restore rebuilds. JAX keeps the LoRA adapters under ``llm``; the
        port has no LoRA, so nothing under ``llm`` is kept."""
        return {k: v for k, v in state.items() if k.split(".")[0] != "llm"}

    @staticmethod
    def drop_pretrained_heads(saved: dict) -> dict:
        """Pretraining -> finetuning transfer leaves the output head behind
        (and the word embeddings, which no checkpoint of the port holds)."""
        return {k: v for k, v in saved.items()
                if k.split(".")[0] not in ("output_projection", "word_embeddings")}


def _resolve_moe(llm_cfg, llm, quantize: int, device: torch.device):
    """``llm.expert_capacity`` and ``llm.moe_grouped`` on the backbone's
    config (``medtsllm_tpu/models/medtsllm.py:194-202, 278-332``, with "on
    the TPU" read as "on a CUDA device"). ``moe_grouped = "auto"`` is on
    for a CUDA device with integer experts (``load_in_8bit``, or
    ``load_in_4bit`` with the absmax codebook, with ``int8_matmul``) and off
    on the CPU, as JAX resolves it off the TPU; forced on, it needs integer
    experts and runs the plain grouped chain on the CPU."""
    moe = getattr(llm_cfg, "n_experts", 0) > 1
    cap = llm.get("expert_capacity", None)
    if cap is not None:
        if not moe:
            raise ValueError(f"models.llm.expert_capacity set but backbone "
                             f"{llm.llm!r} is not a MoE (n_experts <= 1)")
        llm_cfg = dataclasses.replace(llm_cfg, expert_capacity=float(cap))
    mg = llm.get("moe_grouped", "auto")
    if not moe:
        if mg not in ("auto", False):
            raise ValueError(f"models.llm.moe_grouped set but backbone {llm.llm!r} "
                             "is not an enabled MoE (n_experts <= 1 or llm disabled)")
        return llm_cfg
    int_mxu = bool(llm.get("int8_matmul", True)) and (
        quantize == 8 or (quantize == 4 and llm_cfg.quant4_codebook == "absmax"))
    if mg == "auto":
        mg = int_mxu and device.type == "cuda"
    if mg and not int_mxu:
        raise ValueError("models.llm.moe_grouped requires integer experts "
                         "(load_in_8bit, or load_in_4bit with the absmax codebook, "
                         "with int8_matmul): the grouped kernel's contraction is "
                         "s8 x s8 only")
    return dataclasses.replace(llm_cfg, moe_grouped=bool(mg))


# ---------------------------------------------------------------------------
# host-side prompt construction (numpy; no device work)
# ---------------------------------------------------------------------------

def calculate_lags(x: np.ndarray, n_lags: int = 5) -> np.ndarray:
    """Top-k FFT autocorrelation lags (medtsllm.py:530-538)."""
    x = np.transpose(x, (0, 2, 1)) if x.ndim == 3 else x[:, None, :]
    q = np.fft.rfft(x, axis=-1)
    corr = np.fft.irfft(q * np.conj(q), n=x.shape[-1], axis=-1)
    mean_value = corr.mean(axis=1)
    return np.argsort(-mean_value, axis=-1, kind="stable")[:, :n_lags]


def _fmt_float(v):
    if isinstance(v, (list, np.ndarray)):
        return "[" + ", ".join(_fmt_float(x) for x in v) + "]"
    return f"{float(v):.3f}"


def _fmt_trend(v):
    if isinstance(v, (list, np.ndarray)):
        return "[" + ", ".join(_fmt_trend(x) for x in v) + "]"
    return "upward" if v else "downward"


class PromptBuilder:
    """Batch preprocessor: prompt text -> token ids, grow-only bucket left
    padding, input statistics (medtsllm.py:845-1200 of the JAX package).
    With the prefix cache, the constant head [bos + dataset (+ task under
    ``cache_order``)] is emitted unpadded as 1-D ``prefix_ids``; under
    ``clip_head`` (default on) a batch with clip descriptions on a llama
    backbone gets per-window head rows [bos + dataset (+ task) + clip],
    left-padded into a grow-only 16-granular bucket: [B, P] ``prefix_ids``
    for the task's per-clip KV bank (``clip_cache_slots`` rows, default
    8). With in-context examples (a batch with ``examples``) the head stops
    at [bos + dataset]; the rest of the first part, ending in the example's
    text, is ``prompt_ids``, the example series ``example_ts`` [B,
    ``example_len``, C] (f32), and the second part ``post_prompt_ids`` in a
    grow-only 16-granular bucket of its own. No prompt at all with the
    backbone disabled."""

    N_LAGS = 5
    PARTS = ("dataset", "clip", "input_stats", "task", "examples")

    def __init__(self, config, dataset, model: MedTsLLM):
        self.model = model
        mc = MedTsLLM.model_config(config)
        prompting = mc.get("prompting") or {}
        self.cfg = {
            "dataset": prompting.get("dataset", True),
            "clip": prompting.get("clip", True),
            "input_stats": prompting.get("input_stats", True),
            "task": prompting.get("task", True),
            "examples": prompting.get("examples", False),
            "input_stats_dim": prompting.get("input_stats_dim", 0),
            "input_stats_select": prompting.get("input_stats_select", "all"),
            "cache_order": prompting.get("cache_order", False),
            "clip_head": prompting.get("clip_head", True),
            "clip_cache_slots": int(prompting.get("clip_cache_slots", 8)),
        }
        wanted = any(self.cfg[k] for k in self.PARTS)
        self.enabled = model.llm_enabled and wanted
        if not model.llm_enabled and wanted:
            warnings.warn("llm.enabled=false: prompts are disabled")
        self.tokenizer = get_tokenizer(mc.llm.llm, model.cache_dir,
                                       vocab_size=model.llm_cfg.vocab_size)
        self.pad_id = self.tokenizer.pad_token_id
        if self.pad_id is None:
            self.pad_id = self.tokenizer.eos_token_id or 0
        self.bos = getattr(self.tokenizer, "bos_token", None)
        self.dataset_description = dataset.description
        self.task_description = getattr(dataset, "task_description", None) or (
            TASK_DESCRIPTIONS[config.task].format(seq=config.history_len,
                                                  pred=config.pred_len))
        self.split_prefix = model.supports_prefix_cache
        self.max_bucket = 16
        self.max_bucket_suffix = 16
        self.max_bucket_head = 16
        self.max_bucket_post = 16
        self._cache: dict[str, list[int]] = {}
        pool = getattr(dataset, "examples", None) if self.cfg["examples"] else None
        if pool:
            # one example length, from the dataset's pool median: the same
            # whatever the shuffle or the batch size (medtsllm.py:916-924)
            med = int(np.median([np.asarray(e).shape[0] for e in pool]))
            self.example_len = min(model.seq_len, max(model.patch_len, med))
            if self.enabled and model.covariate_mode in PER_CHANNEL_MODES:
                # JAX's init asserts it on its first batch (medtsllm.py:607)
                raise ValueError("in-context examples require a batch-preserving covariate "
                                 f"mode, not {model.covariate_mode!r}")

    def _encode(self, text: str) -> list[int]:
        if text not in self._cache:
            if len(self._cache) >= 4096:
                self._cache.clear()
            self._cache[text] = list(self.tokenizer(text).input_ids)
        return self._cache[text]

    def _stats_prompts(self, x: np.ndarray) -> list[str]:
        """Input-statistics prompt (medtsllm.py:441-495)."""
        if x.ndim == 2:
            x = x[..., None]
        if self.cfg["input_stats_select"] != "all":
            raise ValueError("prompting.input_stats_select only supports 'all'")
        dim = self.cfg["input_stats_dim"]
        if dim == "all":
            insert, s = "per feature", "s"
        else:
            insert, s = f"feature {dim}", ""
            x = x[:, :, int(dim)]
        mins = x.min(axis=1)
        maxs = x.max(axis=1)
        # torch.median's LOWER middle element for even n (the reference)
        medians = np.sort(x.astype(np.float32), axis=1)[:, (x.shape[1] - 1) // 2]
        trends = np.diff(x, axis=1).sum(axis=1) > 0
        lags = calculate_lags(x.astype(np.float64), self.N_LAGS)
        return [f"Input statistics ({insert}): "
                f"min value{s} = {_fmt_float(mins[b])}, "
                f"max value{s} = {_fmt_float(maxs[b])}, "
                f"median value{s} = {_fmt_float(medians[b])}, "
                f"the trend of input is {_fmt_trend(trends[b])}, "
                f"the top {self.N_LAGS} lags are {[int(v) for v in lags[b]]}."
                for b in range(x.shape[0])]

    def has_examples(self, batch: dict) -> bool:
        return bool(self.cfg["examples"] and "examples" in batch)

    def build_prompts(self, batch: dict):
        """(pre_parts, post_parts): ordered prompt strings per sample, before
        and after the in-context example's series."""
        bs = len(batch["x_enc"])
        dataset_prompt = (f"Dataset: {self.dataset_description}"
                          if self.cfg["dataset"] else "")
        clip_prompts = (list(batch.get("descriptions", [""] * bs))
                        if self.cfg["clip"] else [""] * bs)
        stats_prompts = (self._stats_prompts(np.asarray(batch["x_enc"]))
                         if self.cfg["input_stats"] else [""] * bs)
        task_prompt = f"Task: {self.task_description}" if self.cfg["task"] else ""
        if "dataset_description" in batch:  # the pretraining mixture: one a row
            dataset_prompts = [f"Dataset: {d}" if self.cfg["dataset"] else ""
                               for d in batch["dataset_description"]]
        else:
            dataset_prompts = [dataset_prompt] * bs
        bos = self.bos if self.bos is not None else ""
        examples = self.has_examples(batch)
        example_texts = [e[0] for e in batch["examples"]] if examples else [""] * bs
        # the example's text breaks the head: the task stays in the second part
        task_in_head = bool(self.cfg["cache_order"] and task_prompt and not examples)
        clip_in_head = self.clip_in_head(batch)
        pre_prompts, post_prompts = [], []
        for b in range(bs):
            # the clip joins the per-clip head; the token order is the same
            # either way (the clip precedes the stats)
            pre = ([bos, dataset_prompts[b]] + ([task_prompt] if task_in_head else [])
                   + ([clip_prompts[b]] if clip_in_head else []) + [example_texts[b]])
            post = ["" if clip_in_head else clip_prompts[b], stats_prompts[b],
                    "" if task_in_head else task_prompt, "Time series:"]
            pre = [p for p in pre if p != ""]
            post = [p for p in post if p != ""]
            pre_prompts.append([(p + " " if i != 0 else p) for i, p in enumerate(pre)])
            post_prompts.append([p + " " for p in post])
        return pre_prompts, post_prompts

    def _pad_ids(self, ids: list[list[int]], bucket: int) -> np.ndarray:
        out = np.full((len(ids), bucket), self.pad_id, dtype=np.int64)
        for b, seq in enumerate(ids):
            out[b, bucket - len(seq):] = seq  # LEFT pad (medtsllm.py:304-311)
        return out

    def _bucket_for(self, maxlen: int) -> int:
        while self.max_bucket < maxlen:
            self.max_bucket *= 2
        return self.max_bucket

    def _bucket_suffix(self, maxlen: int) -> int:
        self.max_bucket_suffix = max(self.max_bucket_suffix,
                                     ((maxlen + 15) // 16) * 16)
        return self.max_bucket_suffix

    def _bucket_head(self, maxlen: int) -> int:
        self.max_bucket_head = max(self.max_bucket_head, ((maxlen + 15) // 16) * 16)
        return self.max_bucket_head

    def _bucket_post(self, maxlen: int) -> int:
        self.max_bucket_post = max(self.max_bucket_post, ((maxlen + 15) // 16) * 16)
        return self.max_bucket_post

    def clip_in_head(self, batch: dict) -> bool:
        """Whether the clip description joins the cacheable head (the
        per-clip KV bank): the prefix cache, clip prompting under
        ``clip_head`` with descriptions in the batch, no in-context
        examples, no per-row dataset prompts (the pretraining mixture), and
        a llama backbone (the Mamba state cache keeps one entry)."""
        return bool(self.split_prefix and self.cfg["clip"] and self.cfg["clip_head"]
                    and "descriptions" in batch and "dataset_description" not in batch
                    and not self.has_examples(batch)
                    and self.model.llm_cfg.style != "mamba")

    def _head_part_count(self, batch: dict) -> int:
        """Leading parts of ``pre`` that form the cacheable head: none for
        the pretraining mixture, whose dataset prompt differs row by row
        (the whole prompt then goes through the step, no ``prefix_ids``);
        never the example's text."""
        if not self.split_prefix or "dataset_description" in batch:
            return 0
        return (int(bool(self.bos)) + int(bool(self.cfg["dataset"]))
                + int(bool(self.cfg["task"] and self.cfg["cache_order"]
                           and not self.has_examples(batch)))
                + int(self.clip_in_head(batch)))

    def __call__(self, batch: dict) -> dict:
        arrays = {k: v for k, v in batch.items() if k in ARRAY_BATCH_KEYS}
        if not self.enabled:
            return arrays
        pre_prompts, post_prompts = self.build_prompts(batch)
        if not (pre_prompts[0] or post_prompts[0]):
            return arrays
        n_head = self._head_part_count(batch)
        has_head = False
        if n_head and self.clip_in_head(batch):
            rows = [sum((self._encode(p) for p in pre[:n_head]), []) for pre in pre_prompts]
            arrays["prefix_ids"] = self._pad_ids(rows, self._bucket_head(max(map(len, rows))))
            has_head = True
        elif n_head:
            head_ids = sum((self._encode(p) for p in pre_prompts[0][:n_head]), [])
            if head_ids:
                arrays["prefix_ids"] = np.asarray(head_ids, dtype=np.int64)
                has_head = True
        pre_ids = [sum((self._encode(p) for p in pre[n_head:]), []) for pre in pre_prompts]
        post_ids = [sum((self._encode(p) for p in post), []) for post in post_prompts]
        bucket = self._bucket_suffix if has_head else self._bucket_for
        if self.has_examples(batch):
            if any(map(len, pre_ids)) or not has_head:
                arrays["prompt_ids"] = self._pad_ids(pre_ids, bucket(max(map(len, pre_ids))))
            arrays["example_ts"] = self._example_tensor(batch)
            arrays["post_prompt_ids"] = self._pad_ids(
                post_ids, self._bucket_post(max(map(len, post_ids))))
            return arrays
        ids = [pre + post for pre, post in zip(pre_ids, post_ids)]
        if any(map(len, ids)) or not has_head:
            arrays["prompt_ids"] = self._pad_ids(ids, bucket(max(map(len, ids))))
        return arrays

    def _example_tensor(self, batch: dict) -> np.ndarray:
        """The batch's example series cropped or tiled to ``example_len``
        (without a pool at ``__init__``, a length from the model's sizes
        alone: never from a batch)."""
        tensors = [np.asarray(e[1])[0] for e in batch["examples"]]
        if not hasattr(self, "example_len"):
            self.example_len = min(self.model.seq_len,
                                   max(self.model.patch_len, self.model.seq_len // 4))
        fixed = self.example_len
        out = np.zeros((len(tensors), fixed, tensors[0].shape[-1]), np.float32)
        for i, t in enumerate(tensors):
            if t.shape[0] >= fixed:
                out[i] = t[:fixed]
            else:
                out[i] = np.tile(t, (-(-fixed // t.shape[0]), 1))[:fixed]
        return out
