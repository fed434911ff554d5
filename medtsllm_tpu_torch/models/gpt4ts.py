"""GPT4TS (port of ``medtsllm_tpu/models/gpt4ts.py``, "One Fits All"): a
GPT-2 backbone, frozen but for its LayerNorms and learned positions (and
its MLPs under ``train_mlp``), between per-task embeddings and linear
heads.

Each task's path is JAX's: the non-stationary window norm (mean and
standard deviation both detached; under imputation with a mask,
``masked_window_norm``), ``DataEmbedding`` (value conv and sincos
positions; classification's over the unfolded patches), the features
zero-padded to the backbone's width, the backbone, the ``[:, :, :d_ff]``
slice, ``out_layer``, then the denorm or the eval-only sigmoid / softmax.
Two traps sit in the same model: the backbone's LayerNorms use its
``norm_eps`` (1e-5) while GPT4TS's own ``ln_proj`` is a default flax
LayerNorm (1e-6), and the backbone's GELU is tanh while the classification
head's is exact.

The backbone's weights: a local gpt2 snapshot (``paths.llm_path``) with
``*.safetensors`` replaces the seeded random init of its first
``gpt_layers`` blocks (``models/llm/loader.py``); without one the init
stays and the model warns as JAX's does. The state dict has the flax
tree's keys (the backbone under ``gpt2``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embed import DataEmbedding, patch_unfold
from ..ops.revin import masked_window_norm
from .llm.config import DecoderConfig, resolve_config
from .llm.loader import load_backbone_weights_
from .llm.transformer import LayerNorm, Linear, TransformerDecoder, dropout


class GPT4TS(nn.Module):
    supported_tasks = ("forecasting", "imputation", "reconstruction",
                       "anomaly_detection", "classification",
                       "semantic_segmentation", "segmentation")

    def __init__(self, *, task, seq_len, pred_len, enc_in, c_out, num_class, d_model, d_ff,
                 llm_id, gpt_layers, train_mlp, patch_size, stride, dropout=0.0,
                 cache_dir=None, seg_mode=None):
        super().__init__()
        self.task, self.seq_len, self.pred_len = task, seq_len, pred_len
        self.num_class, self.d_ff, self.seg_mode = num_class, d_ff, seg_mode
        self.patch_size, self.stride = patch_size, stride
        self.llm_id, self.cache_dir = llm_id, cache_dir
        cfg = resolve_config(llm_id, gpt_layers, cache_dir)
        if not isinstance(cfg, DecoderConfig) or cfg.is_encoder_decoder:
            raise ValueError(f"GPT4TS needs a decoder backbone, not {llm_id!r}")
        self.gpt2 = TransformerDecoder(cfg)
        # ``param_labels``' rule: inside the backbone only its LayerNorms
        # (``ln_*``) and ``wpe`` train, and its MLPs under ``train_mlp``
        for name, p in self.gpt2.named_parameters():
            p.requires_grad_("ln_" in name or name == "wpe"
                             or (train_mlp and ".mlp." in f".{name}"))
        d_llm = self.d_llm = cfg.d_model
        if task == "classification":
            n_patches = (seq_len - patch_size) // stride + 2  # patch_unfold's count
            self.enc_embedding = DataEmbedding(enc_in * patch_size, d_model, "timeF", "h",
                                               p=dropout)
            self.ln_proj = LayerNorm(d_llm * n_patches)
            self.out_layer = Linear(d_llm * n_patches, num_class)
            return
        if task not in ("anomaly_detection", "reconstruction"):
            self.enc_embedding = DataEmbedding(enc_in, d_model, "timeF", "h", p=dropout)
        if task == "forecasting":
            self.predict_linear_pre = Linear(seq_len, seq_len + pred_len)
        if task == "imputation":
            self.ln_proj = LayerNorm(d_llm)
            self.out_layer = Linear(d_llm, c_out)
        elif task in ("semantic_segmentation", "segmentation"):
            n_out = num_class if task == "semantic_segmentation" and num_class > 2 else 1
            self.out_layer = Linear(d_ff, n_out)
        else:
            self.out_layer = Linear(d_ff, c_out)

    @classmethod
    def from_config(cls, config, dataset):
        mc = config.models.gpt4ts
        task = config.task
        if task == "forecasting":
            pred_len = config.pred_len
        elif config.pred_len != config.history_len:
            raise ValueError(f"{task} requires pred_len == history_len")
        else:
            pred_len = 0
        cache_dir = config.get("paths", {}).get("llm_path") or None
        if cache_dir in ("", "none"):
            cache_dir = None
        return cls(
            task=task, seq_len=config.history_len, pred_len=pred_len,
            enc_in=dataset.n_features, c_out=dataset.n_features,
            num_class=(dataset.n_classes
                       if task in ("classification", "semantic_segmentation") else 0),
            d_model=mc.d_model, d_ff=mc.d_ff, llm_id=mc.get("llm", "gpt2"),
            gpt_layers=mc.gpt_layers, train_mlp=mc.train_mlp,
            patch_size=mc.patching.patch_len, stride=mc.patching.stride,
            dropout=config.training.dropout, cache_dir=cache_dir,
            seg_mode=config.tasks.segmentation.mode if task == "segmentation" else None)

    def load_backbone_weights(self) -> None:
        """The trainer's hook: a local snapshot's weights into the backbone
        (``loader.load_backbone_weights_``)."""
        load_backbone_weights_(self.gpt2, self.gpt2.cfg, self.llm_id, self.cache_dir)

    @staticmethod
    def _normalize(x_enc):
        means = x_enc.mean(dim=1, keepdim=True).detach()
        x = x_enc - means
        stdev = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + 1e-5).detach()
        return x / stdev, means, stdev

    def _backbone(self, x, generator):
        """The features zero-padded to the backbone's width, then the
        backbone."""
        return self.gpt2(F.pad(x, (0, self.d_llm - x.shape[-1])), generator=generator)

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        x_enc = inputs["x_enc"]
        task = self.task
        if task == "forecasting":
            x, means, stdev = self._normalize(x_enc)
            enc = self.enc_embedding(x, generator=generator)
            enc = self.predict_linear_pre(enc.transpose(1, 2)).transpose(1, 2)
            out = self.out_layer(self._backbone(enc, generator)[:, :, :self.d_ff])
            out = out * stdev[:, 0:1, :] + means[:, 0:1, :]
            return out[:, -self.pred_len:, :]
        if task in ("anomaly_detection", "reconstruction"):
            x, means, stdev = self._normalize(x_enc)
            out = self.out_layer(self._backbone(x, generator)[:, :, :self.d_ff])
            return out * stdev + means
        if task == "imputation":
            mask = inputs.get("mask")
            x, means, stdev = (masked_window_norm(x_enc, mask) if mask is not None
                               else self._normalize(x_enc))
            enc = self.enc_embedding(x, generator=generator)
            out = self.out_layer(self.ln_proj(self._backbone(enc, generator)))
            return out * stdev + means
        if task == "classification":
            B = x_enc.shape[0]
            patches = patch_unfold(x_enc.transpose(1, 2), self.patch_size, self.stride)
            tokens = patches.permute(0, 2, 3, 1).reshape(B, patches.shape[2], -1)
            enc = self.enc_embedding(tokens, generator=generator)
            out = F.gelu(self._backbone(enc, generator)).reshape(B, -1)  # exact GELU
            out = self.ln_proj(out)
            if self.training:
                out = dropout(out, 0.1, generator)
            return self.out_layer(out)
        x, _, _ = self._normalize(x_enc)  # the segmentation tasks
        enc = self.enc_embedding(x, generator=generator)
        out = self.out_layer(self._backbone(enc, generator)[:, :, :self.d_ff])
        out = out.squeeze(-1) if out.shape[-1] == 1 else out
        if not self.training:
            if task == "semantic_segmentation":
                out = torch.softmax(out, dim=-1) if self.num_class > 2 else torch.sigmoid(out)
            elif self.seg_mode == "boundary-prediction":
                out = torch.sigmoid(out)
        return out
