"""The task runtime (port of ``medtsllm_tpu/tasks/base.py``): datasets and
pipelines, parameter init, the optimizer and the loss, ``train_step`` and
the epoch loop ``train``, ``train_model_inputs`` / ``eval_model_inputs``,
``eval_prepare`` / ``eval_dispatch`` for the plain kind, the prefill of the
1-D prompt-head cache, ``run_eval``, ``eval_n_points`` and
``finalize_series``.

Everything lives on one explicit device. The constant prompt head is
prefilled once and every window attends it as prefix K/V (or resumes the
Mamba scan from its state); the train step serves it from the same cache
when the model says that is safe (frozen backbone, no backbone dropout).
Dropout masks come from a generator on the trainer's device seeded from
``setup.seed``. No logger or checkpoint files yet: the losses and each
epoch's val scores are kept in ``self.losses`` and ``self.val_scores`` and
printed (``runtime/checkpoint.py`` is ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import random
import warnings

import numpy as np
import torch

from ..data import BatchPipeline, SyntheticDataset
from ..device import resolve_device
from ..models.medtsllm import MedTsLLM, PromptBuilder, storage_dtype
from ..runtime.optim import Optimizer
from ..weights import init_random_
from .losses import build_loss


class BaseTask:
    task: str = ""

    def __init__(self, run_id, config, device="cuda"):
        if config.model not in ("medtsllm", "timellm"):
            raise NotImplementedError(f"model {config.model!r}: the port has "
                                      "MedTsLLM (ROADMAP queue 1 item 9)")
        self.run_id = run_id
        self.config = config
        self.device = resolve_device(device)
        seed = int(config.setup.seed)
        random.seed(seed)
        np.random.seed(seed)

        bs = config.training.batch_size
        self.train_dataset = SyntheticDataset(config, "train")
        self.val_dataset = SyntheticDataset(config, "val")
        self.test_dataset = SyntheticDataset(config, "test")
        self.train_pipeline = BatchPipeline(self.train_dataset, bs, shuffle=True, seed=seed)
        self.val_pipeline = BatchPipeline(self.val_dataset, bs)
        self.test_pipeline = BatchPipeline(self.test_dataset, bs)

        with torch.device(self.device):
            self.model = MedTsLLM.from_config(config, self.train_dataset)
        self.preprocessor = PromptBuilder(config, self.train_dataset, self.model)
        generator = torch.Generator(self.device).manual_seed(seed)
        init_random_(self.model, generator)
        warnings.warn(f"LLM {self.model.llm_id!r}: no weights are loaded — "
                      "random init (shapes and throughput faithful; task "
                      "quality not meaningful)")
        self.model.to(storage_dtype(config)).eval()
        self._prefix_kv_cache = {}

        self.dropout_generator = torch.Generator(self.device).manual_seed(seed)
        self.optimizer = Optimizer(config, self.model.parameters())
        self.loss_fn = build_loss(config.training.loss, self.task)
        self.epoch = 1
        self.step = 0
        self.losses: list[float] = []
        self.val_scores: list[dict] = []
        direction = config.training.get("eval_metric_direction", "min")
        self.best_score = float("inf") if direction == "min" else float("-inf")

    # ------------------------------------------------------------------
    # eval step
    # ------------------------------------------------------------------

    def load_state_dict(self, state: dict) -> None:
        """Replace every parameter (e.g. ``weights.from_flax``); the
        storage dtype of the run is kept."""
        dt = storage_dtype(self.config)
        own = self.model.state_dict()
        if set(state) != set(own):
            raise KeyError(f"state dict mismatch: missing {sorted(set(own) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(own))}")
        self.model.load_state_dict({
            k: v.to(self.device, dt if v.is_floating_point() else v.dtype)
            for k, v in state.items()})
        self._prefix_kv_cache.clear()

    def model_inputs(self, batch: dict) -> dict:
        """Host batch -> model inputs (prompt token ids via the builder)."""
        return self.preprocessor(batch)

    def _to_device(self, arrays: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in arrays.items()}

    def eval_model_inputs(self, batch: dict) -> dict:
        """Model inputs with the constant prompt head (``prefix_ids``)
        swapped for its cached per-layer KV."""
        arrays = self._to_device(self.model_inputs(batch))
        ids = arrays.pop("prefix_ids", None)
        if ids is not None:
            arrays["prefix_kv"] = self._prefix_kv(ids)
        return arrays

    def train_model_inputs(self, batch: dict) -> dict:
        """Train-side inputs: the 1-D prompt head served from the cache when
        ``model.train_prefix_cache_safe`` (the cache is then a constant of
        the optimization: same loss, same gradients), else embedded in the
        graph."""
        arrays = self._to_device(self.model_inputs(batch))
        ids = arrays.get("prefix_ids")
        if ids is not None and ids.dim() == 1 and self.model.train_prefix_cache_safe:
            arrays["prefix_kv"] = self._prefix_kv(arrays.pop("prefix_ids"))
        return arrays

    def train_step(self, arrays: dict, valid: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch of model inputs -> the loss
        (detached, on the device). The model runs in train mode (dropout,
        the einsum reprogramming graph), its predictions are taken in f32,
        and only the fusion layers update."""
        self.model.train()
        try:
            pred = self.model(arrays, generator=self.dropout_generator).float()
            loss = self.loss_fn(pred, arrays, valid)
            self.optimizer.zero_grad()
            loss.backward()
            self.optimizer.step()
        finally:
            self.model.eval()
        return loss.detach()

    def eval_prepare(self, batch: dict):
        """Host side of ``eval_dispatch`` (split out so a caller can time
        host preparation apart from the device work)."""
        return ("plain", self.eval_model_inputs(batch))

    @torch.inference_mode()
    def eval_step(self, arrays: dict) -> torch.Tensor:
        return self.model(arrays)

    def eval_dispatch(self, batch: dict | None = None, prepared=None):
        if prepared is None:
            prepared = self.eval_prepare(batch)
        kind, arrays = prepared
        assert kind == "plain", kind
        return self.eval_step(arrays)

    @torch.no_grad()
    def _prefix_kv(self, ids: torch.Tensor):
        """Per-layer K/V of the 1-D prompt head, prefilled once per eval
        pass and kept through the epoch's train steps (the backbone is
        frozen). The head embeds at ts_emb's dtype, f32 (the fusion layers
        promote to f32), so cached and uncached forwards agree. Built under
        ``no_grad``, not ``inference_mode``: the train step's backward saves
        the cached K/V (K2) and SSM state (K9)."""
        if ids.dim() != 1:
            raise NotImplementedError("per-clip 2-D prompt heads are ROADMAP "
                                      "queue 1 item 7")
        key = ids.cpu().numpy().tobytes()
        kv = self._prefix_kv_cache.get(key)
        if kv is None:
            kv = self.model.prefill(ids, torch.float32)
            self._prefix_kv_cache[key] = kv
        return kv

    # ------------------------------------------------------------------
    # train loop (medtsllm_tpu/tasks/base.py:577-617)
    # ------------------------------------------------------------------

    def train(self):
        """For each epoch: set the epoch's learning rate, run the shuffled
        train batches through ``train_step``, log the losses, then ``val()``.
        A step's loss is read back while the next step runs, as JAX does."""
        epochs = int(self.config.training.epochs)
        for epoch in range(self.epoch - 1, epochs):
            print(f"Epoch {epoch + 1}/{epochs}")
            self.optimizer.set_epoch(epoch)
            pending = None
            for batch in self.train_pipeline:
                arrays = self.train_model_inputs(batch)
                loss = self.train_step(arrays, arrays["valid"])
                if pending is not None:
                    self.log_step(*pending)
                pending = (loss, int(batch["valid"].sum()))
            if pending is not None:
                self.log_step(*pending)
            self.log_epoch(self.val())

    def log_step(self, loss, n_valid: int) -> None:
        self.step += n_valid  # real samples: the padded final batch counts fewer
        self.losses.append(float(loss))
        print(f"step {self.step}: train/loss {self.losses[-1]:.6f}")

    def log_epoch(self, scores: dict) -> None:
        self.val_scores.append(dict(scores))
        scores = dict(scores, **{"train/lr": self.optimizer.get_last_lr()[0]})
        print(f"epoch {self.epoch}: {scores}")
        self.epoch += 1
        metric = scores["val/" + self.config.training.get("eval_metric", "mse")]
        if self.config.training.get("eval_metric_direction", "min") == "min":
            self.best_score = min(self.best_score, metric)
        else:
            self.best_score = max(self.best_score, metric)

    # ------------------------------------------------------------------
    # eval loop
    # ------------------------------------------------------------------

    def run_eval(self, pipeline, extra_keys=()):
        """Run the eval step over a pipeline; returns the stacked valid
        per-window predictions and the requested batch keys."""
        self._prefix_kv_cache.clear()  # parameters may have changed
        preds, extras = [], {k: [] for k in extra_keys}
        for batch in pipeline:
            out = self.eval_dispatch(batch)
            v = batch["valid"]
            preds.append(out.float().cpu().numpy()[v])
            for k in extra_keys:
                extras[k].append(np.asarray(batch[k])[v])
        result = {"pred": np.concatenate(preds)}
        for k in extra_keys:
            result[k] = np.concatenate(extras[k])
        return result

    def eval_n_points(self, dataset) -> int:
        """Full-series buffer length (tasks/forecasting.py:59)."""
        return self.config.pred_len + (len(dataset) - 1) * dataset.step_size

    def finalize_series(self, *series):
        """Assert the stitched series are complete."""
        for arr in series:
            if np.isnan(arr).any():
                raise ValueError("unfilled points after stitching")
        return series if len(series) > 1 else series[0]

    def val(self):
        raise NotImplementedError

    def test(self):
        raise NotImplementedError
