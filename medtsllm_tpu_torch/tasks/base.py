"""The eval runtime (port of ``medtsllm_tpu/tasks/base.py``, eval only:
datasets and pipelines, parameter init, ``eval_model_inputs``,
``eval_prepare`` / ``eval_dispatch`` for the plain kind, the prefill of
the 1-D prompt-head KV cache, ``run_eval``, ``eval_n_points`` and
``finalize_series``).

Everything lives on one explicit device. The constant prompt head is
prefilled once per eval pass and every window attends it as prefix K/V.
"""

from __future__ import annotations

import random
import warnings

import numpy as np
import torch

from ..data import BatchPipeline, SyntheticDataset
from ..device import resolve_device
from ..models.medtsllm import MedTsLLM, PromptBuilder, storage_dtype
from ..weights import init_random_


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

        self.train_dataset = SyntheticDataset(config, "train")
        self.test_dataset = SyntheticDataset(config, "test")
        self.test_pipeline = BatchPipeline(self.test_dataset,
                                           config.training.batch_size)

        with torch.device(self.device):
            self.model = MedTsLLM.from_config(config, self.train_dataset)
        self.preprocessor = PromptBuilder(config, self.train_dataset, self.model)
        generator = torch.Generator(self.device).manual_seed(seed)
        init_random_(self.model, generator)
        warnings.warn(f"LLM {self.model.llm_id!r}: no weights are loaded — "
                      "random init (shapes and throughput faithful; task "
                      "quality not meaningful)")
        self.model.to(storage_dtype(config)).eval().requires_grad_(False)
        self._prefix_kv_cache = {}

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

    @torch.inference_mode()
    def _prefix_kv(self, ids: torch.Tensor):
        """Per-layer K/V of the 1-D prompt head, prefilled once per eval
        pass. The head embeds at ts_emb's dtype, f32 (the fusion layers
        promote to f32), so cached and uncached forwards agree."""
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

    def test(self):
        raise NotImplementedError
