"""The synthetic sinusoid-mixture family (``medtsllm_tpu/data/readers/synthetic.py``):
every task, no files. Sizes from ``[datasets.synthetic]``: ``n_points``
(default 2048), ``n_features`` (3), ``n_classes`` (2) and, with ``clips``,
``n_clips`` (4) equal clips (the last taking the remainder), each with a
patient description. Val and test are distinct series."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset


class SyntheticFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "anomaly_detection",
                       "segmentation", "semantic_segmentation", "pretraining",
                       "classification", "imputation")
    description = "A synthetic sinusoid-mixture dataset used for testing."

    def get_data(self, split=None) -> dict:
        return self.generate_synthetic(split or self.split)

    @property
    def clip_dataset(self) -> bool:
        return bool(self.dataset_config.get("clips", False)) and self.task != "forecasting"

    @property
    def n_classes(self) -> int:
        if self.task == "classification" and self.task_config.get(
                "window_label", "majority") == "any":
            return 2
        if self.task in ("semantic_segmentation", "classification"):
            return int(self.dataset_config.get("n_classes", 2))
        return 0

    def generate_synthetic(self, split) -> dict:
        n = int(self.dataset_config.get("n_points", 2048))
        C = int(self.dataset_config.get("n_features", 3))
        rng = syn.rng_for(f"synthetic:{self.name}", split)
        data = syn.sine_mixture(rng, n, C, period_range=(16, 256), noise=0.1)
        out = {"data": data}
        if self.task == "anomaly_detection":
            if split != "train":
                out["data"], out["labels"] = syn.inject_anomalies(rng, data, rate=0.05)
        elif self.task == "segmentation":
            out["labels"] = syn.periodic_boundaries(rng, n, mean_period=100)
        elif self.task in ("semantic_segmentation", "classification"):
            out["labels"] = syn.segment_class_labels(rng, n, self.n_classes, mean_seg=64)
        if self.dataset_config.get("clips", False):
            n_clips = int(self.dataset_config.get("n_clips", 4))
            ids = np.repeat(np.arange(n_clips), n // n_clips)
            out["clip_ids"] = np.pad(ids, (0, n - len(ids)), constant_values=n_clips - 1)
            out["clip_descriptions"] = syn.patient_descriptions(out["clip_ids"])
        return out
