"""BIDMC: ECG, PPG and respiration of intensive-care patients with
annotated breaths (``medtsllm_tpu/data/readers/bidmc.py``): train.csv /
test.csv with Time, patient_id and label columns beside the signals."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table


class BIDMCFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "segmentation")
    description = ("The BIDMC dataset is a dataset of electrocardiogram (ECG), "
                   "pulse oximetry (photoplethysmogram, PPG) and impedance "
                   "pneumography respiratory signals acquired from intensive "
                   "care patients. Two annotators manually annotated individual "
                   "breaths in each recording using the impedance respiratory "
                   "signal.")

    N_FEATURES = 3  # ECG, PPG, RESP

    def get_data(self, split=None) -> dict:
        split = split or self.split
        path = self.data_root() / "bidmc" / ("train.csv" if split == "train" else "test.csv")
        if path.exists():
            df = Table(path)
            return {"data": df.matrix(df.difference(["Time", "patient_id", "label"])),
                    "labels": df.ints("label"), "clip_ids": df.ints("patient_id"),
                    "timestamps": df.floats("Time")}
        return self.synthetic_fallback(split)

    def generate_synthetic(self, split) -> dict:
        key = "train" if split == "train" else "test"
        rng = syn.rng_for("bidmc", key)
        n_clips = 5 if key == "train" else 2
        data, clip_ids = syn.clip_series(
            rng, n_clips, 8000, self.N_FEATURES,
            clip_id_fn=lambda i: i if key == "train" else 50 + i,
            period_range=(150, 350), noise=0.08)
        n = len(data)
        labels = syn.periodic_boundaries(rng, n, mean_period=260)
        return {"data": data, "labels": labels, "clip_ids": clip_ids,
                "timestamps": np.arange(n, dtype=float) / 125.0}
