"""MSL: NASA's Mars Science Laboratory rover telemetry
(``medtsllm_tpu/data/readers/msl.py``): MSL_train.npy / MSL_test.npy, the
anomaly labels in MSL_test_label.npy off the train split."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset


class MSLFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "anomaly_detection", "imputation")
    description = ("The MSL (Mars Science Laboratory rover) dataset was created "
                   "by NASA and consists of telemetry data across 55 sensors on "
                   "the rover. The data is collected at 1 minute intervals and "
                   "spans a period of 78 Martian days. The dataset is labeled "
                   "with 143 anomalous intervals, each of which is labeled by an "
                   "expert as an incident, surprise, or an anomaly.")

    N_FEATURES = 55

    def get_data(self, split=None) -> dict:
        split = split or self.split
        base = self.data_root() / "msl"
        fn = "MSL_train.npy" if split == "train" else "MSL_test.npy"
        if (base / fn).exists():
            labels = None
            # the dataset's split, not the one read (the train statistics
            # of a test dataset read the labels too, as in JAX)
            if self.task == "anomaly_detection" and self.split != "train":
                labels = np.load(base / "MSL_test_label.npy").astype(int)
            return {"data": np.load(base / fn), "labels": labels}
        return self.synthetic_fallback(split)

    def generate_synthetic(self, split) -> dict:
        key = "train" if split == "train" else "test"
        rng = syn.rng_for("msl", key)
        n = 12000 if key == "train" else 6000
        data = syn.sine_mixture(rng, n, self.N_FEATURES, noise=0.25)
        labels = None
        # anomalies only for anomaly detection: the other tasks evaluate on
        # the clean series
        if key != "train" and self.task == "anomaly_detection":
            data, labels = syn.inject_anomalies(rng, data, rate=0.05, max_len=80)
        if self.split == "train":
            labels = None
        return {"data": data, "labels": labels}
