"""PSM: eBay's pooled server metrics (``medtsllm_tpu/data/readers/psm.py``):
train.csv / test.csv with a timestamp_(min) column dropped and NaN taken
as 0; the anomaly labels in test_label.csv off the train split; val and
test both read test.csv."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table

TIME_COL = "timestamp_(min)"


class PSMFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "anomaly_detection", "imputation")
    description = ("The PSM dataset is proposed by eBay and consists of 26 "
                   "dimensional data captured internally from application server "
                   "nodes. The dataset is used to predict the number of sessions "
                   "in the next 10 minutes based on the current and historical data.")

    N_FEATURES = 25

    def get_data(self, split=None) -> dict:
        split = split or self.split
        base = self.data_root() / "psm"
        path = base / ("train.csv" if split == "train" else "test.csv")
        if path.exists():
            df = Table(path)
            data = np.nan_to_num(df.matrix(df.without([TIME_COL])))
            labels = None
            if self.task == "anomaly_detection" and self.split != "train":
                ldf = Table(base / "test_label.csv")
                labels = ldf.ints(ldf.without([TIME_COL])[0])
            return {"data": data, "labels": labels}
        return self.synthetic_fallback(split)

    def generate_synthetic(self, split) -> dict:
        key = "train" if split == "train" else "test"
        rng = syn.rng_for("psm", key)
        n = 16000 if key == "train" else 8000
        data = syn.sine_mixture(rng, n, self.N_FEATURES, noise=0.3)
        labels = None
        if key != "train" and self.task == "anomaly_detection":
            data, labels = syn.inject_anomalies(rng, data, rate=0.03)
        if self.split == "train":
            labels = None
        return {"data": data, "labels": labels}
