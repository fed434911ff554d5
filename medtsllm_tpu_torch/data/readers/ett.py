"""ETT: electricity transformer temperatures
(``medtsllm_tpu/data/readers/ett.py``): one CSV a variant (ETTh1, ETTh2,
ETTm1, ETTm2) whose date column is the index, split by rows into 12 / 4 /
4 months of hourly data."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table


class ETTFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "imputation")
    description = ("The Electricity Transformer Temperature (ETT) is a crucial "
                   "indicator in the electric power long-term deployment.")

    N_FEATURES = 7

    def split_ranges(self) -> dict:
        # 12 / 4 / 4 months of hourly rows, the minutely variants too
        train = (0, 12 * 30 * 24)
        val = (train[1], train[1] + 4 * 30 * 24)
        test = (val[1], val[1] + 4 * 30 * 24)
        return {"train": train, "val": val, "test": test}

    def get_data(self, split=None) -> dict:
        split = split or self.split
        path = self.data_root() / "ett" / f"{self.name}.csv"
        if path.exists():
            df = Table(path)
            full = df.matrix(df.without(["date"]))  # the date column is the index
        else:
            full = self.synthetic_series()
        ranges = self.split_ranges()
        if split not in ranges:
            raise ValueError(f"Invalid split: {split}")
        return {"data": full[slice(*ranges[split])]}

    def synthetic_series(self) -> np.ndarray:
        if not self.allow_synthetic():
            raise FileNotFoundError(f"ETT csv missing under {self.data_root()}")
        rng = syn.rng_for(f"ett:{self.name}")
        return syn.sine_mixture(rng, 20 * 30 * 24, self.N_FEATURES,
                                period_range=(24, 24 * 30), noise=0.2)
