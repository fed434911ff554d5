"""The pretraining mixture (a copy of ``medtsllm_tpu/data/util.py``)."""

from __future__ import annotations

import math

import numpy as np


class PretrainingDataset:
    """Several datasets, each rewired to reconstruction, as one: each
    downsampled by a permutation drawn from one ``default_rng(seed)``
    (``downsample_pct`` of its windows, at least one), their windows in
    turn; features tiled, then cut, to ``n_features`` ("auto" or None: the
    widest member's). Items drop the per-clip ``descriptions`` (a batch
    cannot mix rows with and without them) and carry their member's
    ``dataset`` name and ``dataset_description``; the windows are laid out
    one after another for stitching."""

    description = "This dataset consists of a mix of different biomedical time series datasets."
    univariate = False
    clip_dataset = False
    task_description = None
    clip_descriptions = None

    def __init__(self, datasets: dict, downsample_pct: float = 1.0, n_features=None,
                 seed: int = 0):
        self.datasets = list(datasets.values())
        self.dataset_names = list(datasets.keys())
        self.split = self.datasets[0].split
        self.name = "pretrain:" + "+".join(self.dataset_names)
        rng = np.random.default_rng(seed)
        self.dataset_inds = [rng.permutation(len(ds))[:max(1, int(downsample_pct * len(ds)))]
                             for ds in self.datasets]
        self.lens = [len(inds) for inds in self.dataset_inds]
        self.cumsums = np.concatenate([[0], np.cumsum(self.lens)])
        if n_features is None or n_features == "auto":
            n_features = max(ds.n_features for ds in self.datasets)
        self.n_features = self.real_features = int(n_features)
        self.pred_len = self.datasets[0].pred_len
        self.step_size = self.datasets[0].step_size
        self.n_points = int(sum(self.step_size * n for n in self.lens))

    n_classes = 0

    def __len__(self) -> int:
        return int(sum(self.lens))

    def _locate(self, index: int):
        d = int(np.searchsorted(self.cumsums, index, side="right")) - 1
        return d, int(self.dataset_inds[d][index - int(self.cumsums[d])])

    def adjust_n_features(self, x: np.ndarray) -> np.ndarray:
        if x.shape[1] < self.n_features:
            x = np.tile(x, (1, math.ceil(self.n_features / x.shape[1])))
        return x[:, :self.n_features]

    def __getitem__(self, index: int) -> dict:
        d, local = self._locate(index)
        item = self.datasets[d][local]
        item.pop("descriptions", None)
        item["x_enc"] = self.adjust_n_features(item["x_enc"])
        if "y" in item:
            item["y"] = self.adjust_n_features(item["y"])
        item["dataset"] = self.dataset_names[d]
        item["dataset_description"] = self.datasets[d].description
        return item

    def x_starts(self, idx) -> np.ndarray:
        return np.asarray(idx) * self.step_size
