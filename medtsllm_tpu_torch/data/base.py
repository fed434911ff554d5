"""The dataset frame (a copy of ``medtsllm_tpu/data/base.py``): one
windowed series for one (task, split), z-scored with the train split's
statistics, with its labels converted for the task; the stand-in a family
generates when its files are absent; and the univariate view.

A family (``readers/``) implements ``get_data(split)``, returning a dict
with ``data`` [n, C] and, where it has them, ``labels`` [n],
``timestamps`` [n], ``clip_ids`` [n] and ``clip_descriptions`` {clip id:
text}, and ``generate_synthetic(split)``, the same keys from a seeded
generator (``synthetic.py``)."""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

from . import windowing as W


class StandardScaler:
    """Per-feature z-score (ddof 0, a zero std taken as 1), fit on the
    train split only."""

    def fit(self, x: np.ndarray) -> "StandardScaler":
        self.mean = np.mean(x, axis=0)
        std = np.std(x, axis=0)
        self.std = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return x * self.std + self.mean


# tasks.classification.window_label -> the window's label from its per-step
# labels: the most frequent (ties to the lowest id), the last, or whether
# any is nonzero
WINDOW_LABELS = {
    "majority": lambda seg: np.int64(np.bincount(seg).argmax()),
    "last": lambda seg: np.int64(seg[-1]),
    "any": lambda seg: np.int64((seg != 0).any()),
}


class TimeSeriesDataset:
    """One windowed dataset for one (task, split). Windows are
    ``ForecastWindows`` (forecasting: ``x_enc`` the history before ``y``),
    ``ClipWindows`` for the family's ``clip_tasks`` (never across a clip;
    a stitched series keeps the points of ``mask``), else
    ``AlignedWindows``; the test split steps by ``pred_len``. Items carry
    the task's labels (per step, or one per window for classification by
    ``window_label``) and, where the family has clip descriptions, the
    description of the window's clip. Segmentation's labels are boundary
    indicators, or in ``steps-to-boundary`` mode the distances to the next
    boundary."""

    supported_tasks: tuple = ()
    clip_tasks: tuple = ()
    description: str = ""
    task_description: str | None = None

    univariate = False
    labels = None
    timestamps = None
    clip_ids = None
    clip_descriptions = None
    normalizer = None

    def __init__(self, config, split: str):
        self.config = config
        self.split = split
        self.task = config.task
        self.name = config.data.dataset
        self.task_config = config.get("tasks", {}).get(self.task, {})
        self.dataset_config = config.get("datasets", {}).get(self.name, {})
        self.data_config = config.data
        self.history_len = config.history_len
        self.pred_len = config.pred_len
        # non-overlapping windows on the test split
        self.step_size = config.pred_len if split == "test" else config.data.step
        if config.data.cols != "all":
            raise NotImplementedError(f"data.cols = {config.data.cols!r}: the datasets read "
                                      "every column (\"all\"), as the JAX package's do")
        if self.task not in self.supported_tasks:
            raise ValueError(f"task {self.task} not supported by dataset {self.name}")
        if self.task == "classification":
            mode = self.task_config.get("window_label", "majority")
            self.window_label = WINDOW_LABELS.get(mode)
            if self.window_label is None:
                raise ValueError(f"Unknown classification window_label {mode!r}")
        self.load_data()
        self.build_windows()
        if self.task == "segmentation":
            mode = self.task_config.mode
            if mode == "steps-to-boundary":
                self.labels = W.steps_to_boundary_labels(self.labels)
            elif mode != "boundary-prediction":
                raise ValueError(f"Segmentation mode {mode} not supported")

    # -- data --------------------------------------------------------------

    def get_data(self, split: str | None = None) -> dict:
        raise NotImplementedError(f"{type(self).__name__} reads no files")

    def load_data(self) -> None:
        got = self.get_data()
        data = np.asarray(got["data"], dtype=np.float64)
        if self.config.data.normalize:
            train = data if self.split == "train" else np.asarray(
                self.get_data("train")["data"], dtype=np.float64)
            self.normalizer = StandardScaler().fit(train)
            data = self.normalizer.transform(data)
        self.data = data.astype(np.float32)
        if got.get("labels") is not None:
            labels = np.asarray(got["labels"])
            n_labels = len(np.unique(labels))
            self.labels = labels.astype(np.int64 if n_labels > 2 else np.int32)
        if got.get("timestamps") is not None:
            self.timestamps = np.asarray(got["timestamps"], dtype=np.float64)
        if got.get("clip_ids") is not None:
            self.clip_ids = np.asarray(got["clip_ids"], dtype=np.int32)
        if got.get("clip_descriptions") is not None:
            self.clip_descriptions = got["clip_descriptions"]

    def build_windows(self) -> None:
        if self.task == "forecasting":
            if self.clip_dataset:
                raise ValueError("clip datasets do not support forecasting")
            self.windows = W.ForecastWindows(self.n_points, self.history_len, self.pred_len,
                                             self.step_size)
        elif self.history_len != self.pred_len:
            raise ValueError(f"{self.task} requires history_len == pred_len")
        elif self.clip_dataset:
            self.windows = W.ClipWindows(self.clip_ids, self.pred_len, self.step_size)
        else:
            self.windows = W.AlignedWindows(self.n_points, self.pred_len, self.step_size)

    @property
    def clip_dataset(self) -> bool:
        return self.task in self.clip_tasks

    @property
    def mask(self) -> np.ndarray:
        return self.windows.mask

    # -- items ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.windows)

    def x_starts(self, idx) -> np.ndarray:
        return self.windows.x_starts(idx)

    def __getitem__(self, idx: int) -> dict:
        s = int(self.x_starts(int(idx)))
        if self.task == "forecasting":
            h = s + self.history_len
            out = {"x_enc": self.data[s:h], "y": self.data[h:h + self.pred_len]}
        else:
            window = slice(s, s + self.pred_len)
            out = {"x_enc": self.data[window]}
            if self.task == "classification":
                out["labels"] = self.window_label(np.asarray(self.labels[window]))
            elif self.task in ("semantic_segmentation", "segmentation") or (
                    self.task == "anomaly_detection" and self.labels is not None):
                out["labels"] = self.labels[window]
        if self.clip_descriptions is not None:
            out["descriptions"] = self.clip_descriptions[int(self.clip_ids[s])]
        return out

    @property
    def n_points(self) -> int:
        return self.data.shape[0]

    @property
    def n_features(self) -> int:
        return self.data.shape[1]

    @property
    def real_features(self) -> int:
        return self.n_features

    @property
    def n_classes(self) -> int:
        if self.task == "semantic_segmentation":
            return len(np.unique(self.labels))
        if self.task == "classification":
            if self.task_config.get("window_label", "majority") == "any":
                return 2
            return int(np.max(self.labels)) + 1
        return 0

    # -- the stand-in ----------------------------------------------------------

    def data_root(self) -> Path:
        root = self.config.get("paths", {}).get("data")
        return Path(root) if root else Path.cwd() / "data"

    def allow_synthetic(self) -> bool:
        return bool(self.data_config.get("allow_synthetic", True))

    def synthetic_fallback(self, split: str, exc=None) -> dict:
        """The family's stand-in when its files are absent, with a warning;
        ``data.allow_synthetic = false`` makes it raise instead."""
        if not self.allow_synthetic():
            raise FileNotFoundError(
                f"dataset {self.name} files not found under {self.data_root()} "
                f"and data.allow_synthetic is false") from exc
        warnings.warn(f"dataset {self.name}: real files not found under {self.data_root()}; "
                      f"using synthetic fixture for split={split}")
        return self.generate_synthetic(split)

    def generate_synthetic(self, split: str) -> dict:
        raise NotImplementedError(f"{type(self).__name__} has no synthetic generator")


class Multi2UniDataset:
    """``data.mode = "univariate"``: a C-feature dataset as C x len(base)
    one-feature windows; flat index w * C + f is window w's feature f."""

    univariate = True

    def __init__(self, base: TimeSeriesDataset):
        self.base = base
        self.windows = W.UnivariateWindows(base.windows, base.n_features)
        for attr in ("config", "split", "task", "name", "task_config", "dataset_config",
                     "data_config", "history_len", "pred_len", "step_size", "description",
                     "task_description", "labels", "clip_descriptions", "clip_ids", "data",
                     "normalizer"):
            setattr(self, attr, getattr(base, attr, None))

    def __len__(self) -> int:
        return len(self.windows)

    n_features = 1

    @property
    def real_features(self) -> int:
        return self.base.n_features

    @property
    def n_points(self) -> int:
        return self.base.n_points

    @property
    def n_classes(self) -> int:
        return self.base.n_classes

    @property
    def clip_dataset(self) -> bool:
        return self.base.clip_dataset

    @property
    def mask(self) -> np.ndarray:
        return self.base.mask

    def x_starts(self, idx) -> np.ndarray:
        return self.windows.x_starts(idx)

    def features(self, idx) -> np.ndarray:
        return self.windows.features(idx)

    def __getitem__(self, idx: int) -> dict:
        C = self.base.n_features
        item = self.base[idx // C]
        f = idx % C
        item["x_enc"] = item["x_enc"][:, f:f + 1]
        if "y" in item:
            item["y"] = item["y"][:, f:f + 1]
        return item
