"""DREAMS: sleep recordings with annotated artifacts
(``medtsllm_tpu/data/readers/dreams.py``): v2 train / test CSVs, the
feature and label columns chosen by ``datasets.dreams.features`` and
``labels`` (eeg, eog or all). Semantic segmentation and classification
read the labelled test file alone, split by time (80 / 20, or 64 / 16 /
20 for classification so that val never scores the reported test rows),
then strided by ``downsample_factor``; the other tasks read train.csv /
test.csv, the labels off the train split."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table, index_dict

EEG_COLS = ["FP1-A1", "CZ-A1", "O1-A1", "FP2-A1", "O2-A1"]
EOG_COLS = ["EOG1-A1", "EOG2-A1"]


def _labeled_split(n: int, task: str, split: str) -> slice:
    """The rows of the labelled test file for one split."""
    if task == "classification":
        bounds = {"train": (0, int(n * 0.64)), "val": (int(n * 0.64), int(n * 0.8)),
                  "test": (int(n * 0.8), n)}
        return slice(*bounds[split])
    split_pt = int(n * 0.8)
    return slice(None, split_pt) if split == "train" else slice(split_pt, None)


class DreamsFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "anomaly_detection",
                       "semantic_segmentation", "classification")
    description = ("The DREAMS database consists of digital 32-channel "
                   "polysomnographic recordings (PSG), acquired from patients "
                   "with different pathologies in a sleep hospital laboratory. "
                   "Muscle or movement artifacts on the electroencephalogram "
                   "(EEG) were annotated in microevents or in sleep stages by "
                   "several experts. Other provided physiological signals "
                   "include multiple electrooculogram (EOG) and electromyography "
                   "(EMG) channels, sampled at 200Hz.")

    @property
    def n_classes(self) -> int:
        if self.task in ("semantic_segmentation", "classification"):
            return 2  # binary artifact labels
        return super().n_classes

    def _n_synth_features(self) -> int:
        sel = self.dataset_config.get("features", "eeg")
        return {"eeg": len(EEG_COLS), "eog": len(EOG_COLS), "all": 9}.get(sel, 5)

    def get_data(self, split=None) -> dict:
        split = split or self.split
        if "version" in self.dataset_config and self.dataset_config.version != "v2":
            raise ValueError(f"dreams version {self.dataset_config.version!r}: only v2")
        base = self.data_root() / "dreams" / "v2"
        if (base / "test.csv").exists():
            return self._read_real(base, split)
        return self.synthetic_fallback(split)

    def _read_real(self, base, split) -> dict:
        labelled = self.task in ("semantic_segmentation", "classification")
        df = Table(base / ("test.csv" if labelled or split != "train" else "train.csv"))
        feature_cols = {"eeg": EEG_COLS, "eog": EOG_COLS,
                        "all": df.difference(["ts", "patient_ID"])}[
            self.dataset_config.features]
        label_col = {"eeg": "EEG_label", "eog": "EOG_label",
                     "all": "ALL_label"}[self.dataset_config.labels]
        xs = df.matrix(feature_cols)
        clip_ids = df.ints("patient_ID")
        timestamps = df.floats("ts")
        if labelled:
            ldf = Table(base / "test_label.csv")
            # two files: their rows must align
            if len(ldf) != len(df):
                raise ValueError(f"dreams test_label.csv rows ({len(ldf)}) != test.csv rows "
                                 f"({len(df)})")
            if "ts" in ldf and not (ldf.floats("ts") == timestamps).all():
                raise ValueError("dreams test_label.csv timestamps misaligned")
            labels = ldf.ints(label_col)
            sl = _labeled_split(xs.shape[0], self.task, split)
            sf = self.dataset_config.downsample_factor
            xs, labels = xs[sl][::sf], labels[sl][::sf]
            clip_ids, timestamps = clip_ids[sl][::sf], timestamps[sl][::sf]
            desc_fn = "test_data_desc.csv"
        else:
            labels = None
            if split != "train":
                labels = Table(base / "test_label.csv").ints(label_col)
            desc_fn = "train_data_desc.csv" if split == "train" else "test_data_desc.csv"
        descriptions = {k: f"Patient description: {v}"
                        for k, v in index_dict(base / desc_fn, "data_desc").items()}
        return {"data": xs, "labels": labels, "clip_ids": clip_ids,
                "clip_descriptions": descriptions, "timestamps": timestamps}

    def generate_synthetic(self, split) -> dict:
        C = self._n_synth_features()
        if self.task in ("semantic_segmentation", "classification"):
            rng = syn.rng_for("dreams:semseg")
            n = 20000
            data = syn.sine_mixture(rng, n, C, period_range=(40, 400), noise=0.3)
            labels = syn.segment_class_labels(rng, n, 2, mean_seg=500)
            clip_ids = np.zeros(n, dtype=np.int64)
            sl = _labeled_split(n, self.task, split)
            sf = self.dataset_config.get("downsample_factor", 1)
            data, labels = data[sl][::sf], labels[sl][::sf]
            clip_ids = clip_ids[sl][::sf]
        else:
            key = "train" if split == "train" else "test"
            rng = syn.rng_for("dreams", key)
            n = 16000 if key == "train" else 8000
            data = syn.sine_mixture(rng, n, C, period_range=(40, 400), noise=0.3)
            labels = None
            if key != "train" and self.task == "anomaly_detection":
                data, labels = syn.inject_anomalies(rng, data, rate=0.04)
            clip_ids = np.zeros(len(data), dtype=np.int64)
        return {"data": data, "labels": labels, "clip_ids": clip_ids,
                "clip_descriptions": syn.patient_descriptions(clip_ids),
                "timestamps": np.arange(len(data), dtype=float) / 200.0}
