"""Ventilator waveforms (``medtsllm_tpu/data/readers/ventilator.py``):
forecasting and reconstruction pool every v1 clip CSV (pressure and flow)
and split it 70 / 15 / 15; semantic segmentation and anomaly detection
read fixed v4 train / test clip lists, the labels from the label column
(rows labelled below 0 dropped, or for anomaly detection the anomalies:
dropped from the train split only); clip ids are patient * 100 + clip."""

from __future__ import annotations

import re

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table


def parse_clip_id(clip_string: str) -> int:
    m = re.match(r"patient_(\d+)_vent_w_(\d+)", clip_string)
    patient_id, clip_number = (int(g) for g in m.groups())
    return patient_id * 100 + clip_number


TRAIN_CLIPS_SEG = [
    "patient_572_vent_w_1_labeled", "patient_572_vent_w_2_labeled",
    "patient_572_vent_w_4_labeled", "patient_674_vent_w_1_labeled",
    "patient_674_vent_w_4_labeled", "patient_697_vent_w_1_labeled",
    "patient_697_vent_w_2_labeled",
]
TEST_CLIPS_SEG = [
    "patient_704_vent_w_1_labeled", "patient_709_vent_w_1_labeled",
    "patient_709_vent_w_2_labeled",
]
TRAIN_CLIPS_AD = TRAIN_CLIPS_SEG + [
    "patient_709_vent_w_1_labeled", "patient_709_vent_w_2_labeled",
]
TEST_CLIPS_AD = ["patient_704_vent_w_1_labeled"]


class VentilatorFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "semantic_segmentation",
                       "anomaly_detection")
    description = ("The dataset contains time-series data of airway pressure "
                   "and flow rate measurements collected from a mechanical "
                   "ventilator during the respiratory support of a fully sedated "
                   "patient. The data is sampled at a frequency of 100 Hz. The "
                   "airway pressure is measured in cmH2O and the flow rate is "
                   "measured in L/min.")

    N_FEATURES = 2

    @property
    def n_classes(self) -> int:
        if self.task == "semantic_segmentation":
            return 2
        return super().n_classes

    def get_data(self, split=None) -> dict:
        split = split or self.split
        if self.task in ("forecasting", "reconstruction"):
            return self._pooled(split)
        return self._clipped(split)

    def _pooled(self, split) -> dict:
        """The v1 CSVs' pressure and flow one after another, in the first
        file's column order (``usecols`` keeps file order)."""
        base = self.data_root() / "ventilator" / "v1"
        files = sorted(base.glob("*.csv")) if base.exists() else []
        if files:
            tables = [Table(f) for f in files]
            cols = [c for c in tables[0].columns if c in ("pressure", "flow")]
            full = np.concatenate([t.matrix(cols) for t in tables], axis=0)
        else:
            if not self.allow_synthetic():
                raise FileNotFoundError(f"no ventilator v1 csvs under {base}")
            rng = syn.rng_for("ventilator:v1")
            full = syn.sine_mixture(rng, 60000, self.N_FEATURES,
                                    period_range=(200, 500), noise=0.1)
        train_idx, val_idx = int(0.7 * full.shape[0]), int(0.85 * full.shape[0])
        ranges = {"train": slice(None, train_idx), "val": slice(train_idx, val_idx),
                  "test": slice(val_idx, None)}
        if split not in ranges:
            raise ValueError(f"Invalid split: {split}")
        return {"data": full[ranges[split]]}

    def _clipped(self, split) -> dict:
        if "version" in self.dataset_config and (
                self.dataset_config.version != "v4"
                or self.dataset_config.get("split_version", "v1") != "v1"):
            raise ValueError("ventilator clips: only version v4, split_version v1")
        base = self.data_root() / "ventilator" / "v4"
        if self.task == "anomaly_detection":
            clip_list = TRAIN_CLIPS_AD if split == "train" else TEST_CLIPS_AD
        else:
            clip_list = TRAIN_CLIPS_SEG if split == "train" else TEST_CLIPS_SEG
        if not (base / f"{clip_list[0]}.csv").exists():
            return self.synthetic_fallback(split)
        data, labels, clip_ids, stamps = [], [], [], []
        for clip in clip_list:
            df = Table(base / f"{clip}.csv")
            label = df.floats("label")
            keep = (label >= 0 if self.task != "anomaly_detection" or split == "train"
                    else np.ones(len(df), dtype=bool))
            label = (label < 0) if self.task == "anomaly_detection" else label
            data.append(df.matrix(["pressure", "flow"])[keep])
            labels.append(np.asarray(label)[keep].astype(int))
            clip_ids.append(np.full(int(keep.sum()), parse_clip_id(clip), dtype=np.int64))
            stamps.append(df.floats("dt")[keep])
        return {"data": np.concatenate(data), "labels": np.concatenate(labels),
                "clip_ids": np.concatenate(clip_ids), "timestamps": np.concatenate(stamps)}

    def generate_synthetic(self, split) -> dict:
        key = "train" if split == "train" else "test"
        rng = syn.rng_for(f"ventilator:{self.task}", key)
        clips = TRAIN_CLIPS_SEG if key == "train" else TEST_CLIPS_SEG
        clip_ids_list = [parse_clip_id(c) for c in clips]
        data, clip_ids = syn.clip_series(
            rng, len(clips), 6000, self.N_FEATURES,
            clip_id_fn=lambda i: clip_ids_list[i],
            period_range=(250, 450), noise=0.08)
        n = len(data)
        if self.task == "anomaly_detection":
            data, labels = syn.inject_anomalies(rng, data, rate=0.04, max_len=120)
        else:  # breath phases: inhale / exhale in turn
            labels = syn.segment_class_labels(rng, n, 2, mean_seg=180)
        return {"data": data, "labels": labels, "clip_ids": clip_ids,
                "timestamps": np.arange(n, dtype=float) / 100.0}
