"""ECG: the MIT-BIH Arrhythmia Database (``medtsllm_tpu/data/readers/ecg.py``):
v2 CSVs under mit_ecg/v2/{anom,seg}. Segmentation reads the label column
and per-patient descriptions; anomaly detection the descriptions and, off
the train split, test_label.csv (its time and patient_id columns must
match the data file's); the other tasks every column but time and
patient_id. Under MedTsLLM's ``prompting.examples`` segmentation also
carries in-context example segments, the data between consecutive
boundaries."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table, index_dict


class ECGMITFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "anomaly_detection", "segmentation")
    description = ("The MIT-BIH Arrhythmia Database contains excerpts of "
                   "two-channel ambulatory ECG from a mixed population of "
                   "inpatients and outpatients, digitized at 360 samples per "
                   "second per channel with 11-bit resolution over a 10 mV range.")

    N_FEATURES = 2

    def __init__(self, config, split):
        super().__init__(config, split)
        if "version" in self.dataset_config and self.dataset_config.version != "v2":
            raise ValueError(f"ECG version {self.dataset_config.version!r}: only v2")
        self.examples_enabled = False
        if self.task == "segmentation" and config.model in ("timellm", "medtsllm"):
            # the model's own section (medtsllm before the timellm alias)
            models = config.models
            mc = models.medtsllm if "medtsllm" in models else models.timellm
            prompting = mc.get("prompting", {})
            self.examples_enabled = bool(prompting.get("examples", False))
            if self.examples_enabled:
                self.examples = self.get_examples(prompting.get("example_pool", 1024))
                self.n_examples = len(self.examples)
                if self.n_examples == 0:
                    raise ValueError(
                        "prompting.examples = true but the ECG labels contain fewer than "
                        "two boundary points: no example segments can be sliced")

    def get_examples(self, n=None) -> list:
        """The data between consecutive boundaries (the raw indicators, or
        the zeros of steps-to-boundary's distances), the first ``n``."""
        mode = self.config.get("tasks", {}).get("segmentation", {}).get(
            "mode", "boundary-prediction")
        inds = (np.flatnonzero(np.asarray(self.labels) == 0) if mode == "steps-to-boundary"
                else np.flatnonzero(self.labels))
        periods = (np.stack([inds[:-1], inds[1:]], axis=1) if len(inds) > 1
                   else np.zeros((0, 2), dtype=int))
        if n is not None:
            periods = periods[:n]
        return [self.data[a:b, :] for a, b in periods]

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        if self.examples_enabled:
            item["examples"] = ("Example segment:",
                                self.examples[idx % self.n_examples][None, ...])
        return item

    def get_data(self, split=None) -> dict:
        split = split or self.split
        sub = "seg" if self.task == "segmentation" else "anom"
        base = self.data_root() / "mit_ecg" / "v2" / sub
        if (base / ("train.csv" if split == "train" else "test.csv")).exists():
            return self._read_real(base, split)
        return self.synthetic_fallback(split)

    def _read_real(self, base, split) -> dict:
        df = Table(base / ("train.csv" if split == "train" else "test.csv"))
        out = {}
        if self.task == "segmentation":
            out["data"] = df.matrix(df.difference(["time", "patient_id", "label"]))
            out["labels"] = df.ints("label")
            out["clip_ids"] = df.ints("patient_id")
        elif self.task == "anomaly_detection":
            out["data"] = df.matrix(df.difference(["time", "patient_id"]))
            out["clip_ids"] = df.ints("patient_id")
            if split != "train":
                ldf = Table(base / "test_label.csv")
                if not (np.array_equal(ldf.floats("time"), df.floats("time"))
                        and np.array_equal(ldf.floats("patient_id"), df.floats("patient_id"))):
                    raise ValueError("ECG test_label.csv: time or patient_id differ from "
                                     "test.csv's")
                out["labels"] = ldf.ints("label")
        else:
            out["data"] = df.matrix(df.without(["time", "patient_id"]))
            return out
        desc = index_dict(base / ("train_data_desc.csv" if split == "train"
                                  else "test_data_desc.csv"), "data_desc")
        out["clip_descriptions"] = {k: f"Patient description: {v}" for k, v in desc.items()}
        return out

    def generate_synthetic(self, split) -> dict:
        key = "train" if split == "train" else "test"
        sub = "seg" if self.task == "segmentation" else "anom"
        rng = syn.rng_for(f"ecg:{sub}", key)
        n_clips = 6 if key == "train" else 3
        data, clip_ids = syn.clip_series(
            rng, n_clips, 4000, self.N_FEATURES,
            clip_id_fn=lambda i: (100 + i) if key == "train" else (200 + i),
            period_range=(90, 130), noise=0.05)
        out = {"data": data, "clip_ids": clip_ids,
               "clip_descriptions": syn.patient_descriptions(clip_ids)}
        if self.task == "segmentation":
            out["labels"] = syn.periodic_boundaries(rng, len(data), mean_period=110)
        elif self.task == "anomaly_detection":
            if key != "train":
                out["data"], out["labels"] = syn.inject_anomalies(rng, data, rate=0.03)
            else:
                out["labels"] = None
        return out
