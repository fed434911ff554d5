"""LUDB: the Lobachevsky University ECG database
(``medtsllm_tpu/data/readers/ludb.py``): 10 s single-lead clips with P,
QRS and T waves delineated; clip id = patient * 100 + the lead's index in
order of first appearance; each clip's description joins its patient's
(``*_data_desc_cleaned.csv``) and its lead's; semantic segmentation is
clip-windowed with four classes and its own task prompt."""

from __future__ import annotations

import numpy as np

from .. import synthetic as syn
from ..base import TimeSeriesDataset
from .table import Table, index_dict

LEADS = ["i", "ii", "iii", "avr", "avl", "avf", "v1", "v2", "v3", "v4", "v5", "v6"]


class LUDBFamily(TimeSeriesDataset):
    supported_tasks = ("forecasting", "reconstruction", "semantic_segmentation")
    clip_tasks = ("semantic_segmentation",)
    description = ("LUDB is an ECG signal database collected from subjects with "
                   "various cardiovascular diseases used for ECG delineation. "
                   "Cardiologists manually annotated boundaries of P, T waves "
                   "and QRS complexes. Each clip consists of a 10 second signal "
                   "from a single ECG lead, sampled at 500Hz.")

    N_FEATURES = 1

    @property
    def task_description(self):
        if self.task == "semantic_segmentation":
            return "Segment the following ECG signal into P waves, T waves, and QRS complexes."
        return None

    @property
    def n_classes(self) -> int:
        if self.task == "semantic_segmentation":
            return 4  # background, P, QRS, T
        return super().n_classes

    def get_data(self, split=None) -> dict:
        split = split or self.split
        if "version" in self.dataset_config and self.dataset_config.version != "v3":
            raise ValueError(f"LUDB version {self.dataset_config.version!r}: only v3")
        base = self.data_root() / "ludb"
        if (base / ("train.csv" if split == "train" else "test.csv")).exists():
            return self._read_real(base, split)
        return self.synthetic_fallback(split)

    def _read_real(self, base, split) -> dict:
        df = Table(base / ("train.csv" if split == "train" else "test.csv"))
        leads = df.strings("lead")
        lead_cats = list(dict.fromkeys(leads))  # factorize: order of appearance
        lead_idx = np.array([lead_cats.index(v) for v in leads], dtype=np.int64)
        clip_id = df.ints("patient_id") * 100 + lead_idx
        # "0 days 00:00:SS.ffffff" -> seconds past the minute
        time = np.array([float(v[14:]) for v in df.strings("time")], dtype=np.float64)
        order = np.lexsort((time, clip_id))  # by clip, then time; stable
        pat_desc = index_dict(base / ("train_data_desc_cleaned.csv" if split == "train"
                                      else "test_data_desc_cleaned.csv"), "data_desc")
        descriptions = {p * 100 + lead: f"Patient information: {dp}; ECG lead: {dl}"
                        for p, dp in pat_desc.items() for lead, dl in enumerate(lead_cats)}
        return {"data": df.floats("ecg")[order][:, np.newaxis],
                "labels": df.ints("label")[order], "timestamps": time[order],
                "clip_ids": clip_id[order], "clip_descriptions": descriptions}

    def generate_synthetic(self, split) -> dict:
        key = "train" if split == "train" else "test"
        rng = syn.rng_for("ludb", key)
        n_patients = 8 if key == "train" else 3
        n_leads = 4  # of the 12 leads: keeps the stand-in small
        clip_len = 5000  # 10 s at 500 Hz
        datas, ids, labels = [], [], []
        for p in range(n_patients):
            pid = p if key == "train" else 100 + p
            for lead in range(n_leads):
                datas.append(syn.sine_mixture(rng, clip_len, 1, period_range=(350, 550),
                                              noise=0.05))
                ids.append(np.full(clip_len, pid * 100 + lead, dtype=np.int64))
                labels.append(syn.segment_class_labels(rng, clip_len, 4, mean_seg=120))
        data = np.concatenate(datas, axis=0)
        clip_ids = np.concatenate(ids)
        descriptions = {int(c): (f"Patient information: synthetic subject {int(c) // 100}; "
                                 f"ECG lead: {LEADS[int(c) % 100]}")
                        for c in np.unique(clip_ids)}
        return {"data": data, "labels": np.concatenate(labels), "clip_ids": clip_ids,
                "clip_descriptions": descriptions,
                "timestamps": np.arange(len(data), dtype=float) / 500.0}
