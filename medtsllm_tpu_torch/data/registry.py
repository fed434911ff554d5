"""The dataset registry (a copy of ``medtsllm_tpu/data/registry.py``)."""

from __future__ import annotations

from .base import Multi2UniDataset
from .readers import (BIDMCFamily, DreamsFamily, ECGMITFamily, ETTFamily, LUDBFamily,
                      MSLFamily, PSMFamily, SyntheticFamily, VentilatorFamily)

dataset_lookup = {
    "ETTh1": ETTFamily,
    "ETTh2": ETTFamily,
    "ETTm1": ETTFamily,
    "ETTm2": ETTFamily,
    "PSM": PSMFamily,
    "MSL": MSLFamily,
    "ECG": ECGMITFamily,
    "ventilator": VentilatorFamily,
    "bidmc": BIDMCFamily,
    "ludb": LUDBFamily,
    "dreams": DreamsFamily,
    "synthetic": SyntheticFamily,
}


def get_dataset(config, split: str):
    """``data.dataset``'s family for ``config.task`` and ``split``, under
    ``data.mode = "univariate"`` as one-feature windows."""
    name = config.data.dataset
    if name not in dataset_lookup:
        raise ValueError(f"Unknown dataset {name!r}")
    cls = dataset_lookup[name]
    if config.task not in cls.supported_tasks:
        raise ValueError(f"Task {config.task} not supported by dataset {name}")
    dataset = cls(config, split)
    if config.data.mode == "univariate":
        dataset = Multi2UniDataset(dataset)
    return dataset
