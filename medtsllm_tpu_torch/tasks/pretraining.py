"""Pretraining (port of ``medtsllm_tpu/tasks/pretraining.py``):
reconstruction over the mixture of the ECG, ventilator, bidmc and ludb
families (``data.util.PretrainingDataset``), each read with ``task =
"reconstruction"``. Every row carries its own dataset's prompt, so no
prompt head is cached: the whole prompt goes through the step."""

from __future__ import annotations

from ..config import Config
from ..data import PretrainingDataset, get_dataset
from .reconstruction import ReconstructionTask

PRETRAIN_DATASETS = ["ECG", "ventilator", "bidmc", "ludb"]


def member_config(config, name: str) -> Config:
    """``config`` with ``data.dataset = name`` and ``task =
    "reconstruction"``."""
    raw = config.to_dict()
    return Config(dict(raw, task="reconstruction", data=dict(raw["data"], dataset=name)))


class PretrainingTask(ReconstructionTask):
    task = "pretraining"

    def build_datasets(self) -> None:
        splits = {"train": {}, "val": {}, "test": {}}
        for name in PRETRAIN_DATASETS:
            cfg = member_config(self.config, name)
            for split in splits:
                splits[split][name] = get_dataset(cfg, split)
        pcfg = self.config.tasks.pretraining
        kw = dict(downsample_pct=pcfg.downsample_pct, n_features=pcfg.n_features,
                  seed=self.config.setup.seed)
        self.train_dataset = PretrainingDataset(splits["train"], **kw)
        self.val_dataset = PretrainingDataset(splits["val"], **kw)
        self.test_dataset = PretrainingDataset(splits["test"], **kw)
