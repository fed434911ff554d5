"""Stdout logger (port of ``medtsllm_tpu/loggers/print_logger.py``)."""

from __future__ import annotations

import json

from ..config import summarize_config
from .base import BaseLogger


class PrintLogger(BaseLogger):
    def __init__(self, trainer, config, newrun=True):
        super().__init__(trainer, config, newrun)
        print("Run ID:", trainer.run_id)
        print("Config:")
        print(json.dumps(summarize_config(config).to_dict(), indent="\t"))

    def log_end(self) -> None:
        print("Done!")

    def log_scores(self, scores=None, **kwscores) -> None:
        scores = dict(scores or {}) | kwscores
        if len(scores) == 1 and "train/loss" in scores:
            return  # the per-step loss is too chatty for stdout
        print(f"Epoch: {self.trainer.epoch}, step: {self.trainer.step}, scores: {scores}")

    def update_config(self, cfg) -> None:
        super().update_config(cfg)
        print("Config updated:", cfg)
