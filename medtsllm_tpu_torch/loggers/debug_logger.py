"""Debug logger (port of ``medtsllm_tpu/loggers/debug_logger.py``): prints,
and writes neither a run directory nor a checkpoint."""

from __future__ import annotations

import json

from ..config import summarize_config
from .base import BaseLogger


class DebugLogger(BaseLogger):
    def __init__(self, trainer, config, newrun=True):
        # BaseLogger.__init__ is skipped: it writes the run directory
        self.trainer = trainer
        self.config = config
        self.newrun = newrun
        print("Run ID:", trainer.run_id)
        print("Config:")
        print(json.dumps(summarize_config(config).to_dict(), indent="\t"))

    def log_end(self) -> None:
        print("Done!")

    def log_scores(self, scores=None, **kwscores) -> None:
        scores = dict(scores or {}) | kwscores
        if len(scores) == 1 and "train/loss" in scores:
            return
        print(f"Epoch: {self.trainer.epoch}, step: {self.trainer.step}, scores: {scores}")

    def save_state(self, name: str, async_: bool = True) -> None:
        pass

    def update_config(self, cfg) -> None:
        print("Config updated:", cfg)
