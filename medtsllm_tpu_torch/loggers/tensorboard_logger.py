"""TensorBoard logger (port of ``medtsllm_tpu/loggers/tensorboard_logger.py``).
tensorboard is imported by the constructor, before anything is written: a
missing package raises ``ImportError`` there (``get_logger`` then logs as
the print logger does)."""

from __future__ import annotations

from ..config import flatten_dict
from .base import BaseLogger


class TensorboardLogger(BaseLogger):
    takes_figures = True

    def __init__(self, trainer, config, newrun=True):
        from torch.utils.tensorboard import SummaryWriter
        super().__init__(trainer, config, newrun)
        self.writer = SummaryWriter(log_dir=str(self.logdir / "tensorboard"))
        self.writer.add_hparams(self.summarized_config_flat(), {}, run_name=".")

    def log_end(self) -> None:
        self.writer.close()

    def log_scores(self, scores=None, **kwscores) -> None:
        self.writer.add_scalar("epoch", self.trainer.epoch, self.trainer.step)
        for key, value in (dict(scores or {}) | kwscores).items():
            self.writer.add_scalar(key, value, self.trainer.step)

    def log_figure(self, fig, name: str) -> None:
        self.writer.add_figure(name, fig, self.trainer.step)

    def update_config(self, cfg) -> None:
        super().update_config(cfg)
        # hparams take no lists (e.g. data.cols = ["HR", "SpO2"]): joined
        flat = {k: (", ".join(map(str, v)) if isinstance(v, list) else v)
                for k, v in flatten_dict(cfg).items()}
        self.writer.add_hparams(flat, {}, run_name=".")
