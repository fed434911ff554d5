"""Weights & Biases logger (port of ``medtsllm_tpu/loggers/wandb_logger.py``).
wandb is imported by the constructor, before anything is written: a missing
package raises ``ImportError`` there (``get_logger`` then falls back to
tensorboard, as JAX does)."""

from __future__ import annotations

from pathlib import Path

from ..config import get_logging_tags, summarize_config
from .base import BaseLogger


class WandBLogger(BaseLogger):
    takes_figures = True

    def __init__(self, trainer, config, newrun=True):
        import wandb
        super().__init__(trainer, config, newrun)
        self.wandb = wandb
        self.run = wandb.init(
            project="med-time-llm", name=trainer.run_id, id=trainer.run_id,
            dir=str(self.logdir), resume="allow", job_type="training",
            config=summarize_config(config).to_dict(), tags=get_logging_tags(config),
            mode="disabled" if config.get("DEBUG", False) else "online")
        self.log_code()

    def log_code(self) -> None:
        """Upload a snapshot of the code (the repository, less its outputs)."""
        basepath = Path(__file__).resolve().parents[2]
        excluded = [basepath / d for d in (".wandb", "wandb", ".venv", "tmp", "outputs", ".git")]

        def exclude_fn(path, root):
            p = Path(root) / path
            return any(e in p.parents for e in excluded)

        self.run.log_code(str(basepath), exclude_fn=exclude_fn)

    def log_end(self) -> None:
        self.run.finish()

    def log_scores(self, scores=None, **kwscores) -> None:
        self.run.log({"epoch": self.trainer.epoch, "step": self.trainer.step}
                     | dict(scores or {}) | kwscores)

    def log_figure(self, fig, name: str) -> None:
        self.run.log({name: self.wandb.Image(fig)})

    def update_config(self, cfg) -> None:
        super().update_config(cfg)
        self.run.config.update(cfg if isinstance(cfg, dict) else cfg.to_dict())
