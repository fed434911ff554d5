"""BaseLogger: the run directory and the checkpoints (port of
``medtsllm_tpu/loggers/base.py``).

The layout is JAX's: ``<logdir>/<run_id>/{config.toml, config.json,
checkpoints/<name>.ckpt}``, with ``config-updates.{toml,json}``; the logdir
is ``paths.logdir``, else ``./outputs/logs``. A checkpoint holds the
trainer's ``checkpoint_params()`` (the frozen backbone left out) and its
meta; its payload is torch's, not JAX's (``runtime/checkpoint.py``).
"""

from __future__ import annotations

import json
import tomllib
import weakref
from datetime import datetime
from pathlib import Path

from ..config import dumps_toml, flatten_dict, summarize_config
from ..runtime.checkpoint import save_checkpoint


def logdir_base(config) -> Path:
    """``paths.logdir``, else ``outputs/logs`` under the working directory
    (``logdir_base`` of the JAX trainer)."""
    base = config.get("paths", {}).get("logdir")
    return Path(base) if base else Path.cwd() / "outputs" / "logs"


class BaseLogger:
    # whether log_figure records a figure (tasks draw one only then)
    takes_figures = False

    # the trainer is held weakly: the trainer holds its logger, and a cycle
    # would keep a dropped trainer's device memory until the next collection
    @property
    def trainer(self):
        return self._trainer()

    @trainer.setter
    def trainer(self, trainer) -> None:
        self._trainer = weakref.ref(trainer)

    def __init__(self, trainer, config, newrun=True):
        self.trainer = trainer
        self.config = config
        self.newrun = newrun
        self.logdir = logdir_base(config) / trainer.run_id
        self.logdir.mkdir(parents=True, exist_ok=True)
        if newrun:
            cfg = config.to_dict()
            (self.logdir / "config.toml").write_text(dumps_toml(cfg))
            (self.logdir / "config.json").write_text(json.dumps(cfg, indent="\t"))

    def save_state(self, name: str, async_: bool = True) -> None:
        ckptdir = self.logdir / "checkpoints"
        ckptdir.mkdir(parents=True, exist_ok=True)
        save_checkpoint(
            ckptdir / f"{name}.ckpt", self.trainer.checkpoint_params(),
            meta={"run_id": self.trainer.run_id, "epoch": self.trainer.epoch,
                  "step": self.trainer.step,
                  # so a resumed run does not demote ``best`` to a worse epoch
                  "best_score": float(self.trainer.best_score),
                  "datetime": datetime.now().isoformat()},
            async_=async_)

    def update_config(self, cfg) -> None:
        if not isinstance(cfg, dict):
            cfg = cfg.to_dict()
        path = self.logdir / "config-updates.toml"
        if path.exists():
            cfg = tomllib.loads(path.read_text()) | cfg
        path.write_text(dumps_toml(cfg))
        (self.logdir / "config-updates.json").write_text(json.dumps(cfg, indent="\t"))

    def log_end(self) -> None:
        pass

    def log_scores(self, scores=None, **kwscores) -> None:
        pass

    def log_figure(self, fig, name: str) -> None:
        pass

    def summarized_config_flat(self) -> dict:
        cfg = flatten_dict(summarize_config(self.config).to_dict())
        return {k: (", ".join(map(str, v)) if isinstance(v, list) else v)
                for k, v in cfg.items()}
