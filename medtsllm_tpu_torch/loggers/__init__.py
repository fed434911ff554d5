"""Run-registry loggers (port of ``medtsllm_tpu/loggers``): ``get_logger``
picks the debug, print, tensorboard or wandb logger by ``DEBUG`` and
``setup.logger``.

One departure from JAX: where ``setup.logger = "tensorboard"`` and
tensorboard does not import (the card's machine has none, and every shipped
dataset config asks for it), the port warns once and logs as the print
logger does, the run directory and the checkpoints written as ever; JAX
would raise. As in JAX, a missing wandb falls back to tensorboard (and so,
without tensorboard either, to print).
"""

from __future__ import annotations

import warnings

from .base import BaseLogger  # noqa: F401
from .debug_logger import DebugLogger
from .print_logger import PrintLogger
from .tensorboard_logger import TensorboardLogger
from .wandb_logger import WandBLogger


def get_logger(trainer, config, newrun=True):
    if config.get("DEBUG", False):
        return DebugLogger(trainer, config, newrun)
    match config.setup.logger:
        case "wandb":
            try:
                return WandBLogger(trainer, config, newrun)
            except ImportError:
                warnings.warn("wandb not installed; falling back to tensorboard logger")
                return _tensorboard(trainer, config, newrun)
        case "tensorboard":
            return _tensorboard(trainer, config, newrun)
        case "print" | "none":
            return PrintLogger(trainer, config, newrun)
        case _:
            raise ValueError(f"Unknown logger: {config.setup.logger}")


def _tensorboard(trainer, config, newrun):
    try:
        return TensorboardLogger(trainer, config, newrun)
    except ImportError:
        warnings.warn("tensorboard not installed; logging to stdout as the print logger "
                      "does (the run directory and checkpoints are written as before)")
        return PrintLogger(trainer, config, newrun)
