"""Run utilities (port of ``medtsllm_tpu/utils.py``): the run id."""

from __future__ import annotations

import datetime


def get_run_id(config=None) -> str:
    """A timestamp run id, ``DEBUG-`` in front under ``DEBUG = true``."""
    run_id = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if config is not None and config.get("DEBUG", False):
        run_id = "DEBUG-" + run_id
    return run_id
