"""Tracing and NaN checks (port of ``medtsllm_tpu/runtime/profiler.py``).

Two facilities, both set under ``[setup]``:
  - ``profile_dir``: a ``torch.profiler`` trace (CPU and CUDA activities) of
    one steady-state train step, written as a Chrome trace into the
    directory (viewable in Perfetto or ``chrome://tracing``); the trainer
    traces step 2 of ``train()`` (counted from 0; on a card a replay of the
    captured step), as JAX's trainer does;
  - ``debug_nans``: the counterpart of ``jax_debug_nans``: the trainer
    raises ``FloatingPointError`` at the first train or eval step whose
    loss, output or updated parameters hold a NaN (a host check after the
    step or its replay, made only when the key is set).

Plus a step timer for throughput lines.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

TRACE_NAME = "train_step2.trace.json"


def configure_from(config) -> bool:
    """``setup.debug_nans`` -> whether the trainer checks its steps for
    NaNs."""
    return bool(config.get("setup", {}).get("debug_nans", False))


@contextlib.contextmanager
def trace(profile_dir: str | None, name: str = TRACE_NAME):
    """A ``torch.profiler`` trace of the region, CPU and (when a card is
    present) CUDA activities, exported as ``<profile_dir>/<name>``; with
    ``profile_dir`` None (or empty) nothing is traced. The region should
    synchronize the device before it ends, so its kernels are in the
    trace."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(profile_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / name))


def check_finite(what: str, *tensors) -> None:
    """Raise ``FloatingPointError`` if any of ``tensors`` (tensors or
    iterables of them; None entries skipped) holds a NaN. One host read."""
    flat = []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            flat.append(t)
        elif t is not None:
            flat.extend(x for x in t if x is not None)
    if not flat:
        return
    bad = [torch.isnan(t.detach()).any() for t in flat if t.is_floating_point()]
    if bad and bool(torch.stack(bad).any()):
        raise FloatingPointError(f"setup.debug_nans: NaN in the {what}")


class StepTimer:
    """Wall-clock step timing with device sync; reports windows/sec."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None):
        if sync_on is not None:
            # the step's result read back to the host: its work has run
            sync_on.reshape(-1)[:1].cpu()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)  # drop the warm-up step
        return {
            "steps": len(t),  # the stat basis (warm-up step excluded)
            "p50_step_s": float(np.percentile(t, 50)),
            "windows_per_sec": float(self.batch_size / np.percentile(t, 50)),
        }
