"""Task runtimes (port of ``medtsllm_tpu/tasks``); the port serves the
reconstruction task."""

from __future__ import annotations

from .reconstruction import ReconstructionTask

task_lookup = {"reconstruction": ReconstructionTask}


def get_trainer(run_id, config, device="cuda"):
    """The task runtime for ``config`` on ``device`` (``"cuda"`` raises
    without a card; nothing drops to the CPU on its own)."""
    if config.task not in task_lookup:
        raise NotImplementedError(f"task {config.task!r}: the port serves "
                                  f"{sorted(task_lookup)} (ROADMAP queue 1 item 7)")
    return task_lookup[config.task](run_id, config, device=device)
