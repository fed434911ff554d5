"""Task runtimes (port of ``medtsllm_tpu/tasks``): reconstruction, anomaly
detection, segmentation and semantic segmentation."""

from __future__ import annotations

from .anomaly_detection import AnomalyDetectionTask
from .reconstruction import ReconstructionTask
from .segmentation import SegmentationTask
from .semantic_segmentation import SemanticSegmentationTask

task_lookup = {"reconstruction": ReconstructionTask,
               "anomaly_detection": AnomalyDetectionTask,
               "segmentation": SegmentationTask,
               "semantic_segmentation": SemanticSegmentationTask}


def get_trainer(run_id, config, device="cuda"):
    """The task runtime for ``config`` on ``device`` (``"cuda"`` raises
    without a card; nothing drops to the CPU on its own)."""
    if config.task not in task_lookup:
        raise NotImplementedError(
            f"task {config.task!r}: the port serves {sorted(task_lookup)} (ROADMAP queue "
            "1, \"The forecasting, classification, imputation and pretraining tasks\")")
    return task_lookup[config.task](run_id, config, device=device)
