"""Task runtimes (port of ``medtsllm_tpu/tasks``): reconstruction, anomaly
detection, segmentation, semantic segmentation, forecasting,
classification, imputation and pretraining."""

from __future__ import annotations

from .anomaly_detection import AnomalyDetectionTask
from .classification import ClassificationTask
from .forecasting import ForecastTask
from .imputation import ImputationTask
from .pretraining import PretrainingTask
from .reconstruction import ReconstructionTask
from .segmentation import SegmentationTask
from .semantic_segmentation import SemanticSegmentationTask

task_lookup = {"reconstruction": ReconstructionTask,
               "anomaly_detection": AnomalyDetectionTask,
               "segmentation": SegmentationTask,
               "semantic_segmentation": SemanticSegmentationTask,
               "forecasting": ForecastTask,
               "classification": ClassificationTask,
               "imputation": ImputationTask,
               "pretraining": PretrainingTask}


def get_trainer(run_id, config, device="cuda"):
    """The task runtime for ``config`` on ``device`` (``"cuda"`` raises
    without a card; nothing drops to the CPU on its own)."""
    if config.task not in task_lookup:
        raise ValueError(f"unknown task {config.task!r}; the tasks are {sorted(task_lookup)}")
    return task_lookup[config.task](run_id, config, device=device)
