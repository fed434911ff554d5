"""Task runtimes (port of ``medtsllm_tpu/tasks``): reconstruction, anomaly
detection, segmentation, semantic segmentation, forecasting,
classification and imputation."""

from __future__ import annotations

from .anomaly_detection import AnomalyDetectionTask
from .classification import ClassificationTask
from .forecasting import ForecastTask
from .imputation import ImputationTask
from .reconstruction import ReconstructionTask
from .segmentation import SegmentationTask
from .semantic_segmentation import SemanticSegmentationTask

task_lookup = {"reconstruction": ReconstructionTask,
               "anomaly_detection": AnomalyDetectionTask,
               "segmentation": SegmentationTask,
               "semantic_segmentation": SemanticSegmentationTask,
               "forecasting": ForecastTask,
               "classification": ClassificationTask,
               "imputation": ImputationTask}


def get_trainer(run_id, config, device="cuda"):
    """The task runtime for ``config`` on ``device`` (``"cuda"`` raises
    without a card; nothing drops to the CPU on its own)."""
    if config.task not in task_lookup:
        raise NotImplementedError(
            f"task {config.task!r}: the port serves {sorted(task_lookup)}; pretraining mixes "
            "the ECG, ventilator, bidmc and ludb families (ROADMAP queue 1, \"The file "
            "readers\")")
    return task_lookup[config.task](run_id, config, device=device)
