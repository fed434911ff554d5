"""Host data (port of ``medtsllm_tpu/data``): the dataset families and
their stand-ins (``readers/``), the dataset frame and the univariate view
(``base.py``), window index math and stitching (``windowing.py``),
fixed-shape batches and their prefetch (``pipeline.py``), the pretraining
mixture (``util.py``) and ``get_dataset`` (``registry.py``). The same
config gives the same arrays as the JAX package's ``get_dataset``
(tests/test_torch_tasks.py, test_torch_clip.py, test_torch_readers.py).
No pandas: the card's machine has none."""

from .base import WINDOW_LABELS, Multi2UniDataset, StandardScaler, TimeSeriesDataset  # noqa: F401
from .pipeline import ARRAY_KEYS, BatchPipeline, prefetch  # noqa: F401
from .readers import SyntheticFamily
from .registry import dataset_lookup, get_dataset  # noqa: F401
from .synthetic import (inject_anomalies, patient_descriptions, periodic_boundaries,  # noqa: F401
                        rng_for, segment_class_labels, sine_mixture)
from .util import PretrainingDataset  # noqa: F401
from .windowing import (AlignedWindows, ClipWindows, ForecastWindows,  # noqa: F401
                        UnivariateWindows, dedup_eval_series, steps_to_boundary_labels,
                        stitch_windows)

# the synthetic family under the name the port's callers use
SyntheticDataset = SyntheticFamily
