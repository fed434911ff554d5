"""The dataset families (a copy of ``medtsllm_tpu/data/readers``): each
reads its recordings' files with the standard library and numpy
(``table.py``; the card's machine has no pandas) and, when they are
absent, generates its own deterministic stand-in, bit-equal to the JAX
package's."""

from .bidmc import BIDMCFamily  # noqa: F401
from .dreams import DreamsFamily  # noqa: F401
from .ecg import ECGMITFamily  # noqa: F401
from .ett import ETTFamily  # noqa: F401
from .ludb import LUDBFamily  # noqa: F401
from .msl import MSLFamily  # noqa: F401
from .psm import PSMFamily  # noqa: F401
from .synthetic import SyntheticFamily  # noqa: F401
from .ventilator import VentilatorFamily  # noqa: F401
