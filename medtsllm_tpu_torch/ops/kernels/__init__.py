"""Hand-written Hopper kernels (``csrc/*.cu``), each beside its plain
PyTorch version. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

Importing the package registers every forward kernel's ``torch.library``
custom op (``medtsllm::...``: the CUDA kernel the launch, the CPU kernel
the plain version), which an exported program (``runtime/export.py``)
calls; nothing of the model code is imported.
"""

from . import (flash_attention, grouped_matmul, reprogramming,  # noqa: F401
               rope_attention, selective_scan, w4a8, w8a8)
