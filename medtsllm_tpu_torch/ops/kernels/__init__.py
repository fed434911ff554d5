"""Hand-written Hopper kernels (``csrc/*.cu``), each beside its plain
PyTorch version. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises."""
