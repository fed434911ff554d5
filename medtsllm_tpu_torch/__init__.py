"""medtsllm_tpu_torch — the PyTorch/CUDA port of ``medtsllm_tpu`` for one
NVIDIA Hopper card.

The JAX package beside it is the reference: each ported module matches its
JAX counterpart given the same weights and inputs (tests/test_torch_*.py).
Every Pallas kernel on the ported path is a hand-written CUDA kernel for
sm_90a under ``csrc/``, built with nvcc at first use
(ops/kernels/_build.py). This package imports no jax.

Slice 1 covers the MedTsLLM serving path on the reconstruction task:
``tasks.get_trainer(run_id, config, device=...).test()``.
"""

__version__ = "0.1.0"
