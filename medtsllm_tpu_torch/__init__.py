"""medtsllm_tpu_torch — the PyTorch/CUDA port of ``medtsllm_tpu`` for one
NVIDIA Hopper card.

The JAX package beside it is the reference: each ported module matches its
JAX counterpart given the same weights and inputs (tests/test_torch_*.py).
Every Pallas kernel on the ported path is a hand-written CUDA kernel for
sm_90a under ``csrc/``, built with nvcc at first use
(ops/kernels/_build.py). This package imports no jax.

Entry points: ``python -m medtsllm_tpu_torch.train <config.toml> [run_id]``
and ``python -m medtsllm_tpu_torch.test <run_id> [split] [ckpt] [basepath]``
(the root ``train.py`` / ``test.py``'s, on a CUDA card; ``--device cpu``
for the CPU), or ``tasks.get_trainer(run_id, config, device=...)``.
"""

__version__ = "0.1.0"
