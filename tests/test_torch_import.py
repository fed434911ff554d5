"""The PyTorch port imports no jax: every module of ``medtsllm_tpu_torch``
is imported in a fresh interpreter (this process already holds jax, see
conftest.py), which then must not have jax, flax or the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import medtsllm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from medtsllm_tpu_torch.models.llm.tokenizer import get_tokenizer
get_tokenizer("llama-tiny", None, vocab_size=512).encode("Dataset: probe 1.0")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "medtsllm_tpu"))
print(" ".join(names), "|", leaked)
"""

# every module of the training, MoE, int4 and long-window slices among them
_TRAIN_MODULES = {"medtsllm_tpu_torch.runtime.optim", "medtsllm_tpu_torch.tasks.losses",
                  "medtsllm_tpu_torch.ops.kernels.selective_scan",
                  "medtsllm_tpu_torch.ops.kernels.w8a8",
                  "medtsllm_tpu_torch.ops.kernels.w4a8",
                  "medtsllm_tpu_torch.ops.kernels.rope_attention",
                  "medtsllm_tpu_torch.ops.kernels.flash_attention",
                  "medtsllm_tpu_torch.ops.kernels.grouped_matmul"}


def test_port_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.strip().split(" | ")
    names = set(names.split())
    assert len(names) >= 18 and _TRAIN_MODULES <= names  # every module was imported
    assert leaked == "[]", leaked
