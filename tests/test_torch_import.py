"""The PyTorch port imports no jax: every module of ``medtsllm_tpu_torch``
is imported in a fresh interpreter (this process already holds jax, see
conftest.py), which then must not have jax, flax or the JAX package, nor
scikit-learn, matplotlib or tensorboard, which the card's machine lacks
(the task modules compute their metrics in numpy and scipy); nor jax after
the tokenizer has run. And with pandas, scikit-learn, tensorboard,
matplotlib and wandb blocked, which the card's machine lacks too, every
module imports (the checkpoint, logger and CLI modules among them) and the
readers, a stand-in, the Bayesian threshold search and the loggers' run
directory run."""

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
# the modules themselves: none of these
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "medtsllm_tpu", "sklearn",
                                       "matplotlib", "tensorboard"))
from medtsllm_tpu_torch.models.llm.tokenizer import get_tokenizer
get_tokenizer("llama-tiny", None, vocab_size=512).encode("Dataset: probe 1.0")
# a tokenizer from the installed transformers may import scikit-learn; no jax
leaked += sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "medtsllm_tpu"))
print(" ".join(names), "|", leaked)
"""

# every module of the training, MoE, int4, long-window and task slices among them
_TRAIN_MODULES = {"medtsllm_tpu_torch.runtime.optim", "medtsllm_tpu_torch.tasks.losses",
                  "medtsllm_tpu_torch.tasks.segmentation",
                  "medtsllm_tpu_torch.tasks.anomaly_detection",
                  "medtsllm_tpu_torch.tasks.semantic_segmentation",
                  "medtsllm_tpu_torch.tasks.metrics", "medtsllm_tpu_torch.tasks.postproc",
                  "medtsllm_tpu_torch.config",
                  "medtsllm_tpu_torch.ops.kernels.selective_scan",
                  "medtsllm_tpu_torch.ops.kernels.w8a8",
                  "medtsllm_tpu_torch.ops.kernels.w4a8",
                  "medtsllm_tpu_torch.ops.kernels.rope_attention",
                  "medtsllm_tpu_torch.ops.kernels.flash_attention",
                  "medtsllm_tpu_torch.ops.kernels.grouped_matmul"}
# the run lifecycle: checkpoints, the loggers, the CLIs
_LIFECYCLE_MODULES = {"medtsllm_tpu_torch.runtime.checkpoint", "medtsllm_tpu_torch.utils",
                      "medtsllm_tpu_torch.loggers", "medtsllm_tpu_torch.loggers.base",
                      "medtsllm_tpu_torch.loggers.print_logger",
                      "medtsllm_tpu_torch.loggers.debug_logger",
                      "medtsllm_tpu_torch.loggers.tensorboard_logger",
                      "medtsllm_tpu_torch.loggers.wandb_logger",
                      "medtsllm_tpu_torch.train", "medtsllm_tpu_torch.test"}


def test_port_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.strip().split(" | ")
    names = set(names.split())
    # every module was imported
    assert len(names) >= 18 and _TRAIN_MODULES <= names and _LIFECYCLE_MODULES <= names
    assert leaked == "[]", leaked


_BLOCKED = """
import sys
for name in ("pandas", "sklearn", "tensorboard", "torch.utils.tensorboard", "matplotlib",
             "wandb"):
    sys.modules[name] = None  # any import of them raises ImportError
import importlib, pkgutil, tempfile, warnings
import numpy as np
import medtsllm_tpu_torch as pkg
import medtsllm_tpu_torch.data.readers as readers
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.data import get_dataset
from medtsllm_tpu_torch.data.readers.table import Table
from medtsllm_tpu_torch.tasks.bayesopt import BayesianOptimization
with tempfile.TemporaryDirectory() as root:
    cfg = Config({"task": "segmentation", "history_len": 64, "pred_len": 64,
                  "data": {"dataset": "bidmc", "mode": "multivariate", "cols": "all",
                           "normalize": True, "step": 32},
                  "tasks": {"segmentation": {"mode": "boundary-prediction"}},
                  "paths": {"data": root}, "model": "medtsllm", "models": {}})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ds = get_dataset(cfg, "test")
    with open(root + "/t.csv", "w") as f:
        f.write("a,b\\n1.5,2\\n")
    assert Table(root + "/t.csv").floats("a")[0] == 1.5
opt = BayesianOptimization(lambda q: -(q - 0.7) ** 2, {"q": (0.5, 1.0)})
opt.maximize(init_points=3, n_iter=3)
readers_loaded = sorted(m for m in sys.modules if m.startswith("medtsllm_tpu_torch.data.readers."))
from medtsllm_tpu_torch.loggers import get_logger
from medtsllm_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
import torch
class Trainer:  # what a logger reads of its trainer
    run_id, epoch, step, best_score = "probe", 1, 0, float("inf")
    def checkpoint_params(self):
        return {"w": torch.ones(2)}
with tempfile.TemporaryDirectory() as root:
    trainer = Trainer()
    for kind in ("tensorboard", "wandb"):
        cfg = Config({"setup": {"logger": kind}, "paths": {"logdir": root}})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            logger = get_logger(trainer, cfg)
        assert type(logger).__name__ == "PrintLogger" and any(
            "tensorboard not installed" in str(w.message) for w in caught)
    logger.save_state("latest", async_=False)
    state, meta = load_checkpoint(root + "/probe/checkpoints/latest.ckpt")
    assert meta["epoch"] == 1 and torch.equal(state["w"], torch.ones(2))
print(len(names), len(ds), len(readers_loaded), round(opt.max["params"]["q"], 3))
"""


def test_port_runs_without_pandas_or_sklearn():
    """The card's machine has none of pandas, scikit-learn, tensorboard,
    matplotlib and wandb: with them blocked, every module imports, each
    reader with them, a family's stand-in is built, a CSV is read, the
    Bayesian threshold search runs, and the tensorboard and wandb loggers
    fall back to the print logger, which writes the run directory and a
    checkpoint."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, n_windows, n_readers, q = out.stdout.strip().splitlines()[-1].split()
    assert int(n_modules) >= 30 and int(n_windows) > 0 and int(n_readers) >= 10
    assert 0.5 <= float(q) <= 1.0
