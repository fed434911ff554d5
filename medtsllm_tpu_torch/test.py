"""Evaluation CLI of the port (the root ``test.py``'s, on a CUDA card):
rebuild a run from its run id and score a checkpoint on the test or val
split.

    python -m medtsllm_tpu_torch.test <run_id> [split] [ckpt] [basepath] [--device cpu]

``split`` is ``test`` (the default) or ``val``, ``ckpt`` ``latest`` (the
default) or ``best``, ``basepath`` the logdir holding ``<run_id>/``
(``./outputs/logs`` by default).
"""

from __future__ import annotations

import sys
import tomllib
from pathlib import Path

from .tasks import task_lookup
from .train import _split_device


def main(run_id, split="test", save_id=None, _basepath=None, device="cuda"):
    basepath = Path(_basepath) if _basepath is not None else Path.cwd() / "outputs" / "logs"
    config = tomllib.loads((basepath / run_id / "config.toml").read_text())
    trainer = task_lookup[config["task"]].from_run_id(run_id, ckpt=save_id,
                                                      basepath=_basepath, device=device)
    if split == "test":
        scores = trainer.test()
    elif split == "val":
        scores = trainer.val()
    else:
        raise ValueError(f"Invalid split selected for testing: {split}")

    print("Results:", scores)
    print("Run ID:", run_id)
    return scores


if __name__ == "__main__":
    args, device = _split_device(sys.argv[1:])
    if not 1 <= len(args) <= 4:
        raise ValueError("Invalid number of arguments")
    main(*args, device=device)
