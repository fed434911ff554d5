"""Training CLI of the port (the root ``train.py``'s, on a CUDA card):

    python -m medtsllm_tpu_torch.train <config.toml> [run_id] [--device cpu]

Trains ``config.toml`` (a new run id when none is given), tests the last
weights, waits for the checkpoint writes and prints the test scores and the
run id. ``--device cpu`` runs on the CPU (the kernels' plain versions);
nothing drops to the CPU on its own.
"""

from __future__ import annotations

import sys

from .config import load_config
from .tasks import get_trainer
from .utils import get_run_id


def main(config_path, run_id=None, device="cuda"):
    config = load_config(config_path)
    run_id = run_id or get_run_id(config)
    trainer = get_trainer(run_id, config, device=device)

    trainer.train()
    test_scores = trainer.test()
    trainer.log_end()

    print("Test results:", test_scores)
    print("Run ID:", run_id)
    return test_scores


def _split_device(argv: list[str]) -> tuple[list[str], str]:
    """(the positional arguments, the ``--device`` value or "cuda")."""
    args, device = list(argv), "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    return args, device


if __name__ == "__main__":
    args, device = _split_device(sys.argv[1:])
    match args:
        case [config_path, run_id]:
            main(config_path, run_id, device=device)
        case [config_path]:
            main(config_path, device=device)
        case []:
            main("configs/config.toml", device=device)
        case _:
            raise ValueError("usage: train.py <config.toml> [run_id] [--device cpu]; "
                             f"got {sys.argv[1:]}")
