#!/usr/bin/env python3
"""Eager and graphed eval-step p50 of the port's main path on one CUDA card.

    python3 tools/torch_eval_step_p50.py [--root DIR] [--steps 30]

Builds the main path's trainer as ``chip_smoke.py`` does
(``bench_config``: the Llama-2-7B-shaped w8a8 bf16 backbone, batch 8,
history 256, the prompt head cached; seeded random weights), taken from the
checkout at ``--root`` (default: this one, so an unpacked copy of another
commit is timed by the same script), prepares its first test batch and
times ``eval_step_eager`` (op by op: the host's per-call cost shows) and
``eval_step`` (the captured CUDA graph), ``--steps`` calls of each after 3
untimed, in turns, by CUDA events. Prints the card and its power limit,
then one JSON line: both p50s and every call's ms.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_eval_step_p50: torch.cuda.is_available() is false")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.tasks import get_trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    tr = get_trainer("eval-step-p50", chip_smoke.bench_config(Config), device=dev)
    _, arrays = tr.eval_prepare(next(iter(tr.test_pipeline)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    steps = {"eager": tr.eval_step_eager, "graphed": tr.eval_step}
    times = {name: [] for name in steps}
    for i in range(3 + args.steps):
        for name, step in steps.items():
            torch.cuda.synchronize()
            start.record()
            step(arrays)
            end.record()
            end.synchronize()
            if i >= 3:
                times[name].append(start.elapsed_time(end))
    print(json.dumps({"root": args.root, "batch": tr.config.training.batch_size,
                      **{f"{n}_p50_ms": statistics.median(t) for n, t in times.items()},
                      **{f"{n}_ms": t for n, t in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
