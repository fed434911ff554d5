#!/usr/bin/env python3
"""Wall windows/s of the port's ``test()``, pass after pass, on one CUDA card.

    python3 tools/torch_serving_passes.py [--root DIR] [--path llama,mamba,moe]
                                          [--passes 3]

Builds each served path's trainer as ``chip_smoke.py`` does (its
configuration and seeded random weights), taken from the checkout at
``--root`` (default: this one, so an unpacked copy of another commit can be
timed by the same script), and runs ``test()`` ``--passes`` times. Prints
the card and power limit, then one JSON line per path: the windows/s of
each pass by the host's clock (the first pass builds the prompt-head cache
and, where the checkout has one, captures the step's CUDA graph) and the
graphs held after.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--path", default="llama,mamba,moe")
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_serving_passes: torch.cuda.is_available() is false")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.tasks import get_trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    configs = {"llama": lambda: chip_smoke.bench_config(Config),
               "mamba": lambda: chip_smoke.mamba_config(Config),
               "moe": lambda: chip_smoke.moe_config(Config)}
    dev = torch.device("cuda", 0)
    for path in args.path.split(","):
        tr = get_trainer(f"passes-{path}", configs[path](), device=dev)
        rates = []
        for _ in range(args.passes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.test()
            torch.cuda.synchronize()
            rates.append(len(tr.test_dataset) / (time.perf_counter() - t0))
        graphs = getattr(tr, "step_graphs", None)
        print(json.dumps({"root": args.root, "path": path, "windows_per_s": rates,
                          "graphs": None if graphs is None else len(graphs)}), flush=True)
        del tr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
