#!/usr/bin/env python3
"""Profile the PyTorch port's serving step, or a train step, on one CUDA
card.

    python3 tools/torch_profile_serving.py [--path mamba|llama|moe|llama-int4|moe-int4|
                                                   llama-long|bidmc|ecgmit-anom|ventilator|
                                                   ecgmit-seg|ludb|forecasting|
                                                   classification|imputation|mamba-train|
                                                   llama-train|bidmc-train|ecgmit-seg-train|
                                                   forecasting-train|classification-train|
                                                   imputation-train|moe-train|bidmc-gpt4ts|
                                                   bidmc-gpt4ts-train]
                                           [--steps 4] [--eager]

Builds the trainer of ``chip_smoke.py`` (the same configuration and random
weights from its seed; ``llama-int4`` and ``moe-int4`` load the backbone in
4 bits, absmax int4, as chip_smoke phases 14 and 15; ``llama-long`` is the
long window of phase 17, history 16384 with d_ff 64, two test batches of 8,
whose decoder attention runs on K4; ``bidmc``, ``ecgmit-anom``,
``ventilator``, ``ecgmit-seg`` and ``ludb`` are the task paths of phases
6a-6c, 6e and 6f under ``mixed`` (ventilator and ecgmit-seg on clips, their
per-clip heads gathered from the KV bank inside the step), ``forecasting``,
``classification`` and ``imputation`` the served task blocks of phases
6g-6i; ``-train`` names the train step of phase 8 (``mamba-train``), 9
(``llama-train``, the 7B w8a8 finetune), 6a, 6e and 6g-6i at four batches
an epoch; ``moe-train`` is phase 8b's, configs/ablation/moe-backbone.toml
as shipped on the capacity path; ``bidmc-gpt4ts`` and its ``-train`` are
phase 6p's configs/baseline-models/bidmc-gpt4ts.toml as shipped). For a serving path it runs one warm-up ``test()``
pass (it builds the kernels and the prompt-head cache and captures the
step's CUDA graph), prepares ``--steps`` test batches on the host, then
runs their eval steps under ``torch.profiler``: the graph's replays, as
serving runs them, or with ``--eager`` the step op by op
(``eval_step_eager``). For a train path it prepares ``--steps`` + 1
shuffled train batches, epoch after epoch (the prompt-head or prompt-state
cache included), runs one warm-up step (``train_step``: the capture of its
CUDA graph) and profiles the next ``--steps`` train steps (forward,
backward, clip, Adam): the graph's replays, or with ``--eager`` the step
op by op (``train_step_eager``). Prints the card, the host-clock time of each
step, the device's busy time and idle share over the profiled span (first
event to last kernel end), the device time and launch count by category,
the top kernels by device time and every depthwise-conv kernel. Writes the
Chrome trace to ``chiprun_out/torch_profile_<path>.json``.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# device kernels by name, first match wins
CATEGORIES = (
    ("selective scan backward (K10)", r"selective_scan_bwd"),
    ("selective scan", r"selective_scan"),
    ("K6 grouped matmul (GEMM)", r"gmm_kernel"),
    ("K6 requant pass", r"requant_kernel"),
    ("K5 w4a8", r"w4a8"),
    ("K3 reprogramming", r"reprogramming"),
    ("K1 w8a8", r"w8a8|act_quant"),
    ("K2 rope attention", r"rope_attention"),
    ("K4 route pre-pass (keys rotated, prefix put ahead)", r"flash_keys"),
    ("K4 flash attention", r"flash_wgmma|flash_f32|rotate_rows"),
    ("GEMM (cuBLAS)", r"gemm|gemv|xmma|cutlass|cublas|splitK|nvjet"),
    ("depthwise conv", r"conv|cudnn|depthwise|implicit"),
    ("MoE router / pack (sort, gather, scatter, cumsum, softmax)",
     r"sort|index|scatter|gather|cumsum|scan_innermost|scan_outer|searchsorted|softmax"),
    # (not "nocast": PyTorch's elementwise kernels carry gpu_kernel_impl_nocast
    # in their names)
    ("copy / cast", r"copy|(?<!no)cast|Memcpy|Memset"),
    ("optimizer (Adam)", r"multi_tensor|adam"),
)


def category(name: str) -> str:
    for label, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other elementwise / reduction"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("mamba", "llama", "moe", "llama-int4", "moe-int4",
                                       "llama-long", "bidmc", "ecgmit-anom", "ventilator",
                                       "ecgmit-seg", "ludb", "forecasting", "classification",
                                       "imputation", "mamba-train", "llama-train",
                                       "bidmc-train", "ecgmit-seg-train", "forecasting-train",
                                       "classification-train", "imputation-train",
                                       "moe-train", "bidmc-gpt4ts", "bidmc-gpt4ts-train"),
                    default="mamba")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--eager", action="store_true",
                    help="profile the step op by op, not its CUDA graph")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_serving: no CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.tasks import get_trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    train = args.path.endswith("-train")
    served = chip_smoke.SERVED_POINTS

    def task_block(block, suffix):
        toml, n_features, (n_train, n_served) = chip_smoke.TASK_BLOCKS[block]
        return chip_smoke.task_block_config(Config, toml, n_train if suffix else n_served,
                                            n_features)
    cfg = {"mamba": lambda: chip_smoke.mamba_config(Config),
           "llama": lambda: chip_smoke.bench_config(Config),
           "moe": lambda: chip_smoke.moe_config(Config),
           "llama-int4": lambda: chip_smoke.bench_config(Config, quant_type="int4"),
           "moe-int4": lambda: chip_smoke.moe_config(Config, int4=True),
           "llama-long": lambda: chip_smoke.long_config(Config),
           # four train batches of 48 per epoch, as chip_smoke phase 8
           "mamba-train": lambda: chip_smoke.mamba_config(Config, n_points=24704, epochs=1),
           "bidmc": lambda: chip_smoke.task_config(Config, chip_smoke.BIDMC_TOML,
                                                   n_points=served[256]),
           "ecgmit-anom": lambda: chip_smoke.task_config(Config, chip_smoke.ECG_ANOM_TOML,
                                                         n_points=served[128]),
           "ventilator": lambda: chip_smoke.task_config(Config, chip_smoke.VENTILATOR_TOML,
                                                        n_points=served[256], llm_layers=4,
                                                        n_clips=64),
           "ecgmit-seg": lambda: chip_smoke.task_config(
               Config, chip_smoke.ECG_SEG_TOML,
               n_points=chip_smoke.SEG_CLIPS * chip_smoke.SEG_CLIP_POINTS,
               n_clips=chip_smoke.SEG_CLIPS),
           "ludb": lambda: chip_smoke.task_config(
               Config, chip_smoke.LUDB_TOML,
               n_points=chip_smoke.LUDB_CLIPS * chip_smoke.LUDB_CLIP_POINTS,
               n_clips=chip_smoke.LUDB_CLIPS, n_features=1, n_classes=4),
           # four train batches of 16 per epoch, as chip_smoke phase 6a
           "bidmc-train": lambda: chip_smoke.task_config(Config, chip_smoke.BIDMC_TOML,
                                                         n_points=8320),
           # three train batches of 8, as chip_smoke phase 9
           "llama-train": lambda: chip_smoke.bench_config(Config, n_points=3200),
           # 32 clips, four train batches of 16, as chip_smoke phase 6e
           "ecgmit-seg-train": lambda: chip_smoke.task_config(
               Config, chip_smoke.ECG_SEG_TOML, n_points=32 * 512, n_clips=32),
           # the shipped files of phases 8b and 6p, on their stand-ins
           "moe-train": lambda: chip_smoke.shipped_config(Config, chip_smoke.MOE_TOML),
           **{f"bidmc-gpt4ts{suffix}": functools.partial(
               chip_smoke.baseline_config, Config, chip_smoke.GPT4TS_TOMLS["bidmc-gpt4ts"])
              for suffix in ("", "-train")},
           **{f"{name}{suffix}": functools.partial(task_block, block, suffix)
              for name, block in (("forecasting", "bidmc-forecast"),
                                  ("classification", "dreams-classification"),
                                  ("imputation", "etth1-imputation"))
              for suffix in ("", "-train")},
           }[args.path]()
    trainer = get_trainer(f"profile-{args.path}", cfg, device=dev)
    if train:
        epochs = itertools.chain.from_iterable(itertools.repeat(trainer.train_pipeline))
        batches = list(itertools.islice(epochs, args.steps + 1))
        prepared = [trainer.train_model_inputs(b) for b in batches]
        step = trainer.train_step_eager if args.eager else trainer.train_step
        step(prepared[0], prepared[0]["valid"])  # warm-up (the capture)
        prepared = prepared[1:]

        def run(a):
            step(a, a["valid"])
    else:
        trainer.test()  # warm-up: kernels built, the prompt-head cache filled
        batches = [b for _, b in zip(range(args.steps), trainer.test_pipeline)]
        prepared = [trainer.eval_prepare(b) for b in batches]

        def run(p):
            if args.eager:
                trainer.eval_step_eager(p[1])
            else:
                trainer.eval_dispatch(prepared=p)
    torch.cuda.synchronize()

    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for p in prepared:
            t0 = time.perf_counter()
            run(p)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    bsz = cfg.training.batch_size
    kind = (("eager " if args.eager else "graphed ")
            + ("train" if train else "eval"))
    print(f"[profile] {args.path}: {len(step_ms)} {kind} steps of "
          f"batch {bsz}, host clock ms {step_ms} (p50 {statistics.median(step_ms):.3f})")

    events = list(prof.events())
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("torch_profile_serving: the trace holds no device kernels")
    span_start = min(e.time_range.start for e in events)
    span_end = max(e.time_range.end for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None  # union of the kernels' intervals
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    span = span_end - span_start
    print(f"[profile] device busy {busy / 1e3:.3f} of {span / 1e3:.3f} ms, idle share "
          f"{1 - busy / span:.4f}")

    by_cat: dict[str, list[float]] = {}
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        for table, key in ((by_cat, category(e.name)), (by_name, e.name)):
            acc = table.setdefault(key, [0.0, 0])
            acc[0] += dur
            acc[1] += 1
    n = len(step_ms)
    print("[profile] device time per step by category (ms, launches):")
    for key, (us, cnt) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"  {key:32s} {us / 1e3 / n:9.4f} ms {cnt // n:6d} launches "
              f"({us / busy:.3f} of busy)")
    print("[profile] top kernels per step (ms, launches):")
    for key, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3 / n:9.4f} ms {cnt // n:6d}  {key[:110]}")
    print("[profile] depthwise conv kernels per step (forward and, in training, backward):")
    for key, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if category(key) == "depthwise conv":
            print(f"  {us / 1e3 / n:9.4f} ms {cnt // n:6d}  {key[:110]}")
    out = ROOT / "chiprun_out" / f"torch_profile_{args.path}.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    print(f"[profile] trace {out.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
