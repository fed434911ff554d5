#!/usr/bin/env python3
"""Times K1's two row quantizers of the PyTorch port on one CUDA card at the
shapes the main paths give them.

    python3 tools/torch_quant_bench.py [--root DIR] [--ptxas]

The activation rows (``quantize_rows``) over one decoder block of each
served model, as chip_smoke.py's ``check_k1`` records list them: the 7B
(M 896), moe-8x1b (M 6,912), the long window (M 17,024), gpt2 (M 1,792),
flan-t5-base's decoder (M 512) and encoder (M 1,024) and mamba-130m (M
6,912) rows, each block's calls at their input dtype and width. The int8
dx's gradient rows (``quantize_grad_rows``): a 7B block's seven (bf16 g,
N 4096 x 5 and 11,008 x 2, one scale row), as phase 9b runs them, and the
moe-8x1b dh's 17,280 rows (E 8 x C 2,160, f32 g, N 5,632, a scale row an
expert). Each time is device time (chip_smoke's ``queued_ms``: 20 calls
queued behind a sleeping kernel, after 3 warm-ups), summed over the
block's calls; beside it the bound (chip_smoke's ``bound``: each input
byte read once, the codes and scales written once, over 3.35 TB/s), the
share bound / time, the worst |kernel - plain| of codes and scales over
the block's calls on the same inputs, which must be 0, and each call's
time with the kernel ``quant_plan`` picks for it (tile or row-group).

Then down_proj's bf16 rows (K 11,008) at M 896 and 17,024 on both of the
port's kernels (the tile kernel, and the row-group kernel that reads a row
twice at this width), and the device's launch floor (a 1-element fill).

``--root DIR`` imports the port from another checkout of the repository
(a parent commit unpacked beside this one), so that two versions are timed
in one call: run parent, change, change, parent. ``--ptxas`` first compiles
``csrc/w8a8.cu`` with ``-Xptxas -v`` and prints each quantizer instance's
registers and spills. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (label, M, ((dtype, K, calls a block), ...)): chip_smoke.py's check_k1 records
ACT = (("7B", 896, (("f32", 4096, 5), ("bf16", 4096, 1), ("bf16", 11008, 1))),
       ("moe-8x1b", 6912, (("f32", 2048, 3), ("bf16", 2048, 2))),
       ("long", 17024, (("f32", 4096, 5), ("bf16", 4096, 1), ("bf16", 11008, 1))),
       ("gpt2", 1792, (("bf16", 768, 3), ("bf16", 3072, 1))),
       ("t5", 512, (("f32", 768, 6), ("bf16", 768, 2), ("bf16", 2048, 1))),
       ("t5-enc", 1024, (("f32", 768, 7), ("bf16", 768, 1), ("bf16", 2048, 1))),
       ("mamba-130m", 6912, (("f32", 768, 1), ("bf16", 1536, 2))))
# (label, M, scale rows, ((dtype, N, calls a block), ...))
GRAD = (("dx 7B", 896, 1, (("bf16", 4096, 5), ("bf16", 11008, 2))),
        ("dh moe-8x1b", 17280, 8, (("f32", 5632, 1),)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="import medtsllm_tpu_torch from this checkout")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from chip_smoke import bound, queued_ms
    from medtsllm_tpu_torch.ops.kernels import _build
    from medtsllm_tpu_torch.ops.kernels import w8a8 as k1

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(f"port: {Path(k1.__file__).resolve().parents[2]}")
    if args.ptxas:
        ptxas_report(_build)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def path(M, K, dt, E):
        """The kernel the port's plan picks (a parent checkout has no plan)."""
        if not hasattr(k1, "quant_plan"):
            return "-"
        R, S, unit, warps, groups = k1.quant_plan(K, M, dtypes[dt].itemsize, (), K, E)
        return f"tiles R {R} S {S}" if R else f"rows unit {unit} W {warps} G {groups}"

    def report(label, M, calls, run, plain, nbytes, E=0):
        dev_ms = err = 0.0
        each = []
        for dt, K, n in calls:
            out, ref = run(dt, K), plain(dt, K)
            err = max(err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(out, ref)))
            each.append(queued_ms(torch, lambda: run(dt, K)))
            dev_ms += n * each[-1]
        bnd = bound(sum(n * nbytes(dt, K) for dt, K, n in calls), 0, "int8")[0]
        print(f"[quant] {label} (M {M}; {', '.join(f'{n} x {dt} {K}' for dt, K, n in calls)}): "
              f"device {dev_ms:.4f} ms a block, bound {bnd:.4f} ms (bytes), share "
              f"{bnd / dev_ms:.2f}, max |kernel - plain| {err:.3e}; a call "
              f"{' / '.join(f'{ms:.4f}' for ms in each)} ms "
              f"({' / '.join(path(M, K, dt, E) for dt, K, _ in calls)})")
        if err:
            raise SystemExit(f"{label}: the kernel is not bit-equal to its plain version")

    for label, M, calls in ACT:
        xs = {(dt, K): torch.randn(M, K, device=dev, generator=g).to(dtypes[dt])
              for dt, K, _ in calls}
        report(label, M, calls, lambda dt, K: k1.quantize_rows(xs[dt, K]),
               lambda dt, K: k1.quantize_rows_plain(xs[dt, K]),
               lambda dt, K: M * K * xs[dt, K].element_size() + M * K + M * 4)
        del xs
    for label, M, E, calls in GRAD:
        gs = {(dt, N): (torch.randn(M, N, device=dev, generator=g).to(dtypes[dt]),
                        torch.rand(E, N, device=dev, generator=g) * 1e-2 + 1e-4)
              for dt, N, _ in calls}

        def scale(dt, N):
            return gs[dt, N][1] if E > 1 else gs[dt, N][1][0]
        report(f"{label}, {E} scale row{'s' if E > 1 else ''}", M, calls,
               lambda dt, N: k1.quantize_grad_rows(gs[dt, N][0], scale(dt, N), N),
               lambda dt, N: k1.quantize_grad_rows_plain(gs[dt, N][0], scale(dt, N), N),
               lambda dt, N: (M * N * gs[dt, N][0].element_size() + E * N * 4 + M * N
                              + M * 4), E)
        del gs
    if hasattr(k1, "quant_plan"):
        wide_rows(torch, dev, g, k1, _build, queued_ms)
    tiny = torch.zeros(1, device=dev)
    print(f"[floor] a 1-element fill: {queued_ms(torch, lambda: tiny.fill_(1.0)):.4f} ms a "
          "launch (device time, queued)")
    torch.cuda.synchronize()


def wide_rows(torch, dev, g, k1, _build, queued_ms):
    """down_proj's bf16 rows (K 11,008) at the 7B's and the long window's M
    on both kernels, through the C entry with each plan: the tile kernel
    (the plan's) and the row-group kernel's vector instance (16 warps a
    row, read twice), each held bit-equal to the plain version."""
    K = 11008
    for M in (896, 17024):
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        ref = k1.quantize_rows_plain(x)
        times = []
        for plan in (k1.quant_plan(K, M, 2), (0, 0, 8, 16, 1)):
            xq = torch.empty(M, K, dtype=torch.int8, device=dev)
            xs = torch.empty(M, dtype=torch.float32, device=dev)

            def run():
                _build.launch("mt_act_quant_rows", dev, _build.ptr(x), 1, _build.ptr(xq),
                              _build.ptr(xs), M, K, *plan)
            run()
            if not (torch.equal(xq, ref[0]) and torch.equal(xs, ref[1])):
                raise SystemExit(f"wide rows, plan {plan}: not bit-equal")
            times.append(queued_ms(torch, run))
        print(f"[wide] bf16 K {K}, M {M}: tile kernel {times[0]:.4f} ms, row-group kernel "
              f"(16 warps, read twice) {times[1]:.4f} ms a call; bit-equal")


def ptxas_report(_build) -> None:
    src = _build.CSRC / "w8a8.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          "-o", "/dev/null", str(src)], capture_output=True, text=True)
    name = ""
    for ln in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if "quant_rows" in m.group(1) else ""
        if name and ("registers" in ln or "spill" in ln):
            print(f"[ptxas] {name}: {ln.strip()}")
    if out.returncode:
        raise SystemExit(f"nvcc failed: {out.returncode}\n{out.stderr[-4000:]}")


if __name__ == "__main__":
    main()
