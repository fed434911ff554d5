#!/usr/bin/env python3
"""Host time per call of the port's GEMM wrappers on one CUDA card.

    python3 tools/torch_host_overhead.py

Calls ``int8_gemm`` (K1's GEMM) and ``w4a8_gemm`` (K5) 500 times each at a
tiny shape (1 x 64 x 8: no device work to speak of) and prints the host
clock's time per call: the wrapper's checks, its ctypes call, the tensor
maps (K1) and the launch. It is what the host adds to each of the 224
projections of a 7B serving step.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 500


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_host_overhead: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from medtsllm_tpu_torch.ops.kernels import w4a8 as k5
    from medtsllm_tpu_torch.ops.kernels import w8a8 as k1

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    xq = torch.zeros(1, 64, dtype=torch.int8, device=dev)
    wq = torch.zeros(8, 64, dtype=torch.int8, device=dev)
    packed = torch.zeros(8, 32, dtype=torch.int8, device=dev)
    s1, s8 = torch.ones(1, device=dev), torch.ones(8, device=dev)
    for name, fn in (("int8_gemm", lambda: k1.int8_gemm(xq, wq, s1, s8, torch.bfloat16)),
                     ("w4a8_gemm", lambda: k5.w4a8_gemm(xq, packed, s1, s8, torch.bfloat16))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"[host] {name}: {(t1 - t0) / CALLS * 1e6:.1f} us per call "
              f"(host clock, {CALLS} calls)")


if __name__ == "__main__":
    main()
