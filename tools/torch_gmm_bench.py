#!/usr/bin/env python3
"""K6 (the grouped w8a8 / w4a8 expert GEMM) at the moe-8x1b serving shape on
one CUDA card.

    python3 tools/torch_gmm_bench.py [--ptxas] [--group-m 1,4,8,16]

The T * k = 48 x 144 x 2 routed rows of one serving batch, packed per expert
over 8 experts (R_pad 14,848, gate + up K 2048 -> N 5632 twice, down K 5632
in 4 chunks -> N 2048), on a random top-2 routing and on a skewed one (every
token on experts 1 and 4), with int8 and with packed int4 experts. For each:
the kernel against its plain version (codes, scales, down output, the plain
form's s32; a disagreement exits non-zero), then CUDA-event times of the
gate+up call (the requant pass included), the requant pass alone, and the
down call, under each raster
``group_m`` given (``grouped_matmul.TILE_GROUP_M``: row tiles walked down
per column tile, for both forms; 1 = each row tile's columns in turn),
beside the int8 bound of the routed rows. ``--ptxas``
first compiles ``csrc/grouped_matmul.cu`` with ``-Xptxas -v`` and prints
each gmm instance's registers, spills and any wgmma serialization warning.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_INT8_OPS = 1979e12  # one H100 SXM, dense (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
T, E, TOP_K, D, F = 48 * 144, 8, 2, 2048, 5632
BN_F, BN_D = 1408, 1024


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3


def ptxas_report() -> None:
    from medtsllm_tpu_torch.ops.kernels import _build
    src = _build.CSRC / "grouped_matmul.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          "-o", "/dev/null", str(src)], capture_output=True, text=True)
    lines = (out.stdout + out.stderr).splitlines()
    name = ""
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        if "gmm_kernel" in name and ("registers" in ln or "spill" in ln):
            print(f"[ptxas] {name[:60]}: {ln.strip()}")
        if "serializ" in ln.lower() or "warning" in ln.lower():
            print(f"[ptxas] {ln.strip()}")
    if out.returncode:
        raise SystemExit(f"nvcc failed: {out.returncode}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--group-m", default="1,8")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_gmm_bench: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from medtsllm_tpu_torch.ops.kernels import _build
    from medtsllm_tpu_torch.ops.kernels import grouped_matmul as gm
    from medtsllm_tpu_torch.ops.kernels import w4a8 as k5

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.ptxas:
        ptxas_report()
    _build.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    group_ms = [int(x) for x in args.group_m.split(",")]
    routed = T * TOP_K
    V = gm.gmm_visits(routed, E, 128)
    R_pad = V * 128
    routings = {"random": torch.rand(T, E, device=dev, generator=g).argsort(-1)[:, :TOP_K],
                "skewed": torch.tensor([1, 4], device=dev).expand(T, TOP_K)}
    default_gm = dict(gm.TILE_GROUP_M)
    for wb in (8, 4):
        lo, hi = (-127, 128) if wb == 8 else (-8, 8)

        def weights(n_out, n_in):
            w = torch.randint(lo, hi, (E, n_out, n_in), device=dev, dtype=torch.int8,
                              generator=g)
            return w if wb == 8 else k5.pack4_split(w)
        w_g, w_u, w_d = weights(F, D), weights(F, D), weights(D, F)
        s_g, s_u, s_d = (torch.rand(E, n, device=dev, generator=g) * 1e-3 for n in (F, F, D))
        for label, top in routings.items():
            counts = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
                0, top.reshape(-1), torch.ones(routed, dtype=torch.int32, device=dev))
            ve, valid, _ = gm.gmm_metadata(counts, 128, V)
            used = int((counts > 0).sum())
            xq = torch.randint(-127, 128, (R_pad, D), device=dev, dtype=torch.int8, generator=g)
            xs = torch.rand(R_pad, 1, device=dev, generator=g) * 1e-2
            up = (xq, xs, (w_g, w_u), (s_g, s_u), ve, valid)
            kw = dict(block_n=BN_F, fuse_silu=True, emit_quant=True, w_bits=wb)
            aq, as_ = gm.gmm(*up, **kw)
            aq0, as0 = gm.gmm_plain(*up, **kw)
            dq = (aq.int() - aq0.int()).abs()
            s_err = ((as_ - as0).abs() / as0).max().item()
            down = (aq, as_, (w_d,), (s_d,), ve, valid)
            (y,) = gm.gmm(*down, block_n=BN_D, w_bits=wb)
            (y0,) = gm.gmm_plain(*down, block_n=BN_D, w_bits=wb)
            d_err = ((y - y0).abs().max() / y0.abs().max()).item()
            raw = gm.gmm(xq, xs, (w_g,), (s_g,), ve, valid, block_n=BN_F, out_dtype=torch.int32,
                          w_bits=wb)[0]
            raw0 = gm.gmm_plain(xq, xs, (w_g,), (s_g,), ve, valid, block_n=BN_F,
                                out_dtype=torch.int32, w_bits=wb)[0]
            ok = (dq.max().item() <= 1 and (dq > 0).float().mean().item() <= 1e-3
                  and s_err <= 1e-6 and d_err <= 1e-5 and torch.equal(raw, raw0))
            print(f"[check] w{wb} {label}: codes max diff {dq.max().item()} share "
                  f"{(dq > 0).float().mean().item():.2e}, scales rel {s_err:.2e}, down "
                  f"{d_err:.2e} x max, s32 {'equal' if torch.equal(raw, raw0) else 'DIFFER'}"
                  f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K6 w{wb} {label}: the kernel disagrees with its plain version")
            b_up = bound_ms(routed * (D + 4) + used * 2 * F * (D * wb // 8 + 4) + R_pad * F
                            + (F // BN_F) * R_pad * 4, 2 * routed * D * F * 2)
            b_dn = bound_ms(routed * F + (F // BN_F) * routed * 4 + used * D * (F * wb // 8 + 4)
                            + R_pad * D * 4, 2 * routed * F * D)
            (t,) = gm.gmm(xq, xs, (w_g, w_u), (s_g, s_u), ve, valid, block_n=BN_F,
                          fuse_silu=True, w_bits=wb)
            rq = cuda_ms(torch, lambda: gm.requant_tiles(t, BN_F))
            for gmv in group_ms:
                gm.TILE_GROUP_M.update(rows=gmv, chunked=gmv)
                t_up = cuda_ms(torch, lambda: gm.gmm(*up, **kw))
                t_dn = cuda_ms(torch, lambda: gm.gmm(*down, block_n=BN_D, w_bits=wb))
                print(f"[time] w{wb} {label} group_m {gmv}: gate_up {t_up:.4f} ms (bound "
                      f"{b_up:.4f}; requant {rq:.4f} of it), down {t_dn:.4f} ms (bound "
                      f"{b_dn:.4f})")
            gm.TILE_GROUP_M.update(default_gm)
            del xq, xs, aq, as_, aq0, as0, y, y0, raw, raw0, t, up, down


if __name__ == "__main__":
    main()
