#!/usr/bin/env python3
"""Times K4 and K10 of the PyTorch port on one CUDA card at the shapes the
main paths give them.

    python3 tools/torch_flash_scan_bench.py [--only k4|k4shapes|k10|scan]
                                            [--keys 512,1024] [--ptxas] [--root DIR]

K4 shapes (``--only k4shapes``): the JAX interface at the shapes PERF.md's
K4 rows time, causal and end-aligned: gpt2's (f32, B 16, H 12, L = S 512,
D 64) and, at B 8, L 512, S 768, D 192 (H 12) and D 256, 384, 512, 576,
768, 1024 (H 8; ``--dims`` picks), f32 and bf16, each beside SDPA with the
same mask (and gpt2's beside SDPA with ``is_causal``, chip_smoke's yardstick), its
bound and its worst error against the plain version (f32 max |diff|, bf16
the worst row's share of 2^-6 x its max). ``--root DIR`` imports the port
from another checkout of the repository (a parent commit unpacked beside
this one), so two versions are timed in one call; a head dim that version
refuses prints as refused.
K4: the JAX interface (``flash_attention``, q rotated) at the long
window's cached (B 8, H 32, D 128, L 2128, S 2167) and uncached (L = S)
shapes, the route's pre-pass (``rope_flash_keys``) and the whole route
(``rope_flash_attention``) at the cached shape beside RoPE + SDPA with the
same mask, then the route table (K2 / the route at the listed key counts,
batch 8, a 37-token prefix). K10: ``selective_ssm_bwd`` without
dA_T, as training runs it, at the Mamba train shape cached (B 48, L 144, E
1536, N 16) and uncached (L 158), twice, checking the bits agree. The
scan's forward (K7 / K8 / K9 / the prefill through the raw f32 interface,
K8 / K7 / the prefill through the gated bf16 interface, K8 gated in f32)
at the Mamba serving shapes, each with its worst error as a share of its
card test's tolerance, beside the special-function units' floor.
``--ptxas`` first compiles ``csrc/selective_scan.cu`` and
``csrc/flash_attention.cu`` with ``-Xptxas -v`` and prints each forward scan
instance's (N, dtype, gated) and each K4 kernel's registers and spills.
CUDA events over 20 calls after 3 warm-ups; bounds as chip_smoke.py counts
them. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("k4", "k4shapes", "k10", "scan"))
    ap.add_argument("--keys", default="512,1024,2048,4096")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--root", help="import medtsllm_tpu_torch from this checkout")
    ap.add_argument("--dims", default="64,192,256,384,512,576,768,1024",
                    help="the head dims --only k4shapes times")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    if args.ptxas:
        ptxas_report()
    import torch
    import torch.nn.functional as F

    from chip_smoke import SFU_EXP_PER_S, bound, cuda_ms
    from medtsllm_tpu_torch.ops.kernels import flash_attention as k4
    from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
    from medtsllm_tpu_torch.ops.kernels import selective_scan as ss

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    if args.only in (None, "k4"):
        B, H, D, P, L = 8, 32, 128, 39, 2128
        S = P + L
        for name, Lq in (("cached", L), ("uncached", S)):
            q, k, v = r(B, H, Lq, D), r(B, H, S, D), r(B, H, S, D)
            pairs = Lq * (S - Lq) + Lq * (Lq + 1) // 2
            bnd = bound(2 * (2 * B * H * Lq * D + 2 * B * H * S * D), 4 * B * H * D * pairs,
                        "bf16")
            mask = torch.ones(Lq, S, dtype=torch.bool, device=dev).tril(S - Lq)
            print(f"[k4] flash_attention {name} (L {Lq} S {S}): "
                  f"{cuda_ms(torch, lambda: k4.flash_attention(q, k, v)):.4f} ms, bound "
                  f"{bnd[0]:.4f} ({bnd[1]}), SDPA "
                  f"{cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)):.4f}")
        del q, k, v
        q, k, v = r(B, L, H, D), r(B, L, H, D), r(B, L, H, D)
        pk, pv = r(1, H, P, D), r(1, H, P, D)
        cos, sin = k2.rope_tables(torch.arange(P, P + L, device=dev), D, 10000.0)
        mask = torch.ones(L, S, dtype=torch.bool, device=dev).tril(P)
        keys_ms = cuda_ms(torch, lambda: k4.rope_flash_keys(k, v, cos, sin, pk, pv))
        kbytes = 2 * (2 * B * L * H * D + 2 * H * P * D + 2 * B * H * S * D) + 8 * L * D // 2
        print(f"[k4] rope_flash_keys: {keys_ms:.4f} ms, bound "
              f"{bound(kbytes, 0, 'bf16')[0]:.4f} (bytes)")

        def rope_sdpa():
            kr = torch.cat([pk.expand(B, -1, -1, -1), k2.rope(k, cos, sin).transpose(1, 2)], 2)
            vv = torch.cat([pv.expand(B, -1, -1, -1), v.transpose(1, 2)], 2)
            return F.scaled_dot_product_attention(k2.rope(q, cos, sin).transpose(1, 2), kr, vv,
                                                  attn_mask=mask).transpose(1, 2)
        print(f"[k4] rope_flash_attention (L {L} S {S}): "
              f"{cuda_ms(torch, lambda: k4.rope_flash_attention(q, k, v, cos, sin, pk, pv)):.4f} "
              f"ms, RoPE + SDPA {cuda_ms(torch, rope_sdpa):.4f} ms")
        del q, k, v
        for keys in map(int, args.keys.split(",")):
            Lr = keys - 37
            q, k, v = r(B, Lr, H, D), r(B, Lr, H, D), r(B, Lr, H, D)
            pk, pv = r(1, H, 37, D), r(1, H, 37, D)
            cos, sin = k2.rope_tables(torch.arange(37, keys, device=dev), D, 10000.0)
            k2_txt = (f"{cuda_ms(torch, lambda: k2.rope_attention(q, k, v, cos, sin, pk, pv)):.4f}"
                      if keys <= k2.MAX_KEYS else "-")
            print(f"[route] {keys} keys: K2 {k2_txt} ms, route "
                  f"{cuda_ms(torch, lambda: k4.rope_flash_attention(q, k, v, cos, sin, pk, pv)):.4f} ms")
    if args.only == "k4shapes":
        k4_shapes(torch, F, dev, g, k4, cuda_ms, bound, {int(d) for d in args.dims.split(",")})
    if args.only in (None, "k10"):
        Bm, E, N = 48, 1536, 16
        for name, Lm, h0_rows in (("cached", 144, 1), ("uncached", 158, 0)):
            dt = torch.rand(Bm, Lm, E, device=dev, generator=g) * 0.1
            xs, gy = r(Bm, Lm, E, dtype=torch.float32), r(Bm, Lm, E, dtype=torch.float32)
            A_T = -torch.rand(N, E, device=dev, generator=g) * N
            Bs, Cs = r(Bm, Lm, N, dtype=torch.float32), r(Bm, Lm, N, dtype=torch.float32)
            h0 = r(h0_rows, N, E, dtype=torch.float32) if h0_rows else None
            _, hb = ss.selective_ssm_bounds(dt, A_T, Bs, Cs, xs, torch.zeros(E, device=dev), h0)
            one = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb, need_dA=False)
            two = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb, need_dA=False)
            same = all(torch.equal(a, b) for a, b in zip(one[:4], two[:4]))
            ms = cuda_ms(torch, lambda: ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb,
                                                             need_dA=False))
            print(f"[k10] selective_ssm_bwd {name} (B {Bm} L {Lm} E {E} N {N}): {ms:.4f} ms, "
                  f"two calls bit-equal {same}")

    if args.only in (None, "scan"):
        scan_bench(torch, F, dev, g, ss, cuda_ms, SFU_EXP_PER_S)


def k4_shapes(torch, F, dev, g, k4, cuda_ms, bound, dims):
    print(f"[k4shapes] port from {Path(k4.__file__).resolve().parents[2]}")
    rows = [("gpt2", 16, 12, 512, 512, 64, (torch.float32,))]
    rows += [(f"D{D}", 8, 12 if D == 192 else 8, 512, 768, D, (torch.float32, torch.bfloat16))
             for D in (192, 256, 384, 512, 576, 768, 1024)]
    for name, B, H, L, S, D, dtypes in rows:
        if D not in dims:
            continue
        for dtype in dtypes:
            kind = "f32" if dtype == torch.float32 else "bf16"
            q = torch.randn(B, H, L, D, device=dev, generator=g).to(dtype)
            kk, vv = (torch.randn(B, H, S, D, device=dev, generator=g).to(dtype)
                      for _ in range(2))
            mask = torch.ones(L, S, dtype=torch.bool, device=dev).tril(S - L)
            pairs = L * (S - L) + L * (L + 1) // 2
            esz = 4 if dtype == torch.float32 else 2
            bnd = bound(esz * (2 * B * H * L * D + 2 * B * H * S * D), 4 * B * H * D * pairs,
                        kind)
            sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, kk, vv,
                                                                         attn_mask=mask))
            if L == S:
                causal_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, kk, vv, is_causal=True))
                sdpa_txt = f"SDPA {sdpa:.4f} ms (is_causal {causal_ms:.4f})"
            else:
                sdpa_txt = f"SDPA {sdpa:.4f} ms"
            try:
                out = k4.flash_attention(q, kk, vv, True)
            except ValueError as e:
                print(f"[k4shapes] {name}-{kind}: refused ({e}); {sdpa_txt}")
                continue
            ref = k4.flash_attention_plain(q, kk, vv, True)
            err = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                acc = f"max |diff| {err.max().item():.3e}"
            else:
                lim = 2.0 ** -6 * ref.float().abs().amax(-1)
                acc = f"worst row {(err.amax(-1) / lim.clamp_min(1e-30)).max().item():.4f}"
            ms = cuda_ms(torch, lambda: k4.flash_attention(q, kk, vv, True))
            print(f"[k4shapes] {name}-{kind} (B {B} H {H} L {L} S {S} D {D}, causal): "
                  f"{ms:.4f} ms, {sdpa_txt}, bound {bnd[0]:.4f} ({bnd[1]}), {acc}")
            del q, kk, vv, out, ref, err
            torch.cuda.empty_cache()


def ptxas_report() -> None:
    from medtsllm_tpu_torch.ops.kernels import _build
    src = _build.CSRC / "flash_attention.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          "-o", "/dev/null", str(src)], capture_output=True, text=True)
    name = ""
    for ln in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if "flash" in m.group(1) else ""
        if name and ("registers" in ln or "spill" in ln):
            print(f"[ptxas] {name}: {ln.strip()}")
    if out.returncode:
        raise SystemExit(f"nvcc failed: {out.returncode}\n{out.stderr[-4000:]}")
    src = _build.CSRC / "selective_scan.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          "-o", "/dev/null", str(src)], capture_output=True, text=True)
    name = ""
    for ln in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"selective_scan_kernelILi(\d+)E(f|13__nv_bfloat16)Lb([01])E", m.group(1))
            name = (f"N {t.group(1)} {'f32' if t.group(2) == 'f' else 'bf16'} "
                    f"{'gated' if t.group(3) == '1' else 'raw'}") if t else ""
        if name and ("registers" in ln or "spill" in ln):
            print(f"[ptxas] selective_scan_kernel {name}: {ln.strip()}")
    if out.returncode:
        raise SystemExit(f"nvcc failed: {out.returncode}")


def scan_bench(torch, F, dev, g, ss, cuda_ms, sfu_rate):
    """The scan's forward forms at the Mamba serving shapes (mamba-130m: E
    1536, N 16, R 48; batch 48, the cached L 144 with a batch-1 h0, the
    uncached L 158, the prefill B 1, L 14)."""
    E, N, R = 1536, 16, 48
    cases = []  # (label, call, plain output, tolerance check, exponentials)
    for label, B, L, h0_rows, final in (("K8", 48, 144, 1, False), ("K7", 48, 158, 0, False),
                                        ("prefill", 1, 14, 0, True)):
        dt = torch.rand(B, L, E, device=dev, generator=g) * 0.1
        xs = torch.randn(B, L, E, device=dev, generator=g)
        A_T = -torch.rand(N, E, device=dev, generator=g) * N
        Bs, Cs = (torch.randn(B, L, N, device=dev, generator=g) for _ in range(2))
        Dv = torch.randn(E, device=dev, generator=g)
        h0 = torch.randn(h0_rows, N, E, device=dev, generator=g) if h0_rows else None
        raw = (dt, A_T, Bs, Cs, xs, Dv, h0)
        y0 = ss.selective_ssm_final_plain(*raw)[0]
        cases.append((f"raw f32 {label}", lambda raw=raw: ss.selective_ssm_final(*raw)[0],
                      y0, 1e-5 * max(1.0, y0.abs().max().item()), B * L * N * E))
        if label != "prefill":
            _, hb0 = ss.selective_ssm_bounds_plain(*raw)
            cases.append((f"raw f32 K9 from {label}",
                          lambda raw=raw: ss.selective_ssm_bounds(*raw)[1],
                          hb0, 1e-4 * hb0.abs().max().item(), B * L * N * E))
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and label != "K8":
                continue
            xdbc = torch.randn(B, L, R + 2 * N, device=dev, generator=g).to(dtype)
            xz = torch.randn(B, L, 2 * E, device=dev, generator=g).to(dtype)
            A_log = (torch.log(torch.arange(1, N + 1, device=dev, dtype=torch.float32))
                     .expand(E, N) + 0.1 * torch.randn(E, N, device=dev, generator=g))
            ops = ((torch.randn(B, L, E, device=dev, generator=g) - 3).to(dtype),
                   A_log.to(dtype), xdbc[..., R:R + N], xdbc[..., R + N:],
                   torch.randn(B, L, E, device=dev, generator=g).to(dtype),
                   torch.randn(E, device=dev, generator=g).to(dtype), xz[..., E:])
            out0 = ss.selective_ssm_gated_plain(*ops, h0)
            if dtype == torch.bfloat16:  # the card test's per-element bound
                y = ss._plain_scan(*ss.scan_operands(*ops[:6]), h0, 0)[0]
                tol = (F.silu(ops[6]).float().abs() * (1e-5 * y.abs().max() + 2.0 ** -7
                                                       * y.abs())
                       + 2.0 ** -7 * out0.float().abs())
            else:
                tol = 1e-5 * out0.abs().max().item() + 1e-5 * out0.abs()
            cases.append((f"gated {str(dtype)[6:]} {label}",
                          lambda ops=ops, h0=h0: ss.selective_ssm_gated(*ops, h0), out0, tol,
                          B * L * N * E + 2 * B * L * E))
    for label, call, want, tol, n_exp in cases:
        got = call()
        err = (got.float() - want.float()).abs()
        # a NaN error stays NaN: torch's max() propagates it
        share = torch.where(err == 0, 0.0, err / tol).max().item()
        same = torch.equal(got, call())
        print(f"[scan] {label}: {cuda_ms(torch, call):.4f} ms, "
              f"expf floor {n_exp / sfu_rate * 1e3:.4f} ms, worst error at {share:.3f} "
              f"of the card test's tolerance, finite {bool(torch.isfinite(got).all())}, "
              f"two calls bit-equal {same}")


if __name__ == "__main__":
    main()
