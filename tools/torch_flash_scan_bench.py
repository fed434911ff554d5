#!/usr/bin/env python3
"""Times K4 and K10 of the PyTorch port on one CUDA card at the shapes the
main paths give them.

    python3 tools/torch_flash_scan_bench.py [--only k4|k10] [--keys 512,1024]

K4: the JAX interface (``flash_attention``, q rotated) at the long
window's cached (B 8, H 32, D 128, L 2128, S 2167) and uncached (L = S)
shapes, the route's pre-pass (``rope_flash_keys``) and the whole route
(``rope_flash_attention``) at the cached shape beside RoPE + SDPA with the
same mask, then the route table (K2 / the route at the listed key counts,
batch 8, a 37-token prefix). K10: ``selective_ssm_bwd`` without
dA_T, as training runs it, at the Mamba train shape cached (B 48, L 144, E
1536, N 16) and uncached (L 158), twice, checking the bits agree. CUDA
events over 20 calls after 3 warm-ups; bounds as chip_smoke.py counts
them. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("k4", "k10"))
    ap.add_argument("--keys", default="512,1024,2048,4096")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    from chip_smoke import bound, cuda_ms
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


if __name__ == "__main__":
    main()
