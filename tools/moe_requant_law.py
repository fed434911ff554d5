#!/usr/bin/env python3
"""How far the JAX package's dropless grouped MoE chain lies from its
dropless capacity bmm at a backbone's widths, on the CPU.

    python3 tools/moe_requant_law.py [--llm moe-8x1b] [--tokens 256] [--seeds 2] [--quantize 8|4]

The two paths share the router and the per-row int8 quantization of the
input; they differ in how the SwiGLU activation is requantized before the
down projection: per (row, 1408-wide F-tile) in the chain, per row in the
bmm. For each seed: f32 MoEMLP parameters from ``init``, experts quantized
per channel (``QuantDense.quantize`` at ``--quantize`` bits: int8, or
packed absmax int4), ``--tokens`` N(0, 1) tokens,
then max |grouped - bmm| / max |bmm| and the ratio of the two outputs'
rms. This is the law ``chip_smoke.py`` holds the port's card chain to at
moe-8x1b widths (``tests/test_moe.py`` holds 0.02 at d_model 128).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--llm", default="moe-8x1b")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--quantize", type=int, choices=(8, 4), default=8)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from medtsllm_tpu.models.llm.loader import resolve_config
    from medtsllm_tpu.models.llm.transformer import MoEMLP, QuantDense

    cfg = dataclasses.replace(resolve_config(args.llm)[0], expert_capacity=0.0)
    for seed in range(args.seeds):
        t0 = time.time()
        x = jnp.asarray(np.random.RandomState(seed).randn(1, args.tokens, cfg.d_model)
                        .astype(np.float32))
        pf = jax.jit(MoEMLP(cfg).init)(jax.random.PRNGKey(seed + 1), x)["params"]
        qp = {"gate": pf["gate"]}
        for name in ("w_gate", "w_up", "w_down"):
            qs = [QuantDense.quantize(np.asarray(pf[name][e]), bits=args.quantize)
                  for e in range(cfg.n_experts)]
            qp[name + "_q"] = jnp.stack([jnp.asarray(q) for q, _ in qs])
            qp[name + "_scale"] = jnp.stack([jnp.asarray(s) for _, s in qs])
        del pf
        y_b = np.asarray(MoEMLP(cfg, quantize=args.quantize).apply({"params": qp}, x))
        y_g = np.asarray(MoEMLP(dataclasses.replace(cfg, moe_grouped=True),
                                quantize=args.quantize).apply({"params": qp}, x))
        d = np.abs(y_g - y_b)
        print(f"{args.llm} w{args.quantize} seed {seed}, {args.tokens} tokens on "
              f"{jax.default_backend()}: "
              f"max |grouped - bmm| / max |bmm| {d.max() / np.abs(y_b).max():.4f}, rms ratio "
              f"{np.sqrt((d ** 2).mean() / (y_b ** 2).mean()):.4f} ({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
