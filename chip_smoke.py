#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``medtsllm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
nvidia-smi. Phases, one line each:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the hand-written kernels (csrc/*.cu) with its seconds;
  3. each kernel against its plain PyTorch version at the serving path's
     shapes (K1 integers bit-equal), with both times from CUDA events;
  4. the serving path: ``get_trainer(...).test()`` of MedTsLLM on the
     Llama-2-7B-shaped w8a8 bf16 backbone (random weights from a seed) at
     batch 8, history 256, with the prompt-head KV cache; the launch count
     of every kernel in that run; windows/s, p50 ms per batch and peak
     memory; finite scores;
  5. a small 2-layer GQA slice (dense f32 projections) on the card against
     the same slice on the CPU (plain versions) with the same weights.
Then one JSON line with the kernels and, last, the result line. Any failure
raises (exit code != 0) and prints no result line; without a CUDA card it
fails before any work.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0


def bench_config(Config, llm="meta-llama/Llama-2-7b-hf", batch=8, history=256,
                 dtype="bf16", n_points=8192, num_tokens=1024, d_ff=128,
                 llm_layers=-1, load_in_8bit=True):
    """The serving configuration of ``bench.py`` (build_trainer defaults)."""
    return Config({
        "task": "reconstruction", "model": "medtsllm",
        "history_len": history, "pred_len": history,
        "data": {"dataset": "synthetic", "mode": "multivariate", "cols": "all",
                 "normalize": True, "step": history // 2},
        "training": {"batch_size": batch, "dropout": 0.1},
        "datasets": {"synthetic": {"n_points": n_points, "n_features": 3}},
        "models": {"medtsllm": {
            "d_model": 32, "d_ff": d_ff, "n_heads": 8, "num_tokens": num_tokens,
            "covariate_mode": "concat", "embedding_downsample_mode": "linear",
            "patching": {"patch_len": 16, "stride": 8},
            "prompting": {"dataset": True, "task": True, "clip": False,
                          "input_stats": True, "examples": False,
                          "input_stats_dim": 0, "input_stats_select": "all",
                          "cache_order": True},
            "llm": {"enabled": True, "llm": llm, "llm_layers": llm_layers,
                    "prefix_cache": True, "load_in_8bit": load_in_8bit}}},
        "setup": {"seed": SEED, "dtype": dtype},
    })


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this smoke test runs on a CUDA card only")
    if not (ROOT / "medtsllm_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no medtsllm_tpu_torch/ beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 references
    torch.backends.cudnn.allow_tf32 = False

    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.ops.kernels import _build
    from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
    from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
    from medtsllm_tpu_torch.ops.kernels import w8a8 as k1
    from medtsllm_tpu_torch.tasks import get_trainer

    dev = torch.device("cuda", 0)
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")

    # the serving run's shapes: region length L and prompt head P come from
    # the prompt builder on the first test batch (host only, no kernel runs)
    cfg = bench_config(Config)
    trainer = get_trainer("chip-smoke", cfg, device=dev)
    model, lcfg = trainer.model, trainer.model.llm_cfg
    first = trainer.model_inputs(next(iter(trainer.test_pipeline)))
    P = len(first["prefix_ids"])
    L = first["prompt_ids"].shape[1] + model.n_patches
    B = cfg.training.batch_size
    H, KV, D = lcfg.n_heads, lcfg.kv_heads, lcfg.head_dim
    print(f"[shapes] tokenizer {type(trainer.preprocessor.tokenizer).__name__} "
          f"P={P} L={L} B={B} H={H} KV={KV} D={D}")

    # 3. kernels against their plain versions at those shapes
    g = torch.Generator(dev).manual_seed(SEED)
    kernels = []

    def record(name, source, replaces, err, tol, ms, plain_ms, extra=""):
        check(err <= tol, f"{name}: max |kernel - plain| {err} > tolerance {tol}")
        print(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{extra}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})

    # K1 over one decoder block's seven projections at M = B * L rows:
    # q, k, v, gate and up quantize the f32 normed residual (K = d), o_proj
    # the bf16 attention output (K = d), down_proj the bf16 SwiGLU output
    # (K = d_ff); GEMMs q, k, v, o at d x d, gate and up d x d_ff, down
    # d_ff x d, all written as bf16
    M, d, f = B * L, lcfg.d_model, lcfg.d_ff
    q_err = q_ms = q_plain = 0.0
    for dt, K, n in ((torch.float32, d, 5), (torch.bfloat16, d, 1),
                     (torch.bfloat16, f, 1)):
        x = torch.randn(M, K, device=dev, generator=g).to(dt)
        xq, xs = k1.quantize_rows(x)
        xq0, xs0 = k1.quantize_rows_plain(x)
        check(torch.equal(xq, xq0) and torch.equal(xs, xs0),
              f"w8a8 quantizer not bit-equal at {dt} [{M}, {K}]")
        q_err = max(q_err, (xq.int() - xq0.int()).abs().max().item(),
                    (xs - xs0).abs().max().item())
        q_ms += n * cuda_ms(torch, lambda: k1.quantize_rows(x))
        q_plain += n * cuda_ms(torch, lambda: k1.quantize_rows_plain(x))
    record("w8a8_quantize", "medtsllm_tpu_torch/csrc/w8a8.cu",
           "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", q_err, 0.0, q_ms, q_plain,
           " (per decoder block, 7 calls; xq and x_scale bit-equal)")
    g_err, g_ms, g_plain, g_dense = 0.0, 0.0, 0.0, 0.0
    for K, N, n in ((d, d, 4), (d, f, 2), (f, d, 1)):
        xq = torch.randint(-127, 128, (M, K), device=dev, dtype=torch.int8,
                           generator=g)
        wq = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                           generator=g)
        xs = torch.rand(M, device=dev, generator=g) * 1e-2
        ws = torch.rand(N, device=dev, generator=g) * 1e-3
        check(torch.equal(k1.int8_gemm(xq, wq, xs, ws, torch.int32),
                          k1.int8_matmul_plain(xq, wq)),
              f"w8a8 s32 accumulators not bit-equal at {M}x{K}x{N}")
        y = k1.int8_gemm(xq, wq, xs, ws, torch.bfloat16)
        y0 = k1.int8_gemm_plain(xq, wq, xs, ws, torch.bfloat16)
        g_err = max(g_err, (y.float() - y0.float()).abs().max().item())
        xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)  # dense reference
        g_ms += n * cuda_ms(torch, lambda: k1.int8_gemm(xq, wq, xs, ws, torch.bfloat16))
        g_plain += n * cuda_ms(torch, lambda: k1.int8_gemm_plain(xq, wq, xs, ws,
                                                                  torch.bfloat16))
        g_dense += n * cuda_ms(torch, lambda: xb @ wb.T)
    # same integers and the same f32 epilogue order: bit-equal
    record("w8a8_gemm", "medtsllm_tpu_torch/csrc/w8a8.cu",
           "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", g_err, 0.0, g_ms, g_plain,
           f" (per decoder block, 7 GEMMs; s32 bit-equal; cuBLAS dense bf16 "
           f"GEMMs of the same shapes {g_dense:.4f} ms)")

    q = torch.randn(B, L, H, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(B, L, KV, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(B, L, KV, D, device=dev, generator=g).to(torch.bfloat16)
    pk = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
    pv = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
    cos, sin = k2.rope_tables(torch.arange(P, P + L, device=dev), D,
                              lcfg.rope_theta)
    o = k2.rope_attention(q, k, v, cos, sin, pk, pv)
    o0 = k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)
    # bf16 output: the kernel rounds each rotation once, the plain version
    # after each of its three ops, so probabilities and outputs may differ
    # by a few bf16 ulps (2^-8 relative each)
    tol = 2.0 ** -6 * o0.float().abs().max().item()
    record("rope_attention", "medtsllm_tpu_torch/csrc/rope_attention.cu",
           "medtsllm_tpu/ops/pallas/rope_attention.py:182",
           (o.float() - o0.float()).abs().max().item(), tol,
           cuda_ms(torch, lambda: k2.rope_attention(q, k, v, cos, sin, pk, pv)),
           cuda_ms(torch, lambda: k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)))

    mc = cfg.models.medtsllm
    S, E, Hr = mc.num_tokens, mc.d_ff, mc.n_heads
    qr = torch.randn(B, model.n_patches, Hr, E, device=dev, generator=g)
    kr = torch.randn(S, Hr, E, device=dev, generator=g)
    vr = torch.randn(S, Hr, E, device=dev, generator=g)
    o = k3.reprogramming_attention(qr, kr, vr)
    o0 = k3.reprogramming_attention_plain(qr, kr, vr)
    # f32: summation order and online vs two-pass softmax differ
    record("reprogramming_attention", "medtsllm_tpu_torch/csrc/reprogramming.cu",
           "medtsllm_tpu/ops/pallas/reprogramming.py:47",
           (o - o0).abs().max().item(), 1e-5 * max(1.0, o0.abs().max().item()),
           cuda_ms(torch, lambda: k3.reprogramming_attention(qr, kr, vr)),
           cuda_ms(torch, lambda: k3.reprogramming_attention_plain(qr, kr, vr)))

    # 4. the serving path, through the user's entry point
    wrappers = {"w8a8_quantize": k1.quantize_rows, "w8a8_gemm": k1.int8_gemm,
                "rope_attention": k2.rope_attention,
                "reprogramming_attention": k3.reprogramming_attention}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    scores = trainer.test()
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    n_windows = len(trainer.test_dataset)
    print(f"[slice] test() {n_windows} windows in {len(trainer.test_pipeline)} "
          f"batches: {start.elapsed_time(end):.1f} ms (CUDA events, prefill "
          f"and host prep included), {n_windows / wall:.2f} windows/s wall")
    print(f"[slice] launches {counts}; peak memory {peak / 2**30:.2f} GiB")
    print(f"[slice] scores {scores}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by the serving path")
    for entry in kernels:
        entry["launches"] = counts[entry["name"]]
    check(all(math.isfinite(s) for s in scores.values()), f"non-finite {scores}")
    preds, targets = trainer.predict(trainer.test_pipeline)
    check(preds.shape == targets.shape == (trainer.eval_n_points(
        trainer.test_dataset), 3), f"prediction shape {preds.shape}")
    check(bool(torch.isfinite(torch.from_numpy(preds)).all()), "non-finite preds")

    batch_ms = []
    for batch in trainer.test_pipeline:
        prepared = trainer.eval_prepare(batch)
        start.record()
        trainer.eval_dispatch(prepared=prepared)
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
    p50 = statistics.median(batch_ms)
    print(f"[slice] eval step p50 {p50:.2f} ms per batch of {B} "
          f"({B * 1000 / p50:.1f} windows/s at p50; per batch {batch_ms})")

    # 5. a small GQA slice on the card against the same slice on the CPU
    del trainer, model
    torch.cuda.empty_cache()
    # (dense f32 projections: the int8 path amplifies last-bit differences
    # into activation rounding flips, ~3% of the output at this size even
    # between two CPU runs; K1 is held bit-equal in phase 3 instead)
    small = bench_config(Config, llm="llama-1b", batch=2, history=64,
                         dtype="float32", n_points=256, num_tokens=128,
                         d_ff=64, llm_layers=2, load_in_8bit=False)
    gpu = get_trainer("chip-smoke-small", small, device=dev)
    cpu = get_trainer("chip-smoke-small", small, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
    batch = next(iter(gpu.test_pipeline))
    out_gpu = gpu.eval_dispatch(batch).cpu()
    out_cpu = cpu.eval_dispatch(batch)
    err = (out_gpu - out_cpu).abs().max().item()
    # f32 end to end: only summation order differs
    tol = 1e-3 * max(1.0, out_cpu.abs().max().item())
    check(err <= tol, f"small slice: card vs CPU max err {err} > {tol}")
    print(f"[reference] llama-1b 2-layer GQA dense f32 slice, card vs CPU: "
          f"max_abs_err {err:.3e} (tol {tol:.3e})")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
