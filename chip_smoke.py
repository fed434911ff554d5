#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``medtsllm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
nvidia-smi. Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the hand-written kernels (csrc/*.cu) with its seconds;
  3. each kernel against its plain PyTorch version at the shapes the two
     serving paths give it (K1 integers bit-equal), with both times from
     CUDA events, the least time the card could take for the same work
     (bound) and, where one exists, the time of the one PyTorch call that
     computes the same function (timed here only; the port never calls it);
  4. the llama serving path: ``get_trainer(...).test()`` of MedTsLLM on the
     Llama-2-7B-shaped w8a8 bf16 backbone (random weights from a seed) at
     batch 8, history 256, with the prompt-head KV cache; the launch count
     of every kernel in that run; windows/s, p50 ms per batch and peak
     memory; finite scores;
  5. a small 2-layer GQA slice (dense f32 projections) on the card against
     the same slice on the CPU (plain versions) with the same weights;
  6. the Mamba serving path: ``get_trainer(...).test()`` of
     configs/ablation/mamba-backbone.toml's model (mamba-130m, 24 layers,
     bf16, batch 48, prompt-state cache) on synthetic data; the launches of
     the scan variants and K3; windows/s, p50 ms per batch, peak memory,
     finite scores; then one pass with prefix_cache = false, which runs the
     uncached scan and must agree with the cached pass;
  7. a 2-layer mamba-130m f32 slice on the card against the CPU;
  8. the Mamba train path: ``get_trainer(...).train()`` of the same
     mamba-130m configuration (one epoch of four shuffled batches of 48,
     then ``val()``), the launches of K9 (the scan that records its
     chunk-start states) and K10 (its backward) in that run and in each
     further train step (24 each, and no K7/K8), the train step's p50 ms
     per batch, windows/s and peak memory; one train step with the prompt
     head embedded (K9/K10 at the uncached shape);
  9. the llama finetune step: ``train()`` of the Llama-2-7B-shaped w8a8
     bf16 configuration (frozen int8 backbone, trainable fusion layers,
     batch 8): finite losses, changed fusion layers, an unchanged backbone,
     K1 and K2 launched; p50 ms per step and peak memory;
 10. one f32 train step of 2-layer slices (mamba-130m widths; llama-1b
     dense, GQA) on the card against the CPU with the same weights: the
     loss and the gradient of every trainable parameter.
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
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MAMBA_TOML = ROOT / "configs" / "ablation" / "mamba-backbone.toml"

# One H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): HBM bytes
# per second and peak operations per second by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# expf on the special-function units: 16 results per clock per SM, 132 SMs
# at the 1.98 GHz boost clock (Hopper white paper); a floor the scan's
# bound does not count, printed beside it
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def bench_config(Config, llm="meta-llama/Llama-2-7b-hf", batch=8, history=256,
                 dtype="bf16", n_points=8192, num_tokens=1024, d_ff=128,
                 llm_layers=-1, load_in_8bit=True, dropout=0.1):
    """The configuration of ``bench.py`` (build_trainer defaults): served by
    ``test()``, trained (the frozen-w8a8 finetune step) by ``train()``."""
    return Config({
        "task": "reconstruction", "model": "medtsllm",
        "history_len": history, "pred_len": history,
        "data": {"dataset": "synthetic", "mode": "multivariate", "cols": "all",
                 "normalize": True, "step": history // 2},
        "training": {"epochs": 1, "batch_size": batch, "optimizer": "adam",
                     "learning_rate": 1e-4, "dropout": dropout, "loss": "mse",
                     "eval_metric": "mse", "eval_metric_direction": "min"},
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


def mamba_config(Config, n_points=49152, batch=None, history=None, dtype=None,
                 llm_layers=-1, prefix_cache=True, epochs=None, dropout=None):
    """configs/ablation/mamba-backbone.toml (mamba-130m, reconstruction,
    concat covariates, history 256, patch 16 / 8, bf16, dense projections,
    batch 48, adam at 1e-4, mse, dropout 0.1) on the synthetic 3-feature
    data: the ventilator files are not in the repository. The default
    n_points gives 192 test windows, four batches of 48."""
    raw = tomllib.loads(MAMBA_TOML.read_text())
    raw["data"]["dataset"] = "synthetic"
    raw["datasets"] = {"synthetic": {"n_points": n_points, "n_features": 3}}
    if epochs is not None:
        raw["training"]["epochs"] = epochs
    if dropout is not None:
        raw["training"]["dropout"] = dropout
    if batch is not None:
        raw["training"]["batch_size"] = batch
    if history is not None:
        raw["history_len"] = raw["pred_len"] = history
        raw["data"]["step"] = history // 2
    if dtype is not None:
        raw["setup"]["dtype"] = dtype
    llm = raw["models"]["timellm"]["llm"]
    llm["llm_layers"], llm["prefix_cache"] = llm_layers, prefix_cache
    return Config(raw)


def finite(values) -> bool:
    return all(math.isfinite(v) for v in values)


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


def bound(nbytes: float, ops: float, kind: str):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    # plain f32 references: no TF32 in matmuls, nor in f32 convolutions,
    # which cuDNN would run in TF32 by default (the f32 Mamba slice of
    # phase 7 runs a depthwise conv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.ops.kernels import _build
    from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
    from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
    from medtsllm_tpu_torch.ops.kernels import selective_scan as ss
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

    # the serving runs' shapes: region length L and prompt head P come from
    # the prompt builder on the first test batch (host only, no kernel runs)
    cfg = bench_config(Config)
    trainer = get_trainer("chip-smoke", cfg, device=dev)
    model, lcfg = trainer.model, trainer.model.llm_cfg
    first = trainer.model_inputs(next(iter(trainer.test_pipeline)))
    P = len(first["prefix_ids"])
    L = first["prompt_ids"].shape[1] + model.n_patches
    B = cfg.training.batch_size
    H, KV, D = lcfg.n_heads, lcfg.kv_heads, lcfg.head_dim
    print(f"[shapes] llama: tokenizer {type(trainer.preprocessor.tokenizer).__name__} "
          f"P={P} L={L} B={B} H={H} KV={KV} D={D}")
    mcfg = mamba_config(Config)
    mtrainer = get_trainer("chip-smoke-mamba", mcfg, device=dev)
    mmodel, scfg = mtrainer.model, mtrainer.model.llm_cfg
    mfirst = mtrainer.model_inputs(next(iter(mtrainer.test_pipeline)))
    Pm = len(mfirst["prefix_ids"])
    Lm = mfirst["prompt_ids"].shape[1] + mmodel.n_patches
    Bm, Em, Nm = mcfg.training.batch_size, scfg.d_inner, scfg.d_state
    print(f"[shapes] mamba-130m: P={Pm} L={Lm} B={Bm} E={Em} N={Nm} "
          f"layers={scfg.n_layers}")

    # 3. kernels against their plain versions at those shapes
    g = torch.Generator(dev).manual_seed(SEED)
    kernels = []

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, library_ms,
               extra=""):
        check(err <= tol, f"{name}: max |kernel - plain| {err} > tolerance {tol}")
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) library {lib}{extra}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": None, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": library_ms})

    # K1 over one decoder block's seven projections at M = B * L rows:
    # q, k, v, gate and up quantize the f32 normed residual (K = d), o_proj
    # the bf16 attention output (K = d), down_proj the bf16 SwiGLU output
    # (K = d_ff); GEMMs q, k, v, o at d x d, gate and up d x d_ff, down
    # d_ff x d, all written as bf16
    M, d, f = B * L, lcfg.d_model, lcfg.d_ff
    q_err = q_ms = q_plain = q_lib = q_bytes = 0.0
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
        q_bytes += n * (M * K * x.element_size() + M * K + M * 4)
    # no single PyTorch call quantizes rows to int8 with their absmax scale
    record("w8a8_quantize", "medtsllm_tpu_torch/csrc/w8a8.cu",
           "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", q_err, 0.0, q_ms, q_plain,
           bound(q_bytes, 0, "int8"), None,
           " (per decoder block, 7 calls; xq and x_scale bit-equal)")
    g_err, g_ms, g_plain, g_dense, g_lib, g_bytes, g_ops = (0.0,) * 7
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
        # the library's int8 GEMM (cuBLASLt) and the same rescale
        g_lib += n * cuda_ms(torch, lambda: (torch._int_mm(xq, wq.T).float() * (
            xs[:, None] * ws[None, :])).to(torch.bfloat16))
        g_bytes += n * (M * K + N * K + M * 4 + N * 4 + M * N * 2)
        g_ops += n * 2 * M * K * N
    # same integers and the same f32 epilogue order: bit-equal
    record("w8a8_gemm", "medtsllm_tpu_torch/csrc/w8a8.cu",
           "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", g_err, 0.0, g_ms, g_plain,
           bound(g_bytes, g_ops, "int8"), g_lib,
           f" (per decoder block, 7 GEMMs; s32 bit-equal; library = torch._int_mm "
           f"+ rescale; cuBLAS dense bf16 GEMMs of the same shapes {g_dense:.4f} ms)")

    q = torch.randn(B, L, H, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(B, L, KV, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(B, L, KV, D, device=dev, generator=g).to(torch.bfloat16)
    pk = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
    pv = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
    cos, sin = k2.rope_tables(torch.arange(P, P + L, device=dev), D,
                              lcfg.rope_theta)
    o = k2.rope_attention(q, k, v, cos, sin, pk, pv)
    o0 = k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)
    mask = torch.ones(L, P + L, dtype=torch.bool, device=dev).tril(P)

    def rope_sdpa():  # plain RoPE, then the library's attention
        kr = torch.cat([pk.expand(B, -1, -1, -1), k2.rope(k, cos, sin).transpose(1, 2)], 2)
        vv = torch.cat([pv.expand(B, -1, -1, -1), v.transpose(1, 2)], 2)
        return F.scaled_dot_product_attention(k2.rope(q, cos, sin).transpose(1, 2), kr, vv,
                                              attn_mask=mask)
    # each query i sees the P prefix keys and region keys 0..i
    pairs = L * P + L * (L + 1) // 2
    # bf16 output: the kernel rounds each rotation once, the plain version
    # after each of its three ops, so probabilities and outputs may differ
    # by a few bf16 ulps (2^-8 relative each)
    tol = 2.0 ** -6 * o0.float().abs().max().item()
    record("rope_attention", "medtsllm_tpu_torch/csrc/rope_attention.cu",
           "medtsllm_tpu/ops/pallas/rope_attention.py:182",
           (o.float() - o0.float()).abs().max().item(), tol,
           cuda_ms(torch, lambda: k2.rope_attention(q, k, v, cos, sin, pk, pv)),
           cuda_ms(torch, lambda: k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)),
           bound(2 * (2 * B * L * H * D + 2 * B * L * KV * D + 2 * KV * P * D)
                 + 4 * L * D, 4 * B * H * D * pairs, "bf16"),
           cuda_ms(torch, rope_sdpa))

    def check_k3(name, Bq, Lq, Hr, E, S):
        qr = torch.randn(Bq, Lq, Hr, E, device=dev, generator=g)
        kr = torch.randn(S, Hr, E, device=dev, generator=g)
        vr = torch.randn(S, Hr, E, device=dev, generator=g)
        o = k3.reprogramming_attention(qr, kr, vr)
        o0 = k3.reprogramming_attention_plain(qr, kr, vr)
        kb = kr.permute(1, 0, 2)[None].expand(Bq, -1, -1, -1)
        vb = vr.permute(1, 0, 2)[None].expand(Bq, -1, -1, -1)
        # f32: summation order and online vs two-pass softmax differ
        record(name, "medtsllm_tpu_torch/csrc/reprogramming.cu",
               "medtsllm_tpu/ops/pallas/reprogramming.py:47",
               (o - o0).abs().max().item(), 1e-5 * max(1.0, o0.abs().max().item()),
               cuda_ms(torch, lambda: k3.reprogramming_attention(qr, kr, vr)),
               cuda_ms(torch, lambda: k3.reprogramming_attention_plain(qr, kr, vr)),
               bound(4 * (2 * Bq * Lq * Hr * E + 2 * S * Hr * E),
                     4 * Bq * Lq * Hr * S * E, "f32"),
               cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   qr.transpose(1, 2), kb, vb)),
               f" (B={Bq} L={Lq} H={Hr} E={E} S={S}; library = SDPA over the "
               "basis expanded across the batch)")

    mc = cfg.models.medtsllm
    check_k3("reprogramming_attention", B, model.n_patches, mc.n_heads, mc.d_ff,
             mc.num_tokens)
    mmc = mcfg.models.timellm
    check_k3("reprogramming_attention[mamba-130m]", Bm, mmodel.n_patches, mmc.n_heads,
             mmc.d_ff, mmc.num_tokens)

    # the scan at the Mamba serving shapes: the cached window (K8, batch-1
    # h0), the uncached window over [head | region] (K7) and the prefill of
    # the head (batch 1, final state); no single PyTorch call computes it
    def check_scan(name, fn, replaces, Bs_, Ls, h0_rows, final):
        dt = torch.rand(Bs_, Ls, Em, device=dev, generator=g) * 0.1
        xs = torch.randn(Bs_, Ls, Em, device=dev, generator=g)
        A_T = -torch.rand(Nm, Em, device=dev, generator=g) * Nm
        Bs = torch.randn(Bs_, Ls, Nm, device=dev, generator=g)
        Cs = torch.randn(Bs_, Ls, Nm, device=dev, generator=g)
        Dv = torch.randn(Em, device=dev, generator=g)
        h0 = (torch.randn(h0_rows, Nm, Em, device=dev, generator=g),) if h0_rows else ()
        out = fn(dt, A_T, Bs, Cs, xs, Dv, *h0)
        ref = ss.selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, Dv, *h0)
        if final:
            err = max((out[0] - ref[0]).abs().max().item(),
                      (out[1] - ref[1]).abs().max().item())
            scale = max(ref[0].abs().max().item(), ref[1].abs().max().item())
        else:
            err = (out - ref[0]).abs().max().item()
            scale = ref[0].abs().max().item()
        nbytes = 4 * (3 * Bs_ * Ls * Em + 2 * Bs_ * Ls * Nm + Nm * Em + Em
                      + h0_rows * Nm * Em + (Bs_ * Nm * Em if final else 0))
        # per (b, t, n, e): dt*A, exp, dA*h, dBx*B, +, h*C, +; per (b, t, e):
        # dt*x, D*x, +
        ops = 7 * Bs_ * Ls * Nm * Em + 3 * Bs_ * Ls * Em
        # f32 with expf: fused multiply-adds and the order of the N-sum only
        record(name, "medtsllm_tpu_torch/csrc/selective_scan.cu", replaces, err,
               1e-5 * max(1.0, scale),
               cuda_ms(torch, lambda: fn(dt, A_T, Bs, Cs, xs, Dv, *h0)),
               cuda_ms(torch, lambda: ss.selective_ssm_final_plain(dt, A_T, Bs, Cs, xs,
                                                                   Dv, *h0)),
               bound(nbytes, ops, "f32"), None,
               f" (B={Bs_} L={Ls} E={Em} N={Nm}, h0 rows {h0_rows}, final {final})")

    check_scan("selective_scan_h0", ss.selective_ssm_h0,
               "medtsllm_tpu/ops/pallas/selective_scan.py:272", Bm, Lm, 1, False)
    check_scan("selective_scan", ss.selective_ssm,
               "medtsllm_tpu/ops/pallas/selective_scan.py:234", Bm, Pm + Lm, 0, False)
    check_scan("selective_scan_final", ss.selective_ssm_final,
               "medtsllm_tpu/ops/pallas/selective_scan.py:91", 1, Pm, 0, True)

    # K9 and K10 at the Mamba train shapes: the train step's scan records
    # its chunk-start states (K9, from the cached head's state or from 0)
    # and its backward runs K10 from them. A is frozen in training, so K10
    # runs there without dA_T, and is timed so; its five outputs are
    # compared here with dA_T. f32 with expf: the order of the sums over n
    # and e and fused multiply-adds, held at 1e-4 x max |plain| (the JAX
    # tests' tolerance for the Pallas backward)
    def check_train_scan(label, Ls, h0_rows):
        chunk = ss.CHUNK
        dt = torch.rand(Bm, Ls, Em, device=dev, generator=g) * 0.1
        xs = torch.randn(Bm, Ls, Em, device=dev, generator=g)
        A_T = -torch.rand(Nm, Em, device=dev, generator=g) * Nm
        Bs = torch.randn(Bm, Ls, Nm, device=dev, generator=g)
        Cs = torch.randn(Bm, Ls, Nm, device=dev, generator=g)
        Dv = torch.randn(Em, device=dev, generator=g)
        gy = torch.randn(Bm, Ls, Em, device=dev, generator=g)
        h0 = torch.randn(h0_rows, Nm, Em, device=dev, generator=g) if h0_rows else None
        y, hb = ss.selective_ssm_bounds(dt, A_T, Bs, Cs, xs, Dv, h0, chunk)
        y0, hb0 = ss.selective_ssm_bounds_plain(dt, A_T, Bs, Cs, xs, Dv, h0, chunk)
        nc = hb.shape[1]
        bles, blns, blnes = Bm * Ls * Em, Bm * Ls * Nm, Bm * Ls * Nm * Em
        # reads dt, x, B, C, A_T, D, h0; writes y, hb. Per (b, t, n, e) the
        # forward's 7 operations; per (b, t, e) 3
        err = max((y - y0).abs().max().item(), (hb - hb0).abs().max().item())
        scale = max(y0.abs().max().item(), hb0.abs().max().item())
        record(f"selective_scan_bounds{label}", "medtsllm_tpu_torch/csrc/selective_scan.cu",
               "medtsllm_tpu/ops/pallas/selective_scan.py:358", err, 1e-4 * scale,
               cuda_ms(torch, lambda: ss.selective_ssm_bounds(dt, A_T, Bs, Cs, xs, Dv, h0,
                                                              chunk)),
               cuda_ms(torch, lambda: ss.selective_ssm_bounds_plain(dt, A_T, Bs, Cs, xs, Dv,
                                                                    h0, chunk),
                       iters=3, warmup=1),
               bound(4 * (3 * bles + 2 * blns + Nm * Em + Em + h0_rows * Nm * Em
                          + Bm * nc * Nm * Em), 7 * blnes + 3 * bles, "f32"), None,
               f" (B={Bm} L={Ls} E={Em} N={Nm} chunk {chunk}, h0 rows {h0_rows}; "
               f"expf floor {blnes / SFU_EXP_PER_S * 1e3:.4f} ms)")
        got = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb0, chunk)
        want = ss.selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, gy, hb0, chunk)
        # each of the five outputs within 1e-4 x its own max; the record
        # holds the output nearest its tolerance
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        scales = [b.abs().max().item() for b in want]
        worst = max(range(5), key=lambda i: errs[i] / scales[i])
        for name, e_, s_ in zip(("ddt", "dx", "dB", "dC", "dA_T"), errs, scales):
            check(e_ <= 1e-4 * s_, f"K10{label} {name}: max |kernel - plain| {e_} > "
                  f"1e-4 x {s_}")
        # reads dt, x, g, B, C, A_T, hb; writes ddt, dx, dB and dC (the
        # per-block slabs summed into dB, dC are the kernel's choice, not
        # the function's bytes). Per (b, t, n, e) ~20 operations: the
        # forward recompute (4) and the reverse step (16); 2 expf
        record(f"selective_scan_bwd{label}", "medtsllm_tpu_torch/csrc/selective_scan_bwd.cu",
               "medtsllm_tpu/ops/pallas/selective_scan.py:414", errs[worst], 1e-4 * scales[worst],
               cuda_ms(torch, lambda: ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb, chunk,
                                                           need_dA=False)),
               cuda_ms(torch, lambda: ss.selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, gy, hb,
                                                                 chunk),
                       iters=3, warmup=1),
               bound(4 * (5 * bles + 4 * blns + Nm * Em + Bm * nc * Nm * Em),
                     20 * blnes + 6 * bles, "f32"), None,
               f" (as K9, without dA_T as in training; error of "
               f"{('ddt', 'dx', 'dB', 'dC', 'dA_T')[worst]}, the output nearest its "
               f"tolerance; expf floor {2 * blnes / SFU_EXP_PER_S * 1e3:.4f} ms)")

    check_train_scan("", Lm, 1)
    check_train_scan("[uncached]", Pm + Lm, 0)

    wrappers = {"w8a8_quantize": k1.quantize_rows, "w8a8_gemm": k1.int8_gemm,
                "rope_attention": k2.rope_attention,
                "reprogramming_attention": k3.reprogramming_attention,
                "selective_scan": ss.selective_ssm,
                "selective_scan_h0": ss.selective_ssm_h0,
                "selective_scan_final": ss.selective_ssm_final,
                "selective_scan_bounds": ss.selective_ssm_bounds,
                "selective_scan_bwd": ss.selective_ssm_bwd}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def serve(tr, label):
        """``test()`` with every launch count set to 0 just before and read
        just after; then the p50 of the eval step over the test batches."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        start.record()
        scores = tr.test()
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: w.launches for name, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        n_windows = len(tr.test_dataset)
        print(f"[{label}] test() {n_windows} windows in {len(tr.test_pipeline)} "
              f"batches: {start.elapsed_time(end):.1f} ms (CUDA events, prefill "
              f"and host prep included), {n_windows / wall:.2f} windows/s wall")
        print(f"[{label}] launches {counts}; peak memory {peak / 2**30:.2f} GiB")
        print(f"[{label}] scores {scores}")
        check(all(math.isfinite(s) for s in scores.values()), f"non-finite {scores}")
        preds, targets = tr.predict(tr.test_pipeline)
        check(preds.shape == targets.shape == (tr.eval_n_points(tr.test_dataset), 3),
              f"prediction shape {preds.shape}")
        check(bool(torch.isfinite(torch.from_numpy(preds)).all()), "non-finite preds")
        batch_ms = []
        for batch in tr.test_pipeline:
            prepared = tr.eval_prepare(batch)
            start.record()
            tr.eval_dispatch(prepared=prepared)
            end.record()
            end.synchronize()
            batch_ms.append(start.elapsed_time(end))
        bsz = tr.config.training.batch_size
        p50 = statistics.median(batch_ms)
        print(f"[{label}] eval step p50 {p50:.2f} ms per batch of {bsz} "
              f"({bsz * 1000 / p50:.1f} windows/s at p50; per batch {batch_ms})")
        return counts, preds

    def set_launches(counts, names):
        for entry in kernels:
            if entry["name"] in names:
                entry["launches"] = counts[names[entry["name"]]]

    # 4. the llama serving path, through the user's entry point
    counts, _ = serve(trainer, "slice")
    for name in ("w8a8_quantize", "w8a8_gemm", "rope_attention",
                 "reprogramming_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by the serving path")
    set_launches(counts, {n: n for n in ("w8a8_quantize", "w8a8_gemm", "rope_attention",
                                         "reprogramming_attention")})

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
    del gpu, cpu

    # 6. the Mamba serving path (prompt-state cache), then one uncached pass
    counts, preds = serve(mtrainer, "mamba")
    for name in ("selective_scan_h0", "selective_scan_final", "reprogramming_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by the Mamba path")
    set_launches(counts, {"selective_scan_h0": "selective_scan_h0",
                          "selective_scan_final": "selective_scan_final",
                          "reprogramming_attention[mamba-130m]":
                              "reprogramming_attention"})
    unc = get_trainer("chip-smoke-mamba-uncached",
                      mamba_config(Config, prefix_cache=False), device=dev)
    unc.load_state_dict(mtrainer.model.state_dict())
    counts, preds_u = serve(unc, "mamba-uncached")
    check(counts["selective_scan"] > 0 and counts["selective_scan_h0"] == 0,
          f"the uncached pass must run the scan from h = 0: {counts}")
    set_launches(counts, {"selective_scan": "selective_scan"})
    # bf16 storage: the two passes compute the head's activations at other
    # batch sizes (1 in the prefill, 48 in-graph), so cuBLAS may round them
    # differently, and 24 layers carry that on: the CPU tests' bf16
    # tolerance, |uncached - cached| <= 3e-2 (max |cached| + |cached|)
    diff, tol = abs(preds_u - preds), 3e-2 * (abs(preds).max() + abs(preds))
    check(bool((diff <= tol).all()), f"Mamba uncached vs cached predictions differ: "
          f"max |diff| / tolerance {float((diff / tol).max())}")
    print(f"[mamba-uncached] vs cached: max_abs_err {float(diff.max()):.3e}, largest "
          f"share of the tolerance {float((diff / tol).max()):.3f}")
    del mtrainer, mmodel, unc
    torch.cuda.empty_cache()

    # 7. a 2-layer mamba-130m f32 slice on the card against the CPU (f32 in
    # the depthwise conv too: cuDNN's TF32 is off above)
    small = mamba_config(Config, n_points=512, batch=2, history=64, dtype="float32",
                         llm_layers=2)
    gpu = get_trainer("chip-smoke-mamba-small", small, device=dev)
    cpu = get_trainer("chip-smoke-mamba-small", small, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
    batch = next(iter(gpu.test_pipeline))
    out_gpu = gpu.eval_dispatch(batch).cpu()
    out_cpu = cpu.eval_dispatch(batch)
    err = (out_gpu - out_cpu).abs().max().item()
    # f32 end to end: summation order and fused multiply-adds only
    tol = 1e-3 * max(1.0, out_cpu.abs().max().item())
    check(err <= tol, f"mamba slice: card vs CPU max err {err} > {tol}")
    print(f"[reference] mamba-130m 2-layer f32 slice, card vs CPU: "
          f"max_abs_err {err:.3e} (tol {tol:.3e})")

    del gpu, cpu
    torch.cuda.empty_cache()

    def drive(fn):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after; returns (counts, wall seconds)."""
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return {name: w.launches for name, w in wrappers.items()}, time.perf_counter() - t0

    def step_p50(tr, label, n_steps, expect=None):
        """p50 of ``train_step`` (CUDA events) over the next shuffled train
        batches, their inputs prepared first; ``expect`` maps kernels to
        their launches in every step."""
        arrays = [tr.train_model_inputs(b) for _, b in zip(range(n_steps), tr.train_pipeline)]
        step_ms = []
        for a in arrays:
            for w in wrappers.values():
                w.launches = 0
            start.record()
            loss = tr.train_step(a, a["valid"])
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            counts = {name: w.launches for name, w in wrappers.items()}
            check(math.isfinite(float(loss)), f"{label}: non-finite loss {float(loss)}")
            for name, n in (expect or {}).items():
                check(counts[name] == n, f"{label}: {name} launched {counts[name]} times "
                      f"in a train step, not {n}: {counts}")
        bsz = tr.config.training.batch_size
        p50 = statistics.median(step_ms)
        print(f"[{label}] train step p50 {p50:.2f} ms per batch of {bsz} "
              f"({bsz * 1000 / p50:.1f} windows/s at p50; per step {step_ms}); launches "
              f"in the last step {counts}")
        return p50

    # 8. the Mamba train path through the user's entry point: one epoch of
    # four shuffled batches of 48 (n_points 24704: 192 train and val
    # windows at step 128), then val()
    n_layers = scfg.n_layers
    tr = get_trainer("chip-smoke-mamba-train", mamba_config(Config, n_points=24704, epochs=1),
                     device=dev)
    n_steps = len(tr.train_pipeline)
    check(n_steps == 4, f"the Mamba train split gives {n_steps} batches, not 4")
    torch.cuda.reset_peak_memory_stats()
    counts, wall = drive(tr.train)
    print(f"[mamba-train] train() {n_steps} steps of {Bm} and val() over "
          f"{len(tr.val_dataset)} windows in {wall:.2f} s wall; losses {tr.losses}; "
          f"val {tr.val_scores}; launches {counts}")
    check(len(tr.losses) == n_steps and finite(tr.losses), f"losses {tr.losses}")
    check(len(tr.val_scores) == 1 and finite(tr.val_scores[0].values()),
          f"val scores {tr.val_scores}")
    # the train steps run K9 and K10 once per layer and neither K7 nor K8;
    # val() runs K8 per layer and batch, after the prefill of the head
    check(counts["selective_scan_bounds"] == counts["selective_scan_bwd"] == n_layers * n_steps
          and counts["selective_scan"] == 0
          and counts["selective_scan_h0"] == n_layers * len(tr.val_pipeline),
          f"Mamba train() launches {counts}")
    set_launches(counts, {"selective_scan_bounds": "selective_scan_bounds",
                          "selective_scan_bwd": "selective_scan_bwd"})
    per_step = {"selective_scan_bounds": n_layers, "selective_scan_bwd": n_layers,
                "selective_scan": 0, "selective_scan_h0": 0, "selective_scan_final": 0}
    step_p50(tr, "mamba-train", n_steps, per_step)
    print(f"[mamba-train] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # one step with the prompt head embedded in the graph: K9 from h = 0
    # over [head | region], K10 from its states
    batch = next(iter(tr.train_pipeline))
    arrays = tr._to_device(tr.model_inputs(batch))
    check("prefix_ids" in arrays, "the uncached train step needs the embedded head")
    counts, _ = drive(lambda: check(math.isfinite(float(tr.train_step(arrays, arrays["valid"]))),
                                    "non-finite uncached Mamba loss"))
    check(all(counts[k] == n for k, n in per_step.items()),
          f"uncached Mamba train step launches {counts}")
    set_launches(counts, {"selective_scan_bounds[uncached]": "selective_scan_bounds",
                          "selective_scan_bwd[uncached]": "selective_scan_bwd"})
    del tr, arrays
    torch.cuda.empty_cache()

    # 9. the llama finetune step: the 7B-shaped w8a8 bf16 configuration
    # trained through train() (n_points 3200: three shuffled batches of 8,
    # then val() over 24 windows); the int8 backbone is frozen, the fusion
    # layers train through K1's straight-through backward and K2's
    tr = get_trainer("chip-smoke-llama-train", bench_config(Config, n_points=3200),
                     device=dev)
    trainable = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                 if p.requires_grad}

    def backbone():  # float tensors whole (0.27 GB), int8 weights by exact sums
        return {n: t.detach().clone() if t.is_floating_point()
                else torch.sum(t, dtype=torch.float64)
                for n, t in tr.model.state_dict().items() if n.startswith("llm.")}
    frozen = backbone()
    check(trainable and not any(n.startswith("llm.") for n in trainable),
          "the backbone must be frozen")
    torch.cuda.reset_peak_memory_stats()
    counts, wall = drive(tr.train)
    n_steps = len(tr.train_pipeline)
    print(f"[llama-train] train() {n_steps} steps of {B} and val() in {wall:.2f} s wall; "
          f"losses {tr.losses}; val {tr.val_scores}; launches {counts}")
    check(len(tr.losses) == n_steps and finite(tr.losses), f"losses {tr.losses}")
    check(finite(tr.val_scores[0].values()), f"val scores {tr.val_scores}")
    for name in ("w8a8_quantize", "w8a8_gemm", "rope_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by the finetune path")
    state = tr.model.state_dict()
    unchanged = [n for n, t in trainable.items() if torch.equal(state[n], t)]
    check(not unchanged, f"trainable parameters that did not change: {unchanged}")
    check(all(torch.equal(t, frozen[n]) for n, t in backbone().items()), "the backbone changed")
    del trainable, frozen, state
    n_block = lcfg.n_layers
    step_p50(tr, "llama-train", n_steps, {"w8a8_quantize": 7 * n_block,
                                          "w8a8_gemm": 7 * n_block,
                                          "rope_attention": n_block})
    print(f"[llama-train] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tr
    torch.cuda.empty_cache()

    # 10. one f32 train step of 2-layer slices on the card against the CPU
    # (plain versions) with the same weights, dropout 0: the loss and the
    # gradient of every trainable parameter, relative to that gradient's
    # largest element. f32 end to end: summation order and fused
    # multiply-adds only, so 1e-3. The reprogramming key bias is left out:
    # its exact gradient is 0 (the softmax over keys ignores a constant
    # added to a query's scores), both sides hold rounding noise; it is
    # held below 1e-4 of the largest gradient instead
    slices = (("mamba-130m 2-layer f32",
               mamba_config(Config, n_points=512, batch=2, history=64, dtype="float32",
                            llm_layers=2, dropout=0.0)),
              ("llama-1b 2-layer GQA dense f32",
               bench_config(Config, llm="llama-1b", batch=2, history=64, dtype="float32",
                            n_points=256, num_tokens=128, d_ff=64, llm_layers=2,
                            load_in_8bit=False, dropout=0.0)))
    for label, scfg_t in slices:
        gpu = get_trainer("chip-smoke-train-small", scfg_t, device=dev)
        cpu = get_trainer("chip-smoke-train-small", scfg_t, device="cpu")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
        batch = next(iter(gpu.train_pipeline))
        ag, ac = gpu.train_model_inputs(batch), cpu.train_model_inputs(batch)
        lg = float(gpu.train_step(ag, ag["valid"]))
        lc = float(cpu.train_step(ac, ac["valid"]))
        loss_err = abs(lg - lc) / abs(lc)
        grads_c = {n: p.grad for n, p in cpu.model.named_parameters() if p.requires_grad}
        grads_g = {n: p.grad.cpu() for n, p in gpu.model.named_parameters() if p.requires_grad}
        top = max(t.abs().max().item() for t in grads_c.values())
        worst, worst_name = 0.0, ""
        for n, gc in grads_c.items():
            diff = (grads_g[n] - gc).abs().max().item()
            if n.endswith("key_projection.bias"):
                check(max(gc.abs().max().item(), grads_g[n].abs().max().item()) <= 1e-4 * top,
                      f"{label}: {n} should hold rounding noise only")
                continue
            rel = diff / max(gc.abs().max().item(), 1e-30)
            if rel > worst:
                worst, worst_name = rel, n
        check(loss_err <= 1e-5, f"{label}: train loss card {lg} vs CPU {lc}")
        check(worst <= 1e-3, f"{label}: gradient of {worst_name} differs by {worst} "
              "of its largest element (tolerance 1e-3)")
        print(f"[reference-train] {label} train step, card vs CPU: loss {lg:.6f} vs "
              f"{lc:.6f} (relative {loss_err:.2e}, tol 1e-5); largest gradient error "
              f"{worst:.3e} of its tensor's max ({worst_name}; tol 1e-3) over "
              f"{len(grads_c)} trainable tensors")
        del gpu, cpu

    check(all(e["launches"] for e in kernels), f"unlaunched kernels: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
