#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``medtsllm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
nvidia-smi. Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the hand-written kernels (csrc/*.cu) with its seconds;
  3. each kernel against its plain PyTorch version at the shapes the
     serving and train paths give it (K1 and K5 integers and outputs
     bit-equal, at the 7B and moe-8x1b blocks; K6 in its gate+up and down
     forms with int8 and with packed int4 experts, on a random and a skewed
     routing, with its requant pass timed apart (``[requant]``, beside the
     workspace's bytes), its raster at group_m 1 and 16 (``[raster]``) and
     K1's GEMM per expert over the same rows (``[yardstick]``); K2 with a
     per-row prefix at ecgmit-seg.toml's clip shape, each query row held
     against the plain version fed the once-rounded rotation), with both
     times from CUDA events, the least time the card could take for the
     same work (bound) and, where one exists, the time of the one PyTorch
     call that computes the same function (timed here only; the port never
     calls it);
  4. the llama serving path: ``get_trainer(...).test()`` of MedTsLLM on the
     Llama-2-7B-shaped w8a8 bf16 backbone (random weights from a seed) at
     batch 8, history 256, with the prompt-head KV cache; the launch count
     of every kernel in that run; windows/s, p50 ms per batch and peak
     memory; finite scores;
  5. a small 2-layer GQA slice (dense f32 projections) on the card against
     the same slice on the CPU (plain versions) with the same weights;
  6m. (the first of the 6 phases) configs/ablation/ecgmit-seg-examples.toml
     as shipped (in-context examples; the ECG family's stand-in and its
     example pool, mixed, the dense Llama-2-7B at full depth, batch 16,
     ``training.epochs`` cut to 1): the example length and the head / prompt / post buckets, K2 over
     [prompt | example | post | patches] and K3 at the window's and the
     example's patch counts (listed as ``rope_attention[ecgmit-seg-
     examples]``, ``reprogramming_attention[ecgmit-seg-examples]`` and
     ``[ecgmit-seg-examples-example]``), ``train()`` (captured steps, then
     ``val()``: K3 twice a val batch), ``train_graphed``, ``serve()`` (K3
     twice a batch), then the cached head against the head embedded in the
     step (2^-5 x max: 6d's bound for two orders of bf16 sums);
  6n. the mode sweep at the 7B's width cut to 4 layers on bidmc.toml's
     settings (3 features, 4 test batches): ``independent``,
     ``interleave``, ``add``, ``weighted-average``, ``merge-end``, the
     ``truncate`` and ``average`` downsamples and ``llm.enabled = false``,
     each through ``build_task`` (its build's peak; K2 and K3 held at its
     shapes: B * C rows for the per-channel modes, a P * C-token region
     for ``interleave``), ``serve()`` (replays bit-equal) and
     ``train_graphed`` over 2 steps; the disabled backbone's build peak
     against a 4-layer one's (no decoder block built); then
     ``independent`` and ``merge-end`` on ecgmit-seg.toml's settings (24
     clips through the 16-row bank: K2 with B * C per-row prefixes) and
     ``independent`` on mamba-backbone.toml's (the gated scan over B * C
     rows from the one-row cached state). Listed: ``rope_attention[mode-
     independent]`` / ``[mode-interleave]`` / ``[mode-independent-bank]``,
     ``reprogramming_attention[mode-independent]`` and
     ``selective_scan_gated_h0[mode-independent-mamba]``;
  6a. the tasks under ``setup.dtype = "mixed"`` (the shipped
     configs/datasets/*.toml as they are but for synthetic data; a dense
     Llama-2-7B backbone stored at bf16, f32 fusion layers, batch 16):
     bidmc.toml's segmentation: the build's seconds and peak memory, K2
     and K3 held at its shapes (printed), ``train()`` four steps and
     ``val()`` (finite losses, the full key set, a frozen backbone, K2 per
     layer per step), then ``train_graphed``: the train step's p50 over 16
     steps after one untimed, op by op and captured, and both peaks, then
     ``serve()`` over 32 test batches on a trainer that loads the trained
     weights;
  6b. ecgmit-anom.toml's anomaly detection through ``serve()`` (32 test
     batches);
  6c. ventilator.toml's semantic segmentation (binary) as shipped
     (``prompting.clip``: per-clip head rows from the KV bank) on 64 clips
     at 4 layers through ``serve()`` (32 test batches);
  6e. ecgmit-seg.toml's boundary segmentation as shipped at full depth:
     ``train()`` four steps on 32 clips (the per-clip heads embedded in the
     train step) and ``val()`` (banked), ``train_graphed``,
     then ``serve()`` over 33 test batches of 48 clips (MIT-BIH's record
     count) through a bank of 16 rows, on a trainer that loads the trained
     weights;
  6f. ludb.toml's 4-class semantic segmentation as shipped at full depth
     (``covariate_mode = "univariate"``, one feature, history 512, 64
     patches, K3 at E 128) on 200 clips through ``serve()`` (38 batches);
  6g-6i. the forecasting, classification and imputation tasks under mixed
     at full depth, each configuration composed of a shipped task file's
     task block (``task``, ``history_len``, ``pred_len``, ``data.step``,
     ``[training]``, ``[tasks.*]``) and bidmc.toml's MedTsLLM settings
     (``task_block_config``): 6g bidmc-gpt4ts.toml's BIDMC forecasting
     (batch 16, history 256, pred 64, step 64), 6h
     dreams-classification.toml's artifact classification (batch 16,
     history 128, ``window_label = "any"``, 5 features, ce), 6i
     etth1-imputation.toml's imputation (batch 32, history 96, 7 features,
     ``mask_rate`` 0.25). Each as 6a: the build's seconds and peak, K2 and
     K3 at its shapes (printed), ``train()`` four steps and ``val()``,
     ``train_graphed``, then ``serve()`` over 32 test batches on a
     trainer that loads the trained weights (imputation's ``mask`` an input
     of the captured step);
  6j. bidmc.toml as shipped, ``data.dataset = "bidmc"``: the BIDMC family's
     stand-in (the recordings are not in the repository; it warns) and its
     description in the cached head, ``training.epochs`` cut to 1:
     ``train()`` (20 captured steps and ``val()``), ``train_graphed``,
     ``serve()`` (4 test batches), then one ``test()`` with
     ``distance_thresh = "optimize"`` (the Bayesian search on the host:
     the chosen distance, its host seconds, no scikit-learn loaded); K2 at
     its head listed as ``rope_attention[bidmc-shipped]``;
  6k. pretraining at full width (bidmc.toml's MedTsLLM settings, ``task =
     "pretraining"``, the ECG, ventilator, bidmc and ludb stand-ins mixed):
     no cached head, no ``prefix_ids``, K2 with no prefix over [prompt |
     32 patches] (listed as ``rope_attention[pretraining]``, 32 launches a
     batch); ``train_graphed``'s captured steps, then ``serve()`` (24
     test batches);
  6l. the run lifecycle at bidmc.toml's full width, its run directories
     under a temporary directory: (a) ``python -m medtsllm_tpu_torch.train``
     as a subprocess on bidmc.toml as shipped (``dumps_toml`` of it, only
     ``training.epochs = 1`` and ``paths.logdir`` changed; the logger as
     shipped, tensorboard: the print logger's behaviour with a warning on a
     machine without it), printing the logger used, the checkpoint's bytes
     and the run directory's layout; (b) ``python -m
     medtsllm_tpu_torch.test <run_id> test latest <logdir>``, its scores
     equal to (a)'s exactly; (c) a second train subprocess sent SIGUSR1
     after its first step line: exit 0, ``latest`` at epoch 1 with
     ``step > 0``; then ``from_run_id`` in this process (the trainable
     parameters bit-equal to the checkpoint's), a sync and an async save
     timed, and ``train()`` finishing the epoch; (d) 6k's
     ``pretraining_config`` 4 captured steps saved as ``latest``, then
     bidmc.toml with ``[finetuning]`` from it (warmup 1 epoch at 0.1): the
     loaded tensors (no ``output_projection``) bit-equal to the
     checkpoint's, LRs [1e-4, 1e-5] in epoch 0, ``train()`` moving them;
     K2 / K3 launches printed, not listed. The other phases' configs set
     ``DEBUG`` (as bench.py does): no run directory;
  6d. each task's window predictions on a 2-layer llama-1b slice under
     mixed, card against the CPU's plain versions (2^-5 x max), ecgmit-seg
     on 12 clips through a bank of 8 rows on both, forecasting (pred 16),
     classification and imputation at history 64;
  6. the Mamba serving path: ``get_trainer(...).test()`` of
     configs/ablation/mamba-backbone.toml's model (mamba-130m, 24 layers,
     bf16, batch 48, prompt-state cache) on synthetic data; the launches of
     the scan's forms (through the gated interface, ``selective_ssm_gated``)
     and K3; windows/s, p50 ms per batch, peak memory,
     finite scores; then one pass with prefix_cache = false, which runs the
     uncached scan and must agree with the cached pass;
  7. a 2-layer mamba-130m f32 slice on the card against the CPU;
  8. the Mamba train path: ``get_trainer(...).train()`` of the same
     mamba-130m configuration (one epoch of four shuffled batches of 48,
     then ``val()``), the launches of K9 (the scan that records its
     chunk-start states) and K10 (its backward) in that run and in each
     further train step (24 each, and no K7/K8), ``train_graphed``; the
     train step with the prompt head embedded (K9/K10 at the uncached
     shape), a second signature: its capture, then a replay;
  9. the llama finetune step: ``train()`` of the Llama-2-7B-shaped w8a8
     bf16 configuration (frozen int8 backbone, trainable fusion layers,
     batch 8): finite losses, changed fusion layers, an unchanged backbone,
     K1 and K2 launched; ``train_graphed``;
 10. one f32 train step of 2-layer slices (mamba-130m widths; llama-1b
     dense, GQA) on the card against the CPU with the same weights: the
     loss and the gradient of every trainable parameter; then the card's
     update (capturable Adam with a clip that bites; SGD) against a CPU
     optimizer given the card's state and gradients, after the first step
     and after a replay under the next epoch's LR: every parameter and
     optimizer-state tensor;
 11. the MoE serving path: ``get_trainer(...).test()`` of
     configs/ablation/moe-backbone.toml's model (moe-8x1b: 22 blocks, d 2048,
     GQA 32/4 x 64, 8 experts top-2, d_ff 5632; w8a8, bf16, batch 48,
     prompt-head KV cache, ``moe_grouped = "auto"``, which is on for the
     card) on synthetic data: the launches of both K6 forms (2 per layer per
     batch, plus the prefill), K1, K2 and K3; p50 ms per batch, windows/s,
     peak memory, finite scores;
 12. one moe-8x1b MoE layer (the served weights of block 0): the grouped
     chain (K6) against the same layer on the CPU (the plain chain), with
     the share of differing requantized int8 codes, and against the
     dropless capacity bmm on the card (relative difference < 0.05 at f32
     compute: JAX's own law at these widths is 0.032-0.033);
 13. the served MoE model with ``moe_grouped = false`` (the capacity-1.25
     bmm, K1 per expert): finite scores (it drops tokens, so it is not
     compared);
 14. the int4 llama serving path: phase 4's configuration with
     ``load_in_4bit`` (quant_type int4): K1's quantizer and K5 on all seven
     projections of every block, K1's GEMM never; p50, windows/s, peak
     memory, finite scores;
 15. the int4 MoE serving path: phase 11's configuration with
     ``load_in_4bit``: K6's w_bits=4 forms twice and K5 four times per layer
     per batch and in the prefill; p50, windows/s, peak memory, finite
     scores;
 16. one int4 moe-8x1b layer, the card's grouped chain against the CPU's
     and against the dropless int4 bmm (relative difference < 0.05: JAX's
     own law at these widths is 0.032); a 2-layer llama-1b nf4 slice at f32
     on the card against the CPU;
 17. the long-window llama serving path: ``test()`` of phase 4's
     configuration at history 16384 (2048 patches, ~2,167 keys, past K2's
     2048) with d_ff 64, batch 8, two test batches: the K4 route
     (``rope_flash_attention``: the pre-pass ``rope_flash_keys``, then K4
     with q rotated at load) 32 times per batch, K2 only in the prefill of
     the prompt head; windows/s, p50, peak memory (reset after the build),
     finite scores; then one batch with the head embedded in the graph
     (L == S, JAX's padded-kernel route) against the same batch served
     from a cache prefilled on the K4 route (1e-5 x max);
 18. the crossover window: ``test()`` at history 4096 (~630 keys, d_ff
     128): the launches ``K4_MIN_KEYS`` says (K2 or the K4 route);
 19. a 2-layer llama-1b dense f32 slice with every attention forced onto
     the K4 route (``K4_MIN_KEYS`` set to 1 for the phase, then restored) on
     the card against the CPU.
Phase 3 also prints the route table behind ``K4_MIN_KEYS``: K2, the K4
route and RoPE + SDPA at 512, 1024, 2048 and 4096 keys of the 7B layout,
the route held in three parts up to 2048 keys (the pre-pass and q's
rotation bit-equal to one f32 rotation, each query row of the attention on
those inputs within 2^-6 x its max, the whole route within 2^-6 x the
output's max of its plain version, which rounds the rotation three times);
the quantizer's rows also print its device time (``queued_ms``); K10 is
held bit-equal from one call to the next. The scan's forward forms are held
twice: through the raw f32 interface (``selective_scan``, ``_h0``,
``_final``: printed, not listed, since serving reaches them through the
gated interface; ``selective_scan_bounds``, K9, listed) and through the
mixer's gated bf16 interface on strided views (``selective_scan_gated``,
``_gated_h0``, ``_gated_final``, listed; each element finite and within one
bf16 step of y and of the product), each with the special-function units'
floor beside its bound. Phase 17 first checks K4 through
its JAX interface (q rotated, [B, H, L, D]) against its plain version at
the long window's shapes (cached, uncached L == S, non-causal, GQA 32 / 4 x
64), each query row within 2^-6 x the largest |plain| of that row (printed,
not listed: the served path reaches K4 through the route), then the route
at the served cached and uncached shapes (rows
``rope_flash_attention[long]`` / ``[uncached]``, held in the three parts,
with RoPE + SDPA's time, and the pre-pass ``rope_flash_keys[long]`` /
``[uncached]`` with its byte bound), then K1 over one 7B block at the long
window's M (8 x 2,128 = 17,024 rows; rows ``w8a8_quantize[long]`` and
``w8a8_gemm[long]``, bit-equal, with the library's time) and K3 at the long
window's shape (B 8, L 2048, H 8, E 64 = the cell's d_ff, S 1024; row
``reprogramming_attention[long]``, with SDPA's time; E 128 printed beside
it), all listed with the launches of the long run.
Every served path (phases 4, 6a-6c, 6e-6i, 6, 11, 13, 14, 15, 17 and 18) runs
through ``serve()``: the eager step (``eval_step_eager``) on each test batch,
each batch prepared just before it (its head's or its bank misses' prefill
counted apart), then
``test()``, whose eval step replays one CUDA graph per input signature
(``runtime/graph.py``; the first batch of a signature runs eagerly and is
captured); it prints the eager and the graphed p50 side by side, the graphs
and their capture ms, the peak memory of both and the pool the graphs
hold, ``test()``'s windows/s (first pass, captures included, and a second
pass that must score the same), and holds every replay bit-equal to the
eager step with the eager step's launches; ``test()``'s launches are the
preparations' and the eager batches', and they are what the kernels line
carries. A path with a per-clip KV bank (6c, 6e) also prints each pass's
hits, misses and evictions (evictions required), the bank's GiB and one
miss's prefill ms, and holds the banked step against the same batch with
its head embedded (2^-6 x max); its replays run across evictions.
Every train path (6a, 6e, 6g-6i, 8, 9) trains through ``train()``, whose
train step replays one CUDA graph per input signature (forward, backward,
clip and Adam; ``TrainGraphs``), and then ``train_graphed``: the train
step's p50 op by op (``train_step_eager``) and captured (``train_step``)
side by side, each's peak memory, the graphs, their capture ms and the
train pool's GiB, every graphed step with the eager step's launches; then
the parameters, the optimizer's state and the dropout generator snapshot
in place, 4 graphed steps across an LR change, the snapshot restored and 4
eager steps: the losses, the trainable parameters, the optimizer's state,
the gradients and the generator's state bit-equal, and the backbone
unchanged.
Then one JSON line with the kernels and, last, the result line. Any failure
raises (exit code != 0) and prints no result line; without a CUDA card it
fails before any work.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import tomllib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
MAMBA_TOML = ROOT / "configs" / "ablation" / "mamba-backbone.toml"
MOE_TOML = ROOT / "configs" / "ablation" / "moe-backbone.toml"
BIDMC_TOML = ROOT / "configs" / "datasets" / "bidmc.toml"
ECG_ANOM_TOML = ROOT / "configs" / "datasets" / "ecgmit-anom.toml"
VENTILATOR_TOML = ROOT / "configs" / "datasets" / "ventilator.toml"
ECG_SEG_TOML = ROOT / "configs" / "datasets" / "ecgmit-seg.toml"
LUDB_TOML = ROOT / "configs" / "datasets" / "ludb.toml"
ECG_EXAMPLES_TOML = ROOT / "configs" / "ablation" / "ecgmit-seg-examples.toml"
# the task blocks of phases 6g-6i (each file's model is a baseline the port
# lacks; bidmc.toml gives the MedTsLLM settings)
BIDMC_FORECAST_TOML = ROOT / "configs" / "baseline-models" / "bidmc-gpt4ts.toml"
DREAMS_CLS_TOML = ROOT / "configs" / "ablation" / "dreams-classification.toml"
ETTH1_IMP_TOML = ROOT / "configs" / "ablation" / "etth1-imputation.toml"
# phase -> (task file, features, (points a split for train(), for serve()))
TASK_BLOCKS = {
    # 6g: history 256, pred 64, step 64: 64 train windows, 512 test
    "bidmc-forecast": (BIDMC_FORECAST_TOML, 3, (64 * 64 + 319, 512 * 64 + 319)),
    # 6h: history 128, step 64, window_label "any": one row of 2 logits
    "dreams-classification": (DREAMS_CLS_TOML, 5, (63 * 64 + 128, 512 * 128)),
    # 6i: history 96, step 1, batch 32: 128 train windows, 1024 test
    "etth1-imputation": (ETTH1_IMP_TOML, 7, (127 + 96, 1024 * 96)),
}
# points a split of a served task path, by history (= pred_len = the test
# split's step): 512 test windows, 32 batches of 16
SERVED_POINTS = {256: 512 * 256, 128: 512 * 128}
# ecgmit-seg.toml's served clip dataset (phase 6e): the 48 records of
# MIT-BIH Arrhythmia, 11 test windows of 256 a clip (528 windows, 33
# batches of 16), three times the per-clip KV bank's 16 rows
SEG_CLIPS, SEG_CLIP_POINTS = 48, 11 * 256
# ludb.toml's (phase 6f): LUDB's 200 records, 3 test windows of 512 a clip
# (600 windows, 38 batches)
LUDB_CLIPS, LUDB_CLIP_POINTS = 200, 3 * 512
# the mode sweep (phase 6n) on bidmc.toml's settings: 64 test windows of 256,
# 4 batches of 16
SWEEP_POINTS = 64 * 256
# each task's score keys (without the split's prefix)
TASK_KEYS = {
    "segmentation": {"point_mae", "point_rmse", "segment_miou", "pred_label_ratio",
                     "point_acc@50", "point_acc@100", "point_acc@200", "segment_acc@50iou",
                     "segment_acc@75iou", "segment_acc@90iou"},
    "anomaly_detection": {"accuracy", "f1", "auroc", "precision", "recall", "iou",
                          "recon_mse", "recon_mae", "anomaly_quantile", "anomaly_threshold"},
    "semantic_segmentation": {"accuracy", "f1", "precision", "recall", "iou"},
    "forecasting": {"mse", "mae"},
    "classification": {"accuracy", "f1", "precision", "recall", "auroc"},
    "imputation": {"masked_mse", "masked_mae", "full_mse"},
    "pretraining": {"mse", "mae"},
}

# One H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): HBM bytes
# per second and peak operations per second by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# expf on the special-function units: 16 results per clock per SM, 132 SMs
# at the 1.98 GHz boost clock (Hopper white paper); a floor the scan's
# bound does not count, printed beside it
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def quiet(Config, raw: dict):
    """``raw`` as a Config with ``DEBUG`` set, as bench.py sets it on every
    config it runs: the debug logger, which writes no run directory and no
    checkpoint (phase 6l runs the lifecycle with ``DEBUG`` off)."""
    return Config(dict(raw, DEBUG=True))


def bench_config(Config, llm="meta-llama/Llama-2-7b-hf", batch=8, history=256,
                 dtype="bf16", n_points=8192, num_tokens=1024, d_ff=128,
                 llm_layers=-1, load_in_8bit=True, dropout=0.1, quant_type=None):
    """The configuration of ``bench.py`` (build_trainer defaults): served by
    ``test()``, trained (the frozen-w8a8 finetune step) by ``train()``.
    ``quant_type`` ("int4", "nf4", "fp4") loads the backbone in 4 bits in
    place of 8 (``bench.py --quant 4``). ``DEBUG`` as in bench.py: no run
    directory is written (the debug logger)."""
    return Config({
        "DEBUG": True,
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
                    "prefix_cache": True, "load_in_8bit": load_in_8bit and not quant_type,
                    "load_in_4bit": bool(quant_type), "quant_type": quant_type or "int4"}}},
        "setup": {"seed": SEED, "dtype": dtype, "logger": "print"},
    })


def mamba_config(Config, n_points=49152, batch=None, history=None, dtype=None,
                 llm_layers=-1, prefix_cache=True, epochs=None, dropout=None, model=None):
    """configs/ablation/mamba-backbone.toml (mamba-130m, reconstruction,
    concat covariates, history 256, patch 16 / 8, bf16, dense projections,
    batch 48, adam at 1e-4, mse, dropout 0.1) on the synthetic 3-feature
    data: the ventilator files are not in the repository. The default
    n_points gives 192 test windows, four batches of 48. ``model`` as in
    ``task_config``."""
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
    set_model(raw["models"]["timellm"], model)
    return quiet(Config, raw)


def moe_config(Config, n_points=49152, batch=None, llm_layers=-1, moe_grouped=None,
               int4=False):
    """configs/ablation/moe-backbone.toml (moe-8x1b, w8a8, bf16, batch 48,
    history 256, patch 16 / 8, expert capacity 1.25 for the bmm path,
    ``moe_grouped`` left at "auto") on the synthetic 3-feature data: the
    ventilator files are not in the repository. The default n_points gives
    192 test windows, four batches of 48. ``int4`` sets ``load_in_4bit``
    (absmax int4, w4a8) in place of ``load_in_8bit``."""
    raw = tomllib.loads(MOE_TOML.read_text())
    raw["data"]["dataset"] = "synthetic"
    raw["datasets"] = {"synthetic": {"n_points": n_points, "n_features": 3}}
    if batch is not None:
        raw["training"]["batch_size"] = batch
    llm = raw["models"]["timellm"]["llm"]
    llm["llm_layers"] = llm_layers
    if moe_grouped is not None:
        llm["moe_grouped"] = moe_grouped
    if int4:
        llm["load_in_4bit"], llm["load_in_8bit"] = True, False
    return quiet(Config, raw)


def long_config(Config, history=16384, d_ff=64):
    """``bench_config`` at a long window with 16 test windows, two batches
    of 8. At history 16384 the FlattenHead (d_ff x n_patches -> 3 x
    history) holds 6.4 G parameters at d_ff 64, the width of
    configs/datasets/bidmc.toml and ventilator.toml: 25.8 GB at the f32
    init, 12.9 GB at bf16 (bench.py's d_ff 128 would need 77 GB in
    flight)."""
    return bench_config(Config, history=history, d_ff=d_ff, n_points=16 * history)


def task_config(Config, toml, n_points, epochs=1, llm=None, llm_layers=None,
                history=None, batch=None, n_clips=None, n_features=3, n_classes=None,
                model=None):
    """A shipped dataset config (configs/datasets/*.toml) as it is, its
    model, prompting and task settings, ``setup.dtype = "mixed"`` and the
    Llama-2-7B shapes included, on the synthetic data (the recordings are
    not in the repository): ``n_points`` points a split of ``n_features``
    features (and ``n_classes`` classes, when given), in ``n_clips`` clips
    when given (each clip with its description: a clip dataset), one
    epoch; ``llm``, ``llm_layers``,
    ``history`` (step = history / 2) and ``batch`` cut the card-vs-CPU
    slices; ``model`` sets entries of ``[models.timellm]`` (a mode: its
    ``covariate_mode``, ``embedding_downsample_mode`` or ``llm``'s
    ``enabled``)."""
    from medtsllm_tpu_torch.config import load_config
    raw = load_config(toml).to_dict()
    raw["data"]["dataset"] = "synthetic"
    raw["datasets"] = {"synthetic": {"n_points": n_points, "n_features": n_features}}
    if n_clips is not None:
        raw["datasets"]["synthetic"].update(clips=True, n_clips=n_clips)
    if n_classes is not None:
        raw["datasets"]["synthetic"]["n_classes"] = n_classes
    raw["training"]["epochs"] = epochs
    mc = raw["models"]["timellm"]
    if llm is not None:
        mc["llm"]["llm"] = llm
    if llm_layers is not None:
        mc["llm"]["llm_layers"] = llm_layers
    if history is not None:
        raw["history_len"] = raw["pred_len"] = history
        raw["data"]["step"] = history // 2
    if batch is not None:
        raw["training"]["batch_size"] = batch
    set_model(mc, model)
    return quiet(Config, raw)


def set_model(mc: dict, entries: dict | None) -> None:
    """Set ``entries`` in a ``[models.timellm]`` table, a nested dict merged
    (``{"llm": {"enabled": False}}`` keeps the other ``llm`` entries)."""
    for key, value in (entries or {}).items():
        if isinstance(value, dict):
            set_model(mc[key], value)
        else:
            mc[key] = value


def task_block_config(Config, task_toml, n_points, n_features, epochs=1, llm=None,
                      llm_layers=None, history=None, pred=None, batch=None):
    """A task the port's MedTsLLM runs but no shipped file pairs it with:
    the task block of ``task_toml`` (``task``, ``history_len``,
    ``pred_len``, ``data.step``, ``[training]``, ``[tasks.*]``; its own
    model is a baseline) on configs/datasets/bidmc.toml's MedTsLLM settings
    (``[models.timellm]``: patching, prompting, the dense Llama-2-7B, and
    ``setup.dtype = "mixed"``), on the synthetic data at the dataset's
    feature count. ``llm``, ``llm_layers``, ``history`` / ``pred`` (step =
    pred) and ``batch`` cut the card-vs-CPU slices."""
    from medtsllm_tpu_torch.config import load_config
    raw = load_config(BIDMC_TOML).to_dict()
    block = load_config(task_toml).to_dict()
    for key in ("task", "history_len", "pred_len", "training", "tasks"):
        raw.pop(key, None)
        if key in block:
            raw[key] = block[key]
    raw["data"]["step"] = block["data"]["step"]
    raw["data"]["dataset"] = "synthetic"
    raw["datasets"] = {"synthetic": {"n_points": n_points, "n_features": n_features}}
    raw["training"]["epochs"] = epochs
    mc = raw["models"]["timellm"]
    if llm is not None:
        mc["llm"]["llm"] = llm
    if llm_layers is not None:
        mc["llm"]["llm_layers"] = llm_layers
    if history is not None:
        raw["history_len"], raw["pred_len"] = history, pred or history
        raw["data"]["step"] = pred or history // 2
    if batch is not None:
        raw["training"]["batch_size"] = batch
    return quiet(Config, raw)


def shipped_config(Config, toml, epochs=1, **tasks):
    """A shipped config as it is, its ``data.dataset`` included (the
    family's stand-in when the recordings are absent, with its warning),
    ``training.epochs`` cut to ``epochs``; ``tasks`` replaces entries of
    its ``[tasks.<task>]`` table."""
    from medtsllm_tpu_torch.config import load_config
    raw = load_config(toml).to_dict()
    raw["training"]["epochs"] = epochs
    raw["tasks"][raw["task"]].update(tasks)
    return quiet(Config, raw)


def pretraining_config(Config):
    """Pretraining on configs/datasets/bidmc.toml's MedTsLLM settings
    (mixed, dense Llama-2-7B, batch 16, history 256, d_ff 64, its
    prompting): ``task = "pretraining"``, ``[tasks.pretraining]
    downsample_pct = 1.0, n_features = "auto"``; loss and eval metric
    mse (bidmc.toml's bce and segment_miou are segmentation's)."""
    from medtsllm_tpu_torch.config import load_config
    raw = load_config(BIDMC_TOML).to_dict()
    raw["task"] = "pretraining"
    raw["training"].update(epochs=1, loss="mse", eval_metric="mse",
                           eval_metric_direction="min")
    raw["tasks"] = {"pretraining": {"downsample_pct": 1.0, "n_features": "auto"}}
    return quiet(Config, raw)


def one_class(tr, split) -> bool:
    """A classification split whose window labels hold one class: its
    AUROC is NaN by the task's rule."""
    ds = getattr(tr, f"{split}_dataset")
    return tr.config.task == "classification" and len(
        np.unique([ds[i]["labels"] for i in range(len(ds))])) == 1


def scores_ok(tr, scores, split) -> bool:
    """Every score finite, but a one-class classification split's AUROC,
    which must be NaN."""
    nan = {f"{split}/auroc"} if one_class(tr, split) else set()
    return all(math.isnan(v) if k in nan else math.isfinite(v) for k, v in scores.items())


def same_scores(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def window_shapes(tr):
    """(P, L): the prompt head (its bucket, for per-clip head rows; 0 where
    no head is cached, as in the pretraining mixture) and the computed
    region (prompt suffix, the in-context example's patches and the prompt
    after it, then the window's patches, C a patch under ``interleave``)
    of a built trainer's first test batch (host only)."""
    first = tr.model_inputs(next(iter(tr.test_pipeline)))
    head = first.get("prefix_ids")
    L = tr.model.n_patches + sum(first[k].shape[1] for k in ("prompt_ids", "post_prompt_ids")
                                 if k in first)
    if "example_ts" in first:
        L += example_patches(tr)
    return (0 if head is None else head.shape[-1]), L


def example_patches(tr) -> int:
    """The tokens of the in-context example's encoding: its patches at
    ``example_len`` (C a patch under ``interleave``)."""
    m = tr.model
    n = int((tr.preprocessor.example_len - m.patch_len) / m.stride + 2)
    return n * m.n_features if m.covariate_mode == "interleave" else n


def k3_rows(tr, B) -> int:
    """The query rows K3 runs on for a batch of B windows: B under
    ``concat`` and ``univariate``, a row per channel (B * C) in the other
    covariate modes."""
    m = tr.model
    return B if m.covariate_mode in ("concat", "univariate") else B * m.n_features


def row_share(out, ref, rel=2.0 ** -6):
    """The largest share, over query rows (the last dim is D), of a row's
    max |out - ref| in ``rel`` x max |ref| of that row; at most 1 passes.
    Taken per row because an attention row that sees a few keys has outputs
    tens of times larger than a row that averages thousands, so one bound
    for the whole tensor would pass a wrong row of the second kind."""
    err = (out.float() - ref.float()).abs().amax(-1)
    lim = rel * ref.float().abs().amax(-1)
    return (err / lim.clamp_min(1e-30)).max().item()


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


def queued_ms(torch, fn, iters=20, warmup=3):
    """Mean device milliseconds per call of a host-bound ``fn`` (many small
    launches): the timed calls queue behind a sleeping kernel (~0.1 s), so
    the events time the device's work, not the host's enqueueing."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
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


def train_state(opt) -> list:
    """The tensors a step of ``opt`` (the port's ``runtime/optim.py``
    ``Optimizer``) updates, detached (their storage shared): the trainable
    parameters, then the optimizer's state parameter by parameter (Adam's
    step count and moments, SGD's momentum buffer). A captured step reads
    and writes them where they lie, so a snapshot is restored into them
    with ``copy_``."""
    import torch

    state = [t for p in opt.params for t in opt._opt.state.get(p, {}).values()
             if isinstance(t, torch.Tensor)]
    return [t.detach() for t in (*opt.params, *state)]


def pool_bytes(graphs) -> int:
    """The device memory the pool of ``graphs`` (``runtime/graph.py``'s
    ``StepGraphs`` or ``TrainGraphs``) holds: its segments' sizes."""
    import torch

    if graphs._pool is None:
        return 0
    pool = tuple(graphs._pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def cli_scores(stdout: str, prefix: str) -> dict:
    """The score dict a CLI printed after ``prefix`` ("Test results:" or
    "Results:"), a Python dict's repr (NaN printed as ``nan``)."""
    line = next(ln for ln in stdout.splitlines() if ln.startswith(prefix))
    return eval(line[len(prefix):], {"__builtins__": {}, "nan": math.nan, "inf": math.inf})


def run_cli(module: str, *args: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """``python -m medtsllm_tpu_torch.<module> args`` from the repository's
    root, on the card; fails unless it exits 0."""
    out = subprocess.run([sys.executable, "-u", "-m", f"medtsllm_tpu_torch.{module}", *args],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0, f"[lifecycle] {module} {' '.join(args)} exited "
          f"{out.returncode}: {out.stdout[-2000:]} {out.stderr[-3000:]}")
    return out


def lifecycle(runs: Path, dev, drive, Config) -> None:
    """Phase 6l: the train and test CLIs, SIGUSR1 and the resume, and
    pretraining -> finetuning, on the card at bidmc.toml's full width, the
    run directories under ``runs``."""
    import torch

    from medtsllm_tpu_torch.config import dumps_toml, load_config
    from medtsllm_tpu_torch.runtime.checkpoint import load_checkpoint, wait_for_saves
    from medtsllm_tpu_torch.tasks import get_trainer, task_lookup

    def shipped(**top) -> dict:
        raw = load_config(BIDMC_TOML).to_dict()
        raw["training"]["epochs"] = 1
        raw["paths"] = {"logdir": str(runs)}
        return dict(raw, **top)

    def trainable(tr) -> dict:
        return {n: p.detach() for n, p in tr.model.named_parameters() if p.requires_grad}

    cfg_path = runs / "bidmc.toml"
    cfg_path.write_text(dumps_toml(shipped()))

    # (a) the train CLI
    t0 = time.perf_counter()
    out = run_cli("train", str(cfg_path), "bidmc-cli")
    train_s = time.perf_counter() - t0
    test_a = cli_scores(out.stdout, "Test results:")
    run = runs / "bidmc-cli"
    warned = "tensorboard not installed" in out.stderr
    logger = ("tensorboard" if (run / "tensorboard").is_dir()
              else "print (tensorboard missing: warned)" if warned else "print")
    latest = run / "checkpoints" / "latest.ckpt"
    state, meta = load_checkpoint(latest)
    n_bytes = latest.stat().st_size
    n_params = sum(t.numel() for t in state.values())
    check(tomllib.loads((run / "config.toml").read_text()) == shipped()
          and json.loads((run / "config.json").read_text()) == shipped()
          and (run / "checkpoints" / "best.ckpt").is_file(),
          f"[lifecycle] the run directory: {sorted(p.name for p in run.rglob('*'))}")
    check(not any(n.startswith("llm.") for n in state) and meta["epoch"] == 2
          and meta["step"] > 0 and math.isfinite(meta["best_score"]),
          f"[lifecycle] latest: {meta}, names {sorted(state)[:4]}")
    check(all(math.isfinite(v) for v in test_a.values()), f"[lifecycle] test scores {test_a}")
    print(f"[lifecycle] (a) train CLI on bidmc.toml (epochs 1): {train_s:.1f} s wall; logger "
          f"{logger}; latest.ckpt {n_bytes:,} bytes: {len(state)} tensors, {n_params:,} "
          f"parameters (no llm.*), meta epoch {meta['epoch']} step {meta['step']} best "
          f"{meta['best_score']:.6f}; test {test_a}")

    # (b) the test CLI on (a)'s run directory
    t0 = time.perf_counter()
    out = run_cli("test", "bidmc-cli", "test", "latest", str(runs))
    test_b = cli_scores(out.stdout, "Results:")
    check(same_scores(test_a, test_b), f"[lifecycle] test CLI {test_b} != train CLI {test_a}")
    print(f"[lifecycle] (b) test CLI: {time.perf_counter() - t0:.1f} s wall; the scores equal "
          "(a)'s exactly")

    # (c) SIGUSR1 after the first step line, then the resume in this process
    t0 = time.perf_counter()
    err_path = runs / "bidmc-sig.stderr"
    with open(err_path, "w") as err:  # a file: a full pipe would stall the child
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "medtsllm_tpu_torch.train", str(cfg_path),
             "bidmc-sig"], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            stdout=subprocess.PIPE, stderr=err, text=True)
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("step "):
                    proc.send_signal(signal.SIGUSR1)
                    break
            rest, _ = proc.communicate(timeout=600)
        finally:
            proc.kill()
            proc.wait()
    stdout = "".join(lines) + rest
    check(proc.returncode == 0 and "Interrupted!" in stdout and "Test results" not in stdout,
          f"[lifecycle] SIGUSR1: exit {proc.returncode}: {stdout[-1500:]} "
          f"{err_path.read_text()[-2000:]}")
    sig_ckpt = runs / "bidmc-sig" / "checkpoints" / "latest.ckpt"
    saved, meta = load_checkpoint(sig_ckpt)
    check(meta["epoch"] == 1 and meta["step"] > 0, f"[lifecycle] SIGUSR1 latest meta {meta}")
    sig_s = time.perf_counter() - t0
    tr = task_lookup["segmentation"].from_run_id("bidmc-sig", basepath=runs, device=dev)
    check(tr.epoch == 1 and tr.step == meta["step"],
          f"[lifecycle] resumed at epoch {tr.epoch} step {tr.step}")
    params = trainable(tr)
    check(params.keys() == saved.keys() and all(torch.equal(params[n].cpu(), saved[n])
                                                  for n in saved),
          "[lifecycle] the restored trainable parameters differ from the checkpoint's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.logger.save_state("timing-sync", async_=False)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.logger.save_state("timing-async")
    call_s = time.perf_counter() - t0
    wait_for_saves()
    async_s = time.perf_counter() - t0
    counts, wall = drive(tr.train)
    check(len(tr.losses) == len(tr.train_pipeline) and finite(tr.losses) and tr.epoch == 2,
          f"[lifecycle] the resumed epoch: losses {tr.losses}, epoch {tr.epoch}")
    tr.log_end()
    _, meta2 = load_checkpoint(sig_ckpt)
    check(meta2["epoch"] == 2, f"[lifecycle] the resumed run's latest {meta2}")
    print(f"[lifecycle] (c) SIGUSR1 after the first step line: exit 0 in {sig_s:.1f} s wall, "
          f"latest epoch {meta['epoch']} step {meta['step']}; from_run_id: the "
          f"{len(saved)} trainable tensors bit-equal to the checkpoint's; save of "
          f"{n_bytes:,} bytes: sync {sync_s:.3f} s, async call {call_s:.3f} s (written "
          f"{async_s:.3f} s after it); the resumed epoch {len(tr.losses)} captured steps and "
          f"val() in {wall:.2f} s, losses finite; launches {counts}")
    del tr, params
    torch.cuda.empty_cache()

    # (d) pretraining -> finetuning
    t0 = time.perf_counter()
    pre_raw = dict(pretraining_config(Config).to_dict(), DEBUG=False)
    pre_raw["paths"] = {"logdir": str(runs)}
    pre = get_trainer("pretrain", Config(pre_raw), device=dev)
    pre.optimizer.set_epoch(0)
    for batch, _ in zip(pre.train_pipeline, range(4)):
        arrays = pre.train_model_inputs(batch)
        check(math.isfinite(float(pre.train_step(arrays, arrays["valid"]))),
              "[lifecycle] a pretraining step's loss")
    pre.logger.save_state("latest")
    pre.log_end()
    graphs = pre.train_graphs
    check(graphs is not None and len(graphs) == 1, f"[lifecycle] pretraining graphs {graphs}")
    del pre
    torch.cuda.empty_cache()
    pre_ckpt, _ = load_checkpoint(runs / "pretrain" / "checkpoints" / "latest.ckpt")
    ft = get_trainer("finetune", Config(shipped(finetuning={
        "enabled": True, "pretrained_id": "pretrain", "pretrained_ckpt": "latest",
        "warmup_epochs": 1, "warmup_factor": 0.1})), device=dev)
    loaded = set(ft.loaded_params)
    check(loaded and loaded == set(pre_ckpt) - {n for n in pre_ckpt
                                                 if n.startswith("output_projection")},
          f"[lifecycle] loaded {sorted(loaded)}")
    params = trainable(ft)
    check(all(torch.equal(params[n].cpu(), pre_ckpt[n]) for n in loaded),
          "[lifecycle] the loaded tensors differ from the pretraining checkpoint's")
    ft.optimizer.set_epoch(0)
    lrs = ft.optimizer.get_last_lr()
    check(len(lrs) == 2 and math.isclose(lrs[0], 1e-4, rel_tol=1e-12)
          and math.isclose(lrs[1], 1e-5, rel_tol=1e-12)
          and math.isclose(ft.optimizer.loaded_lr.item(), 1e-5, rel_tol=1e-6),
          f"[lifecycle] epoch 0 LRs {lrs}")
    counts, wall = drive(ft.train)
    check(len(ft.losses) == len(ft.train_pipeline) and finite(ft.losses),
          f"[lifecycle] finetune losses {ft.losses}")
    moved = [n for n in loaded if not torch.equal(params[n].cpu(), pre_ckpt[n])]
    check(len(moved) >= len(loaded) - 1, f"[lifecycle] loaded tensors unmoved: "
          f"{sorted(loaded - set(moved))}")
    ft.log_end()
    print(f"[lifecycle] (d) pretraining 4 captured steps saved, then bidmc.toml finetuning: "
          f"{len(loaded)} tensors loaded (output_projection not among them), bit-equal to the "
          f"checkpoint's; epoch 0 LRs {lrs}; train() {len(ft.losses)} captured steps and val() "
          f"in {wall:.2f} s, {len(moved)} loaded tensors moved; K2 {counts['rope_attention']} "
          f"and K3 {counts['reprogramming_attention']} launches (not listed); "
          f"{time.perf_counter() - t0:.1f} s wall")
    del ft, params
    torch.cuda.empty_cache()


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
    # which cuDNN would run in TF32 by default (the port's mixer keeps its
    # own f32 depthwise conv at f32 whatever this flag says)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from medtsllm_tpu_torch.config import Config
    from medtsllm_tpu_torch.models.llm import transformer as tfm
    from medtsllm_tpu_torch.ops.kernels import _build
    from medtsllm_tpu_torch.ops.kernels import flash_attention as k4
    from medtsllm_tpu_torch.ops.kernels import grouped_matmul as gm
    from medtsllm_tpu_torch.ops.kernels import reprogramming as k3
    from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
    from medtsllm_tpu_torch.ops.kernels import selective_scan as ss
    from medtsllm_tpu_torch.ops.kernels import w4a8 as k5
    from medtsllm_tpu_torch.ops.kernels import w8a8 as k1
    from medtsllm_tpu_torch.runtime.optim import Optimizer
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
    P, L = window_shapes(trainer)
    B = cfg.training.batch_size
    H, KV, D = lcfg.n_heads, lcfg.kv_heads, lcfg.head_dim
    print(f"[shapes] llama: tokenizer {type(trainer.preprocessor.tokenizer).__name__} "
          f"P={P} L={L} B={B} H={H} KV={KV} D={D}")
    mcfg = mamba_config(Config)
    mtrainer = get_trainer("chip-smoke-mamba", mcfg, device=dev)
    mmodel, scfg = mtrainer.model, mtrainer.model.llm_cfg
    Pm, Lm = window_shapes(mtrainer)
    Bm, Em, Nm = mcfg.training.batch_size, scfg.d_inner, scfg.d_state
    print(f"[shapes] mamba-130m: P={Pm} L={Lm} B={Bm} E={Em} N={Nm} "
          f"layers={scfg.n_layers}")
    ecfg = moe_config(Config)
    etrainer = get_trainer("chip-smoke-moe", ecfg, device=dev)
    emodel, xcfg = etrainer.model, etrainer.model.llm_cfg
    check(xcfg.moe_grouped, "moe_grouped = \"auto\" must resolve on for the card")
    Pe, Le = window_shapes(etrainer)
    Be = ecfg.training.batch_size
    print(f"[shapes] moe-8x1b: P={Pe} L={Le} B={Be} H={xcfg.n_heads} KV={xcfg.kv_heads} "
          f"D={xcfg.head_dim} experts={xcfg.n_experts} top-{xcfg.n_experts_per_tok} "
          f"d_ff={xcfg.d_ff} layers={xcfg.n_layers}")
    # built again (the same seeded weights) for phase 11: its 6.5 GB stay out
    # of the earlier phases' peak memory
    del etrainer, emodel
    torch.cuda.empty_cache()

    # 3. kernels against their plain versions at those shapes
    g = torch.Generator(dev).manual_seed(SEED)
    kernels = []

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, library_ms,
               extra="", listed=True, share=None,
               share_of="its tolerance, 2^-6 x max |plain| of the row", share_unit="row"):
        """Check and print one kernel at one shape; ``listed`` shapes enter
        the kernels line (a shape no main path runs is printed only). The
        check is ``err <= tol``, or with ``share`` (``tol`` None) a bound for
        each query row (from ``row_share``) or each ``share_unit``, which
        ``share_of`` names."""
        if share is None:
            check(err <= tol, f"{name}: max |kernel - plain| {err} > tolerance {tol}")
            tol_txt = f"tol {tol:.3e}"
        else:
            check(share <= 1, f"{name}: a {share_unit}'s |kernel - plain| is {share} of "
                  f"{share_of}")
            tol_txt = f"worst {share_unit} at {share:.4f} of {share_of}"
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"[kernel] {name}: max_abs_err {err:.3e} ({tol_txt}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) library {lib}{extra}")
        if not listed:
            return
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": None, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": library_ms})

    def kernels_ms(name):
        return next(e["ms"] for e in kernels if e["name"] == name)

    def check_k1(label, M, quants, gemms, note):
        """K1 over one decoder block at M = B * L rows: ``quants`` (input
        dtype, K, calls) of the quantizer, ``gemms`` (K, N, calls) of the
        GEMM, written as bf16; each held bit-equal to its plain version."""
        q_err = q_ms = q_dev = q_plain = q_bytes = 0.0
        for dt, K, n in quants:
            x = torch.randn(M, K, device=dev, generator=g).to(dt)
            xq, xs = k1.quantize_rows(x)
            xq0, xs0 = k1.quantize_rows_plain(x)
            check(torch.equal(xq, xq0) and torch.equal(xs, xs0),
                  f"w8a8 quantizer not bit-equal at {dt} [{M}, {K}]")
            q_err = max(q_err, (xq.int() - xq0.int()).abs().max().item(),
                        (xs - xs0).abs().max().item())
            q_ms += n * cuda_ms(torch, lambda: k1.quantize_rows(x))
            # the same calls queued behind a sleeping kernel: the device's
            # time, without the host's per-call cost
            q_dev += n * queued_ms(torch, lambda: k1.quantize_rows(x))
            q_plain += n * cuda_ms(torch, lambda: k1.quantize_rows_plain(x))
            q_bytes += n * (M * K * x.element_size() + M * K + M * 4)
        # no single PyTorch call quantizes rows to int8 with their absmax scale
        record("w8a8_quantize" + label, "medtsllm_tpu_torch/csrc/w8a8.cu",
               "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", q_err, 0.0, q_ms, q_plain,
               bound(q_bytes, 0, "int8"), None,
               f" (per decoder block, {sum(n for *_, n in quants)} calls at M={M}; xq and "
               f"x_scale bit-equal; device time, queued: {q_dev:.4f} ms)")
        g_err, g_ms, g_plain, g_dense, g_lib, g_bytes, g_ops = (0.0,) * 7
        for K, N, n in gemms:
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
        record("w8a8_gemm" + label, "medtsllm_tpu_torch/csrc/w8a8.cu",
               "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", g_err, 0.0, g_ms, g_plain,
               bound(g_bytes, g_ops, "int8"), g_lib,
               f" (per decoder block, {note}; s32 bit-equal; library = torch._int_mm "
               f"+ rescale; cuBLAS dense bf16 GEMMs of the same shapes {g_dense:.4f} ms)")

    # the 7B block's seven projections: q, k, v, gate and up quantize the f32
    # normed residual (K = d), o_proj the bf16 attention output (K = d),
    # down_proj the bf16 SwiGLU output (K = d_ff); GEMMs q, k, v, o at d x d,
    # gate and up d x d_ff, down d_ff x d
    d, f = lcfg.d_model, lcfg.d_ff
    check_k1("", B * L, ((torch.float32, d, 5), (torch.bfloat16, d, 1), (torch.bfloat16, f, 1)),
             ((d, d, 4), (d, f, 2), (f, d, 1)), "7 GEMMs")
    # the moe-8x1b block: q, k, v quantize the f32 normed residual, o_proj the
    # bf16 attention output and the MoE its bf16 input rows (row_quant); GEMMs
    # q and o at d x d, k and v at d x KV * D (the experts run on K6)
    d, hkv = xcfg.d_model, xcfg.kv_heads * xcfg.head_dim
    check_k1("[moe-8x1b]", Be * Le, ((torch.float32, d, 3), (torch.bfloat16, d, 2)),
             ((d, d, 2), (d, hkv, 2)), "4 attention GEMMs")

    def check_k5(label, M, gemms, note):
        """K5 over one decoder block at M = B * L rows: ``gemms`` (K, N,
        calls), written as bf16 (as served); s32, f32 and bf16 outputs held
        bit-equal to the plain version."""
        err, ms, plain, lib, nbytes, ops = (0.0,) * 6
        for K, N, n in gemms:
            xq = torch.randint(-127, 128, (M, K), device=dev, dtype=torch.int8, generator=g)
            wq = torch.randint(-8, 8, (N, K), device=dev, dtype=torch.int8, generator=g)
            packed = k5.pack4_split(wq)
            xs = torch.rand(M, device=dev, generator=g) * 1e-2
            ws = torch.rand(N, device=dev, generator=g) * 1e-2
            for dt in (torch.int32, torch.float32, torch.bfloat16):
                y = k5.w4a8_gemm(xq, packed, xs, ws, dt)
                y0 = k5.w4a8_matmul_plain(xq, packed, xs, ws, dt)
                check(torch.equal(y, y0), f"w4a8 {dt} not bit-equal at {M}x{K}x{N}")
                err = max(err, (y.double() - y0.double()).abs().max().item())
            ms += n * cuda_ms(torch, lambda: k5.w4a8_gemm(xq, packed, xs, ws, torch.bfloat16))
            plain += n * cuda_ms(torch, lambda: k5.w4a8_matmul_plain(xq, packed, xs, ws,
                                                                      torch.bfloat16))
            # the library's int8 GEMM (cuBLASLt) on the unpacked int8 weight
            lib += n * cuda_ms(torch, lambda: (torch._int_mm(xq, wq.T).float() * xs[:, None]
                                               * ws[None, :]).to(torch.bfloat16))
            nbytes += n * (M * K + N * K // 2 + M * 4 + N * 4 + M * N * 2)
            ops += n * 2 * M * K * N
        record("w4a8_gemm" + label, "medtsllm_tpu_torch/csrc/w4a8.cu",
               "medtsllm_tpu/ops/pallas/quant_matmul.py:96", err, 0.0, ms, plain,
               bound(nbytes, ops, "int8"), lib,
               f" (per decoder block, {note}; s32, f32 and bf16 bit-equal; library = "
               "torch._int_mm on the unpacked int8 weight + rescale, reading twice the "
               "weight bytes)")

    # K5 at the same blocks with int4 weights: the 7B block's seven GEMMs,
    # the moe-8x1b block's four attention GEMMs
    d, f = lcfg.d_model, lcfg.d_ff
    check_k5("", B * L, ((d, d, 4), (d, f, 2), (f, d, 1)), "7 GEMMs")
    d = xcfg.d_model
    check_k5("[moe-8x1b]", Be * Le, ((d, d, 2), (d, hkv, 2)), "4 attention GEMMs")

    def check_k2(name, B, L, H, KV, D, P, theta, listed=True, PB=1):
        """K2 with a prefix of PB rows: 1 (the constant head) or B (per-clip
        head rows gathered from the bank); P 0: no prefix (``pk = None``,
        as the pretraining mixture's step runs it)."""
        q = torch.randn(B, L, H, D, device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn(B, L, KV, D, device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn(B, L, KV, D, device=dev, generator=g).to(torch.bfloat16)
        pk = pv = None
        if P:
            pk = torch.randn(PB, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
            pv = torch.randn(PB, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
        cos, sin = k2.rope_tables(torch.arange(P, P + L, device=dev), D, theta)
        o = k2.rope_attention(q, k, v, cos, sin, pk, pv)
        o0 = k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)
        mask = torch.ones(L, P + L, dtype=torch.bool, device=dev).tril(P)

        def rope_sdpa():  # plain RoPE, then the library's attention
            kr, vv = k2.rope(k, cos, sin).transpose(1, 2), v.transpose(1, 2)
            if P:
                kr = torch.cat([pk.expand(B, -1, -1, -1), kr], 2)
                vv = torch.cat([pv.expand(B, -1, -1, -1), vv], 2)
            return F.scaled_dot_product_attention(k2.rope(q, cos, sin).transpose(1, 2), kr,
                                                  vv, attn_mask=mask, enable_gqa=KV < H)
        # each query i sees the P prefix keys and region keys 0..i
        pairs = L * P + L * (L + 1) // 2
        # bf16 output: the kernel rounds each rotation once, the plain version
        # after each of its three ops, so probabilities and outputs may differ
        # by a few bf16 ulps (2^-8 relative each). Held per query row (2^-6 x
        # max |plain| of the row, as K4 is) where every row keeps it, else by
        # the whole-tensor bound with the worst row's share printed
        err = (o.float() - o0.float()).abs().max().item()
        share = row_share(o, o0)
        tol = 2.0 ** -6 * o0.float().abs().max().item()
        # each query row within 2^-6 x its max against the plain version fed
        # K2's once-rounded rotation (the per-row prefix is held so alone,
        # with the whole tensor within 2^-6 x max |plain| of the plain
        # version itself)
        ones, zeros = torch.ones_like(cos), torch.zeros_like(sin)
        share1 = row_share(o, k2.rope_attention_plain(
            k4.rope_once(q, cos, sin), k4.rope_once(k, cos, sin), v, ones, zeros, pk, pv))
        check(share1 <= 1, f"{name}: a query row is {share1} of 2^-6 x its max against "
              "the plain version fed the once-rounded rotation")
        per_row = PB == 1 and share <= 1
        record(name, "medtsllm_tpu_torch/csrc/rope_attention.cu",
               "medtsllm_tpu/ops/pallas/rope_attention.py:182", err,
               None if per_row else tol,
               cuda_ms(torch, lambda: k2.rope_attention(q, k, v, cos, sin, pk, pv)),
               cuda_ms(torch, lambda: k2.rope_attention_plain(q, k, v, cos, sin, pk, pv)),
               bound(2 * (2 * B * L * H * D + 2 * B * L * KV * D + 2 * PB * KV * P * D)
                     + 4 * L * D, 4 * B * H * D * pairs, "bf16"),
               cuda_ms(torch, rope_sdpa),
               f" (B={B} L={L} H={H} KV={KV} D={D} P={P} PB={PB}"
               + (f"; each query row at most {share1:.4f} of 2^-6 x its max against the "
                  f"plain version fed the once-rounded rotation, {share:.4f} against the "
                  "plain version itself)" if PB > 1 else
                  f"; each query row at most {share1:.4f} of 2^-6 x its max against the "
                  "plain version fed the once-rounded rotation)" if per_row
                  else f"; worst row at {share:.4f} of 2^-6 x its max |plain|, so the "
                  f"whole-tensor bound holds it; {share1:.4f} against the plain version "
                  "fed the once-rounded rotation)"),
               listed=listed, share=share if per_row else None)

    check_k2("rope_attention", B, L, H, KV, D, P, lcfg.rope_theta)
    check_k2("rope_attention[moe-8x1b]", Be, Le, xcfg.n_heads, xcfg.kv_heads,
             xcfg.head_dim, Pe, xcfg.rope_theta)
    # the per-row prefix at ecgmit-seg.toml's clip shape (phase 6e): the head
    # bucket and region the prompt builder gives a batch of 16 clip windows
    # (a one-layer build: the builder's output does not depend on depth)
    clip_tr = get_trainer("chip-smoke-clip-shapes", task_config(
        Config, ECG_SEG_TOML, n_points=SEG_CLIPS * SEG_CLIP_POINTS, n_clips=SEG_CLIPS,
        llm_layers=1), device=dev)
    Pc, Lc = window_shapes(clip_tr)
    Bc = clip_tr.config.training.batch_size
    del clip_tr
    torch.cuda.empty_cache()
    check_k2("rope_attention[ecgmit-seg]", Bc, Lc, H, KV, D, Pc, lcfg.rope_theta, PB=Bc)

    def hold_route(q, k, v, cos, sin, pk, pv, label):
        """The long-window route (the pre-pass, then K4 with q rotated at
        load) held in three parts: the rotation (the pre-pass's keys and
        values bit-equal to their plain version, f32 with one rounding;
        the route's output bit-equal to K4's JAX interface fed q rotated
        the same way), the attention on those rotated inputs (each query
        row within 2^-6 x its max |plain|), and the whole route against its
        plain version, whose torch bf16 rope rounds three times (K2's
        bound, 2^-6 x the output's max). Returns (max |route - plain|,
        the worst row's share)."""
        out = k4.rope_flash_attention(q, k, v, cos, sin, pk, pv)
        keys, values = k4.rope_flash_keys(k, v, cos, sin, pk, pv)
        keys0, values0 = k4.rope_flash_keys_plain(k, v, cos, sin, pk, pv)
        check(torch.equal(keys, keys0) and torch.equal(values, values0),
              f"{label}: the pre-pass's keys or values differ from one f32 rotation")
        qr = k4.rope_once(q, cos, sin).transpose(1, 2).contiguous()
        check(torch.equal(out, k4.flash_attention(qr, keys, values).transpose(1, 2)),
              f"{label}: q rotated at load differs from one f32 rotation")
        share = row_share(out, k4.flash_attention_plain(qr, keys, values).transpose(1, 2))
        check(share <= 1, f"{label}: a query row's error is {share} of 2^-6 x its max")
        del keys, values, keys0, values0, qr
        ref = k4.rope_flash_attention_plain(q, k, v, cos, sin, pk, pv)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -6 * ref.float().abs().max().item()
        check(err <= tol, f"{label}: |route - plain| {err} > {tol}")
        return err, share

    # the route table behind K4_MIN_KEYS: one block's attention at the 7B
    # layout (batch 8, the P-token head as prefix) by K2, by the K4 route
    # (rope_flash_attention: the pre-pass, then K4 with q rotated at load,
    # as Attention runs it) and by RoPE + SDPA, at 512, 1024 and 2048 keys
    # (K2's limit), and 4096; the route held in its three parts up to 2048
    def route_row(keys):
        Lr = keys - P
        q = torch.randn(B, Lr, H, D, device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn(B, Lr, KV, D, device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn(B, Lr, KV, D, device=dev, generator=g).to(torch.bfloat16)
        pk = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
        pv = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
        cos, sin = k2.rope_tables(torch.arange(P, P + Lr, device=dev), D, lcfg.rope_theta)
        scale = 1.0 / math.sqrt(D)
        mask = torch.ones(Lr, keys, dtype=torch.bool, device=dev).tril(P)

        def k4_route():
            return k4.rope_flash_attention(q, k, v, cos, sin, pk, pv, scale).reshape(
                B, Lr, H * D)

        def rope_sdpa():
            kr = torch.cat([pk.expand(B, -1, -1, -1), k2.rope(k, cos, sin).transpose(1, 2)], 2)
            vv = torch.cat([pv.expand(B, -1, -1, -1), v.transpose(1, 2)], 2)
            return F.scaled_dot_product_attention(
                k2.rope(q, cos, sin).transpose(1, 2), kr, vv, attn_mask=mask,
                enable_gqa=KV < H).transpose(1, 2).reshape(B, Lr, H * D)
        row = {"keys": keys, "k4": cuda_ms(torch, k4_route), "sdpa": cuda_ms(torch, rope_sdpa)}
        k2_txt, held = "- (past its limit)", ""
        if keys <= k2.MAX_KEYS:
            err, share = hold_route(q, k, v, cos, sin, pk, pv, f"route at {keys} keys")
            held = (f"; held: rotation bit-equal, worst row {share:.4f}, |route - plain| "
                    f"{err:.3e}")
            # one bound for the tensor, not per row: both round the
            # rotation once, but each in its own order of sums
            out2 = k2.rope_attention(q, k, v, cos, sin, pk, pv, scale).reshape(B, Lr, H * D)
            err = (k4_route().float() - out2.float()).abs().max().item()
            tol = 2.0 ** -6 * out2.float().abs().max().item()
            check(err <= tol, f"route table at {keys} keys: |K4 route - K2| {err} > {tol}")
            row["k2"] = cuda_ms(torch, lambda: k2.rope_attention(q, k, v, cos, sin, pk, pv,
                                                                 scale))
            k2_txt = f"{row['k2']:.4f} ms"
        print(f"[route] {keys} keys (L={Lr}, P={P}, B={B} H={H} D={D}): K2 {k2_txt}, "
              f"K4 route {row['k4']:.4f} ms, RoPE + SDPA {row['sdpa']:.4f} ms{held}")
        return row

    route = [route_row(keys) for keys in (512, 1024, 2048, 4096)]
    picked = next((r["keys"] for r in route if "k2" in r and r["k4"] < r["k2"]),
                  k2.MAX_KEYS + 1)
    print(f"[route] least listed key count at which the K4 route beats K2: {picked}; the "
          f"code's K4_MIN_KEYS = {tfm.K4_MIN_KEYS}")

    def check_k3(name, Bq, Lq, Hr, E, S, listed=True):
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
               f" (B={Bq} L={Lq} H={Hr} E={E} S={S}, {k3.split_plan(Bq * Lq, Hr, S)[0]} "
               "split(s) of S; library = SDPA over the basis expanded across the batch)",
               listed)

    mc = cfg.models.medtsllm
    check_k3("reprogramming_attention", B, model.n_patches, mc.n_heads, mc.d_ff,
             mc.num_tokens)
    mmc = mcfg.models.timellm
    check_k3("reprogramming_attention[mamba-130m]", Bm, mmodel.n_patches, mmc.n_heads,
             mmc.d_ff, mmc.num_tokens)

    # the scan at the Mamba serving shapes: the cached window (K8, batch-1
    # h0), the uncached window over [head | region] (K7) and the prefill of
    # the head (batch 1, final state); no single PyTorch call computes it.
    # Its floor is the special-function units' (SFU_EXP_PER_S): one
    # exponential a (b, t, n, e), printed beside the bound. Printed, not
    # listed: the serving path launches these forms through the gated
    # interface below, whose rows carry their launches
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
        # f32, exp(dt A) as 2^(dt (A log2 e)) on the special-function unit:
        # fused multiply-adds, the order of the N-sum and ex2's last bits
        record(name, "medtsllm_tpu_torch/csrc/selective_scan.cu", replaces, err,
               1e-5 * max(1.0, scale),
               cuda_ms(torch, lambda: fn(dt, A_T, Bs, Cs, xs, Dv, *h0)),
               cuda_ms(torch, lambda: ss.selective_ssm_final_plain(dt, A_T, Bs, Cs, xs,
                                                                   Dv, *h0)),
               bound(nbytes, ops, "f32"), None,
               f" (B={Bs_} L={Ls} E={Em} N={Nm}, h0 rows {h0_rows}, final {final}; expf "
               f"floor {Bs_ * Ls * Nm * Em / SFU_EXP_PER_S * 1e3:.4f} ms)", listed=False)

    check_scan("selective_scan_h0", ss.selective_ssm_h0,
               "medtsllm_tpu/ops/pallas/selective_scan.py:272", Bm, Lm, 1, False)
    check_scan("selective_scan", ss.selective_ssm,
               "medtsllm_tpu/ops/pallas/selective_scan.py:234", Bm, Pm + Lm, 0, False)
    check_scan("selective_scan_final", ss.selective_ssm_final,
               "medtsllm_tpu/ops/pallas/selective_scan.py:91", 1, Pm, 0, True)

    # the same three forms as the mixer serves them (selective_ssm_gated):
    # bf16 dt_proj output, conv output and gate, B / C and z as column views
    # of x_proj- and in_proj-shaped buffers, A_log and D at bf16; the
    # softplus, the casts and the silu(z) gate inside the kernel. Held per
    # element: the kernel's f32 y moves from the plain loop's within the f32
    # tolerance (1e-5 x max |y|) and that can flip round(y) by one bf16 step
    # (2^-7 |y|), both carried by |silu(z)|; then one step of the product's
    # rounding (2^-7 |plain|)
    def check_gated(name, replaces, Bs_, Ls, h0_rows, final):
        R = scfg.rank
        bf = torch.bfloat16
        xdbc = torch.randn(Bs_, Ls, R + 2 * Nm, device=dev, generator=g).to(bf)
        xz = torch.randn(Bs_, Ls, 2 * Em, device=dev, generator=g).to(bf)
        A_log = (torch.log(torch.arange(1, Nm + 1, device=dev, dtype=torch.float32))
                 .expand(Em, Nm) + 0.1 * torch.randn(Em, Nm, device=dev, generator=g)).to(bf)
        ops = ((torch.randn(Bs_, Ls, Em, device=dev, generator=g) - 3).to(bf), A_log,
               xdbc[..., R:R + Nm], xdbc[..., R + Nm:],
               torch.randn(Bs_, Ls, Em, device=dev, generator=g).to(bf),
               torch.randn(Em, device=dev, generator=g).to(bf), xz[..., Em:])
        h0 = torch.randn(h0_rows, Nm, Em, device=dev, generator=g) if h0_rows else None
        out = ss.selective_ssm_gated(*ops, h0, final)
        ref = ss.selective_ssm_gated_plain(*ops, h0, final)
        if final:
            (out, hf), (ref, hf0) = out, ref
            check(bool(torch.isfinite(hf).all()), f"{name}: non-finite h_final")
            herr = (hf - hf0).abs().max().item()
            check(herr <= 1e-5 * max(1.0, hf0.abs().max().item()),
                  f"{name}: h_final max |kernel - plain| {herr}")
        y = ss._plain_scan(*ss.scan_operands(*ops[:6]), h0, 0)[0]
        lim = (F.silu(ops[6]).float().abs() * (1e-5 * y.abs().max() + 2.0 ** -7 * y.abs())
               + 2.0 ** -7 * ref.float().abs())
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        bles, blnes = Bs_ * Ls * Em, Bs_ * Ls * Nm * Em
        # reads dt_raw, x, z (bf16), the B / C elements, A_log, D, h0; writes
        # out (bf16) and h_final. Per (b, t, n, e) the scan's 7 operations;
        # per (b, t, e) dt x, D x, +, softplus (2), silu (2), the product.
        # Exponentials: one a (b, t, n, e), the softplus's and silu's a (b, t, e)
        nbytes = (2 * (4 * bles + 2 * Bs_ * Ls * Nm + 2 * Em * Nm + Em)
                  + 4 * (h0_rows * Nm * Em + (Bs_ * Nm * Em if final else 0)))
        record(name, "medtsllm_tpu_torch/csrc/selective_scan.cu", replaces,
               diff.max().item(), None,
               cuda_ms(torch, lambda: ss.selective_ssm_gated(*ops, h0, final)),
               cuda_ms(torch, lambda: ss.selective_ssm_gated_plain(*ops, h0, final)),
               bound(nbytes, 7 * blnes + 9 * bles, "f32"), None,
               f" (bf16, B={Bs_} L={Ls} E={Em} N={Nm} R={R}, h0 rows {h0_rows}, final "
               f"{final}; expf floor {(blnes + 2 * bles) / SFU_EXP_PER_S * 1e3:.4f} ms; "
               f"{(diff > 2.0 ** -8 * ref.float().abs()).float().mean().item():.2e} of the "
               f"elements past 2^-8 |plain|)",
               # a NaN share stays NaN (max() propagates it) and fails the check
               share=torch.where(diff == 0, 0.0, diff / lim).max().item(),
               share_of="its bound (one bf16 step of y and of the product)",
               share_unit="element")

    check_gated("selective_scan_gated_h0", "medtsllm_tpu/ops/pallas/selective_scan.py:272",
                Bm, Lm, 1, False)
    check_gated("selective_scan_gated", "medtsllm_tpu/ops/pallas/selective_scan.py:234",
                Bm, Pm + Lm, 0, False)
    check_gated("selective_scan_gated_final", "medtsllm_tpu/ops/pallas/selective_scan.py:91",
                1, Pm, 0, True)

    # K9 and K10 at the Mamba train shapes: the train step's scan records
    # its chunk-start states (K9, from the cached head's state or from 0)
    # and its backward runs K10 from them. A is frozen in training, so K10
    # runs there without dA_T, and is timed so; its five outputs are
    # compared here with dA_T. f32 with exp(dt A) as ex2.approx of a rounded
    # exponent: the order of the sums over n and e and fused
    # multiply-adds, held at 1e-4 x max |plain| (the JAX tests' tolerance
    # for the Pallas backward)
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
        # no float atomics: a second call gives the same bits
        again = ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb0, chunk)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K10{label}: two calls differ")
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
        # the function's bytes). Per (b, t, n, e) ~16 operations: the
        # states recomputed from hb (4) and the reverse step (12); one expf
        # on the special-function units, a floor printed beside the bound
        record(f"selective_scan_bwd{label}", "medtsllm_tpu_torch/csrc/selective_scan_bwd.cu",
               "medtsllm_tpu/ops/pallas/selective_scan.py:414", errs[worst], 1e-4 * scales[worst],
               cuda_ms(torch, lambda: ss.selective_ssm_bwd(dt, A_T, Bs, Cs, xs, gy, hb, chunk,
                                                           need_dA=False)),
               cuda_ms(torch, lambda: ss.selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, gy, hb,
                                                                 chunk),
                       iters=3, warmup=1),
               bound(4 * (5 * bles + 4 * blns + Nm * Em + Bm * nc * Nm * Em),
                     16 * blnes + 6 * bles, "f32"), None,
               f" (as K9, without dA_T as in training; error of "
               f"{('ddt', 'dx', 'dB', 'dC', 'dA_T')[worst]}, the output nearest its "
               f"tolerance; expf floor {blnes / SFU_EXP_PER_S * 1e3:.4f} ms, one a "
               f"(b, t, n, e); two calls bit-equal)")

    check_train_scan("", Lm, 1)
    check_train_scan("[uncached]", Pm + Lm, 0)

    # K6 at the moe-8x1b serving shapes: the T * k routed rows of one batch
    # packed per expert, on the visit list of a random top-2 routing and of a
    # skewed one (every token on the same two experts), with int8 experts and
    # with packed int4 ones (w_bits=4). Form (a) gate + up (fused SwiGLU,
    # requant per 1408-wide tile), form (b) the down gmm on (a)'s codes and
    # chunked scales, form (c) the plain form's s32. The bound counts what
    # this routing needs: the routed rows' operations at the int8 peak;
    # bytes: the routed rows of xq and their scales, the used experts'
    # weights (half a byte each at w_bits=4) and scales, each output once
    Te, E_, k_ = Be * Le, xcfg.n_experts, xcfg.n_experts_per_tok
    Dm, Ff = xcfg.d_model, xcfg.d_ff
    bn_f, bn_d = gm.pick_block_n(Ff, 1408), gm.pick_block_n(Dm, 1024)
    V = gm.gmm_visits(Te * k_, E_, 128)
    R_pad = V * 128
    routings = {
        "random": torch.rand(Te, E_, device=dev, generator=g).argsort(-1)[:, :k_],
        "skewed": torch.tensor([1, 4], device=dev).expand(Te, k_),
    }
    for wb in (8, 4):
        lo, hi = (-127, 128) if wb == 8 else (-8, 8)

        def expert_weights(n_out, n_in):
            w = torch.randint(lo, hi, (E_, n_out, n_in), device=dev, dtype=torch.int8,
                              generator=g)
            return w if wb == 8 else k5.pack4_split(w)
        w_g, w_u, w_d = expert_weights(Ff, Dm), expert_weights(Ff, Dm), expert_weights(Dm, Ff)
        s_g, s_u, s_d = (torch.rand(E_, n, device=dev, generator=g) * 1e-3
                         for n in (Ff, Ff, Dm))
        prefix = "grouped_matmul" if wb == 8 else "grouped_matmul_w4"
        replaces = ("medtsllm_tpu/ops/pallas/grouped_matmul.py:205" if wb == 8 else
                    "medtsllm_tpu/ops/pallas/grouped_matmul.py:106")
        for label, top in routings.items():
            counts = torch.zeros(E_, dtype=torch.int32, device=dev).index_add_(
                0, top.reshape(-1), torch.ones(Te * k_, dtype=torch.int32, device=dev))
            ve, valid, _ = gm.gmm_metadata(counts, 128, V)
            routed, used = Te * k_, int((counts > 0).sum())
            xq = torch.randint(-127, 128, (R_pad, Dm), device=dev, dtype=torch.int8,
                               generator=g)
            xs = torch.rand(R_pad, 1, device=dev, generator=g) * 1e-2
            up_args = (xq, xs, (w_g, w_u), (s_g, s_u), ve, valid)
            kw_up = dict(block_n=bn_f, fuse_silu=True, emit_quant=True, w_bits=wb)
            aq, as_ = gm.gmm(*up_args, **kw_up)
            aq0, as0 = gm.gmm_plain(*up_args, **kw_up)
            dq = (aq.int() - aq0.int()).abs()
            share = (dq > 0).float().mean().item()
            # codes at most 1 apart in at most 1e-3 of them (silu's expf may
            # round otherwise than the plain version's), scales 1e-6 relative
            check(dq.max().item() <= 1 and share <= 1e-3,
                  f"K6 w{wb} gate_up[{label}] codes: max diff {dq.max().item()}, share {share}")
            s_err = ((as_ - as0).abs() / as0).max().item()
            check(s_err <= 1e-6, f"K6 w{wb} gate_up[{label}] scales: relative error {s_err}")
            ops_up = 2 * routed * Dm * Ff * 2
            bytes_up = (routed * (Dm + 4) + used * 2 * Ff * (Dm * wb // 8 + 4) + R_pad * Ff
                        + (Ff // bn_f) * R_pad * 4)
            suffix = "" if label == "random" else f"[{label}]"
            record(prefix + "_gate_up" + suffix, "medtsllm_tpu_torch/csrc/grouped_matmul.cu",
                   replaces, s_err, 1e-6,
                   cuda_ms(torch, lambda: gm.gmm(*up_args, **kw_up)),
                   cuda_ms(torch, lambda: gm.gmm_plain(*up_args, **kw_up), iters=3, warmup=1),
                   bound(bytes_up, ops_up, "int8"), None,
                   f" (w_bits={wb}, R_pad={R_pad} K={Dm} N={Ff} block_n={bn_f}, {label} "
                   f"routing over {used} experts; error = scales' relative, codes differing "
                   f"{share:.2e}; no single PyTorch call computes a grouped int8 GEMM)")
            down_args = (aq, as_, (w_d,), (s_d,), ve, valid)
            (y,) = gm.gmm(*down_args, block_n=bn_d, w_bits=wb)
            (y0,) = gm.gmm_plain(*down_args, block_n=bn_d, w_bits=wb)
            ops_dn = 2 * routed * Ff * Dm
            bytes_dn = (routed * Ff + (Ff // bn_f) * routed * 4 + used * Dm * (Ff * wb // 8 + 4)
                        + R_pad * Dm * 4)
            # the same rounded f32 ops in the same order: 1e-5 x max
            record(prefix + "_down" + suffix, "medtsllm_tpu_torch/csrc/grouped_matmul.cu",
                   replaces, (y - y0).abs().max().item(), 1e-5 * y0.abs().max().item(),
                   cuda_ms(torch, lambda: gm.gmm(*down_args, block_n=bn_d, w_bits=wb)),
                   cuda_ms(torch, lambda: gm.gmm_plain(*down_args, block_n=bn_d, w_bits=wb),
                           iters=3, warmup=1),
                   bound(bytes_dn, ops_dn, "int8"), None,
                   f" (w_bits={wb}, R_pad={R_pad} K={Ff} N={Dm} KB={Ff // bn_f} "
                   f"block_n={bn_d}, {label} routing)")
            # the requant pass alone, on the gate+up call's activated f32
            # workspace (written once, read once): codes and scales
            # bit-equal to the plain requantization of the same workspace
            (t_ws,) = gm.gmm(xq, xs, (w_g, w_u), (s_g, s_u), ve, valid, block_n=bn_f,
                             fuse_silu=True, w_bits=wb)
            rq, rs = gm.requant_tiles(t_ws, bn_f)
            rq0, rs0 = gm.requant_tiles_plain(t_ws, bn_f)
            check(torch.equal(rq, rq0) and torch.equal(rs, rs0),
                  f"K6 w{wb} requant[{label}]: codes or scales differ from the plain pass")
            ws_bytes = R_pad * Ff * 4
            rq_ms = cuda_ms(torch, lambda: gm.requant_tiles(t_ws, bn_f))
            rq_bound = bound(ws_bytes + R_pad * Ff + (Ff // bn_f) * R_pad * 4, 0, "int8")
            print(f"[requant] K6 w{wb} gate_up[{label}]: requant pass {rq_ms:.4f} ms of the "
                  f"call (bound {rq_bound[0]:.4f} ms, {rq_bound[1]}); workspace [{R_pad}, {Ff}] "
                  f"f32 = {ws_bytes} bytes, written once and read once")
            if wb == 8 and label == "random":
                record("grouped_matmul_requant", "medtsllm_tpu_torch/csrc/grouped_matmul.cu",
                       "medtsllm_tpu/ops/pallas/grouped_matmul.py:173", 0.0, 0.0, rq_ms,
                       cuda_ms(torch, lambda: gm.requant_tiles_plain(t_ws, bn_f), iters=3,
                               warmup=1),
                       rq_bound, None, f" (emit_quant's second pass, R_pad={R_pad} N={Ff} "
                       f"block_n={bn_f}; codes and scales bit-equal; launched once per gate_up "
                       f"call, at both weight widths)")
            # the raster: each form at group_m 1 (the plain order: each row
            # tile's columns in turn) and 16; the wrapper ships the faster
            shipped = dict(gm.TILE_GROUP_M)
            raster = {}
            try:
                for gmv in (1, 16):
                    gm.TILE_GROUP_M.update(rows=gmv, chunked=gmv)
                    raster[gmv] = (cuda_ms(torch, lambda: gm.gmm(*up_args, **kw_up)),
                                   cuda_ms(torch, lambda: gm.gmm(*down_args, block_n=bn_d,
                                                                 w_bits=wb)))
            finally:
                gm.TILE_GROUP_M.update(shipped)
            print(f"[raster] K6 w{wb}[{label}]: gate_up {raster[1][0]:.4f} / "
                  f"{raster[16][0]:.4f} ms, down {raster[1][1]:.4f} / {raster[16][1]:.4f} ms "
                  f"at group_m 1 / 16; shipped: gate_up {shipped['rows']}, down "
                  f"{shipped['chunked']}")
            if wb == 8:
                # a yardstick, not a library call: K1's own GEMM per used
                # expert over the same routed rows (f32 out, unit row scales;
                # no SwiGLU, no requant, per-row scales in the down GEMM);
                # one launch per expert and weight is host-bound: queued_ms
                _, _, row_off = gm.gmm_metadata(counts, 128, V)
                rows = [(e, o, c) for e, (o, c) in
                        enumerate(zip(row_off.tolist(), counts.tolist())) if c]
                ones = torch.ones(R_pad, device=dev)

                def k1_up():
                    for e, o, c in rows:
                        for w_, s_ in ((w_g, s_g), (w_u, s_u)):
                            k1.int8_gemm(xq[o:o + c], w_[e], ones[o:o + c], s_[e], torch.float32)

                def k1_down():
                    for e, o, c in rows:
                        k1.int8_gemm(aq[o:o + c], w_d[e], ones[o:o + c], s_d[e], torch.float32)
                print(f"[yardstick] K1 int8_gemm per expert over the {routed} routed rows "
                      f"[{label}]: gate+up {queued_ms(torch, k1_up):.4f} ms, down "
                      f"{queued_ms(torch, k1_down):.4f} ms (device time; {len(rows)} experts; "
                      f"K6 gate_up "
                      f"{kernels_ms(prefix + '_gate_up' + suffix):.4f} ms with its requant, "
                      f"down {kernels_ms(prefix + '_down' + suffix):.4f} ms)")
                del ones
            del t_ws, rq, rs, rq0, rs0
            raw = gm.gmm(xq, xs, (w_g,), (s_g,), ve, valid, block_n=bn_f,
                         out_dtype=torch.int32, w_bits=wb)
            check(torch.equal(raw[0], gm.gmm_plain(xq, xs, (w_g,), (s_g,), ve, valid,
                                                   block_n=bn_f, out_dtype=torch.int32,
                                                   w_bits=wb)[0]),
                  f"K6 w{wb} plain form[{label}]: s32 accumulators not bit-equal")
            print(f"[kernel] {prefix} plain form[{label}]: s32 bit-equal at R_pad={R_pad} "
                  f"K={Dm} N={Ff}")
        # out of the later phases' peak memory
        del w_g, w_u, w_d, xq, xs, aq, as_, aq0, as0, y, y0, raw, up_args, down_args

    wrappers = {"w8a8_quantize": k1.quantize_rows, "w8a8_gemm": k1.int8_gemm,
                "rope_attention": k2.rope_attention, "flash_attention": k4.flash_attention,
                "rope_flash_attention": k4.rope_flash_attention,
                "rope_flash_keys": k4.rope_flash_keys,
                "reprogramming_attention": k3.reprogramming_attention,
                "selective_scan": ss.selective_ssm,
                "selective_scan_h0": ss.selective_ssm_h0,
                "selective_scan_final": ss.selective_ssm_final,
                "selective_scan_bounds": ss.selective_ssm_bounds,
                "selective_scan_bwd": ss.selective_ssm_bwd,
                "grouped_matmul_gate_up": gm.GATE_UP, "grouped_matmul_down": gm.DOWN,
                "grouped_matmul_requant": gm.REQUANT, "w4a8_gemm": k5.w4a8_gemm,
                "grouped_matmul_w4_gate_up": gm.GATE_UP_W4,
                "grouped_matmul_w4_down": gm.DOWN_W4}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def counted(fn):
        """fn() with every launch count set to 0 just before; (its result,
        the counts just after)."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        return out, {name: w.launches for name, w in wrappers.items()}

    def bank_book(tr):
        """This pass's per-clip KV bank bookkeeping (None without a bank)."""
        return next((b for k, b in tr._prefix_kv_cache.items() if k[0] == "clip_bank"), None)

    def serve(tr, label):
        """A served path through ``test()``, eager and graphed. First the
        eager step (``eval_step_eager``) on every test batch, each batch's
        inputs prepared just before it (the prefill of its head or of its
        bank's misses, counted apart from the step): launches, p50 by CUDA
        events, peak memory. Then ``test()`` with every launch count set to
        0 just before and read just after (the first batch of each input
        signature runs eagerly as the warm-up and is captured, the others
        replay): its launches must be the preparations' and the eager
        batches'. Then a second pass (every graph captured, the prompt-head
        cache and the bank refilled in place) must score the same, and each
        test batch, prepared anew in the same order, replayed must equal its
        eager output bit for bit, with the eager step's launches and no new
        capture. With a per-clip KV bank also: each pass's hits, misses and
        evictions, the bank's GiB, a prefill's ms, and the banked step
        against the same batch with its head embedded (2^-6 x max)."""
        graphs = tr.step_graphs
        # the prompt buckets only grow: settle them (host only), so every
        # prepared batch has the signature test() serves
        for batch in tr.test_pipeline:
            tr.model_inputs(batch)
        tr._prefix_kv_cache.clear()
        tr.eval_step_eager(tr.eval_prepare(next(iter(tr.test_pipeline)))[1])  # warm, untimed
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr._prefix_kv_cache.clear()
        eager_ms, eager_out, eager_counts, prep_counts = [], [], [], []
        for batch in tr.test_pipeline:
            (kind, arrays), c = counted(lambda: tr.eval_prepare(batch))
            prep_counts.append(c)
            start.record()
            out, c = counted(lambda: tr.eval_step_eager(arrays))
            end.record()
            end.synchronize()
            eager_ms.append(start.elapsed_time(end))
            eager_out.append(out)
            eager_counts.append(c)
        eager_peak = torch.cuda.max_memory_allocated()
        banked = kind == "banked"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n_graphs, n_captures = len(graphs), len(graphs.capture_ms)
        t0 = time.perf_counter()
        start.record()
        scores, counts = counted(tr.test)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        test_peak = torch.cuda.max_memory_allocated()
        books = [dict(bank_book(tr) or {})]
        want = {name: sum(c[name] for c in prep_counts + eager_counts) for name in counts}
        check(counts == want, f"[{label}] test() launches {counts} are not the preparations' "
              f"and the eager batches' {want}")
        n_windows = len(tr.test_dataset)
        capture_ms = graphs.capture_ms[n_captures:]
        check(len(graphs) > n_graphs, f"[{label}] test() captured no graph")
        print(f"[{label}] test() {n_windows} windows in {len(tr.test_pipeline)} "
              f"batches: {start.elapsed_time(end):.1f} ms (CUDA events, prefill, host prep "
              f"and {len(capture_ms)} capture(s) included), {n_windows / wall:.2f} "
              f"windows/s wall")
        print(f"[{label}] launches {counts} (the preparations' and the eager batches'); peak "
              f"memory {test_peak / 2**30:.2f} GiB")
        print(f"[{label}] scores {scores}")
        check(scores_ok(tr, scores, "test"), f"non-finite {scores}")
        t0 = time.perf_counter()
        second = tr.test()
        wall2 = time.perf_counter() - t0
        books.append(dict(bank_book(tr) or {}))
        check(same_scores(second, scores),
              f"[{label}] the second pass scores {second}, not {scores}")
        preds = tr.run_eval(tr.test_pipeline)["pred"]  # the window predictions
        check(preds.shape[0] == n_windows and bool(np.isfinite(preds).all()),
              f"[{label}] window predictions {preds.shape}, finite {np.isfinite(preds).all()}")
        torch.cuda.reset_peak_memory_stats()
        graph_ms = []
        tr._prefix_kv_cache.clear()
        for i, (batch, ref, ref_counts) in enumerate(
                zip(tr.test_pipeline, eager_out, eager_counts)):
            prepared = tr.eval_prepare(batch)
            start.record()
            out, c = counted(lambda: tr.eval_dispatch(prepared=prepared))
            end.record()
            end.synchronize()
            graph_ms.append(start.elapsed_time(end))
            check(torch.equal(out, ref), f"[{label}] batch {i}: the replay differs from the "
                  f"eager step by {(out.float() - ref.float()).abs().max().item()}")
            check(c == ref_counts, f"[{label}] batch {i}: replay launches {c}, eager "
                  f"{ref_counts}")
        check(len(graphs.capture_ms) == n_captures + len(capture_ms),
              f"[{label}] the second pass or the replays captured anew")
        replay_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        bsz = tr.config.training.batch_size
        p50, p50_graph = statistics.median(eager_ms), statistics.median(graph_ms)
        print(f"[{label}] eval step p50 eager {p50:.2f} ms, graphed {p50_graph:.2f} ms per "
              f"batch of {bsz} ({bsz * 1000 / p50:.1f} / {bsz * 1000 / p50_graph:.1f} "
              f"windows/s at p50; per batch eager {eager_ms}, graphed {graph_ms})")
        print(f"[{label}] {len(graphs)} graph(s), capture {sum(capture_ms):.1f} ms "
              f"({capture_ms}); replay bit-equal to the eager step and with its launches "
              f"on all {len(eager_out)} test batches; second pass {n_windows / wall2:.2f} "
              f"windows/s wall, the same scores")
        print(f"[{label}] peak memory: eager steps {eager_peak / 2**30:.2f} GiB; test() "
              f"(prefill, warm-up, capture, replays) {test_peak / 2**30:.2f} GiB; replays "
              f"{replay_peak / 2**30:.2f} GiB; after, {held / 2**30:.2f} GiB allocated and "
              f"{reserved / 2**30:.2f} GiB reserved (the graphs' pool "
              f"{(reserved - held) / 2**30:.2f} GiB)")
        if banked:
            hold_bank(tr, label, books)
        return counts, preds, scores, books

    def hold_bank(tr, label, books):
        """The per-clip KV bank of a served path: each test() pass's hits,
        misses and evictions (evictions required), its GiB, one miss's
        prefill (CUDA events), and the banked step against the same first
        batch with its head embedded in the step (no cache), within 2^-6 x
        max |embedded|."""
        first = next(iter(tr.test_pipeline))
        ids = tr.model_inputs(first)["prefix_ids"]
        key = ("clip_bank", ids.shape[1], False)
        bank = tr._prefix_kv_store[key]
        gib = sum(t.numel() * t.element_size() for layer in bank for t in layer) / 2**30
        for i, b in enumerate(books, 1):
            check(b["evictions"] > 0, f"[{label}] pass {i} evicted no bank row: {b}")
            print(f"[{label}] bank, test() pass {i}: {b['tick'] - b['misses']} hits, "
                  f"{b['misses']} misses, {b['evictions']} evictions, {b['cap']} rows")
        row = torch.as_tensor(ids[:1], device=dev)
        with torch.inference_mode():
            prefill_ms = cuda_ms(torch, lambda: tr.model.prefill(row), iters=5, warmup=1)
        tr._prefix_kv_cache.clear()
        banked_out = tr.eval_step_eager(tr.eval_prepare(first)[1]).float()
        embedded = tr.eval_step_eager(tr._to_device(tr.model_inputs(first))).float()
        err = (banked_out - embedded).abs().max().item()
        tol = 2.0 ** -6 * embedded.abs().max().item()
        check(err <= tol, f"[{label}] banked vs head embedded: {err} > {tol}")
        print(f"[{label}] bank {tuple(bank[0][0].shape)} per tensor, {len(bank)} layers x "
              f"(k, v): {gib:.3f} GiB; prefill of one miss (batch 1, P={ids.shape[1]}) "
              f"{prefill_ms:.2f} ms; banked vs head embedded: max_abs_err {err:.3e} (tol "
              f"{tol:.3e})")
        tr._prefix_kv_cache.clear()

    def set_launches(counts, names, share=1):
        """Each listed row of ``names`` gets the launches of its counter in
        ``counts``, over ``share`` (a counter whose launches ``share`` rows
        of one run split evenly: K3 at the window's and at the example's
        patches)."""
        for entry in kernels:
            if entry["name"] in names:
                entry["launches"] = counts[names[entry["name"]]] // share

    def drive(fn):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after; returns (counts, wall seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, counts = counted(lambda: (fn(), torch.cuda.synchronize()))
        return counts, time.perf_counter() - t0

    def step_p50(tr, label, n_steps, expect=None, warmup=0, step=None):
        """p50 of ``step`` (``train_step`` unless given; CUDA events) over
        the next ``n_steps`` shuffled train batches (epoch after epoch),
        their inputs prepared first, after ``warmup`` untimed steps;
        ``expect`` maps kernels to their launches in every step. Returns
        the p50 and each step's launches."""
        step = tr.train_step if step is None else step
        epochs = itertools.chain.from_iterable(itertools.repeat(tr.train_pipeline))
        arrays = [tr.train_model_inputs(b) for b in itertools.islice(epochs, warmup + n_steps)]
        step_ms, step_counts = [], []
        for i, a in enumerate(arrays):
            for w in wrappers.values():
                w.launches = 0
            start.record()
            loss = step(a, a["valid"])
            end.record()
            end.synchronize()
            if i >= warmup:
                step_ms.append(start.elapsed_time(end))
            counts = {name: w.launches for name, w in wrappers.items()}
            step_counts.append(counts)
            check(math.isfinite(float(loss)), f"{label}: non-finite loss {float(loss)}")
            for name, n in (expect or {}).items():
                check(counts[name] == n, f"{label}: {name} launched {counts[name]} times "
                      f"in a train step, not {n}: {counts}")
        bsz = tr.config.training.batch_size
        p50 = statistics.median(step_ms)
        print(f"[{label}] train step p50 {p50:.2f} ms per batch of {bsz} "
              f"({bsz * 1000 / p50:.1f} windows/s at p50; {len(step_ms)} steps after {warmup} "
              f"untimed: {step_ms}); launches in the last step {counts}")
        return p50, step_counts

    def train_graphed(tr, label, n_steps, expect=None, warmup=1):
        """The train step op by op (``train_step_eager``) and captured
        (``train_step``: one CUDA graph per input signature): the p50 of
        each over ``n_steps`` after ``warmup`` untimed, each's peak memory,
        the graphs, their capture ms and the train pool's GiB; every
        graphed step launches what the eager step launches. Then
        ``hold_train_graph``."""
        graphs = tr.train_graphs
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p50_e, counts_e = step_p50(tr, f"{label}-train[eager]", n_steps, expect, warmup,
                                   tr.train_step_eager)
        peak_e = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n_captures = len(graphs.capture_ms)
        p50_g, counts_g = step_p50(tr, f"{label}-train", n_steps, expect, warmup)
        # a replay allocates nothing: its intermediates live in the pool,
        # which the reserved peak counts and the allocated one does not
        peak_g = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        check(all(c == counts_e[-1] for c in counts_e + counts_g),
              f"[{label}-train] launches a step: eager {counts_e}, graphed {counts_g}")
        print(f"[{label}-train] train step p50 eager {p50_e:.2f} -> graphed {p50_g:.2f} ms "
              f"({p50_e / p50_g:.2f}x); peak memory allocated / reserved: eager "
              f"{peak_e[0] / 2**30:.2f} / {peak_e[1] / 2**30:.2f} GiB, graphed "
              f"{peak_g[0] / 2**30:.2f} / {peak_g[1] / 2**30:.2f} GiB; {len(graphs)} train "
              f"graph(s), captures {graphs.capture_ms} ms ({len(graphs.capture_ms) - n_captures}"
              f" in the timed run), the train pool {pool_bytes(graphs) / 2**30:.2f} GiB; "
              f"launches a step, eager = graphed: {counts_e[-1]}")
        hold_train_graph(tr, label)
        return p50_e, p50_g

    def hold_train_graph(tr, label, k=4):
        """The parameters, the optimizer's state and the dropout generator
        snapshot in place; k graphed steps across an LR change (epoch 0's LR,
        then epoch 1's, under a two-epoch warmup set for the check: 0.5x,
        then 1x); the snapshot restored; k eager steps on the same batches.
        Bit-equal: the losses, every trainable parameter, the optimizer's
        state, the last gradients and the generator's state; the launches a
        step; the frozen backbone unchanged (exact float64 sums); no new
        capture."""
        opt, gen = tr.optimizer, tr.dropout_generator
        epochs = itertools.chain.from_iterable(itertools.repeat(tr.train_pipeline))
        arrays = [tr.train_model_inputs(b) for b in itertools.islice(epochs, k)]
        frozen = {n: torch.sum(t, dtype=torch.float64)
                  for n, t in tr.model.state_dict().items() if n.startswith("llm.")}
        n_captures = len(tr.train_graphs.capture_ms)
        snap = [t.clone() for t in train_state(opt)]
        gen_state = gen.get_state()

        def run(step):
            losses, counts, lrs = [], [], []
            for i, a in enumerate(arrays):
                if i in (0, k // 2):
                    opt.set_epoch(2 * i // k)
                lrs.append(opt.get_last_lr()[0])
                loss, c = counted(lambda: step(a, a["valid"]))
                losses.append(loss)
                counts.append(c)
            grads = [None if p.grad is None else p.grad.clone() for p in opt.params]
            return (torch.stack(losses), counts, [t.clone() for t in train_state(opt)], grads,
                    gen.get_state(), lrs)

        warmup_epochs = opt.lr_warmup_epochs
        opt.lr_warmup_epochs = 2
        try:
            graphed = run(tr.train_step)
            for t, v in zip(train_state(opt), snap):
                t.copy_(v)
            gen.set_state(gen_state)
            eager = run(tr.train_step_eager)
        finally:
            opt.lr_warmup_epochs = warmup_epochs
            opt.set_epoch(0)
        check(len(set(eager[5])) == 2, f"[{label}-train] the check's LRs {eager[5]}")
        check(torch.equal(graphed[0], eager[0]),
              f"[{label}-train] losses graphed {graphed[0].tolist()}, eager {eager[0].tolist()}")
        check(graphed[1] == eager[1], f"[{label}-train] launches graphed {graphed[1]}, eager "
              f"{eager[1]}")
        n_params = len(opt.params)
        for i, (g, e) in enumerate(zip(graphed[2] + graphed[3], eager[2] + eager[3])):
            what = ("parameter" if i < n_params else "optimizer state"
                    if i < len(graphed[2]) else "gradient")
            check((g is None and e is None) or torch.equal(g, e),
                  f"[{label}-train] a {what} ({i}) differs: graphed vs eager max |diff| "
                  f"{(g.float() - e.float()).abs().max().item() if g is not None else None}")
        check(torch.equal(graphed[4], eager[4]) and not torch.equal(gen_state, eager[4]),
              f"[{label}-train] the dropout generator's state after the graphed steps differs "
              "from the eager steps', or did not advance")
        moved = sum(not torch.equal(a, b) for a, b in zip(snap[:n_params], eager[2]))
        check(moved > 0, f"[{label}-train] no trainable parameter moved")
        check(all(torch.sum(t, dtype=torch.float64) == frozen[n]
                  for n, t in tr.model.state_dict().items() if n.startswith("llm.")),
              f"[{label}-train] the backbone changed")
        check(len(tr.train_graphs.capture_ms) == n_captures,
              f"[{label}-train] the check captured anew")
        print(f"[{label}-train] {k} replays across an LR change ({eager[5]}) bit-equal to {k} "
              f"eager steps from the same state: losses {eager[0].tolist()}, {n_params} "
              f"trainable tensors ({moved} moved), {len(snap) - n_params} optimizer state "
              f"tensors, the gradients, the generator's state; launches a step "
              f"{eager[1][0]}; the backbone unchanged")

    # 4. the llama serving path, through the user's entry point
    counts, *_ = serve(trainer, "slice")
    for name in ("w8a8_quantize", "w8a8_gemm", "rope_attention",
                 "reprogramming_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by the serving path")
    check(counts["flash_attention"] == counts["rope_flash_attention"] == 0,
          f"{P + L} keys stay on K2: {counts}")
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

    # 6a-6f. the tasks under "mixed" at the shipped configs' widths
    # (configs/datasets/*.toml on synthetic data): a dense Llama-2-7B backbone
    # stored at bf16 (no quantization: K1 never runs), f32 fusion layers; K2
    # at bf16 over the cached [bos + dataset] head or, on a clip dataset with
    # prompting.clip, over per-clip head rows gathered from the KV bank (a
    # per-row prefix, PB = B); K3 at f32 in eval (the train step runs the
    # einsum graph at bf16). Their K2 / K3 launches and shapes are printed
    # here; the kernels line keeps the main paths' and ecgmit-seg's per-row K2
    build_peak = {}  # label -> the peak device bytes of its trainer's build

    def build_task(label, cfg, listed=False, k3_listed=False):
        """Build a task's trainer on the card: seconds, peak memory, the
        storage policy; K2 and K3 held at the shapes its eval step gives
        them (printed; K2's row ``listed`` with ``listed``, K3's with
        ``k3_listed``): K2 on a row per window, or per channel under
        ``independent`` / ``merge-end`` (their prefix rows repeated per
        channel on a clip dataset), none with the backbone disabled; K3 on
        ``k3_rows``, and a second time at the in-context example's patches
        (``[<label>-example]``)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = get_trainer(f"chip-smoke-{label}", cfg, device=dev)
        torch.cuda.synchronize()
        wrong = [n for n, p in tr.model.named_parameters() if p.is_floating_point()
                 and (p.dtype, p.requires_grad) != ((torch.bfloat16, False)
                                                    if n.startswith("llm.")
                                                    else (torch.float32, True))]
        check(not wrong, f"[{label}] parameters off the mixed policy: {wrong[:5]}")
        n_all = sum(p.numel() for p in tr.model.parameters())
        n_train = sum(p.numel() for p in tr.model.parameters() if p.requires_grad)
        build_peak[label] = torch.cuda.max_memory_allocated()
        print(f"[{label}] model built in {time.perf_counter() - t0:.1f} s: {n_all:,} "
              f"parameters, {n_train:,} trainable at f32, the backbone at bf16; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        # the prompt buckets only grow: settle them over the test split
        # (host only), so the shapes held are the ones its batches are served at
        for batch in tr.test_pipeline:
            tr.model_inputs(batch)
        Pt, Lt = window_shapes(tr)
        Bt, tl, tm, m = cfg.training.batch_size, tr.model.llm_cfg, cfg.models.timellm, tr.model
        first = tr.model_inputs(next(iter(tr.test_pipeline)))
        head = first.get("prefix_ids")
        per_clip = head is not None and head.ndim == 2
        rows = Bt * m.n_features if m.covariate_mode in ("independent", "merge-end") else Bt
        print(f"[shapes] {label}: task {cfg.task}, P={Pt} L={Lt} B={Bt} "
              f"patches={m.n_patches} layers={tl.n_layers} d={tl.d_model}"
              f"{', clips ' + str(len(np.unique(tr.test_dataset.clip_ids))) if tr.test_dataset.clip_dataset else ''}"
              f"{', per-clip head rows' if per_clip else ''}"
              f"; covariate_mode {m.covariate_mode}, downsample {m.embedding_downsample_mode}, "
              f"llm.enabled {m.llm_enabled}; K2 rows {rows if m.llm_enabled else 0}, K3 rows "
              f"{k3_rows(tr, Bt)}"
              + (f"; example_len {tr.preprocessor.example_len} ({example_patches(tr)} patches), "
                 f"buckets prompt {first['prompt_ids'].shape[1]} / post "
                 f"{first['post_prompt_ids'].shape[1]} / head {Pt}"
                 if "example_ts" in first else ""))
        if m.llm_enabled:
            check_k2(f"rope_attention[{label}]", rows, Lt, tl.n_heads, tl.kv_heads, tl.head_dim,
                     Pt, tl.rope_theta, listed=listed, PB=rows if per_clip else 1)
        check_k3(f"reprogramming_attention[{label}]", k3_rows(tr, Bt), m.base_n_patches,
                 tm.n_heads, tm.d_ff, tm.num_tokens, listed=k3_listed)
        if "example_ts" in first:
            check_k3(f"reprogramming_attention[{label}-example]", k3_rows(tr, Bt),
                     int((tr.preprocessor.example_len - m.patch_len) / m.stride + 2),
                     tm.n_heads, tm.d_ff, tm.num_tokens, listed=k3_listed)
        return tr

    def check_scores(label, tr, scores, split):
        want = {f"{split}/{k}" for k in TASK_KEYS[tr.config.task]}
        check(set(scores) == want, f"[{label}] {split} keys {sorted(scores)}, not {sorted(want)}")
        check(scores_ok(tr, scores, split), f"[{label}] non-finite {split} scores {scores}")

    def serve_task(tr, label):
        """``serve()`` (the graphs an earlier ``val()`` captured dropped
        first, so ``test()`` captures its own) over at least 32 test
        batches; then K2 once per layer per test batch and in each prefill
        (the constant head's, or each bank miss's), K3 once per batch, K1
        never. Returns test()'s launches."""
        tr.step_graphs.clear()
        counts, _, scores, books = serve(tr, label)
        check_scores(label, tr, scores, "test")
        n_b, n_l = len(tr.test_pipeline), tr.model.llm_cfg.n_layers
        prefills = books[0]["misses"] if books[0] else 1
        check(n_b >= 32, f"[{label}] the test split gives {n_b} batches, not 32 or more")
        check(counts["rope_attention"] == n_l * (n_b + prefills)
              and counts["reprogramming_attention"] == n_b
              and counts["w8a8_gemm"] == counts["w8a8_quantize"] == 0,
              f"[{label}] test() launches {counts}")
        print(f"[{label}] K2 launches {counts['rope_attention']} ({n_l} layers x ({n_b} "
              f"batches + {prefills} prefill(s))), K3 {counts['reprogramming_attention']}, "
              "K1 0")
        return counts

    def train_task(label, cfg, val_prefills):
        """``train()`` (4 shuffled steps of 16, then ``val()``) on a built
        task: finite losses, the val scores, the launches (K2 once per layer
        per step, per val batch and in each prefill, ``val_prefills(tr)`` of
        them beside the train step's own), a frozen backbone and changed
        fusion layers; then the train step's p50 over 16 steps after one
        untimed. Returns the trainer."""
        tr = build_task(label, cfg)
        n_steps, n_l = len(tr.train_pipeline), tr.model.llm_cfg.n_layers
        check(n_steps == 4, f"the {label} train split gives {n_steps} batches, not 4")
        trainable = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                     if p.requires_grad}
        frozen = {n: torch.sum(t, dtype=torch.float64)
                  for n, t in tr.model.state_dict().items() if n.startswith("llm.")}
        torch.cuda.reset_peak_memory_stats()
        counts, wall = drive(tr.train)
        print(f"[{label}-train] train() {n_steps} steps of {cfg.training.batch_size} and val() "
              f"over {len(tr.val_dataset)} windows in {wall:.2f} s wall; losses {tr.losses}; "
              f"val {tr.val_scores}; launches {counts}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(len(tr.losses) == n_steps and finite(tr.losses), f"{label} losses {tr.losses}")
        check_scores(label, tr, tr.val_scores[0], "val")
        n_val = len(tr.val_pipeline)
        check(counts["rope_attention"] == n_l * (n_steps + n_val + val_prefills(tr))
              and counts["reprogramming_attention"] == n_val
              and counts["w8a8_gemm"] == 0,
              f"{label} train(): K2 once per layer per step, per val batch and in each "
              f"prefill, K3 per val batch (training runs the einsum graph): {counts}")
        state = tr.model.state_dict()
        unchanged = [n for n, t in trainable.items() if torch.equal(state[n], t)]
        check(not unchanged, f"{label} trainable parameters that did not change: {unchanged}")
        check(all(torch.sum(state[n], dtype=torch.float64) == v for n, v in frozen.items()),
              f"the {label} backbone changed")
        del trainable, frozen, state
        train_graphed(tr, label, 16, {"rope_attention": n_l, "reprogramming_attention": 0,
                                      "w8a8_gemm": 0})
        check_scores(label, tr, tr.val(), "val")
        return tr

    # 6m. configs/ablation/ecgmit-seg-examples.toml as shipped: the ECG
    # family's stand-in with its in-context example pool (the data between
    # consecutive boundaries), mixed, the dense Llama-2-7B at full depth and
    # width, batch 16; the one cut, training.epochs 10 -> 1 (93 train
    # windows: 6 steps). The head is [bos + dataset] (1-D, cached); each
    # window's prompt is [prompt_ids (clip, "Example segment:") | the
    # example's encoding | post_prompt_ids (task, "Time series:")], then its
    # patches, so K3 runs twice a step (the window's 32 patches, the
    # example's). train() (captured steps, then val()), train_graphed's
    # replays against eager steps, serve() (test(): 46 windows, 3 batches),
    # then the cached head against the head embedded in the step
    t_phase = time.perf_counter()
    label = "ecgmit-seg-examples"
    tr = build_task(label, shipped_config(Config, ECG_EXAMPLES_TOML), listed=True,
                    k3_listed=True)
    first = tr.model_inputs(next(iter(tr.test_pipeline)))
    check(type(tr.test_dataset).__name__ == "ECGMITFamily" and tr.test_dataset.examples_enabled
          and "example_ts" in first and first["prefix_ids"].ndim == 1,
          f"[{label}] the batch carries no example or the head is not 1-D: {sorted(first)}")
    n_steps, n_val, n_l = (len(tr.train_pipeline), len(tr.val_pipeline),
                           tr.model.llm_cfg.n_layers)
    print(f"[{label}] the ECG stand-in: {len(tr.train_dataset)} / {len(tr.val_dataset)} / "
          f"{len(tr.test_dataset)} windows a split, a pool of {tr.train_dataset.n_examples} "
          f"examples; the example length {tr.preprocessor.example_len} (the pool's median "
          f"within [patch_len, history_len]); "
          f"example_ts {first['example_ts'].shape}, buckets: head {first['prefix_ids'].shape[0]}"
          f", prompt {first['prompt_ids'].shape[1]}, post {first['post_prompt_ids'].shape[1]};"
          f" K3 at {tr.model.base_n_patches} and {example_patches(tr)} patches; cuts: "
          f"training.epochs 10 -> 1 ({n_steps} train steps)")
    torch.cuda.reset_peak_memory_stats()
    counts, wall = drive(tr.train)
    print(f"[{label}-train] train() {n_steps} graphed steps of 16 and val() over "
          f"{len(tr.val_dataset)} windows in {wall:.2f} s wall; losses {tr.losses}; val "
          f"{tr.val_scores}; launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; train captures "
          f"{tr.train_graphs.capture_ms} ms")
    check(len(tr.losses) == n_steps and finite(tr.losses), f"[{label}] losses {tr.losses}")
    check_scores(label, tr, tr.val_scores[0], "val")
    # the train cache (bf16) and the eval cache (f32): two prefills; K3 twice
    # a val batch (training runs the einsum graph)
    check(counts["rope_attention"] == n_l * (n_steps + n_val + 2)
          and counts["reprogramming_attention"] == 2 * n_val and counts["w8a8_gemm"] == 0,
          f"[{label}] train(): K2 once per layer per step, per val batch and in two "
          f"prefills, K3 twice per val batch: {counts}")
    train_graphed(tr, label, 4, {"rope_attention": n_l, "reprogramming_attention": 0,
                                 "w8a8_gemm": 0})
    tr.step_graphs.clear()
    counts, _, scores, _ = serve(tr, label)
    check_scores(label, tr, scores, "test")
    n_b = len(tr.test_pipeline)
    check(counts["rope_attention"] == n_l * (n_b + 1)
          and counts["reprogramming_attention"] == 2 * n_b,
          f"[{label}] test(): K2 32 a batch and in the head's prefill, K3 twice: {counts}")
    set_launches(counts, {f"rope_attention[{label}]": "rope_attention"})
    set_launches(counts, {f"reprogramming_attention[{label}]": "reprogramming_attention",
                          f"reprogramming_attention[{label}-example]":
                          "reprogramming_attention"}, share=2)
    # the two paths compute the head's activations at other row counts (the
    # head alone in the batch-1 prefill, 16 windows of [head | region] in
    # the step), so cuBLAS sums the bf16 GEMMs in other orders and 32
    # layers carry that on: 6d's bound for two orders of bf16 sums, 2^-5 x
    # max (CPU f32: 1e-5, tests/test_torch_examples.py)
    batch = next(iter(tr.test_pipeline))
    tr._prefix_kv_cache.clear()
    cached = tr.eval_step_eager(tr.eval_prepare(batch)[1]).float()
    embedded = tr.eval_step_eager(tr._to_device(tr.model_inputs(batch))).float()
    err = (cached - embedded).abs().max().item()
    tol = 2.0 ** -5 * embedded.abs().max().item()
    check(err <= tol, f"[{label}] cached vs head embedded: {err} > {tol}")
    print(f"[{label}] cached head vs head embedded in the step: max_abs_err {err:.3e} (tol "
          f"{tol:.3e}, 2^-5 x max; {2 * err / tol:.4f} of 2^-6 x max); K2 "
          f"{counts['rope_attention']} launches ({n_l} layers x ({n_b} batches + 1 prefill)), "
          f"K3 {counts['reprogramming_attention']} (2 a batch)")
    del tr, cached, embedded
    torch.cuda.empty_cache()
    print(f"[{label}] phase 6m: {time.perf_counter() - t_phase:.1f} s wall")

    # 6n. the mode sweep at Llama-2-7B's width (d 4096, 32 x 128 heads) cut
    # to 4 layers (as 6c), bidmc.toml's settings (mixed, batch 16, history
    # 256, 32 patches, d_ff 64) on SWEEP_POINTS points a split of 3 features
    # (64 test windows, 4 batches): each of the other covariate modes, the
    # truncate and average downsamples and llm.enabled = false. Each:
    # build_task (its peak, K2 / K3 held at its shapes), serve() (every
    # replay bit-equal to its eager step, finite scores), train_graphed's
    # captured steps (2 timed, then 4 replays against 4 eager steps). Then
    # independent and merge-end on ecgmit-seg.toml's settings (24 clips of
    # 512 points through its 16-row bank: the bank's rows repeated per
    # channel, K2 with B * C per-row prefixes) and independent on
    # mamba-backbone.toml's (the gated scan over B * C rows from the
    # one-row cached state)
    t_phase = time.perf_counter()

    def mode_run(label, cfg, listed=False, k3_listed=False):
        """One run of the sweep: build_task, serve() and its launches (K2
        once per layer per batch and per prefill, none with the backbone
        disabled; K3 once a batch), train_graphed over 2 steps. Returns
        test()'s launches."""
        tr = build_task(label, cfg, listed=listed, k3_listed=k3_listed)
        m = tr.model
        check(m.n_features > 1, f"[{label}] one feature: the modes need C > 1")
        check(m.llm_enabled or not any(".blocks." in n for n, _ in m.named_parameters()),
              f"[{label}] the disabled backbone built decoder blocks")
        counts, _, scores, books = serve(tr, label)
        check_scores(label, tr, scores, "test")
        n_b, n_l = len(tr.test_pipeline), (m.llm_cfg.n_layers if m.llm_enabled else 0)
        prefills = books[0]["misses"] if books[0] else int(bool(tr._prefix_kv_store))
        check(counts["rope_attention"] == n_l * (n_b + prefills)
              and counts["reprogramming_attention"] == n_b,
              f"[{label}] test() launches {counts}")
        train_graphed(tr, label, 2, {"rope_attention": n_l, "reprogramming_attention": 0,
                                     "w8a8_gemm": 0})
        del tr
        torch.cuda.empty_cache()
        return counts

    sweep = {"independent": {"covariate_mode": "independent"},
             "interleave": {"covariate_mode": "interleave"},
             "add": {"covariate_mode": "add"},
             "weighted-average": {"covariate_mode": "weighted-average"},
             "merge-end": {"covariate_mode": "merge-end"},
             "truncate": {"embedding_downsample_mode": "truncate"},
             "average": {"embedding_downsample_mode": "average"},
             "llm-disabled": {"llm": {"enabled": False}}}
    for mode, entries in sweep.items():
        label = f"mode-{mode}"
        counts = mode_run(label, task_config(Config, BIDMC_TOML, n_points=SWEEP_POINTS,
                                             llm_layers=4, model=entries),
                          listed=mode in ("independent", "interleave"),
                          k3_listed=mode == "independent")
        set_launches(counts, {f"rope_attention[{label}]": "rope_attention",
                              f"reprogramming_attention[{label}]": "reprogramming_attention"})
    # the disabled backbone: its word embeddings only, no decoder block (4
    # blocks of the 7B hold 1.62 GB at bf16, drawn at f32 first; the 32 of
    # the shipped file 12.9 GB at bf16)
    off, on = build_peak["mode-llm-disabled"], build_peak["mode-truncate"]
    check(on - off > 1.62e9,
          f"the disabled backbone's build peaks at {off / 2**30:.2f} GiB, the 4-layer one at "
          f"{on / 2**30:.2f} GiB")
    print(f"[mode-llm-disabled] build peak {off / 2**30:.2f} GiB against the 4-layer "
          f"backbone's {on / 2**30:.2f} GiB (truncate): no decoder block built")
    for mode in ("independent", "merge-end"):
        label = f"mode-{mode}-bank"
        counts = mode_run(label, task_config(Config, ECG_SEG_TOML, n_points=24 * 512,
                                             n_clips=24, llm_layers=4,
                                             model={"covariate_mode": mode}),
                          listed=mode == "independent")
        set_launches(counts, {f"rope_attention[{label}]": "rope_attention",
                              f"reprogramming_attention[{label}]": "reprogramming_attention"})
    label = "mode-independent-mamba"
    mtr = get_trainer(label, mamba_config(Config, model={"covariate_mode": "independent"}),
                      device=dev)
    n_l, C = mtr.model.llm_cfg.n_layers, mtr.model.n_features
    check(C > 1, f"[{label}] one feature")
    Pmi, Lmi = window_shapes(mtr)
    print(f"[shapes] {label}: P={Pmi} L={Lmi} B={Bm} x C {C} = {Bm * C} rows, h0 one row "
          f"(the cached state broadcast), layers {n_l}")
    check_gated(f"selective_scan_gated_h0[{label}]",
                "medtsllm_tpu/ops/pallas/selective_scan.py:272", Bm * C, Lmi, 1, False)
    counts, _, scores, _ = serve(mtr, label)
    check(scores_ok(mtr, scores, "test"), f"[{label}] non-finite {scores}")
    n_b = len(mtr.test_pipeline)
    check(counts["selective_scan_h0"] == n_l * n_b and counts["selective_scan_final"] == n_l
          and counts["reprogramming_attention"] == n_b,
          f"[{label}] test(): the gated scan from h0 once per layer per batch, the prefill "
          f"once per layer: {counts}")
    set_launches(counts, {f"selective_scan_gated_h0[{label}]": "selective_scan_h0"})
    train_graphed(mtr, label, 2, {"selective_scan_bounds": n_l, "selective_scan_bwd": n_l})
    del mtr
    torch.cuda.empty_cache()
    print(f"[mode-sweep] phase 6n: {time.perf_counter() - t_phase:.1f} s wall")

    # 6a. segmentation, configs/datasets/bidmc.toml (boundary-prediction,
    # bce, history 256, batch 16): train() on 8320 points a split (64 train
    # windows, four batches; 64 val windows; the train cache at bf16 and the
    # eval cache at f32: two prefills), then served from a trainer of
    # SERVED_POINTS[history] points a split (the synthetic splits share one
    # length) that loads the trained weights
    tr = train_task("bidmc", task_config(Config, BIDMC_TOML, n_points=8320),
                    lambda tr: 2)
    served = get_trainer("chip-smoke-bidmc-served",
                         task_config(Config, BIDMC_TOML, n_points=SERVED_POINTS[256]), device=dev)
    served.load_state_dict(tr.model.state_dict())
    del tr
    torch.cuda.empty_cache()
    serve_task(served, "bidmc")
    del served
    torch.cuda.empty_cache()

    # 6b. anomaly detection, configs/datasets/ecgmit-anom.toml (history 128,
    # mse, threshold auto, normalize_by_feature)
    tr = build_task("ecgmit-anom", task_config(Config, ECG_ANOM_TOML,
                                               n_points=SERVED_POINTS[128]))
    serve_task(tr, "ecgmit-anom")
    del tr
    torch.cuda.empty_cache()

    # 6c. semantic segmentation, configs/datasets/ventilator.toml as shipped
    # (binary, bce, input statistics, prompting.clip: per-clip head rows
    # from the KV bank) on 64 clips of 2048 points at llm_layers = 4
    tr = build_task("ventilator", task_config(Config, VENTILATOR_TOML,
                                              n_points=SERVED_POINTS[256], llm_layers=4,
                                              n_clips=64))
    check(tr.model.n_classes == 2 and tr.model.n_outputs_per_step == 1,
          "the ventilator slice is binary: one logit a step")
    serve_task(tr, "ventilator")
    del tr
    torch.cuda.empty_cache()

    # 6e. boundary segmentation, configs/datasets/ecgmit-seg.toml as shipped
    # (prompting.clip: per-clip head rows [bos + dataset + clip] from the KV
    # bank, input_stats off, history 256, step 256, bce, dropout 0.1) at full
    # depth: train() on 32 clips of 512 points (64 train windows, four
    # batches; the per-clip heads embedded in the train step's graph; val()
    # through the banked step, a batch-1 prefill per miss), then served from
    # a trainer with SEG_CLIPS clips of SEG_CLIP_POINTS points a split that
    # loads the trained weights (33 test batches; 48 clips through a bank of
    # 16 rows: evictions in every pass)
    seg_cfg = task_config(Config, ECG_SEG_TOML, n_points=32 * 512, n_clips=32)
    tr = train_task("ecgmit-seg", seg_cfg,
                    lambda tr: sum(b["misses"] for k, b in tr._prefix_kv_cache.items()
                                   if k[0] == "clip_bank"))
    served = get_trainer("chip-smoke-ecgmit-seg-served", task_config(
        Config, ECG_SEG_TOML, n_points=SEG_CLIPS * SEG_CLIP_POINTS, n_clips=SEG_CLIPS),
        device=dev)
    served.load_state_dict(tr.model.state_dict())
    del tr
    torch.cuda.empty_cache()
    counts = serve_task(served, "ecgmit-seg")
    set_launches(counts, {"rope_attention[ecgmit-seg]": "rope_attention"})
    del served
    torch.cuda.empty_cache()

    # 6f. 4-class semantic segmentation, configs/datasets/ludb.toml as
    # shipped (covariate_mode univariate: one feature; LUDB's 4 classes
    # (background, P, QRS, T); ce, history 512, 64
    # patches, d_ff 128: K3 at E 128; prompting.clip off, so the constant
    # head is cached) at full depth on LUDB_CLIPS clips of LUDB_CLIP_POINTS
    # points (38 test batches)
    tr = build_task("ludb", task_config(Config, LUDB_TOML,
                                        n_points=LUDB_CLIPS * LUDB_CLIP_POINTS,
                                        n_clips=LUDB_CLIPS, n_features=1, n_classes=4))
    check(tr.model.n_outputs_per_step == 4 and tr.model.n_patches == 64
          and tr.model.covariate_mode == "univariate",
          "ludb: four classes a step, 64 patches, univariate")
    serve_task(tr, "ludb")
    del tr
    torch.cuda.empty_cache()

    # 6g-6i. forecasting, classification and imputation at full depth, each
    # composed from a shipped task file's task block and bidmc.toml's
    # MedTsLLM settings (task_block_config), as 6a: train() on four batches
    # (and val()), then served from a trainer of 32 test batches that loads
    # the trained weights. The train step serves the head from its bf16
    # cache (forecasting, classification: two prefills beside val's steps)
    # or, for imputation as in JAX, embeds it (one prefill: val's)
    for label, prefills, check_model in (
            ("bidmc-forecast", 2, lambda m: m.head_steps == 64 and m.n_outputs_per_step == 3),
            ("dreams-classification", 2,
             lambda m: m.head_steps == 1 and m.n_outputs_per_step == 2),
            ("etth1-imputation", 1, lambda m: m.head_steps == 96 and m.n_outputs_per_step == 7)):
        toml, n_feat, (n_train, n_served) = TASK_BLOCKS[label]
        tr = train_task(label, task_block_config(Config, toml, n_train, n_feat),
                        lambda tr, n=prefills: n)
        check(check_model(tr.model) and tr.model.llm_cfg.n_layers == 32,
              f"[{label}] head {tr.model.head_steps} x {tr.model.n_outputs_per_step}, "
              f"{tr.model.llm_cfg.n_layers} layers")
        served = get_trainer(f"chip-smoke-{label}-served",
                             task_block_config(Config, toml, n_served, n_feat), device=dev)
        served.load_state_dict(tr.model.state_dict())
        del tr
        torch.cuda.empty_cache()
        if label == "dreams-classification" and one_class(served, "test"):
            print(f"[{label}] every test window holds a nonzero label (window_label \"any\" "
                  "over 128 points of 64-point class segments): AUROC is NaN by the task's "
                  "rule")
        serve_task(served, label)
        del served
        torch.cuda.empty_cache()

    # 6j. configs/datasets/bidmc.toml as shipped: data.dataset = "bidmc", the
    # BIDMC family's stand-in (5 train clips of 8,000 points, 2 test clips;
    # val reads the test series, as the reader does) and its 47-token
    # description in the cached head; the one cut, training.epochs 10 -> 1
    # (311 train windows: 20 steps of 16, no cap). train() graphed (and
    # val()), train_graphed's replays against eager steps, then serve()
    # (test(): 62 windows, 4 batches), then one more test() with
    # distance_thresh = "optimize": the Bayesian search on the host, with no
    # scikit-learn
    from medtsllm_tpu_torch.tasks import segmentation as seg_task
    t_phase = time.perf_counter()
    tr = build_task("bidmc-shipped", shipped_config(Config, BIDMC_TOML), listed=True)
    ds = tr.test_dataset
    check(type(ds).__name__ == "BIDMCFamily" and ds.name == "bidmc"
          and tr.preprocessor.dataset_description == ds.description,
          f"[bidmc-shipped] the test split is {type(ds).__name__}, not the BIDMC family")
    head = tr.model_inputs(next(iter(tr.test_pipeline)))["prefix_ids"]
    n_desc = len(tr.preprocessor._encode(f"Dataset: {ds.description} "))
    n_steps, n_val, n_l = (len(tr.train_pipeline), len(tr.val_pipeline),
                           tr.model.llm_cfg.n_layers)
    print(f"[bidmc-shipped] data.dataset \"bidmc\": the BIDMC stand-in, "
          f"{len(tr.train_dataset)} / {len(tr.val_dataset)} / {len(ds)} windows a split; the "
          f"head P={head.shape[-1]} ({n_desc} tokens of \"Dataset: <description>\"); cuts: "
          f"training.epochs 10 -> 1 ({n_steps} train steps, not capped)")
    torch.cuda.reset_peak_memory_stats()
    counts, wall = drive(tr.train)
    print(f"[bidmc-shipped-train] train() {n_steps} graphed steps of 16 and val() over "
          f"{len(tr.val_dataset)} windows in {wall:.2f} s wall; losses {tr.losses}; val "
          f"{tr.val_scores}; launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; train captures "
          f"{tr.train_graphs.capture_ms} ms")
    check(len(tr.losses) == n_steps and finite(tr.losses), f"bidmc-shipped losses {tr.losses}")
    check_scores("bidmc-shipped", tr, tr.val_scores[0], "val")
    check(counts["rope_attention"] == n_l * (n_steps + n_val + 2)
          and counts["reprogramming_attention"] == n_val and counts["w8a8_gemm"] == 0,
          f"bidmc-shipped train(): K2 once per layer per step, per val batch and in two "
          f"prefills, K3 per val batch: {counts}")
    train_graphed(tr, "bidmc-shipped", 4, {"rope_attention": n_l, "reprogramming_attention": 0,
                                           "w8a8_gemm": 0})
    tr.step_graphs.clear()
    counts, _, scores, _ = serve(tr, "bidmc-shipped")
    check_scores("bidmc-shipped", tr, scores, "test")
    n_b = len(tr.test_pipeline)
    check(counts["rope_attention"] == n_l * (n_b + 1)
          and counts["reprogramming_attention"] == n_b,
          f"[bidmc-shipped] test(): K2 32 a batch and in the head's prefill: {counts}")
    set_launches(counts, {"rope_attention[bidmc-shipped]": "rope_attention"})
    tr.config = shipped_config(Config, BIDMC_TOML, distance_thresh="optimize")
    t0 = time.perf_counter()
    opt_scores = tr.test()
    opt_wall = time.perf_counter() - t0
    check(math.isfinite(opt_scores["test/segment_miou"]),
          f"[bidmc-shipped] optimize: segment_miou {opt_scores['test/segment_miou']}")
    sk = sorted(m for m in sys.modules if m.split(".")[0] == "sklearn")
    check(not sk, f"[bidmc-shipped] the optimize pass loaded scikit-learn: {sk[:3]}")
    res = tr.predict(tr.test_pipeline)
    est = len(res["labels"]) / max(res["labels"].sum(), 1)
    t0 = time.perf_counter()
    chosen = seg_task.optimize_threshold(res["preds_raw"], res["labels"], est)
    host_s = time.perf_counter() - t0
    print(f"[bidmc-shipped] distance_thresh \"optimize\": the distance {chosen:.4f} in "
          f"[{0.5 * est:.2f}, {1.25 * est:.2f}] (host {host_s:.3f} s for 15 evaluations and 10 "
          f"GP fits over {len(res['preds_raw'])} points; test() {opt_wall:.2f} s wall); "
          f"segment_miou {opt_scores['test/segment_miou']:.4f} (auto: "
          f"{scores['test/segment_miou']:.4f}); no sklearn module loaded")
    del tr, res
    torch.cuda.empty_cache()
    print(f"[bidmc-shipped] phase 6j: {time.perf_counter() - t_phase:.1f} s wall")

    # 6k. pretraining at full width (pretraining_config: bidmc.toml's
    # MedTsLLM settings, task = "pretraining", every window of the four
    # families' stand-ins: ECG, ventilator, bidmc, ludb, rewired to
    # reconstruction, their features tiled to 3). Each row carries its own
    # dataset's prompt, so no head is cached: no prefix_ids, and K2 runs
    # with no prefix (pk = None) over [prompt | 32 patches], the prompt
    # left-padded to a power-of-two bucket. A few captured train steps
    # (train_graphed: the epoch's 130 steps are cut to 4 timed), then
    # serve() (test(): 377 windows, 24 batches)
    t_phase = time.perf_counter()
    tr = build_task("pretraining", pretraining_config(Config), listed=True)
    batch = next(iter(tr.test_pipeline))
    inputs = tr.model_inputs(batch)
    _, arrays = tr.eval_prepare(batch)
    check("prefix_ids" not in inputs and "prefix_kv" not in arrays
          and "prefix_kv" not in tr.train_model_inputs(batch),
          f"[pretraining] the batch has a head: {sorted(inputs)}")
    mix = tr.train_dataset
    members = ", ".join(f"{n} {k}" for n, k in zip(mix.dataset_names, mix.lens))
    n_tok = {d.name: len(tr.preprocessor._encode(f"Dataset: {d.description} "))
             for d in mix.datasets}
    print(f"[pretraining] the mixture: {len(mix)} / {len(tr.val_dataset)} / "
          f"{len(tr.test_dataset)} windows a split (train: {members}), {mix.n_features} "
          f"features; dataset prompt tokens {n_tok}; prompt bucket "
          f"{inputs['prompt_ids'].shape[1]} (L = {inputs['prompt_ids'].shape[1]} + "
          f"{tr.model.n_patches}); no prefix_ids; cuts: train() skipped for "
          f"{len(tr.train_pipeline)} steps (train_graphed's 4 timed steps)")
    n_l = tr.model.llm_cfg.n_layers
    train_graphed(tr, "pretraining", 4, {"rope_attention": n_l, "reprogramming_attention": 0,
                                         "w8a8_gemm": 0})
    counts, _, scores, _ = serve(tr, "pretraining")
    check_scores("pretraining", tr, scores, "test")
    n_b = len(tr.test_pipeline)
    check(counts["rope_attention"] == n_l * n_b and counts["reprogramming_attention"] == n_b
          and not tr._prefix_kv_store,
          f"[pretraining] test(): K2 32 a batch with no prefill, K3 one: {counts}")
    print(f"[pretraining] K2 {counts['rope_attention']} launches ({n_l} layers x {n_b} "
          "batches, no prefix, no prefill), K3 "
          f"{counts['reprogramming_attention']}")
    set_launches(counts, {"rope_attention[pretraining]": "rope_attention"})
    del tr, arrays
    torch.cuda.empty_cache()
    print(f"[pretraining] phase 6k: {time.perf_counter() - t_phase:.1f} s wall")

    # 6l. the run lifecycle at full width, its run directories under a
    # temporary directory: (a) the train CLI on bidmc.toml as shipped (but
    # training.epochs 1 and paths.logdir; the logger as shipped,
    # tensorboard, which the card's machine lacks); (b) the test CLI on
    # (a)'s run; (c) a second train CLI run stopped by SIGUSR1 after its
    # first step line, then resumed in this process by from_run_id; (d)
    # pretraining_config's 4 captured steps saved as ``latest``, then
    # bidmc.toml finetuning from it (warmup 1 epoch at 0.1)
    t_phase = time.perf_counter()
    runs = Path(tempfile.mkdtemp(prefix="chip-smoke-runs-"))
    try:
        lifecycle(runs, dev, drive, Config)
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    print(f"[lifecycle] phase 6l: {time.perf_counter() - t_phase:.1f} s wall")

    # 6d. each task's window predictions on the card against the CPU's plain
    # versions, same seeded weights: 2-layer llama-1b (GQA 32 / 4 x 64),
    # history 64, batch 2, under mixed; ecgmit-seg on 12 clips (per-clip
    # heads through a bank of 8 rows, banked on both); forecasting (pred 16),
    # classification (both classes in its test split) and imputation on
    # their composed configurations. The card's K2 rounds
    # the rotation once where the plain version rounds it three times (a
    # bf16 row within 1.1-1.3 x 2^-6 of its max, PERF.md), and cuBLAS and the
    # CPU sum the bf16 matmuls in their own orders: 2^-5 x max |CPU|
    slice_kw = dict(llm="llama-1b", llm_layers=2, history=64, batch=2)
    smalls = [(label, task_config(Config, toml, n_points=n_points, n_clips=n_clips,
                                  **slice_kw), n_clips)
              for label, toml, n_points, n_clips in (
                  ("bidmc", BIDMC_TOML, 512, None), ("ecgmit-anom", ECG_ANOM_TOML, 512, None),
                  ("ventilator", VENTILATOR_TOML, 512, None),
                  ("ecgmit-seg", ECG_SEG_TOML, 12 * 128, 12))]
    smalls += [(label, task_block_config(Config, toml, 512, n_feat, pred=pred, **slice_kw),
                None)
               for label, toml, n_feat, pred in (
                   ("bidmc-forecast", BIDMC_FORECAST_TOML, 3, 16),
                   ("dreams-classification", DREAMS_CLS_TOML, 5, None),
                   ("etth1-imputation", ETTH1_IMP_TOML, 7, None))]
    for label, small, n_clips in smalls:
        gpu = get_trainer("chip-smoke-task-small", small, device=dev)
        cpu = get_trainer("chip-smoke-task-small", small, device="cpu")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
        counts, _ = drive(lambda: gpu.run_eval(gpu.test_pipeline))
        out_gpu = gpu.run_eval(gpu.test_pipeline)["pred"]
        out_cpu = cpu.run_eval(cpu.test_pipeline)["pred"]
        err = float(np.abs(out_gpu - out_cpu).max())
        tol = 2.0 ** -5 * float(np.abs(out_cpu).max())
        check(counts["rope_attention"] > 0 and counts["reprogramming_attention"] > 0,
              f"[reference-task] {label}: the card's pass must launch K2 and K3: {counts}")
        check(err <= tol, f"[reference-task] {label}: card vs CPU max err {err} > {tol}")
        if n_clips:
            check(bank_book(gpu)["evictions"] > 0 and bank_book(cpu)["evictions"] > 0,
                  f"[reference-task] {label}: no bank row evicted")
        sg, sc = gpu.test(), cpu.test()
        check_scores(label, gpu, sg, "test")
        print(f"[reference-task] {label} ({small.task}) llama-1b 2-layer mixed slice, card vs "
              f"CPU test() window predictions {out_cpu.shape}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e}); scores card {sg} / CPU {sc}")
        del gpu, cpu
    torch.cuda.empty_cache()

    # 6. the Mamba serving path (prompt-state cache), then one uncached pass
    counts, preds, *_ = serve(mtrainer, "mamba")
    for name in ("selective_scan_h0", "selective_scan_final", "reprogramming_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by the Mamba path")
    # the serving path runs the scan's forms through the gated interface;
    # each form has one counter (one kernel template behind both
    # interfaces), read for the gated rows, the only ones listed
    set_launches(counts, {"selective_scan_gated_h0": "selective_scan_h0",
                          "selective_scan_gated_final": "selective_scan_final",
                          "reprogramming_attention[mamba-130m]":
                              "reprogramming_attention"})
    unc = get_trainer("chip-smoke-mamba-uncached",
                      mamba_config(Config, prefix_cache=False), device=dev)
    unc.load_state_dict(mtrainer.model.state_dict())
    counts, preds_u, *_ = serve(unc, "mamba-uncached")
    check(counts["selective_scan"] > 0 and counts["selective_scan_h0"] == 0,
          f"the uncached pass must run the scan from h = 0: {counts}")
    set_launches(counts, {"selective_scan_gated": "selective_scan"})
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

    # 7. a 2-layer mamba-130m f32 slice on the card against the CPU (the
    # mixer's f32 depthwise conv keeps f32 under any TF32 flag)
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
    train_graphed(tr, "mamba", 16, per_step)
    # the step with the prompt head embedded in the graph (a second
    # signature: its warm-up and capture, then a replay): K9 from h = 0
    # over [head | region], K10 from its states
    batch = next(iter(tr.train_pipeline))
    arrays = tr._to_device(tr.model_inputs(batch))
    check("prefix_ids" in arrays, "the uncached train step needs the embedded head")
    n_graphs = len(tr.train_graphs)
    for _ in range(2):
        counts, _ = drive(lambda: check(
            math.isfinite(float(tr.train_step(arrays, arrays["valid"]))),
            "non-finite uncached Mamba loss"))
        check(all(counts[k] == n for k, n in per_step.items()),
              f"uncached Mamba train step launches {counts}")
    check(len(tr.train_graphs) == n_graphs + 1, "the uncached train step captured no graph")
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
    train_graphed(tr, "llama", 16, {"w8a8_quantize": 7 * n_block, "w8a8_gemm": 7 * n_block,
                                    "rope_attention": n_block})
    del tr
    torch.cuda.empty_cache()

    # 10. one f32 train step of 2-layer slices on the card against the CPU
    # (plain versions) with the same weights, dropout 0: the loss and the
    # gradient of every trainable parameter, relative to that gradient's
    # largest element. f32 end to end: summation order and fused
    # multiply-adds only, so 1e-3. The reprogramming key bias is left out:
    # its exact gradient is 0 (the softmax over keys ignores a constant
    # added to a query's scores), both sides hold rounding noise; it is
    # held below 1e-4 of the largest gradient instead. Then the update, on
    # the same inputs: a CPU ``Optimizer`` (torch's Adam, the port's SGD;
    # tests/test_torch_train_graph.py holds both to JAX) given the card's
    # parameters, optimizer state and gradients, after the first step (the
    # card's warm-up, op by op) and after a second on the same batch (a
    # replay of the captured step) under the next epoch's LR (cosine over
    # three epochs: 0.55x, read from the card's LR tensor): every
    # trainable parameter within rtol 1e-4, atol 1e-5, every state tensor
    # within rtol 1e-4, atol 1e-5 of its largest element. Adam at lr 1e-3
    # with a clip of 0.01 that bites, SGD at 1e-2 unclipped, so that each
    # step moves some parameter by over 10x the tolerance
    slices = (("mamba-130m 2-layer f32",
               mamba_config(Config, n_points=512, batch=2, history=64, dtype="float32",
                            llm_layers=2, dropout=0.0),
               dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.01)),
              ("llama-1b 2-layer GQA dense f32",
               bench_config(Config, llm="llama-1b", batch=2, history=64, dtype="float32",
                            n_points=256, num_tokens=128, d_ff=64, llm_layers=2,
                            load_in_8bit=False, dropout=0.0),
               dict(optimizer="sgd", learning_rate=1e-2, grad_clip_norm=0.0)))
    for label, scfg_t, training in slices:
        raw = scfg_t.to_dict()
        raw["training"].update(training, lr_scheduler="cosine", lr_min_factor=0.1, epochs=3)
        scfg_t = Config(raw)
        gpu = get_trainer("chip-smoke-train-small", scfg_t, device=dev)
        cpu = get_trainer("chip-smoke-train-small", scfg_t, device="cpu")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
        ref = Optimizer(scfg_t, [p.detach().cpu().clone().requires_grad_()
                                 for p in gpu.optimizer.params])
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
        clip = ref.clip_norm
        if clip > 0:
            norm = torch.stack([g.double().square().sum() for g in grads_g.values()]).sum()
            check(abs(norm.sqrt().item() - clip) <= 1e-4 * clip,
                  f"{label}: the clip did not bite: clipped norm {norm.sqrt().item()}")
        print(f"[reference-train] {label} train step, card vs CPU: loss {lg:.6f} vs "
              f"{lc:.6f} (relative {loss_err:.2e}, tol 1e-5); largest gradient error "
              f"{worst:.3e} of its tensor's max ({worst_name}; tol 1e-3) over "
              f"{len(grads_c)} trainable tensors")
        del cpu
        n_captures = len(gpu.train_graphs.capture_ms)
        for step in (1, 2):
            if step == 2:  # the card's state into the reference, the next LR
                for r, t in zip(train_state(ref), train_state(gpu.optimizer)):
                    r.copy_(t)
                gpu.optimizer.set_epoch(1)
                ref.set_epoch(1)
                check(ref.get_last_lr() == gpu.optimizer.get_last_lr()
                      and gpu.optimizer.lr.item() < 0.6 * ref.base_lr,
                      f"{label}: epoch 1's LR {gpu.optimizer.lr.item()}")
                gpu.train_step(ag, ag["valid"])
                check(len(gpu.train_graphs) == 1
                      and len(gpu.train_graphs.capture_ms) == n_captures,
                      f"{label}: the second step was not a replay")
            before = [p.detach().clone() for p in ref.params]
            for r, p in zip(ref.params, gpu.optimizer.params):
                r.grad = p.grad.cpu()
            ref.step()
            n_params = len(ref.params)
            errs, move = [], 0.0
            for i, (r, t) in enumerate(zip(train_state(ref), train_state(gpu.optimizer))):
                t = t.cpu()
                atol = 1e-5 if i < n_params else 1e-5 * r.abs().max().item()
                excess = ((t - r).abs() - 1e-4 * r.abs()).max().item()
                check(excess <= atol, f"{label}: step {step}: the card's "
                      f"{'parameter' if i < n_params else 'optimizer state'} {i} is off "
                      f"the CPU optimizer's by {excess} past rtol 1e-4, over atol {atol}")
                errs.append((t - r).abs().max().item())
                if i < n_params:
                    move = max(move, (r - before[i]).abs().max().item())
            check(move >= 10 * 1e-5, f"{label}: step {step} moved no parameter by 10x the "
                  f"tolerance: {move}")
            print(f"[reference-train] {label} {scfg_t.training.optimizer} update, step "
                  f"{step} ({'warm-up, op by op' if step == 1 else 'replay'}; LR "
                  f"{ref.get_last_lr()[0]:.3e}), card vs the CPU optimizer on the card's "
                  f"gradients: largest |diff| {max(errs[:n_params]):.3e} over {n_params} "
                  f"parameters (largest move {move:.3e}), {max(errs[n_params:]):.3e} over "
                  f"{len(errs) - n_params} state tensors; rtol 1e-4, atol 1e-5")
        del gpu, ref

    # 11. the MoE serving path (K6 both forms, K1, K2, K3)
    n_layers = xcfg.n_layers
    etrainer = get_trainer("chip-smoke-moe", ecfg, device=dev)
    counts, *_ = serve(etrainer, "moe")
    n_calls = n_layers * (len(etrainer.test_pipeline) + 1)  # every batch + the prefill
    check(counts["grouped_matmul_gate_up"] == counts["grouped_matmul_down"]
          == counts["grouped_matmul_requant"] == n_calls,
          f"K6 must run twice per layer per batch and in the prefill, the gate_up call "
          f"with its requant pass: {counts}")
    for name in ("w8a8_quantize", "w8a8_gemm", "rope_attention", "reprogramming_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by the MoE path")
    set_launches(counts, {"grouped_matmul_gate_up": "grouped_matmul_gate_up",
                          "grouped_matmul_down": "grouped_matmul_down",
                          "grouped_matmul_gate_up[skewed]": "grouped_matmul_gate_up",
                          "grouped_matmul_down[skewed]": "grouped_matmul_down",
                          "grouped_matmul_requant": "grouped_matmul_requant",
                          "rope_attention[moe-8x1b]": "rope_attention",
                          "w8a8_quantize[moe-8x1b]": "w8a8_quantize",
                          "w8a8_gemm[moe-8x1b]": "w8a8_gemm"})

    # 12. one moe-8x1b MoE layer (block 0's served weights) on 256 tokens:
    # the grouped chain (K6) on the card against the plain chain on the CPU
    # (bf16 compute, as served; the gmm calls' outputs are recorded on the
    # way: the layer calls its module's ``gmm``), and against the dropless
    # bmm (K1 per expert) on the card
    moe = etrainer.model.llm.blocks[0].mlp
    x = torch.randn(4, 64, xcfg.d_model, device=dev, generator=g)
    seen = []

    def spy(*a, **kw):
        out = gm.gmm(*a, **kw)
        seen.append(out)
        return out
    tfm.gmm = spy
    try:
        with torch.inference_mode():
            y_card = moe(x).float()
            cpu_moe = copy.deepcopy(moe).cpu()
            y_cpu = cpu_moe(x.cpu()).float()
    finally:
        tfm.gmm = gm.gmm
    (aq_card, as_card), _, (aq_cpu, as_cpu), _ = seen
    dq = (aq_card.cpu().int() - aq_cpu.int()).abs()
    share = (dq > 0).float().mean().item()
    check(dq.max().item() <= 1 and share <= 1e-3,
          f"MoE layer card vs CPU: codes max diff {dq.max().item()}, share {share}")
    s_err = ((as_card.cpu() - as_cpu).abs() / as_cpu).max().item()
    # bf16 output (a few bf16 ulps of 2^-8) and the rare flipped code
    err = (y_card.cpu() - y_cpu).abs().max().item()
    tol = 2.0 ** -6 * y_cpu.abs().max().item()
    check(s_err <= 1e-6 and err <= tol, f"MoE layer card vs CPU: scales {s_err}, "
          f"output max err {err} > {tol}")
    print(f"[moe-reference] moe-8x1b layer 0, 256 tokens, grouped chain card vs CPU: "
          f"requantized codes differing {share:.3e} (max diff {dq.max().item()}), scales "
          f"relative {s_err:.2e}, output max_abs_err {err:.3e} (tol {tol:.3e})")
    # grouped vs dropless bmm at f32 compute: the two differ by the requant
    # of the SwiGLU activation (per (row, 1408-tile) against per row). The
    # JAX package's own MoEMLP at these widths on 256 random tokens puts
    # max |grouped - bmm| / max |bmm| at 0.032-0.033, rms ratio 0.027
    # (tools/moe_requant_law.py on the CPU; tests/test_moe.py's 0.02 is for
    # d_model 128): held below 0.05 here. At bf16 the bmm path also rounds
    # g, u and silu(g) * u to bf16, which the chain's f32 epilogue does not:
    # printed only
    grouped_cfg, served_dtype = moe.cfg, moe.dtype
    bmm_cfg = dataclasses.replace(grouped_cfg, moe_grouped=False, expert_capacity=0.0)
    rel, rms = {}, {}
    try:
        with torch.inference_mode():
            for dtype in (served_dtype, None):
                moe.dtype = dtype
                moe.cfg = grouped_cfg
                y_g = moe(x).float()
                moe.cfg = bmm_cfg
                y_b = moe(x).float()
                rel[dtype] = ((y_g - y_b).abs().max() / y_b.abs().max()).item()
                rms[dtype] = ((y_g - y_b).square().mean() / y_b.square().mean()).sqrt().item()
    finally:
        moe.cfg, moe.dtype = grouped_cfg, served_dtype
    check(rel[None] < 0.05, f"MoE layer grouped vs dropless bmm at f32: relative "
          f"difference {rel[None]}")
    print(f"[moe-reference] grouped (K6) vs dropless bmm (K1 per expert) on the card: "
          f"max |diff| / max |bmm| {rel[None]:.4f}, rms ratio {rms[None]:.4f} at f32 "
          f"compute (tolerance 0.05); {rel[served_dtype]:.4f} and {rms[served_dtype]:.4f} "
          f"at {served_dtype} compute")
    del cpu_moe, moe

    # 13. the served MoE model on the capacity bmm (moe_grouped = false,
    # expert capacity 1.25): finite, not compared (it drops tokens)
    bmm = get_trainer("chip-smoke-moe-bmm", moe_config(Config, moe_grouped=False), device=dev)
    check(not bmm.model.llm_cfg.moe_grouped and bmm.model.llm_cfg.expert_capacity == 1.25,
          f"the bmm pass config {bmm.model.llm_cfg}")
    bmm.load_state_dict(etrainer.model.state_dict())
    del etrainer
    torch.cuda.empty_cache()
    counts, *_ = serve(bmm, "moe-bmm")
    check(counts["grouped_matmul_gate_up"] == counts["grouped_matmul_down"]
          == counts["grouped_matmul_requant"] == 0 and counts["w8a8_gemm"] > 0,
          f"the bmm pass must run K1 per expert, not K6: {counts}")
    del bmm
    torch.cuda.empty_cache()

    # 14. configuration (A): the 7B llama with int4 weights (load_in_4bit,
    # quant_type int4: absmax, w4a8); every projection runs K1's quantizer
    # and K5, K1's GEMM never
    tr = get_trainer("chip-smoke-int4", bench_config(Config, quant_type="int4"), device=dev)
    check(tr.model.llm.blocks[0].attn.q_proj.bits == 4, "the int4 backbone")
    counts, *_ = serve(tr, "int4")
    n_calls = lcfg.n_layers * (len(tr.test_pipeline) + 1)  # every batch + the prefill
    check(counts["w4a8_gemm"] == 7 * n_calls and counts["w8a8_gemm"] == 0
          and counts["w8a8_quantize"] == 7 * n_calls,
          f"the int4 path must run K1's quantizer and K5 on all 7 projections, not "
          f"K1's GEMM: {counts}")
    set_launches(counts, {"w4a8_gemm": "w4a8_gemm"})
    del tr
    torch.cuda.empty_cache()

    # 15. configuration (B): moe-8x1b with int4 experts (load_in_4bit): K6's
    # w_bits=4 forms for the experts, K5 for the attention projections
    etrainer = get_trainer("chip-smoke-moe-int4", moe_config(Config, int4=True), device=dev)
    check(etrainer.model.llm_cfg.moe_grouped, "moe_grouped = \"auto\" must resolve on for "
          "absmax int4 experts on the card")
    counts, *_ = serve(etrainer, "moe-int4")
    n_calls = xcfg.n_layers * (len(etrainer.test_pipeline) + 1)
    check(counts["grouped_matmul_w4_gate_up"] == counts["grouped_matmul_w4_down"]
          == counts["grouped_matmul_requant"] == n_calls
          and counts["w4a8_gemm"] == 4 * n_calls and counts["grouped_matmul_gate_up"] == 0
          and counts["w8a8_gemm"] == 0,
          f"K6-w4 twice and K5 four times per layer per batch and in the prefill: {counts}")
    set_launches(counts, {"grouped_matmul_w4_gate_up": "grouped_matmul_w4_gate_up",
                          "grouped_matmul_w4_down": "grouped_matmul_w4_down",
                          "grouped_matmul_w4_gate_up[skewed]": "grouped_matmul_w4_gate_up",
                          "grouped_matmul_w4_down[skewed]": "grouped_matmul_w4_down",
                          "w4a8_gemm[moe-8x1b]": "w4a8_gemm"})

    # 16. references of the int4 paths. One int4 moe-8x1b layer (block 0's
    # served weights, 256 tokens, bf16 as served): the grouped chain on the
    # card against the plain chain on the CPU, then against the dropless
    # int4 bmm (the unpacked experts on K1) on the card at f32 compute. The
    # JAX package's own int4 MoEMLP at these widths puts max |grouped - bmm|
    # / max |bmm| at 0.0316 and 0.0320, rms ratio 0.0275 and 0.0274
    # (tools/moe_requant_law.py --quantize 4, two seeds, on the CPU): held
    # below 0.05
    moe = etrainer.model.llm.blocks[0].mlp
    seen = []

    def spy4(*a, **kw):
        out = gm.gmm(*a, **kw)
        seen.append(out)
        return out
    tfm.gmm = spy4
    try:
        with torch.inference_mode():
            y_card = moe(x).float()
            cpu_moe = copy.deepcopy(moe).cpu()
            y_cpu = cpu_moe(x.cpu()).float()
    finally:
        tfm.gmm = gm.gmm
    (aq_card, as_card), _, (aq_cpu, as_cpu), _ = seen
    dq = (aq_card.cpu().int() - aq_cpu.int()).abs()
    share = (dq > 0).float().mean().item()
    s_err = ((as_card.cpu() - as_cpu).abs() / as_cpu).max().item()
    err = (y_card.cpu() - y_cpu).abs().max().item()
    tol = 2.0 ** -6 * y_cpu.abs().max().item()  # bf16 ulps and the rare flipped code
    check(dq.max().item() <= 1 and share <= 1e-3 and s_err <= 1e-6 and err <= tol,
          f"int4 MoE layer card vs CPU: codes max diff {dq.max().item()}, share {share}, "
          f"scales {s_err}, output max err {err} > {tol}")
    print(f"[moe-int4-reference] moe-8x1b int4 layer 0, 256 tokens, grouped chain card vs "
          f"CPU: requantized codes differing {share:.3e} (max diff {dq.max().item()}), scales "
          f"relative {s_err:.2e}, output max_abs_err {err:.3e} (tol {tol:.3e})")
    grouped_cfg, served_dtype = moe.cfg, moe.dtype
    try:
        with torch.inference_mode():
            moe.dtype = None  # f32 compute
            y_g = moe(x).float()
            moe.cfg = dataclasses.replace(grouped_cfg, moe_grouped=False, expert_capacity=0.0)
            y_b = moe(x).float()
    finally:
        moe.cfg, moe.dtype = grouped_cfg, served_dtype
    rel = ((y_g - y_b).abs().max() / y_b.abs().max()).item()
    rms = ((y_g - y_b).square().mean() / y_b.square().mean()).sqrt().item()
    check(rel < 0.05, f"int4 MoE layer grouped vs dropless bmm at f32: relative "
          f"difference {rel}")
    print(f"[moe-int4-reference] grouped (K6 w4) vs dropless int4 bmm (K1 per expert) on "
          f"the card: max |diff| / max |bmm| {rel:.4f}, rms ratio {rms:.4f} at f32 compute "
          f"(tolerance 0.05)")
    del cpu_moe, moe, etrainer
    torch.cuda.empty_cache()
    # a 2-layer llama-1b slice with nf4 weights (the bnb codebook: table
    # dequant, then an f32 matmul) on the card against the CPU; f32 end to
    # end: summation order only
    small = bench_config(Config, llm="llama-1b", batch=2, history=64, dtype="float32",
                         n_points=256, num_tokens=128, d_ff=64, llm_layers=2,
                         quant_type="nf4")
    gpu = get_trainer("chip-smoke-nf4", small, device=dev)
    cpu = get_trainer("chip-smoke-nf4", small, device="cpu")
    check(gpu.model.llm.blocks[0].mlp.down_proj.codebook == "nf4", "the nf4 backbone")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
    batch = next(iter(gpu.test_pipeline))
    out_gpu = gpu.eval_dispatch(batch).cpu()
    out_cpu = cpu.eval_dispatch(batch)
    err = (out_gpu - out_cpu).abs().max().item()
    tol = 1e-3 * max(1.0, out_cpu.abs().max().item())
    check(err <= tol, f"nf4 slice: card vs CPU max err {err} > {tol}")
    print(f"[reference] llama-1b 2-layer nf4 f32 slice, card vs CPU: max_abs_err {err:.3e} "
          f"(tol {tol:.3e})")
    del gpu, cpu

    torch.cuda.empty_cache()

    # 17. the long-window llama serving path: history 16384, d_ff 64, two
    # test batches of 8; every decoder attention has P + L keys, past K2's
    # limit, so K4 runs 32 times per batch; the prefill of the prompt head
    # (P keys) runs K2
    n_block = lcfg.n_layers
    cfg_long = long_config(Config)
    tr = get_trainer("chip-smoke-long", cfg_long, device=dev)
    P_long, L_long = window_shapes(tr)
    S_long = P_long + L_long
    print(f"[shapes] llama long window: history {cfg_long.history_len} P={P_long} "
          f"L={L_long} keys={S_long}")

    # K4 through its JAX interface (q already rotated, [B, H, L, D]) against
    # its plain version at the long window's shapes (the cached region and
    # the uncached form, L == S), non-causal, and the GQA 32 / 4 x 64 layout
    # of llama-1b and moe-8x1b, all bf16; S % 128 != 0 leaves a partial last
    # k-tile. Bound: the products of the (query, key) pairs the mask keeps
    # (QK^T and PV, 4 x D operations each) at the bf16 peak, or q, k and v
    # read and the output written once; library: SDPA with the same mask.
    # The served path reaches the kernel through the route (below), so these
    # are printed, not listed
    def check_k4(name, B, H, KV, L, S, D, causal):
        q = torch.randn(B, H, L, D, device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn(B, KV, S, D, device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn(B, KV, S, D, device=dev, generator=g).to(torch.bfloat16)
        o = k4.flash_attention(q, k, v, causal)
        o0 = k4.flash_attention_plain(q, k, v, causal)
        check(bool(torch.isfinite(o).all()), f"{name}: non-finite output")
        # bf16 output: the kernel normalises after PV, the plain version
        # before its cast, so a bf16 ulp or so of each row's largest output
        err, share = (o.float() - o0.float()).abs().max().item(), row_share(o, o0)
        del o, o0
        mask = torch.ones(L, S, dtype=torch.bool, device=dev).tril(S - L) if causal else None
        pairs = L * (S - L) + L * (L + 1) // 2 if causal else L * S
        record(name, "medtsllm_tpu_torch/csrc/flash_attention.cu",
               "medtsllm_tpu/ops/pallas/flash_attention.py:196", err, None,
               cuda_ms(torch, lambda: k4.flash_attention(q, k, v, causal)),
               cuda_ms(torch, lambda: k4.flash_attention_plain(q, k, v, causal), iters=3,
                       warmup=1),
               bound(2 * (2 * B * H * L * D + 2 * B * KV * S * D), 4 * B * H * D * pairs,
                     "bf16"),
               cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=KV < H)),
               f" (B={B} H={H} KV={KV} L={L} S={S} D={D} causal={causal}; library = "
               "SDPA with the same mask)", False, share)

    check_k4("flash_attention", B, H, KV, L_long, S_long, D, True)
    check_k4("flash_attention[uncached]", B, H, KV, S_long, S_long, D, True)
    check_k4("flash_attention[non-causal]", B, H, KV, L_long, S_long, D, False)
    check_k4("flash_attention[gqa]", B, xcfg.n_heads, xcfg.kv_heads, L_long, S_long,
             xcfg.head_dim, True)

    # the route the decoder runs (rope_flash_attention: the pre-pass, then K4
    # with q rotated at load and the output in [B, L, H, D]) at the served
    # shapes, held in its three parts (hold_route); the pre-pass apart.
    # Bounds: the route reads q, k, v, the prefix and the tables once and
    # writes the output once, with K4's products; the pre-pass reads k, v,
    # the prefix and the tables and writes the concatenated keys and values.
    # Library: RoPE + SDPA with the same mask (the concat included)
    def check_route(label, Lq, Pq):
        q = torch.randn(B, Lq, H, D, device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn(B, Lq, KV, D, device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn(B, Lq, KV, D, device=dev, generator=g).to(torch.bfloat16)
        pk = pv = None
        if Pq:
            pk = torch.randn(1, KV, Pq, D, device=dev, generator=g).to(torch.bfloat16)
            pv = torch.randn(1, KV, Pq, D, device=dev, generator=g).to(torch.bfloat16)
        cos, sin = k2.rope_tables(torch.arange(Pq, Pq + Lq, device=dev), D, lcfg.rope_theta)
        Sq = Pq + Lq
        err, share = hold_route(q, k, v, cos, sin, pk, pv, f"rope_flash_attention{label}")
        mask = torch.ones(Lq, Sq, dtype=torch.bool, device=dev).tril(Pq)

        def rope_sdpa():
            kr, vv = k2.rope(k, cos, sin).transpose(1, 2), v.transpose(1, 2)
            if Pq:
                kr = torch.cat([pk.expand(B, -1, -1, -1), kr], 2)
                vv = torch.cat([pv.expand(B, -1, -1, -1), vv], 2)
            return F.scaled_dot_product_attention(
                k2.rope(q, cos, sin).transpose(1, 2), kr, vv, attn_mask=mask,
                enable_gqa=KV < H).transpose(1, 2)
        pairs = Lq * Pq + Lq * (Lq + 1) // 2
        io = 2 * (2 * B * Lq * H * D + 2 * B * Lq * KV * D + 2 * KV * Pq * D) + 8 * Lq * D // 2
        lib = cuda_ms(torch, rope_sdpa)
        record(f"rope_flash_attention{label}", "medtsllm_tpu_torch/csrc/flash_attention.cu",
               "medtsllm_tpu/ops/pallas/flash_attention.py:196", err, None,
               cuda_ms(torch, lambda: k4.rope_flash_attention(q, k, v, cos, sin, pk, pv)),
               cuda_ms(torch, lambda: k4.rope_flash_attention_plain(q, k, v, cos, sin, pk, pv),
                       iters=3, warmup=1),
               bound(io, 4 * B * H * D * pairs, "bf16"), lib,
               f" (B={B} L={Lq} H={H} KV={KV} D={D} P={Pq}; the pre-pass included; "
               f"|route - plain| {err:.3e} within 2^-6 x max; library = RoPE + SDPA with "
               "the same mask)", share=share)
        kv_bytes = 2 * (2 * B * Lq * KV * D + 2 * KV * Pq * D + 2 * B * KV * Sq * D) \
            + 8 * Lq * D // 2
        record(f"rope_flash_keys{label}", "medtsllm_tpu_torch/csrc/flash_attention.cu",
               "medtsllm_tpu/ops/pallas/flash_attention.py:196", 0.0, 0.0,
               cuda_ms(torch, lambda: k4.rope_flash_keys(k, v, cos, sin, pk, pv)),
               cuda_ms(torch, lambda: k4.rope_flash_keys_plain(k, v, cos, sin, pk, pv)),
               bound(kv_bytes, 0, "bf16"), None,
               f" (the route's pre-pass: keys rotated once and the prefix put ahead, "
               f"[B={B}, KV={KV}, S={Sq}, D={D}]; bit-equal to its plain version; no single "
               "PyTorch call computes it)")

    check_route("[long]", L_long, P_long)
    check_route("[uncached]", S_long, 0)
    torch.cuda.empty_cache()

    # K1 over one 7B block at the long window's M = B * L rows (17,024) and
    # K3 at its shape (the long cell's d_ff, 64, is K3's width; E 128, the
    # llama cell's width at this L, is printed beside it, not listed)
    d, f = lcfg.d_model, lcfg.d_ff
    check_k1("[long]", B * L_long, ((torch.float32, d, 5), (torch.bfloat16, d, 1),
                                    (torch.bfloat16, f, 1)),
             ((d, d, 4), (d, f, 2), (f, d, 1)), "7 GEMMs")
    mcl = cfg_long.models.medtsllm
    check_k3("reprogramming_attention[long]", B, tr.model.n_patches, mcl.n_heads, mcl.d_ff,
             mcl.num_tokens)
    check_k3("reprogramming_attention[long, E 128]", B, tr.model.n_patches, mcl.n_heads, 128,
             mcl.num_tokens, listed=False)
    torch.cuda.empty_cache()

    n_batches = len(tr.test_pipeline)
    check(n_batches == 2, f"the long window gives {n_batches} test batches, not 2")
    counts, preds, *_ = serve(tr, "long")
    check(counts["rope_flash_attention"] == counts["rope_flash_keys"] == n_block * n_batches
          and counts["rope_attention"] == n_block and counts["flash_attention"] == 0,
          f"the long window must run the K4 route {n_block} times per batch and K2 only in "
          f"the prefill: {counts}")
    set_launches(counts, {"rope_flash_attention[long]": "rope_flash_attention",
                          "rope_flash_keys[long]": "rope_flash_keys",
                          "w8a8_quantize[long]": "w8a8_quantize",
                          "w8a8_gemm[long]": "w8a8_gemm",
                          "reprogramming_attention[long]": "reprogramming_attention"})
    # one batch with the prompt head embedded in the graph (the uncached form:
    # L == S, JAX's padded-kernel route), the K4 route in every block, run by
    # the eager step; block 0's call is held against the plain version on
    # those served activations: each query row against K4's plain version
    # fed the same once-rounded rotation. The served graph goes first: its
    # pool and the eager step's working set would not fit together
    tr.step_graphs.clear()
    torch.cuda.empty_cache()
    batch = next(iter(tr.test_pipeline))
    arrays = tr._to_device(tr.model_inputs(batch))
    check("prefix_ids" in arrays, "the uncached form needs the embedded head")
    out, seen = [], []

    def spy(q, k, v, cos, sin, *a, **kw):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone(), cos.clone(), sin.clone()))
        return k4.rope_flash_attention(q, k, v, cos, sin, *a, **kw)
    tfm.rope_flash_attention = spy
    try:
        counts, _ = drive(lambda: out.append(tr.eval_step_eager(arrays).float()))
    finally:
        tfm.rope_flash_attention = k4.rope_flash_attention
    check(counts["rope_flash_attention"] == n_block and counts["rope_attention"] == 0,
          f"the uncached long batch must run the K4 route only: {counts}")
    set_launches(counts, {"rope_flash_attention[uncached]": "rope_flash_attention",
                          "rope_flash_keys[uncached]": "rope_flash_keys"})
    uncached = out[0]
    check(bool(torch.isfinite(uncached).all()), "non-finite uncached long batch")
    q, k, v, cos, sin = seen.pop()
    o = k4.rope_flash_attention(q, k, v, cos, sin)
    keys, values = k4.rope_flash_keys(k, v, cos, sin)
    o0 = k4.flash_attention_plain(k4.rope_once(q, cos, sin).transpose(1, 2), keys,
                                  values).transpose(1, 2)
    err, share = (o.float() - o0.float()).abs().max().item(), row_share(o, o0)
    check(share <= 1, f"K4 on block 0's served activations: a query row's error is {share} "
          f"of its tolerance, 2^-6 x max |plain| of the row")
    print(f"[long-uncached] the K4 route on block 0's served activations (q "
          f"{tuple(q.shape)}, k/v {tuple(k.shape)}) vs K4's plain version on the same "
          f"rotation: max_abs_err {err:.3e}, worst row at {share:.4f} of its tolerance "
          "(2^-6 x max |plain| of the row)")
    del q, k, v, cos, sin, o, o0, keys, values
    # the same batch served from a cache whose prefill also ran on K4
    # (K4_MIN_KEYS set to 1 for that batch, then restored): the prefill
    # returns the pre-pass's own rotated keys, K4 computes each query row
    # alike whatever L is, K1's integer GEMM and per-row quantizer alike
    # whatever M is, so cached and uncached agree to rounding: 1e-5 x max
    # |cached|. (Against the served cache, prefilled on K2, the
    # head's K/V would enter block 1 a few bf16 ulps apart, and the w8a8
    # projections turn such last-bit differences into int8 flips that 32
    # blocks compound: ROADMAP queue 3. That pair bounds nothing, so it is
    # not compared.)
    saved, tfm.K4_MIN_KEYS = tfm.K4_MIN_KEYS, 1
    try:
        tr._prefix_kv_cache.clear()
        cached_k4 = tr.eval_step_eager(tr.eval_model_inputs(batch)).float()
    finally:
        tfm.K4_MIN_KEYS = saved
        tr._prefix_kv_cache.clear()
    err = (uncached - cached_k4).abs().max().item()
    tol = 1e-5 * cached_k4.abs().max().item()
    check(err <= tol, f"long window uncached vs cached (K4 prefill): {err} > {tol}")
    print(f"[long-uncached] head embedded (L = S = {S_long}) vs the same batch served "
          f"from a cache prefilled on K4: max_abs_err {err:.3e} (tol {tol:.3e})")
    del tr, arrays, cached_k4, uncached, out, preds
    torch.cuda.empty_cache()

    # 18. the crossover window: history 4096 (d_ff 128) has P + L keys
    # between 512 and 2048, so K4_MIN_KEYS decides the route
    cfg_x = long_config(Config, history=4096, d_ff=128)
    tr = get_trainer("chip-smoke-crossover", cfg_x, device=dev)
    P_x, L_x = window_shapes(tr)
    counts, *_ = serve(tr, "crossover")
    n_batches = len(tr.test_pipeline)
    on_k4 = P_x + L_x >= tfm.K4_MIN_KEYS
    want = ({"rope_flash_attention": n_block * n_batches, "rope_attention": n_block}
            if on_k4 else
            {"rope_flash_attention": 0, "rope_attention": n_block * (n_batches + 1)})
    check(all(counts[k] == n for k, n in want.items()),
          f"history 4096 ({P_x + L_x} keys, K4_MIN_KEYS {tfm.K4_MIN_KEYS}) must launch "
          f"{want}: {counts}")
    print(f"[crossover] {P_x + L_x} keys, K4_MIN_KEYS {tfm.K4_MIN_KEYS}: the "
          f"{'K4' if on_k4 else 'K2'} route, as launched")
    del tr
    torch.cuda.empty_cache()

    # 19. a 2-layer llama-1b dense f32 slice (GQA 32 / 4 x 64) with every
    # attention, the prefill included, forced onto K4 by setting K4_MIN_KEYS
    # to 1 for this phase: the card's f32 K4 against the CPU's plain version,
    # same weights; f32 end to end, summation order only: 1e-5 x scale
    small = bench_config(Config, llm="llama-1b", batch=2, history=64, dtype="float32",
                         n_points=256, num_tokens=128, d_ff=64, llm_layers=2,
                         load_in_8bit=False)
    saved, tfm.K4_MIN_KEYS = tfm.K4_MIN_KEYS, 1
    try:
        gpu = get_trainer("chip-smoke-k4-small", small, device=dev)
        cpu = get_trainer("chip-smoke-k4-small", small, device="cpu")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
        batch = next(iter(gpu.test_pipeline))
        out = []
        counts, _ = drive(lambda: out.append(gpu.eval_dispatch(batch).cpu()))
        out_cpu = cpu.eval_dispatch(batch)
    finally:
        tfm.K4_MIN_KEYS = saved
    check(counts["rope_flash_attention"] == 2 * 2 and counts["rope_attention"] == 0,
          f"the forced slice must run K4 in both layers of the prefill and the batch: {counts}")
    err = (out[0] - out_cpu).abs().max().item()
    tol = 1e-5 * max(1.0, out_cpu.abs().max().item())
    check(err <= tol, f"K4 slice: card vs CPU max err {err} > {tol}")
    print(f"[reference] llama-1b 2-layer GQA dense f32 slice, every attention forced onto "
          f"K4 (K4_MIN_KEYS set to 1 for this phase, then restored), card vs CPU: "
          f"max_abs_err {err:.3e} (tol {tol:.3e}); K4 route launches "
          f"{counts['rope_flash_attention']}")
    del gpu, cpu

    check(all(e["launches"] for e in kernels), f"unlaunched kernels: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
