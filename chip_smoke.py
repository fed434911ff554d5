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
     against the plain version fed the once-rounded rotation; K4's wide
     heads, D 384, 512 and 768, f32 and bf16, printed), with both
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
  6o. the baseline models: the eight shipped files that name DLinear,
     PatchTST, TimesNet or FEDformer (configs/config.toml,
     baseline-models/etth1-dlinear, psm-patchtst, msl-timesnet,
     msl-fedformer, msl-fedformer-wavelets, ablation/dreams-classification
     and etth1-imputation), each as shipped on its family's stand-in,
     ``training.epochs`` cut to 1; no kernel of the port lies on their path
     (none launches): ``train()`` (captured steps, then ``val()``),
     ``train_graphed`` over 8 steps, ``serve()``, then a line each with
     the eval p50 eager and graphed, the train p50, ``test()``'s
     windows/s and the peak GiB beside the card's name and power limit;
     then configs/config.toml through the train and test CLIs'
     ``__main__`` in this process (``run_main``; 6l runs them as
     subprocesses): the scores equal;
  6p. GPT4TS: the four shipped files that name it (baseline-models/
     bidmc-gpt4ts, dreams, ecgmit-anom, ecgmit-seg), each as shipped (f32,
     gpt2 at d 768, 6 or 12 layers) on its family's stand-in,
     ``training.epochs`` cut to 1; at their 128-320-token windows JAX's
     attention dispatcher runs its plain attention, so no kernel launches:
     ``train()``, ``train_graphed`` over 8 steps (the frozen gpt2 weights
     unchanged), ``serve()``, a summary line each and the device memory left
     after its ``del`` and ``gc.collect()``; then what a trainer leaves when
     it captures on a stream of its own against the shared capture stream;
     then one eval of dreams.toml at history = pred_len = 512, which the
     gate sends to K4 (once a layer a batch, nothing else launched), and K4
     at gpt2's shape (B 16, H = KV 12, L = S 512, D 64, f32, causal) against
     its plain version, listed as ``flash_attention[gpt2]``;
  6q. MedTsLLM over gpt2 at its published widths (12 layers, d 768, 12 x
     64 heads, d_ff 3072, vocab 50257): bidmc-like reconstruction, history
     256, patch 16 / 8, ``concat``, batch 16, bf16, ``load_in_8bit`` (K1 on
     the fused ``c_attn``, ``c_proj``, ``c_fc`` and the MLP's ``c_proj``, the
     bias added after the rescale), the prompt head cached: K1 held at the
     gpt2 block (``w8a8_quantize[gpt2]``, ``w8a8_gemm[gpt2]``), ``serve()``,
     the cached head against the head embedded in the step; the banked step
     on a clip config (per-clip heads) against the embedded head; LoRA
     (rank 8, alpha 16, rslora, on the q third of ``c_attn``) through
     ``train_graphed`` over 4 steps (K1's straight-through dx; replays
     bit-equal to the eager steps; every ``lora_b`` moved, every other
     ``llm.`` tensor unchanged); a 2-layer dense f32 slice at d 768 with
     random adapters, card vs CPU;
  6r. the same over opt-125m's and pythia-160m's published config.json
     (written to a temporary snapshot directory beside a tokenizer, read by
     the port's ``config_from_hf_json``; seeded weights): opt's learned
     positions from row 2 and relu, neox's partial rotary (16 of 64 dims)
     and parallel residual, six K1 GEMMs a block;
  6s. gpt2 at a long window: per-clip heads (a 16-token bucket) and the
     history chosen so that [prefix | region] is 768 keys, which JAX's gate
     sends to K4 (end-aligned, L < S) once a layer a batch through
     ``serve()``; K4 held there (``flash_attention[gpt2-prefix]``), the
     route table printed, and K4's D 192 and D 256 instances, f32 and bf16,
     against the plain version at one shape each (printed, not listed);
  6t. MedTsLLM over google/flan-t5-base's published config.json (12 + 12
     layers, d 768, 12 x 64 heads, gated-gelu d_ff 2048, vocab 32128, 32
     relative buckets) with seeded weights in HF's names, written in two
     shards by the port's safetensors writer and loaded by the trainer
     (every loaded leaf held bit-equal to the written tensors);
     bidmc.toml's settings, w8a8 bf16, batch 16, history 256: the prompt
     through the encoder, the 32 patches through the decoder; K1 held at
     the decoder's rows and at the encoder's (its blocks' and the cross
     k / v; ``w8a8_*[t5]``, ``w8a8_*[t5-enc]``) and K3 at E 64
     (``reprogramming_attention[t5]``); ``serve()`` over 32 test batches,
     ``train()`` (an epoch of captured steps, then ``val()``; the backbone
     unchanged), ``train_graphed``; then ``load_in_4bit`` (K1's quantizer and K5,
     ``w4a8_gemm[t5]``); a 2 + 2-layer dense f32 slice, card vs CPU;
  6u. the same over facebook/bart-base's config.json (6 + 6 post-LN layers,
     ffn 3072, vocab 50265, 1024 positions; the weights under the
     "model." prefix), then at history 4096: 512 patches, JAX's gate
     sends the decoder's causal self-attention (L = S = 512, D 64) to K4
     once a layer a batch, held per query row at 2^-6 of its max
     (``flash_attention[bart-decoder]``);
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
  6l. the run lifecycle at bidmc.toml's full width cut to 4 layers
     (``LIFECYCLE_LAYERS``), its run directories under a temporary
     directory: (a) ``python -m medtsllm_tpu_torch.train`` as a subprocess
     on bidmc.toml as shipped (``dumps_toml`` of it, only ``training.epochs
     = 1``, the depth and ``paths.logdir`` changed; the logger as
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
  8b. MoE training: ``train()`` of configs/ablation/moe-backbone.toml as
     shipped (moe-8x1b, w8a8, bf16, batch 48, expert capacity 1.25) on the
     ventilator stand-in, ``training.epochs`` cut to 1: the capacity path
     (K1's quantizer once and its GEMM per expert for gate, up and down, the
     straight-through backward; K1 and K2 in the attention), the launches of
     a step held, ``train_graphed`` over 8 steps, ``serve()`` (K6, K3); K1's
     GEMM at the capacity shape (C slots an expert) bit-equal, listed as
     ``w8a8_gemm[moe-train]``;
  9. the llama finetune step: ``train()`` of the Llama-2-7B-shaped w8a8
     bf16 configuration (frozen int8 backbone, trainable fusion layers,
     batch 8): finite losses, changed fusion layers, an unchanged backbone,
     K1 and K2 launched; ``train_graphed``;
  9b. the same finetune with ``llm.int8_backward`` and ``grad_accum_steps
     = 2`` (n_points 4000: four micro-batches of 8, two optimizer steps):
     ``train()`` with the gradient rows' quantizer and the int8 dx GEMM 7 x
     32 times a micro-step, the backbone unchanged; a captured odd
     micro-step moving nothing and the even one moving the fusion layers;
     ``train_graphed`` (both phases' graphs, replays bit-equal); the dx at
     one 7B block's shapes (M 896) bit-equal to its plain version and its
     cosine with the straight-through dx, the batched dh at one moe-8x1b
     layer (E 8, C 2160, K 2048, N 5632) bit-equal, the [K, N] copies'
     GiB, the peak, and the dx GEMM against ``torch._int_mm`` + rescale;
     listed as ``w8a8_quantize_grad`` and ``w8a8_gemm[dx]``;
  9c. QLoRA on the 7B: ``load_in_4bit`` (absmax int4: K1's quantizer and
     K5), LoRA rank 8, alpha 16, rslora on q and v, ``ranger21``, batch 8:
     ``train_graphed`` over 4 steps (replays bit-equal, ``lora_b`` moved,
     every other ``llm.`` tensor unchanged, K5 launched); then nf4 at 2
     layers, f32, card against the CPU;
  9d. remat at full width: gpt2 (12 layers, d 768, dropout 0.1) w8a8 bf16
     at batch 16 with LoRA under ``remat`` false / "full" / "dots", three
     captured steps each: losses, adapters and their gradients bit-equal
     across the three, K1's GEMM launches a step (the recompute's) and the
     peak GiB of each; mamba-130m (prompt head embedded) under ``remat =
     true``: two steps with gradients bit-equal to those without, K9 and
     K10 launched; one ``ranger_classic`` step on the gpt2 model;
  6y. serving export (``runtime/export.py``): each trainer's eager eval
     step (and its prefill) through ``torch.export``, every kernel a
     ``medtsllm::`` custom op in the graph, saved, loaded and served: the
     main path (phase 4's 7B w8a8 at full depth) with the export seconds,
     the artifact's bytes against the params' (no weight inside) and the
     loaded program's ms beside the live eager and graphed steps';
     mamba-130m's state prefill; per-clip bank rows from the exported [1,
     P] prefill on 4 layers of ecgmit-seg.toml; gpt2 at 768 keys (K4); 2
     layers of the 7B at int4 (K5) and of moe-8x1b (K6 and its requant).
     Each round trip exactly 0, the loaded program bit-equal to the eager
     and the graphed step, each kernel's counter moved by the loaded
     program;
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
     the card against the CPU;
 20. the ops library no model reaches, at published widths, in eval, f32,
     seeded weights, each module on the card against its copy on the CPU
     (1e-5 x max(1, max |CPU|)) with its CUDA-event ms, no kernel of the
     port launched: Informer as its main_informer.py runs ETTh1 (batch 32,
     96 steps, d_model 512, 8 heads, d_ff 2048, factor 5: a 2-layer
     ProbAttention encoder with a ConvLayer between the layers, then a
     1-layer Decoder over 72 steps with a causal ProbAttention and a
     FullAttention cross-attention; the card's top-u queries fed to the CPU,
     the share the CPU picks alike printed), the same on DSAttention with
     seeded ``tau`` / ``delta``; ``ReformerLayer`` (d_model 512, 8 heads,
     bucket_size 4, 4 hashes, 96 tokens, batch 32; the share of bucket ids
     the card and the CPU agree on, then both on the card's ids);
     ``TwoStageAttentionLayer`` at main_crossformer.py's ETTh1 (7
     variables, 16 segments of 6, d_model 256, d_ff 512, 4 heads, factor
     10, batch 32); ``InceptionBlockV2`` at TimesNet's ETTh1 widths (16 to
     32 channels, 6 kernels, 192 steps) at each of the top-5 periods;
     ``FlattenHead`` at PatchTST's ETTh1 head (16 x 42 -> 96);
     ``RevINAffine`` and the complex ``rfft`` / ``irfft`` (96 and 4,096
     steps).
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
Every served path (phases 4, 6a-6c, 6e-6i, 6o-6u, 6, 8b, 11, 13, 14, 15, 17 and 18) runs
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
Every train path (6a, 6e, 6g-6i, 6o, 6p, 6t-6u, 8, 8b, 9) trains through ``train()``, whose
train step replays one CUDA graph per input signature (forward, backward,
clip and Adam; ``TrainGraphs``), and then ``train_graphed``: the train
step's p50 op by op (``train_step_eager``) and captured (``train_step``)
side by side, each's peak memory, the graphs, their capture ms and the
train pool's GiB, every graphed step with the eager step's launches; then
the parameters, the optimizer's state and the dropout generator snapshot
in place, 4 graphed steps across an LR change, the snapshot restored and 4
eager steps: the losses, the trainable parameters, the optimizer's state,
the gradients and the generator's state bit-equal (the generator advanced
where the model draws dropout masks; DLinear draws none), and the backbone
unchanged (GPT4TS: its frozen gpt2 weights).
Then one JSON line with the kernels and, last, the result line. Any failure
raises (exit code != 0) and prints no result line; without a CUDA card it
fails before any work.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
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
# the task blocks of phases 6g-6i (each file's own model, GPT4TS, PatchTST or
# TimesNet, runs as shipped in 6o / 6p; bidmc.toml gives the MedTsLLM settings)
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
# phase 6o: the shipped files that name a baseline model (the four gpt4ts
# files are 6p's)
BASELINE_TOMLS = {
    "config": ROOT / "configs" / "config.toml",
    "etth1-dlinear": ROOT / "configs" / "baseline-models" / "etth1-dlinear.toml",
    "psm-patchtst": ROOT / "configs" / "baseline-models" / "psm-patchtst.toml",
    "dreams-patchtst-classification": DREAMS_CLS_TOML,
    "msl-timesnet": ROOT / "configs" / "baseline-models" / "msl-timesnet.toml",
    "etth1-timesnet-imputation": ETTH1_IMP_TOML,
    "msl-fedformer": ROOT / "configs" / "baseline-models" / "msl-fedformer.toml",
    "msl-fedformer-wavelets": ROOT / "configs" / "baseline-models" / "msl-fedformer-wavelets.toml",
}
# phase 6p: the shipped files that name GPT4TS (gpt2 at d 768, 6 or 12 layers)
GPT4TS_TOMLS = {name: ROOT / "configs" / "baseline-models" / f"{name}.toml"
                for name in ("bidmc-gpt4ts", "dreams", "ecgmit-anom", "ecgmit-seg")}
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
    "reconstruction": {"mse", "mae"},
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


def baseline_config(Config, toml, epochs=1):
    """A shipped baseline file as it is, its ``data.dataset`` included (the
    family's stand-in when the recordings are absent, with its warning),
    ``training.epochs`` cut to ``epochs``."""
    from medtsllm_tpu_torch.config import load_config
    raw = load_config(toml).to_dict()
    raw["training"]["epochs"] = epochs
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


# phases 6q-6r: the published config.json entries of opt-125m and pythia-160m
# (HF's facebook/opt-125m and EleutherAI/pythia-160m), written to a temporary
# snapshot directory and read by the port's config_from_hf_json (no weights:
# the backbone is seeded)
OPT_125M = {"model_type": "opt", "vocab_size": 50272, "hidden_size": 768,
            "num_hidden_layers": 12, "num_attention_heads": 12, "ffn_dim": 3072,
            "max_position_embeddings": 2048, "do_layer_norm_before": True,
            "word_embed_proj_dim": 768, "dropout": 0.1, "activation_function": "relu",
            "bos_token_id": 2, "eos_token_id": 2, "pad_token_id": 1}
PYTHIA_160M = {"model_type": "gpt_neox", "vocab_size": 50304, "hidden_size": 768,
               "num_hidden_layers": 12, "num_attention_heads": 12,
               "intermediate_size": 3072, "max_position_embeddings": 2048,
               "rotary_pct": 0.25, "rotary_emb_base": 10000, "use_parallel_residual": True,
               "hidden_act": "gelu", "layer_norm_eps": 1e-5, "hidden_dropout": 0.0,
               "bos_token_id": 0, "eos_token_id": 0}
# the LoRA of phases 6q-6r: rank 8, alpha 16, rslora (peft's targets: the q
# third of gpt2's c_attn, opt's and neox's q_proj)
LORA = {"enabled": True, "rank": 8, "alpha": 16, "rslora": True, "dropout": 0.0,
        "layers": "auto"}


# phases 6t-6u: the published config.json entries of google/flan-t5-base and
# facebook/bart-base, written to a temporary snapshot directory with seeded
# weights in HF's names (``encdec_tensors``, written by the port's own
# safetensors writer) and read by the port's config_from_hf_json and loader
FLAN_T5_BASE = {"model_type": "t5", "vocab_size": 32128, "d_model": 768, "d_kv": 64,
                "d_ff": 2048, "num_layers": 12, "num_decoder_layers": 12, "num_heads": 12,
                "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
                "dropout_rate": 0.1, "layer_norm_epsilon": 1e-6,
                "feed_forward_proj": "gated-gelu", "is_encoder_decoder": True,
                "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0}
BART_BASE = {"model_type": "bart", "vocab_size": 50265, "d_model": 768, "encoder_layers": 6,
             "decoder_layers": 6, "encoder_attention_heads": 12,
             "decoder_attention_heads": 12, "encoder_ffn_dim": 3072, "decoder_ffn_dim": 3072,
             "max_position_embeddings": 1024, "activation_function": "gelu", "dropout": 0.1,
             "scale_embedding": False, "is_encoder_decoder": True, "bos_token_id": 0,
             "eos_token_id": 2, "pad_token_id": 1}


def encdec_tensors(torch, dev, fields: dict, seed: int) -> dict:
    """Seeded weights in HF's state-dict names for a t5 or bart
    ``config.json`` at its widths (the names the loader maps): N(0, 0.02)
    matrices and tables, norm weights 1 + N(0, 0.02), biases N(0, 0.02);
    drawn on the card, rounded to bf16 and kept as f32 numpy, so a bf16
    parameter holds each value exactly."""
    g = torch.Generator(dev).manual_seed(seed)
    shapes, V, d = {}, fields["vocab_size"], fields["d_model"]
    if fields["model_type"] == "t5":
        inner, f, nb = fields["num_heads"] * fields["d_kv"], fields["d_ff"], \
            fields["relative_attention_num_buckets"]
        shapes["shared.weight"] = (V, d)
        for side, n, sub in (("encoder", fields["num_layers"], ("SelfAttention",)),
                             ("decoder", fields["num_decoder_layers"],
                              ("SelfAttention", "EncDecAttention"))):
            shapes[f"{side}.final_layer_norm.weight"] = (d,)
            shapes[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
                nb, fields["num_heads"])
            for i in range(n):
                for j, attn in enumerate(sub):
                    p = f"{side}.block.{i}.layer.{j}."
                    shapes[p + "layer_norm.weight"] = (d,)
                    for m in ("q", "k", "v"):
                        shapes[p + f"{attn}.{m}.weight"] = (inner, d)
                    shapes[p + f"{attn}.o.weight"] = (d, inner)
                p = f"{side}.block.{i}.layer.{len(sub)}."
                shapes[p + "layer_norm.weight"] = (d,)
                shapes[p + "DenseReluDense.wi_0.weight"] = (f, d)
                shapes[p + "DenseReluDense.wi_1.weight"] = (f, d)
                shapes[p + "DenseReluDense.wo.weight"] = (d, f)
    else:  # bart, under BartForConditionalGeneration's "model." prefix
        f = fields["encoder_ffn_dim"]
        shapes["model.shared.weight"] = (V, d)
        for side, n in (("encoder", fields["encoder_layers"]),
                        ("decoder", fields["decoder_layers"])):
            shapes[f"model.{side}.embed_positions.weight"] = (
                fields["max_position_embeddings"] + 2, d)
            shapes[f"model.{side}.layernorm_embedding.weight"] = (d,)
            shapes[f"model.{side}.layernorm_embedding.bias"] = (d,)
            for i in range(n):
                p = f"model.{side}.layers.{i}."
                attns = ("self_attn", "encoder_attn") if side == "decoder" else ("self_attn",)
                for attn in attns:
                    for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
                        shapes[p + f"{attn}.{m}.weight"] = (d, d)
                        shapes[p + f"{attn}.{m}.bias"] = (d,)
                    shapes[p + f"{attn}_layer_norm.weight"] = (d,)
                    shapes[p + f"{attn}_layer_norm.bias"] = (d,)
                shapes[p + "fc1.weight"], shapes[p + "fc1.bias"] = (f, d), (f,)
                shapes[p + "fc2.weight"], shapes[p + "fc2.bias"] = (d, f), (d,)
                shapes[p + "final_layer_norm.weight"] = (d,)
                shapes[p + "final_layer_norm.bias"] = (d,)
    out = {}
    for name, shape in shapes.items():
        w = torch.randn(shape, device=dev, generator=g) * 0.02
        if name.endswith("norm.weight") or name.endswith("layernorm_embedding.weight"):
            w += 1.0
        out[name] = w.to(torch.bfloat16).float().cpu().numpy()
    return out


def encdec_config(Config, llm, history=256, n_points=None, batch=16, dtype="bf16",
                  quant_type=None, load_in_8bit=True, llm_layers=-1):
    """configs/datasets/bidmc.toml's MedTsLLM settings (segmentation,
    history 256, patch 16 / 8, concat, d_ff 64, its prompting, batch 16) on
    the synthetic data over ``llm`` (a snapshot directory), at ``dtype``
    (bf16 unless given) with ``load_in_8bit`` (or ``quant_type`` in 4 bits);
    ``n_points`` a split (512 test windows of ``history`` by default: 32
    batches of 16)."""
    raw = task_config(Config, BIDMC_TOML, n_points or 512 * history, llm=llm,
                      llm_layers=llm_layers, history=history, batch=batch).to_dict()
    raw["setup"]["dtype"] = dtype
    raw["models"]["timellm"]["llm"].update(load_in_8bit=load_in_8bit and not quant_type,
                                           load_in_4bit=bool(quant_type),
                                           quant_type=quant_type or "int4")
    return quiet(Config, raw)


def family_config(Config, llm, batch=16, history=256, n_points=8320, dtype="bf16",
                  load_in_8bit=True, lora=False, n_clips=None, n_features=3,
                  input_stats=True, llm_layers=-1, d_ff=128, num_tokens=1024):
    """``bench_config`` over ``llm`` (a preset id or a snapshot directory):
    bidmc-like reconstruction of ``n_features`` synthetic features, the
    prompt head cached; the default n_points gives 64 windows a split (4
    batches of 16). ``lora`` adds the ``LORA`` adapters; ``n_clips`` makes
    the data a clip dataset with per-clip head rows (``prompting.clip``)."""
    raw = bench_config(Config, llm=llm, batch=batch, history=history, dtype=dtype,
                       n_points=n_points, num_tokens=num_tokens, d_ff=d_ff,
                       llm_layers=llm_layers, load_in_8bit=load_in_8bit).to_dict()
    raw["datasets"]["synthetic"]["n_features"] = n_features
    mc = raw["models"]["medtsllm"]
    mc["prompting"]["input_stats"] = input_stats
    if lora:
        mc["lora"] = dict(LORA)
    if n_clips:
        raw["datasets"]["synthetic"].update(clips=True, n_clips=n_clips)
        mc["prompting"]["clip"] = True
    return quiet(Config, raw)


def write_snapshot(root: Path, name: str, fields: dict) -> str:
    """A snapshot directory: ``config.json`` and, as its tokenizer, the
    port's fallback byte-level BPE (``tokenizer.json`` with a
    ``tokenizer_config.json`` naming ``PreTrainedTokenizerFast``), so that
    where transformers is installed it loads a real tokenizer from the
    snapshot, and elsewhere the port's fallback reads the same BPE; returns
    its path. No weights: the backbone is seeded."""
    path = root / name
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(fields))
    shutil.copyfile(ROOT / "medtsllm_tpu_torch" / "models" / "llm" / "assets" /
                    "fallback_bpe.json", path / "tokenizer.json")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "pad_token": "<pad>"}))
    return str(path)


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
    ``Optimizer``) updates, detached (their storage shared):
    ``Optimizer.state_tensors``, the trainable parameters first. A captured
    step reads and writes them where they lie, so a snapshot is restored
    into them with ``copy_``."""
    return opt.state_tensors()


def derived_config(Config, cfg, training=None, llm=None, lora=None):
    """``cfg`` with entries of ``[training]`` and the model's ``llm`` table
    set, and ``lora`` as its ``[models.<m>.lora]``."""
    raw = cfg.to_dict()
    raw["training"].update(training or {})
    mc = raw["models"].get("medtsllm") or raw["models"]["timellm"]
    mc["llm"].update(llm or {})
    if lora:
        mc["lora"] = dict(lora)
    return Config(raw)


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


def run_main(module: str, *args: str) -> str:
    """``python -m medtsllm_tpu_torch.<module> args`` in this process (its
    ``__main__`` block by ``runpy``, as ``-m`` runs it, without a new
    interpreter's ~20 s of imports and set-up); returns its stdout."""
    import contextlib
    import io
    import runpy
    import warnings

    out, argv = io.StringIO(), sys.argv
    sys.argv = [module, *args]
    try:
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            # a module run again, or imported by another CLI, is in sys.modules
            warnings.filterwarnings("ignore", ".*found in sys.modules", RuntimeWarning)
            runpy.run_module(f"medtsllm_tpu_torch.{module}", run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


LIFECYCLE_LAYERS = 4  # 6l's depth: the lifecycle, not the backbone, is under test


def lifecycle(runs: Path, dev, drive, Config) -> None:
    """Phase 6l: the train and test CLIs, SIGUSR1 and the resume, and
    pretraining -> finetuning, on the card at bidmc.toml's full width cut to
    ``LIFECYCLE_LAYERS`` layers, the run directories under ``runs``."""
    import torch

    from medtsllm_tpu_torch.config import dumps_toml, load_config
    from medtsllm_tpu_torch.runtime.checkpoint import load_checkpoint, wait_for_saves
    from medtsllm_tpu_torch.tasks import get_trainer, task_lookup

    def shipped(**top) -> dict:
        raw = load_config(BIDMC_TOML).to_dict()
        raw["training"]["epochs"] = 1
        raw["models"]["timellm"]["llm"]["llm_layers"] = LIFECYCLE_LAYERS
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
    pre_raw["models"]["timellm"]["llm"]["llm_layers"] = LIFECYCLE_LAYERS
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


def ops_library(torch, dev, drive, smi: str) -> None:
    """Phase 20: the ops library no model reaches, at published widths, in
    eval, f32, on the card: each module against the same module (the same
    seeded weights) on the CPU, within 1e-5 x max(1, max |CPU|), with its
    CUDA-event ms; none launches a kernel of the port (every count 0).

    Where a module picks by comparison (ProbAttention's top-u queries, the
    LSH buckets), an ulp between the devices can pick apart: the card's
    picks are fed to the CPU and the share of the CPU's own picks that agree
    is printed (``select``, ``buckets``)."""
    from torch import nn

    from medtsllm_tpu_torch.ops import attention as att
    from medtsllm_tpu_torch.ops import crossformer as cf
    from medtsllm_tpu_torch.ops import dft, heads, revin
    from medtsllm_tpu_torch.ops import inception as inc
    from medtsllm_tpu_torch.ops import transformer as tf
    from medtsllm_tpu_torch.weights import init_random_

    gen = torch.Generator(device=dev)

    def data(*shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(*shape, generator=g, device=dev)

    def pair(module):
        """(the module on the card with seeded weights, in eval; its CPU copy)."""
        module = module.to(dev)
        init_random_(module, gen.manual_seed(SEED))
        return module.eval(), copy.deepcopy(module).cpu().eval()

    def prob_picks(card, cpu):
        """Feed each of ``cpu``'s ProbAttention modules the queries its card
        twin picked, call by call; returns [agreeing, total] picks."""
        tally, picked = [0, 0], []
        for m in (m for m in card.modules() if isinstance(m, att.ProbAttention)):
            def on_card(q, k, *a, _m=m, _f=m.forward, **kw):
                picked.append(_m.select(q, k))
                return _f(q, k, *a, index=picked[-1], **kw)
            m.forward = on_card
        for m in (m for m in cpu.modules() if isinstance(m, att.ProbAttention)):
            def on_cpu(q, k, *a, _m=m, _f=m.forward, **kw):
                idx = picked.pop(0).cpu()
                own = _m.select(q, k)
                tally[0] += int((own.sort(-1).values == idx.sort(-1).values).all(-1).sum())
                tally[1] += own.shape[0] * own.shape[1]
                return _f(q, k, *a, index=idx, **kw)
            m.forward = on_cpu
        return tally, picked

    def held(name, card, cpu, args, **kw):
        """One forward on the card (counted) against the CPU's; its ms."""
        with torch.no_grad():
            out = []
            counts, _ = drive(lambda: out.append(card(*args, **kw)))
            check(not any(counts.values()), f"[ops] {name} launched a kernel: {counts}")
            got = out[0][0] if isinstance(out[0], tuple) else out[0]
            ref = cpu(*[a.cpu() if torch.is_tensor(a) else a for a in args],
                      **{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()})
            ref = ref[0] if isinstance(ref, tuple) else ref
            err = (got.cpu() - ref).abs().max().item()
            tol = 1e-5 * max(1.0, ref.abs().max().item())
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"[ops] {name}: card vs CPU max err {err} > {tol}")
            ms = cuda_ms(torch, lambda: card(*args, **kw))
        print(f"[ops] {name}: out {tuple(got.shape)}, {ms:.4f} ms, max_abs_err {err:.3e} "
              f"(tol {tol:.3e}); {smi}")

    class Informer(nn.Module):
        """Informer (ETTh1 in its main_informer.py: d_model 512, 8 heads,
        d_ff 2048, factor 5, gelu, distil): a 2-layer encoder of ``inner``
        attention with one ConvLayer between the layers, then a 1-layer
        Decoder with a causal ``inner`` self-attention and a FullAttention
        cross-attention, projected to 7 variables."""

        def __init__(self, inner):
            super().__init__()
            d, H, d_ff = 512, 8, 2048
            layers = []
            for i in range(2):
                setattr(self, f"enc_attn_{i}", att.AttentionLayer(inner(False), d, H))
                layers.append(tf.EncoderLayer(getattr(self, f"enc_attn_{i}"), d, d_ff,
                                              p=0.05, activation_name="gelu"))
                setattr(self, f"enc_layer_{i}", layers[-1])
            self.conv_0 = tf.ConvLayer(d)
            self.encoder = tf.Encoder(layers, d, conv_layers=[self.conv_0])
            self.dec_self = att.AttentionLayer(inner(True), d, H)
            self.dec_cross = att.AttentionLayer(att.FullAttention(mask_flag=False), d, H)
            self.dec_layer_0 = tf.DecoderLayer(self.dec_self, self.dec_cross, d, d_ff, p=0.05,
                                               activation_name="gelu")
            self.decoder = tf.Decoder([self.dec_layer_0], d, projection_dim=7)

        def forward(self, x_enc, x_dec, tau=None, delta=None):
            enc, _ = self.encoder(x_enc, tau=tau, delta=delta)
            return self.decoder(x_dec, enc, tau=tau)

    # Informer at batch 32, seq_len 96, label_len 48 + pred_len 24 = 72
    # decoder steps, the inputs at d_model (the embedding is not this
    # library's); then the same encoder and decoder on DSAttention with tau
    # [B] and delta [B, 96] from a seed (the Non-stationary Transformer's)
    x_enc, x_dec = data(32, 96, 512, seed=1), data(32, 72, 512, seed=2)
    card, cpu = pair(Informer(lambda causal: att.ProbAttention(causal, factor=5)))
    tally, picked = prob_picks(card, cpu)
    held("informer[prob]", card, cpu, (x_enc, x_dec))
    picked.clear()  # the timed calls' picks
    check(tally[1] == 32 * 8 * 3, f"[ops] informer[prob]: {tally[1]} picks compared")
    print(f"[ops] informer[prob]: the CPU's own top-u query sets equal the card's on "
          f"{tally[0] / tally[1]:.4f} of {tally[1]} (B, H) rows of its 3 ProbAttentions")
    tau = data(32, seed=3).abs() + 0.5
    delta = data(32, 96, seed=4)
    card, cpu = pair(Informer(lambda causal: att.DSAttention(causal)))
    held("informer[ds]", card, cpu, (x_enc, x_dec), tau=tau, delta=delta)

    # ReformerLayer: d_model 512, 8 heads, bucket_size 4, 4 hashes, 96 tokens
    x = data(32, 96, 512, seed=5)
    card, cpu = pair(att.ReformerLayer(512, 8, bucket_size=4, n_hashes=4))
    rot = card.rotations(96, dev)
    with torch.no_grad():
        b_card, b_cpu = card.buckets(x, rot), cpu.buckets(x.cpu(), rot.cpu())
    share = (b_card.cpu() == b_cpu).double().mean().item()
    print(f"[ops] reformer: bucket ids {tuple(b_card.shape)}, card and CPU agree on "
          f"{share:.6f}")
    check(share >= 0.999, f"[ops] reformer: bucket ids agree on {share} only")
    held("reformer", card, cpu, (x,), rotations=rot, buckets=b_card)

    # Crossformer (ETTh1 in its main_crossformer.py: 7 variables, in_len 96,
    # seg_len 6 -> 16 segments, d_model 256, d_ff 512, 4 heads, factor 10)
    card, cpu = pair(cf.TwoStageAttentionLayer(16, 10, 256, 4, 512, p=0.2, attention_p=0.2))
    held("two_stage_attention", card, cpu, (data(32, 7, 16, 256, seed=6),))

    # TimesNet's inception block V2 at its ETTh1 widths (d_model 16 -> d_ff
    # 32, num_kernels 6; seq_len 96 + pred_len 96 = 192 steps in the 2T
    # buffer), at each of the top-5 periods of a seeded series (the card's,
    # fed to both)
    series = data(32, 192, 16, seed=7)
    periods, _ = inc.fft_for_period(series, 5)
    buf = torch.cat([series, torch.zeros_like(series)], 1)
    card, cpu = pair(inc.InceptionBlockV2(16, 32, 6))
    for p in periods.tolist():
        held(f"inception_v2[period {p}]", card, cpu, (buf, torch.tensor(p, device=dev)),
             seq_len=192, out_len=384)

    # FlattenHead at PatchTST's ETTh1 head (d_model 16 x 42 patches -> 96)
    card, cpu = pair(heads.FlattenHead(16 * 42, 96))
    held("flatten_head", card, cpu, (data(32, 7, 16, 42, seed=8),))

    # RevIN's affine (7 variables) and the complex DFT at 96 and 4,096 steps
    card, cpu = pair(revin.RevINAffine(7))
    for p in card.parameters():
        p.data.copy_(data(7, seed=9))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    held("revin_affine[denorm]", card, cpu, (data(32, 96, 7, seed=10), "denorm"))
    for n in (96, 4096):
        x = data(32, 7, n, seed=11)
        held(f"rfft[{n}]", dft.rfft, dft.rfft, (x,))
        held(f"irfft[{n}]", lambda s: dft.irfft(s, n), lambda s: dft.irfft(s, n),
             (dft.rfft(x),))


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
        if gemms:  # (a caller may list each GEMM apart)
            check_k1_gemm(label, M, gemms, f"per decoder block, {note}")

    def check_k1_gemm(label, M, gemms, note, out_dtype=torch.bfloat16):
        """K1's GEMM at M rows: ``gemms`` (K, N, calls), written as
        ``out_dtype``; s32 accumulators and outputs held bit-equal to the
        plain version."""
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
            y = k1.int8_gemm(xq, wq, xs, ws, out_dtype)
            y0 = k1.int8_gemm_plain(xq, wq, xs, ws, out_dtype)
            g_err = max(g_err, (y.float() - y0.float()).abs().max().item())
            xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)  # dense reference
            g_ms += n * cuda_ms(torch, lambda: k1.int8_gemm(xq, wq, xs, ws, out_dtype))
            g_plain += n * cuda_ms(torch, lambda: k1.int8_gemm_plain(xq, wq, xs, ws,
                                                                      out_dtype))
            g_dense += n * cuda_ms(torch, lambda: xb @ wb.T)
            # the library's int8 GEMM (cuBLASLt) and the same rescale
            g_lib += n * cuda_ms(torch, lambda: (torch._int_mm(xq, wq.T).float() * (
                xs[:, None] * ws[None, :])).to(out_dtype))
            g_bytes += n * (M * K + N * K + M * 4 + N * 4 + M * N * y.element_size())
            g_ops += n * 2 * M * K * N
        # same integers and the same f32 epilogue order: bit-equal
        record("w8a8_gemm" + label, "medtsllm_tpu_torch/csrc/w8a8.cu",
               "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", g_err, 0.0, g_ms, g_plain,
               bound(g_bytes, g_ops, "int8"), g_lib,
               f" ({note}; s32 bit-equal; library = torch._int_mm "
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

    def check_k2(name, B, L, H, KV, D, P, theta, listed=True, PB=1, views=False):
        """K2 with a prefix of PB rows: 1 (the constant head) or B (per-clip
        head rows gathered from the bank); P 0: no prefix (``pk = None``,
        as the pretraining mixture's step runs it). ``views``: q, k and v
        are column views of one fused projection output [B, L, (H + 2 KV)
        D], as ``llm.fuse_projections`` hands them to K2."""
        if views:
            qkv = torch.randn(B, L, (H + 2 * KV) * D, device=dev, generator=g).to(
                torch.bfloat16)
            q, k, v = (t.reshape(B, L, -1, D)
                       for t in qkv.split((H * D, KV * D, KV * D), dim=-1))
        else:
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
                "grouped_matmul_w4_down": gm.DOWN_W4,
                "w8a8_quantize_grad": k1.quantize_grad_rows}
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

    serve_stats = {}  # label -> serve()'s p50s, test()'s windows/s and its peak bytes

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
        serve_stats[label] = {"p50": p50, "p50_graph": p50_graph,
                              "windows_s": n_windows / wall,
                              "peak": max(eager_peak, test_peak, replay_peak)}
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

    def train_graphed(tr, label, n_steps, expect=None, warmup=1, draws=True, frozen="llm."):
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
        hold_train_graph(tr, label, draws=draws, frozen=frozen)
        return p50_e, p50_g

    def hold_train_graph(tr, label, k=4, draws=True, frozen="llm."):
        """The parameters, the optimizer's state and the dropout generator
        snapshot in place; k graphed steps across an LR change (epoch 0's LR,
        then epoch 1's, under a two-epoch warmup set for the check: 0.5x,
        then 1x); the snapshot restored; k eager steps on the same batches.
        Bit-equal: the losses, every trainable parameter, the optimizer's
        state, the last gradients and the generator's state (advanced iff
        the model ``draws`` dropout masks); the launches a step; the frozen
        backbone (the state under ``frozen`` but its trainable parameters)
        unchanged (exact float64 sums); no new capture."""
        opt, gen = tr.optimizer, tr.dropout_generator
        epochs = itertools.chain.from_iterable(itertools.repeat(tr.train_pipeline))
        arrays = [tr.train_model_inputs(b) for b in itertools.islice(epochs, k)]
        trainable = {n for n, p in tr.model.named_parameters() if p.requires_grad}
        backbone = {n for n in tr.model.state_dict()
                    if n.startswith(frozen) and n not in trainable}
        frozen = {n: torch.sum(t, dtype=torch.float64)
                  for n, t in tr.model.state_dict().items() if n in backbone}
        n_captures = len(tr.train_graphs.capture_ms)
        snap = [t.clone() for t in train_state(opt)]
        gen_state, mini_step = gen.get_state(), opt.mini_step

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
            opt.mini_step = mini_step  # the accumulation window's host count
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
        advanced = not torch.equal(gen_state, eager[4])
        check(torch.equal(graphed[4], eager[4]) and advanced == draws,
              f"[{label}-train] the dropout generator's state after the graphed steps differs "
              f"from the eager steps', or advanced {advanced} where the model draws {draws}")
        moved = sum(not torch.equal(a, b) for a, b in zip(snap[:n_params], eager[2]))
        check(moved > 0, f"[{label}-train] no trainable parameter moved")
        check(all(torch.sum(t, dtype=torch.float64) == frozen[n]
                  for n, t in tr.model.state_dict().items() if n in backbone),
              f"[{label}-train] the backbone changed")
        check(len(tr.train_graphs.capture_ms) == n_captures,
              f"[{label}-train] the check captured anew")
        print(f"[{label}-train] {k} replays across an LR change ({eager[5]}) bit-equal to {k} "
              f"eager steps from the same state: losses {eager[0].tolist()}, {n_params} "
              f"trainable tensors ({moved} moved), {len(snap) - n_params} optimizer state "
              f"tensors, the gradients, the generator's state; launches a step "
              f"{eager[1][0]}; the backbone unchanged")

    def check_k4_shape(name, B, H, L, S, D, dtype, listed):
        """K4 through its JAX interface at one end-aligned causal shape against
        its plain version: f32 within 1e-5 x max(1, max |plain|), bf16 each
        query row within 2^-6 x its max; bound: the (query, key) pairs the mask
        keeps, QK^T and PV at 2 D operations each, at the operands' peak, or q,
        k, v read and the output written once; library: SDPA, masked alike."""
        q = torch.randn(B, H, L, D, device=dev, generator=g).to(dtype)
        kk, vv = (torch.randn(B, H, S, D, device=dev, generator=g).to(dtype) for _ in range(2))
        o = k4.flash_attention(q, kk, vv, True)
        o0 = k4.flash_attention_plain(q, kk, vv, True)
        err = (o.float() - o0.float()).abs().max().item()
        f32 = dtype == torch.float32
        mask = torch.ones(L, S, dtype=torch.bool, device=dev).tril(S - L)
        pairs = L * (S - L) + L * (L + 1) // 2
        esz = 4 if f32 else 2
        record(name, "medtsllm_tpu_torch/csrc/flash_attention.cu",
               "medtsllm_tpu/ops/pallas/flash_attention.py:196", err,
               1e-5 * max(1.0, o0.abs().max().item()) if f32 else None,
               cuda_ms(torch, lambda: k4.flash_attention(q, kk, vv, True)),
               cuda_ms(torch, lambda: k4.flash_attention_plain(q, kk, vv, True)),
               bound(esz * (2 * B * H * L * D + 2 * B * H * S * D), 4 * B * H * D * pairs,
                     "f32" if f32 else "bf16"),
               cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, kk, vv,
                                                                     attn_mask=mask)),
               f" (B={B} H=KV={H} L={L} S={S} D={D} {'f32' if f32 else 'bf16'} causal, "
               f"end-aligned; library = SDPA with the mask; {smi.splitlines()[0]})",
               listed=listed, share=None if f32 else row_share(o, o0))

    # K4's wide heads (JAX's gate sends every D % 64 == 0 to its kernel):
    # bf16 on the tensor cores in output-column passes, f32 on register
    # micro-tiles; printed, not listed: no backbone of the port's families
    # has such heads
    for D_w in (384, 512, 768):
        for dtype in (torch.float32, torch.bfloat16):
            kind = "f32" if dtype == torch.float32 else "bf16"
            check_k4_shape(f"flash_attention[D{D_w}-{kind}]", 8, 8, 512, 768, D_w, dtype,
                           False)

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

    # 6o. the baseline models: each shipped file that names DLinear,
    # PatchTST, TimesNet or FEDformer, as shipped (f32, its batch, history
    # and widths) on its family's stand-in (ETTh1, PSM, DREAMS, MSL: the
    # recordings are not in the repository), training.epochs cut to 1. Their
    # JAX counterparts are XLA ops, so no kernel of the port lies on their
    # path and none may launch. train() (captured steps, then val()),
    # train_graphed over 8 steps (every replay bit-equal to an eager step;
    # DLinear draws no dropout mask), serve() (every replay bit-equal, finite
    # scores), a summary line each; then configs/config.toml through the
    # train CLI and the test CLI on the card (their __main__ in this process:
    # 6l runs the CLIs as subprocesses), the scores equal
    t_phase = time.perf_counter()
    for label, toml in BASELINE_TOMLS.items():
        cfg = baseline_config(Config, toml)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what the earlier phases still hold
        t0 = time.perf_counter()
        tr = get_trainer(f"chip-smoke-{label}", cfg, device=dev)
        torch.cuda.synchronize()
        build_s, build_peak[label] = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        mc = cfg.models[cfg.model]
        version = f" {mc.version}" if cfg.model == "fedformer" else ""
        n_params = sum(p.numel() for p in tr.model.parameters())
        n_steps, bsz = len(tr.train_pipeline), cfg.training.batch_size
        print(f"[{label}] {toml.relative_to(ROOT)}: {cfg.model}{version}, {cfg.task}, "
              f"{cfg.data.dataset} stand-in ({tr.train_dataset.n_features} features, "
              f"{len(tr.train_dataset)} / {len(tr.val_dataset)} / {len(tr.test_dataset)} "
              f"windows), history {cfg.history_len}, batch {bsz}; {n_params:,} parameters at "
              f"f32, built in {build_s:.1f} s, peak {build_peak[label] / 2**30:.2f} GiB; cut: "
              f"training.epochs -> 1 ({n_steps} steps)")
        torch.cuda.reset_peak_memory_stats()
        counts, wall = drive(tr.train)
        train_peak = torch.cuda.max_memory_allocated()
        check(len(tr.losses) == n_steps and finite(tr.losses),
              f"[{label}] losses {tr.losses[:4]}...")
        check_scores(label, tr, tr.val_scores[0], "val")
        check(not any(counts.values()), f"[{label}] a kernel launched: {counts}")
        print(f"[{label}-train] train() {n_steps} captured steps and val() over "
              f"{len(tr.val_dataset)} windows in {wall:.2f} s wall; loss {tr.losses[0]:.6f} -> "
              f"{tr.losses[-1]:.6f}; val {tr.val_scores[0]}; peak {train_peak / 2**30:.2f} "
              f"GiB; train captures {tr.train_graphs.capture_ms} ms")
        p50_e, p50_g = train_graphed(tr, label, 8, draws=cfg.model != "dlinear")
        tr.step_graphs.clear()
        counts, _, scores, _ = serve(tr, label)
        check_scores(label, tr, scores, "test")
        check(not any(counts.values()), f"[{label}] a kernel launched in test(): {counts}")
        sv = serve_stats[label]
        print(f"[baselines] {label}: eval p50 eager {sv['p50']:.3f} ms, graphed "
              f"{sv['p50_graph']:.3f} ms (batch {bsz}); train p50 eager {p50_e:.3f} ms, graphed "
              f"{p50_g:.3f} ms; test() {sv['windows_s']:.1f} windows/s; peak GiB over the "
              f"{held / 2**30:.3f} earlier phases hold, build / train() / test(): "
              f"{(build_peak[label] - held) / 2**30:.3f} / {(train_peak - held) / 2**30:.3f} / "
              f"{(sv['peak'] - held) / 2**30:.3f}; {smi.splitlines()[0]}")
        del tr
        torch.cuda.empty_cache()
    from medtsllm_tpu_torch.config import dumps_toml, load_config
    runs = Path(tempfile.mkdtemp(prefix="chip-smoke-baselines-"))
    try:
        raw = load_config(BASELINE_TOMLS["config"]).to_dict()
        raw["training"]["epochs"] = 1
        raw["paths"] = {"logdir": str(runs)}
        cfg_path = runs / "config.toml"
        cfg_path.write_text(dumps_toml(raw))
        t0 = time.perf_counter()
        trained = cli_scores(run_main("train", str(cfg_path), "dlinear-cli"), "Test results:")
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = cli_scores(run_main("test", "dlinear-cli", "test", "latest", str(runs)),
                           "Results:")
        check(finite(trained.values()) and same_scores(trained, again),
              f"[baselines] configs/config.toml: the train CLI's test {trained}, the test "
              f"CLI's {again}")
        print(f"[baselines] configs/config.toml (training.epochs 1) through the train CLI's "
              f"__main__ (as python -m medtsllm_tpu_torch.train runs it, in this process): "
              f"{train_s:.1f} s wall, test {trained}; the test CLI's on its run directory: "
              f"{time.perf_counter() - t0:.1f} s wall, the same scores")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    print(f"[baselines] phase 6o: {time.perf_counter() - t_phase:.1f} s wall")

    # 6p. GPT4TS: the four shipped files that name it (bidmc-gpt4ts: BIDMC
    # forecasting over 256 + 64 tokens; dreams and ecgmit-anom: anomaly
    # detection over 128; ecgmit-seg: boundary segmentation over 256), as
    # shipped (f32, their batch, history and widths: gpt2 at d 768, 12 x 64
    # heads, 6 or 12 layers) on their families' stand-ins, training.epochs
    # cut to 1. JAX's attention dispatcher runs its plain attention below 512
    # tokens, so no kernel of the port lies on these paths and none may
    # launch. Each as 6o (train(), train_graphed over 8 steps with the
    # dropout generator advanced and the frozen gpt2 weights unchanged,
    # serve(), a summary line), then the device memory left after its del
    # and gc.collect(). Then what a trainer leaves on a capture stream of its
    # own (each StepGraphs' layout before the shared capture stream) against
    # the shared one. Then one eval of dreams.toml at history = pred_len =
    # 512, the variant JAX's gate sends to K4: K4 through its JAX interface
    # in every gpt2 layer, held at gpt2's shape and listed as
    # flash_attention[gpt2]
    from medtsllm_tpu_torch.runtime import graph as rgraph
    t_phase = time.perf_counter()

    def released(label, held):
        """Collect, then the device bytes held over ``held``, printed."""
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - held
        print(f"[{label}] after del and gc.collect(): {left:,} bytes ({left / 2**30:.4f} GiB) "
              "allocated over what was allocated before the build")
        return left

    for name, toml in GPT4TS_TOMLS.items():
        label = name if "gpt4ts" in name else f"gpt4ts-{name}"
        cfg = baseline_config(Config, toml)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = get_trainer(f"chip-smoke-{label}", cfg, device=dev)
        torch.cuda.synchronize()
        build_s, build_peak[label] = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        gcfg = tr.model.gpt2.cfg
        tokens = cfg.history_len + (cfg.pred_len if cfg.task == "forecasting" else 0)
        n_params = sum(p.numel() for p in tr.model.parameters())
        n_train = sum(p.numel() for p in tr.model.parameters() if p.requires_grad)
        n_steps, bsz = len(tr.train_pipeline), cfg.training.batch_size
        print(f"[{label}] {toml.relative_to(ROOT)}: gpt4ts over {cfg.models.gpt4ts.llm} "
              f"({gcfg.n_layers} layers, d {gcfg.d_model}, {gcfg.n_heads} x {gcfg.head_dim} "
              f"heads), {cfg.task}, {cfg.data.dataset} stand-in "
              f"({tr.train_dataset.n_features} features, {len(tr.train_dataset)} / "
              f"{len(tr.val_dataset)} / {len(tr.test_dataset)} windows), {tokens} tokens a "
              f"window, batch {bsz}; {n_params:,} parameters at f32, {n_train:,} trainable; "
              f"built in {build_s:.1f} s, peak {build_peak[label] / 2**30:.2f} GiB; cut: "
              f"training.epochs -> 1 ({n_steps} steps)")
        check(k4.attention_route(tokens, tokens, gcfg.head_dim, True) == "plain",
              f"[{label}] {tokens} tokens must take the plain attention")
        torch.cuda.reset_peak_memory_stats()
        counts, wall = drive(tr.train)
        train_peak = torch.cuda.max_memory_allocated()
        check(len(tr.losses) == n_steps and finite(tr.losses),
              f"[{label}] losses {tr.losses[:4]}...")
        check_scores(label, tr, tr.val_scores[0], "val")
        check(not any(counts.values()), f"[{label}] a kernel launched: {counts}")
        print(f"[{label}-train] train() {n_steps} captured steps and val() over "
              f"{len(tr.val_dataset)} windows in {wall:.2f} s wall; loss {tr.losses[0]:.6f} -> "
              f"{tr.losses[-1]:.6f}; val {tr.val_scores[0]}; peak {train_peak / 2**30:.2f} "
              f"GiB; train captures {tr.train_graphs.capture_ms} ms")
        p50_e, p50_g = train_graphed(tr, label, 8, frozen="gpt2.")
        tr.step_graphs.clear()
        counts, _, scores, _ = serve(tr, label)
        check_scores(label, tr, scores, "test")
        check(not any(counts.values()), f"[{label}] a kernel launched in test(): {counts}")
        sv = serve_stats[label]
        print(f"[gpt4ts] {name}: eval p50 eager {sv['p50']:.3f} ms, graphed "
              f"{sv['p50_graph']:.3f} ms (batch {bsz}); train p50 eager {p50_e:.3f} ms, graphed "
              f"{p50_g:.3f} ms; test() {sv['windows_s']:.1f} windows/s; peak GiB over the "
              f"{held / 2**30:.3f} earlier phases hold, build / train() / test(): "
              f"{(build_peak[label] - held) / 2**30:.3f} / {(train_peak - held) / 2**30:.3f} / "
              f"{(sv['peak'] - held) / 2**30:.3f}; {smi.splitlines()[0]}")
        del tr
        left = released(label, held)
        check(left <= 16 << 20, f"[{label}] the deleted trainer left {left:,} bytes")

    def leftover(label, stream):
        """What a dreams.toml trainer leaves after 3 captured train steps and
        2 captured eval steps, del and gc.collect(), capturing on ``stream``
        (None: the shared capture stream)."""
        index = dev.index
        shared = rgraph.capture_stream(dev)
        if stream is not None:
            rgraph._CAPTURE_STREAMS[index] = stream
        try:
            gc.collect()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            tr = get_trainer("chip-smoke-gpt4ts-release",
                             baseline_config(Config, GPT4TS_TOMLS["dreams"]), device=dev)
            for batch, _ in zip(tr.train_pipeline, range(3)):
                a = tr.train_model_inputs(batch)
                tr.train_step(a, a["valid"])
            for batch, _ in zip(tr.test_pipeline, range(2)):
                tr.eval_dispatch(batch)
            torch.cuda.synchronize()
            del tr, a
            return released(label, held)
        finally:
            rgraph._CAPTURE_STREAMS[index] = shared

    own = leftover("gpt4ts-own-stream", torch.cuda.Stream(dev))
    left = leftover("gpt4ts-shared-stream", None)
    check(left <= 16 << 20, f"[gpt4ts] a trainer on the shared capture stream left {left:,} bytes")
    print(f"[gpt4ts] device memory a deleted trainer leaves: {own / 2**30:.4f} GiB when it "
          f"captured on a stream of its own (cuBLAS's workspaces for that stream stay with "
          f"the process), {left / 2**30:.4f} GiB on the shared capture stream")

    # one eval of dreams.toml at 512 tokens: K4 in every layer, each batch
    raw = load_config(GPT4TS_TOMLS["dreams"]).to_dict()
    raw["history_len"] = raw["pred_len"] = 512
    raw["training"]["epochs"] = 1
    tr = get_trainer("chip-smoke-gpt4ts-dreams-512", quiet(Config, raw), device=dev)
    gcfg = tr.model.gpt2.cfg
    check(k4.attention_route(512, 512, gcfg.head_dim, True) == "k4",
          "512 tokens of gpt2 must take K4")
    counts, *_ = serve(tr, "gpt4ts-dreams-512")
    n_batches = len(tr.test_pipeline)
    check(counts["flash_attention"] == gcfg.n_layers * n_batches
          and sum(counts.values()) == counts["flash_attention"],
          f"[gpt4ts-dreams-512] K4 must run once a layer a batch and nothing else: {counts}")
    print(f"[gpt4ts-dreams-512] dreams.toml at history = pred_len = 512 (the variant JAX's gate sends "
          f"to K4; eval only): K4 {counts['flash_attention']} launches in test() "
          f"({gcfg.n_layers} layers x {n_batches} batch(es)); nothing else launched")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # K4 at gpt2's shape through its JAX interface: f32, causal, L = S = 512,
    # B 16, H = KV 12, D 64 (q, k, v from the split c_attn). f32 end to end:
    # summation order and the online softmax only, so 1e-5 x max(1, max
    # |plain|). Bound: the (query, key) pairs the causal mask keeps (QK^T and
    # PV, 4 x D operations each) at the f32 peak, or q, k and v read and the
    # output written once; library: SDPA, causal
    Bg, Hg, Lg, Dg = 16, gcfg.n_heads, 512, gcfg.head_dim
    q, kk, vv = (torch.randn(Bg, Hg, Lg, Dg, device=dev, generator=g) for _ in range(3))
    o = k4.flash_attention(q, kk, vv, True)
    o0 = k4.flash_attention_plain(q, kk, vv, True)
    err = (o - o0).abs().max().item()
    pairs = Lg * (Lg + 1) // 2
    record("flash_attention[gpt2]", "medtsllm_tpu_torch/csrc/flash_attention.cu",
           "medtsllm_tpu/ops/pallas/flash_attention.py:196", err,
           1e-5 * max(1.0, o0.abs().max().item()),
           cuda_ms(torch, lambda: k4.flash_attention(q, kk, vv, True)),
           cuda_ms(torch, lambda: k4.flash_attention_plain(q, kk, vv, True)),
           bound(4 * 4 * Bg * Hg * Lg * Dg, 4 * Bg * Hg * Dg * pairs, "f32"),
           cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, kk, vv, is_causal=True)),
           f" (B={Bg} H=KV={Hg} L=S={Lg} D={Dg} f32 causal, gpt2 at 512 tokens; library = "
           "SDPA, causal)")
    set_launches(counts, {"flash_attention[gpt2]": "flash_attention"})
    del q, kk, vv, o, o0
    print(f"[gpt4ts] phase 6p: {time.perf_counter() - t_phase:.1f} s wall")

    def ln_families():
        """Phases 6q-6s, their names kept out of main's scope (later phases
        read main's B, H, KV, D)."""
        # 6q-6s. MedTsLLM over the LayerNorm decoder families at their published
        # widths (12 layers, d 768, 12 x 64 heads, d_ff 3072): gpt2 (the JAX
        # package's default backbone, its preset), then opt-125m's and
        # pythia-160m's config.json read from a temporary snapshot directory
        # (weights seeded). Each: bidmc-like reconstruction at history 256, patch
        # 16 / 8, concat, batch 16, bf16, load_in_8bit (K1 on c_attn / q_proj,
        # k_proj, v_proj, the output projection, c_fc and the MLP's c_proj, the
        # bias added after K1's rescale), the prompt head cached; serve() (eager,
        # graphed, test()); the cached head against the head embedded in the step;
        # then a trainer with LoRA (rank 8, alpha 16, rslora on the q projection:
        # the q third of gpt2's c_attn) through train_graphed over 4 steps (K1's
        # straight-through dx under the adapters; replays bit-equal to the eager
        # steps; lora_b moved, every other llm. tensor unchanged); then a 2-layer
        # dense f32 slice at the full width with random adapters, card vs CPU.
        # gpt2 also holds K1 at its block (listed as w8a8_*[gpt2]) and the banked
        # step on a clip config (per-clip heads) against the embedded head.
        t_phase = time.perf_counter()
        snapdir = Path(tempfile.mkdtemp(prefix="chip-smoke-snapshots-"))
        families = (("gpt2", "gpt2"),
                    ("opt", write_snapshot(snapdir, "opt-125m", OPT_125M)),
                    ("neox", write_snapshot(snapdir, "pythia-160m", PYTHIA_160M)))
        widths = (12, 768, 12, 64, 3072)
        try:
            for label, llm in families:
                t_fam = time.perf_counter()
                tr = get_trainer(f"chip-smoke-{label}", family_config(Config, llm), device=dev)
                lc = tr.model.llm_cfg
                n_l, n_b = lc.n_layers, len(tr.test_pipeline)
                # K1 GEMMs a block: gpt2's fused c_attn, c_proj, c_fc, mlp.c_proj;
                # opt's and neox's q, k, v, o_proj and the MLP's two
                n_proj = 4 if label == "gpt2" else 6
                check((lc.n_layers, lc.d_model, lc.n_heads, lc.head_dim, lc.d_ff) == widths
                      and lc.style == label and tr.model.supports_prefix_cache,
                      f"[{label}] the backbone {lc}")
                head = tr.model_inputs(next(iter(tr.test_pipeline)))["prefix_ids"]
                check(len(head) > 1, f"[{label}] the prompt head is {len(head)} token(s): the "
                      f"tokenizer {type(tr.preprocessor.tokenizer).__name__} encodes no text")
                for batch in tr.test_pipeline:  # settle the prompt buckets (host only)
                    tr.model_inputs(batch)
                Pf, Lf = window_shapes(tr)
                Bf = tr.config.training.batch_size
                print(f"[shapes] {label}: {llm} -> style {lc.style}, {lc.n_layers} layers, d "
                      f"{lc.d_model}, {lc.n_heads} x {lc.head_dim} heads, d_ff {lc.d_ff}, vocab "
                      f"{lc.vocab_size}, act {lc.act_fn or 'gelu_tanh'}, rotary_dims "
                      f"{lc.rotary_dims if lc.style == 'neox' else 0}, learned positions "
                      f"{lc.learned_positions} (offset {lc.pos_offset}), parallel residual "
                      f"{lc.parallel_residual}, backbone dropout {lc.dropout}; tokenizer "
                      f"{type(tr.preprocessor.tokenizer).__name__}; P={Pf} L={Lf} B={Bf}; "
                      f"route {k4.attention_route(Lf, Pf + Lf, lc.head_dim, True)}")
                if label == "gpt2":
                    # the gpt2 block's K1: c_attn, attn.c_proj and c_fc quantize the
                    # bf16 LayerNorm / attention outputs at K = d, mlp.c_proj the bf16
                    # GELU output at K = d_ff; GEMMs d x 3d, d x d, d x d_ff, d_ff x d
                    d, f = lc.d_model, lc.d_ff
                    check_k1("[gpt2]", Bf * Lf, ((torch.bfloat16, d, 3), (torch.bfloat16, f, 1)),
                             ((d, 3 * d, 1), (d, d, 1), (d, f, 1), (f, d, 1)),
                             "4 GEMMs of the gpt2 block, the bias added after the rescale")
                counts, _, scores, _ = serve(tr, label)
                check_scores(label, tr, scores, "test")
                want = {"w8a8_gemm": n_proj * n_l * (n_b + 1),
                        "w8a8_quantize": n_proj * n_l * (n_b + 1),
                        "reprogramming_attention": n_b, "rope_attention": 0, "flash_attention": 0,
                        "rope_flash_attention": 0}
                check(all(counts[k] == n for k, n in want.items()),
                      f"[{label}] test() launches {counts}, not {want}")
                if label == "gpt2":
                    set_launches(counts, {"w8a8_quantize[gpt2]": "w8a8_quantize",
                                          "w8a8_gemm[gpt2]": "w8a8_gemm"})
                batch = next(iter(tr.test_pipeline))
                tr._prefix_kv_cache.clear()
                cached = tr.eval_step_eager(tr.eval_prepare(batch)[1]).float()
                embedded = tr.eval_step_eager(tr._to_device(tr.model_inputs(batch))).float()
                err = (cached - embedded).abs().max().item()
                tol = 2.0 ** -6 * embedded.abs().max().item()
                check(err <= tol, f"[{label}] cached vs head embedded: {err} > {tol}")
                print(f"[{label}] K1 {counts['w8a8_gemm']} GEMMs in test() ({n_proj} a block "
                      f"x {n_l} layers x ({n_b} batches + 1 prefill)), K3 "
                      f"{counts['reprogramming_attention']}, no attention kernel (plain "
                      f"attention below 512 tokens, JAX's gate); cached head vs head embedded: "
                      f"max_abs_err {err:.3e} (tol 2^-6 x max {tol:.3e}); {smi.splitlines()[0]}")
                del tr, cached, embedded
                torch.cuda.empty_cache()

                if label == "gpt2":
                    # the per-clip head rows through the bank: banked = embedded
                    ct = get_trainer("chip-smoke-gpt2-clips",
                                     family_config(Config, llm, n_points=12 * 512, n_clips=12),
                                     device=dev)
                    for batch in ct.test_pipeline:
                        ct.model_inputs(batch)
                    worst = 0.0
                    for i, batch in zip(range(2), ct.test_pipeline):
                        kind, arrays = ct.eval_prepare(batch)
                        check(kind == "banked", f"[gpt2-clips] a {kind} step on a clip dataset")
                        banked = ct.eval_step_eager(arrays).float()
                        embedded = ct.eval_step_eager(ct._to_device(ct.model_inputs(batch))).float()
                        err = (banked - embedded).abs().max().item()
                        tol = 2.0 ** -6 * embedded.abs().max().item()
                        check(err <= tol,
                              f"[gpt2-clips] batch {i}: banked vs embedded {err} > {tol}")
                        worst = max(worst, err / tol)
                    book = bank_book(ct)
                    print(f"[gpt2-clips] per-clip head rows (P "
                          f"{ct.model_inputs(batch)['prefix_ids'].shape[1]}) from the bank: "
                          f"{book['misses']} misses in 2 batches of "
                          f"{ct.config.training.batch_size}; "
                          f"banked vs head embedded within {worst:.4f} of 2^-6 x max")
                    del ct, banked, embedded
                    torch.cuda.empty_cache()

                # LoRA: 4 captured train steps through K1's straight-through dx
                lt = get_trainer(f"chip-smoke-{label}-lora", family_config(Config, llm, lora=True),
                                 device=dev)
                lora = {n: p.detach().clone() for n, p in lt.model.named_parameters()
                        if n.startswith("llm.") and p.requires_grad}
                check(lora and all(n.rsplit(".", 1)[1] in ("lora_a", "lora_b") for n in lora)
                      and len(lora) == 2 * n_l and not lt.model.train_prefix_cache_safe,
                      f"[{label}-lora] the trainable backbone tensors {sorted(lora)[:4]}")
                frozen = {n: torch.sum(t, dtype=torch.float64)
                          for n, t in lt.model.state_dict().items()
                          if n.startswith("llm.") and n not in lora}
                p50_e, p50_g = train_graphed(
                    lt, f"{label}-lora", 4, {"w8a8_gemm": n_proj * n_l,
                                             "w8a8_quantize": n_proj * n_l,
                                             "reprogramming_attention": 0, "flash_attention": 0,
                                             "rope_attention": 0})
                state = lt.model.state_dict()
                moved_b = sum(not torch.equal(state[n], t) for n, t in lora.items()
                              if n.endswith("lora_b"))
                check(moved_b == n_l, f"[{label}-lora] {moved_b} of {n_l} lora_b moved")
                check(all(torch.sum(state[n], dtype=torch.float64) == v for n, v in frozen.items()),
                      f"[{label}-lora] a backbone tensor other than the adapters changed")
                print(f"[{label}-lora] rank 8, alpha 16, rslora on "
                      f"{sorted(lora)[0].rsplit('.', 1)[0]} and the {n_l - 1} layers after: train "
                      f"step p50 eager {p50_e:.2f} ms, graphed "
                      f"{p50_g:.2f} ms (batch 16); every lora_b moved, every other llm. tensor "
                      f"unchanged; K1 {n_proj * n_l} GEMMs a step; {smi.splitlines()[0]}")
                del lt, lora, frozen, state
                torch.cuda.empty_cache()

                # a 2-layer dense f32 slice at the full width, random adapters
                small = family_config(Config, llm, batch=2, history=64, dtype="float32",
                                      n_points=256, num_tokens=128, d_ff=64, llm_layers=2,
                                      load_in_8bit=False, lora=True)
                gpu = get_trainer(f"chip-smoke-{label}-small", small, device=dev)
                with torch.no_grad():
                    for n, p in gpu.model.named_parameters():
                        if n.endswith("lora_b"):
                            p.normal_(0.0, 0.02, generator=g)
                cpu = get_trainer(f"chip-smoke-{label}-small", small, device="cpu")
                cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
                batch = next(iter(gpu.test_pipeline))
                out_gpu = gpu.eval_dispatch(batch).cpu()
                out_cpu = cpu.eval_dispatch(batch)
                err = (out_gpu - out_cpu).abs().max().item()
                tol = 1e-3 * max(1.0, out_cpu.abs().max().item())
                check(err <= tol, f"[{label}] small slice: card vs CPU max err {err} > {tol}")
                print(f"[reference] {label} 2-layer dense f32 slice at d {lc.d_model} with random "
                      f"adapters, card vs CPU: max_abs_err {err:.3e} (tol {tol:.3e}); "
                      f"{time.perf_counter() - t_fam:.1f} s for the family")
                del gpu, cpu
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(snapdir, ignore_errors=True)
        print(f"[families] phases 6q-6r: {time.perf_counter() - t_phase:.1f} s wall")

        # 6s. gpt2 at a long window: a clip dataset of one feature, the per-clip
        # head [bos + dataset + task + clip] in its 16-token bucket, the suffix
        # "Time series:" in its own, and the history chosen so that [prefix |
        # region] is 768 keys (gpt2 has 1024 positions): JAX's gate then sends the
        # end-aligned attention (L < S, S a multiple of 256, L a multiple of 8) to
        # K4 once a layer a batch. A one-layer build reads the buckets first. The
        # backbone is dense bf16: the banked step (the heads prefilled at 64
        # tokens, the plain attention) and the embedded one (768 tokens, K4) take
        # different attention kernels, and int8 projections would turn their
        # bf16 last-bit differences into rounding flips across 12 layers (a
        # w8a8 run read 1.49 x 2^-6 of the largest output); K1 is 6q's.
        t_phase = time.perf_counter()
        S_long = 768
        probe = get_trainer("chip-smoke-gpt2-long-probe", family_config(
            Config, "gpt2", batch=8, n_points=12 * 512, n_clips=12, n_features=1,
            input_stats=False, llm_layers=1, d_ff=32, load_in_8bit=False), device=dev)
        for batch in probe.test_pipeline:
            probe.model_inputs(batch)
        P_h, L_p = window_shapes(probe)
        suffix = L_p - probe.model.n_patches
        n_patches = S_long - P_h - suffix
        history = 8 * (n_patches - 2) + 16
        del probe
        tr = get_trainer("chip-smoke-gpt2-long", family_config(
            Config, "gpt2", batch=8, history=history, n_points=12 * 2 * history, n_clips=12,
            n_features=1, input_stats=False, d_ff=32, load_in_8bit=False), device=dev)
        for batch in tr.test_pipeline:
            tr.model_inputs(batch)
        P_l, L_l = window_shapes(tr)
        lc = tr.model.llm_cfg
        check(P_l + L_l == S_long and k4.attention_route(L_l, S_long, lc.head_dim, True) == "k4",
              f"[gpt2-long] P {P_l} + L {L_l} keys, route "
              f"{k4.attention_route(L_l, P_l + L_l, lc.head_dim, True)}")
        print(f"[shapes] gpt2-long: history {history}, {tr.model.n_patches} patches, per-clip head "
              f"P={P_l} (suffix {suffix}), L={L_l}, S={P_l + L_l}, B=8, 12 clips, d_ff 32, dense "
              "bf16")
        for keys in (256, 512, 768, 1000, 1024):
            print(f"[route] gpt2 (D 64), causal: L = S = {keys}: "
                  f"{k4.attention_route(keys, keys, 64, True)}; L = {keys - P_l}, S = {keys} "
                  f"(a {P_l}-token prefix): {k4.attention_route(keys - P_l, keys, 64, True)}")
        counts, *_ = serve(tr, "gpt2-long")
        n_b = len(tr.test_pipeline)
        check(counts["flash_attention"] == lc.n_layers * n_b and counts["rope_attention"] == 0
              and counts["reprogramming_attention"] == n_b,
              f"[gpt2-long] K4 once a layer a batch ({lc.n_layers} x {n_b}), K3 once a batch: "
              f"{counts}")
        print(f"[gpt2-long] K4 {counts['flash_attention']} launches in test() ({lc.n_layers} "
              f"layers x {n_b} batches; the prefills of the clip heads, {P_l} tokens, take the "
              f"plain attention), K3 {counts['reprogramming_attention']}; {smi.splitlines()[0]}")
        del tr
        torch.cuda.empty_cache()

        check_k4_shape("flash_attention[gpt2-prefix]", 8, lc.n_heads, L_l, P_l + L_l, lc.head_dim,
                       torch.bfloat16, True)
        set_launches(counts, {"flash_attention[gpt2-prefix]": "flash_attention"})
        # the wide heads K4 gained: pythia-1b's 256 (d 2048, 8 heads) and 192
        for D, H in ((192, 12), (256, 8)):
            for dtype in (torch.float32, torch.bfloat16):
                kind = "f32" if dtype == torch.float32 else "bf16"
                check_k4_shape(f"flash_attention[D{D}-{kind}]", 8, H, 512, 768, D, dtype, False)
        print(f"[gpt2-long] phase 6s: {time.perf_counter() - t_phase:.1f} s wall")
        return history

    gpt2_long_history = ln_families()

    def encdec_families():
        """Phases 6t-6u, their names kept out of main's scope."""
        from medtsllm_tpu_torch.models.llm.loader import hf_to_tree
        from medtsllm_tpu_torch.models.llm.safetensors import save_safetensors
        from medtsllm_tpu_torch.weights import from_flax
        # 6t-6u. MedTsLLM over the encoder-decoders at their published widths:
        # flan-t5-base's and bart-base's config.json with seeded weights in
        # HF's names, written by the port's safetensors writer (t5 in two
        # shards, bart under the "model." prefix) and loaded through the
        # trainer's snapshot path; bidmc.toml's settings (segmentation,
        # history 256, concat, d_ff 64, batch 16), w8a8 bf16: the prompt
        # through the encoder, the 32 patches through the decoder; every
        # loaded leaf held bit-equal to the written tensors; serve() over 32
        # test batches (K1 on every projection, the cross k / v at the
        # encoder's rows; K3); train() and train_graphed (K1's straight-through
        # dx); t5
        # at load_in_4bit (K1's quantizer and K5); bart again at history 4096
        # (512 patches: JAX's gate sends the decoder's causal self-attention,
        # L = S = 512, to K4); then 2-layer dense f32 slices, card vs CPU.
        t_phase = time.perf_counter()
        snapdir = Path(tempfile.mkdtemp(prefix="chip-smoke-encdec-"))
        head = smi.splitlines()[0]
        try:
            for label, fields, seed in (("t5", FLAN_T5_BASE, 1), ("bart", BART_BASE, 2)):
                t_fam = time.perf_counter()
                snap = Path(write_snapshot(snapdir, label, fields))
                hf = encdec_tensors(torch, dev, fields, seed)
                names = list(hf)
                shards = [names[:len(names) // 2], names[len(names) // 2:]] if label == "t5" \
                    else [names]
                for i, part in enumerate(shards):
                    save_safetensors(snap / f"model-{i:05d}-of-{len(shards):05d}.safetensors",
                                     {n: hf[n] for n in part})
                gib = sum(v.nbytes for v in hf.values()) / 2**30
                t0 = time.perf_counter()
                tr = get_trainer(f"chip-smoke-{label}", encdec_config(Config, str(snap)),
                                 device=dev)
                build_s = time.perf_counter() - t0
                lc = tr.model.llm_cfg
                n_enc, n_dec = lc.n_layers, lc.n_dec_layers or lc.n_layers
                check(lc.is_encoder_decoder and lc.style == label and lc.d_model == 768
                      and lc.head_dim == 64 and lc.n_heads == 12
                      and not tr.model.supports_prefix_cache
                      and isinstance(tr.model.llm, tfm.TransformerEncDec),
                      f"[{label}] the backbone {lc}")
                # every leaf the snapshot maps, bit-equal after load (the values
                # are bf16-exact; the projections quantized from the same f32)
                short = {n.removeprefix("model."): v for n, v in hf.items()}
                want = from_flax(hf_to_tree(lc, short, 8))
                state = tr.model.state_dict()
                bad = [n for n, v in want.items()
                       if not torch.equal(state[f"llm.{n}"].cpu(), v.to(state[f"llm.{n}"].dtype))]
                check(not bad and len(want) > 100, f"[{label}] leaves not bit-equal: {bad[:4]}")
                check(torch.equal(state["llm.wte"].float().cpu(),
                                  torch.from_numpy(short["shared.weight"])),
                      f"[{label}] the token table is not the snapshot's")
                first = tr.model_inputs(next(iter(tr.test_pipeline)))
                check("prefix_ids" not in first, f"[{label}] a cached prompt head: {list(first)}")
                for batch in tr.test_pipeline:  # settle the prompt buckets (host only)
                    tr.model_inputs(batch)
                P_enc = tr.model_inputs(next(iter(tr.test_pipeline)))["prompt_ids"].shape[1]
                Lp, Bt = tr.model.n_patches, tr.config.training.batch_size
                print(f"[shapes] {label}: {lc.style}, {n_enc} + {n_dec} layers, d "
                      f"{lc.d_model}, {lc.n_heads} x {lc.head_dim} heads, d_ff {lc.d_ff}, vocab "
                      f"{lc.vocab_size}, gated {lc.t5_gated}, post-LN {lc.post_ln}; snapshot "
                      f"{len(hf)} tensors, {gib:.3f} GiB f32 in {len(shards)} file(s); trainer "
                      f"built and the snapshot loaded in {build_s:.1f} s; encoder rows P={P_enc}, "
                      f"decoder rows L={Lp}, B={Bt}; every loaded leaf bit-equal")
                d, f = lc.d_model, lc.d_ff
                # a block's K1: the decoder's rows (self q, k, v, o; cross q, o;
                # the FFN's two or three) and the encoder's (its block's, plus a
                # decoder block's cross k, v); t5: wi_0, wi_1, wo; bart: fc1, fc2
                ffn = ((d, f, 2), (f, d, 1)) if label == "t5" else ((d, f, 1), (f, d, 1))
                n_ffn = sum(n for *_, n in ffn)
                per_batch = n_enc * (4 + n_ffn) + n_dec * (8 + n_ffn)
                if label == "t5":
                    check_k1("[t5]", Bt * Lp, ((torch.float32, d, 6), (torch.bfloat16, d, 2),
                                                (torch.bfloat16, f, 1)),
                             ((d, d, 6),) + ffn, "the decoder block's 9 GEMMs at B x L rows")
                    check_k1("[t5-enc]", Bt * P_enc,
                             ((torch.float32, d, 5 + 2), (torch.bfloat16, d, 1),
                              (torch.bfloat16, f, 1)),
                             ((d, d, 6),) + ffn, "an encoder block's 7 GEMMs and a decoder "
                             "block's cross k / v at B x P encoder rows")
                    mc = tr.config.models.timellm
                    check_k3("reprogramming_attention[t5]", Bt, Lp, mc.n_heads, mc.d_ff,
                             mc.num_tokens)
                counts, _, scores, _ = serve(tr, label)
                check_scores(label, tr, scores, "test")
                n_b = len(tr.test_pipeline)
                want = {"w8a8_gemm": per_batch * n_b, "w8a8_quantize": per_batch * n_b,
                        "reprogramming_attention": n_b, "rope_attention": 0,
                        "flash_attention": 0, "rope_flash_attention": 0}
                check(all(counts[k] == n for k, n in want.items()),
                      f"[{label}] test() launches {counts}, not {want}")
                if label == "t5":
                    dec_m = n_dec * (6 + n_ffn) * n_b
                    for entry in kernels:
                        entry["launches"] = {
                            "w8a8_quantize[t5]": dec_m, "w8a8_gemm[t5]": dec_m,
                            "w8a8_quantize[t5-enc]": counts["w8a8_gemm"] - dec_m,
                            "w8a8_gemm[t5-enc]": counts["w8a8_gemm"] - dec_m,
                            "reprogramming_attention[t5]": counts["reprogramming_attention"],
                        }.get(entry["name"], entry["launches"])
                # train(): an epoch of captured steps (K1 forward, its
                # straight-through dx), then val(); the backbone frozen
                trainable = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                             if p.requires_grad}
                frozen = {n: torch.sum(t, dtype=torch.float64)
                          for n, t in tr.model.state_dict().items() if n.startswith("llm.")}
                counts, wall = drive(tr.train)
                n_steps, n_val = len(tr.train_pipeline), len(tr.val_pipeline)
                check(len(tr.losses) == n_steps and finite(tr.losses),
                      f"[{label}] train() losses {tr.losses}")
                check_scores(label, tr, tr.val_scores[0], "val")
                check(counts["w8a8_gemm"] == per_batch * (n_steps + n_val)
                      and counts["reprogramming_attention"] == n_val,
                      f"[{label}] train(): K1 {per_batch} a step and a val batch, K3 a val "
                      f"batch: {counts}")
                state = tr.model.state_dict()
                check(all(not torch.equal(state[n], t) for n, t in trainable.items())
                      and all(torch.sum(state[n], dtype=torch.float64) == v
                              for n, v in frozen.items()),
                      f"[{label}] train() left a fusion layer unmoved or moved the backbone")
                print(f"[{label}-train] train() {n_steps} steps of {Bt} and val() over "
                      f"{n_val} batches in {wall:.2f} s wall; losses {tr.losses[0]:.6f} -> "
                      f"{tr.losses[-1]:.6f}; val {tr.val_scores[0]}; the fusion layers moved, the "
                      f"backbone unchanged; {head}")
                del trainable, frozen
                p50_e, p50_g = train_graphed(
                    tr, label, 4, {"w8a8_gemm": per_batch, "w8a8_quantize": per_batch,
                                   "reprogramming_attention": 0, "flash_attention": 0,
                                   "rope_attention": 0})
                st = serve_stats[label]
                print(f"[{label}] summary: eval p50 eager {st['p50']:.2f} / graphed "
                      f"{st['p50_graph']:.2f} ms a batch of {Bt}, test() {st['windows_s']:.2f} "
                      f"windows/s, peak {st['peak'] / 2**30:.2f} GiB; train step p50 eager "
                      f"{p50_e:.2f} / graphed {p50_g:.2f} ms; K1 {per_batch} GEMMs a batch "
                      f"({n_enc} encoder blocks x {4 + n_ffn} + {n_dec} decoder blocks x "
                      f"{8 + n_ffn}), K3 one; finite scores; {head}")
                del tr, state
                torch.cuda.empty_cache()

                if label == "t5":
                    # load_in_4bit (absmax): K1's quantizer and K5 on every projection
                    q4 = get_trainer("chip-smoke-t5-int4",
                                     encdec_config(Config, str(snap), quant_type="int4"),
                                     device=dev)
                    check_k5("[t5]", Bt * Lp, ((d, d, 6),) + ffn,
                             "the decoder block's 9 GEMMs at B x L rows")
                    counts, _, scores, _ = serve(q4, "t5-int4")
                    check_scores("t5-int4", q4, scores, "test")
                    n_b = len(q4.test_pipeline)
                    check(counts["w4a8_gemm"] == per_batch * n_b and counts["w8a8_gemm"] == 0
                          and counts["w8a8_quantize"] == per_batch * n_b,
                          f"[t5-int4] test() launches {counts}")
                    dec_m = n_dec * (6 + n_ffn) * n_b
                    set_launches({"w4a8_gemm": dec_m}, {"w4a8_gemm[t5]": "w4a8_gemm"})
                    print(f"[t5-int4] K5 {counts['w4a8_gemm']} GEMMs in test() ({per_batch} a "
                          f"batch), K1's quantizer {counts['w8a8_quantize']}, K1's GEMM none; "
                          f"{head}")
                    del q4
                    torch.cuda.empty_cache()
                else:
                    # bart at history 4096: 512 patches through the decoder, its causal
                    # self-attention (L = S = 512, D 64) on K4 once a layer a batch
                    lt = get_trainer("chip-smoke-bart-long",
                                     encdec_config(Config, str(snap), history=4096,
                                                   n_points=128 * 4096), device=dev)
                    for batch in lt.test_pipeline:
                        lt.model_inputs(batch)
                    Ll = lt.model.n_patches
                    P_l = lt.model_inputs(next(iter(lt.test_pipeline)))["prompt_ids"].shape[1]
                    route = k4.attention_route(Ll, Ll, 64, True)
                    check(Ll == 512 and route == "k4"
                          and k4.attention_route(Ll, P_l, 64, False) == "plain",
                          f"[bart-long] {Ll} patches, route {route}")
                    check_k4_shape("flash_attention[bart-decoder]", Bt, lc.n_heads, Ll, Ll, 64,
                                   torch.bfloat16, True)
                    counts, *_ = serve(lt, "bart-long")
                    n_b = len(lt.test_pipeline)
                    check(counts["flash_attention"] == n_dec * n_b
                          and counts["reprogramming_attention"] == n_b
                          and counts["w8a8_gemm"] == per_batch * n_b,
                          f"[bart-long] K4 once a decoder layer a batch ({n_dec} x {n_b}): "
                          f"{counts}")
                    set_launches(counts, {"flash_attention[bart-decoder]": "flash_attention"})
                    st = serve_stats["bart-long"]
                    print(f"[bart-long] history 4096: {Ll} patches (decoder L = S = {Ll}, K4), "
                          f"the prompt's {P_l} rows (plain attention), the cross-attention L "
                          f"{Ll} x S {P_l} (plain: S % 256 != 0); K4 {counts['flash_attention']} "
                          f"launches in test(); eval p50 eager {st['p50']:.2f} / graphed "
                          f"{st['p50_graph']:.2f} ms, {st['windows_s']:.2f} windows/s, peak "
                          f"{st['peak'] / 2**30:.2f} GiB; {head}")
                    del lt
                    torch.cuda.empty_cache()

                # a 2-layer dense f32 slice (2 + 2 layers) of the same snapshot,
                # card vs CPU
                small = encdec_config(Config, str(snap), history=64, n_points=256, batch=2,
                                      dtype="float32", load_in_8bit=False, llm_layers=2)
                gpu = get_trainer(f"chip-smoke-{label}-small", small, device=dev)
                cpu = get_trainer(f"chip-smoke-{label}-small", small, device="cpu")
                check(torch.equal(gpu.model.llm.wte.cpu(), cpu.model.llm.wte),
                      f"[{label}-small] card and CPU loaded different token tables")
                cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
                batch = next(iter(gpu.test_pipeline))
                out_gpu = gpu.eval_dispatch(batch).cpu()
                out_cpu = cpu.eval_dispatch(batch)
                err = (out_gpu - out_cpu).abs().max().item()
                tol = 1e-3 * max(1.0, out_cpu.abs().max().item())
                check(err <= tol, f"[{label}] small slice: card vs CPU max err {err} > {tol}")
                print(f"[reference] {label} 2 + 2-layer dense f32 slice of the snapshot, card "
                      f"vs CPU: max_abs_err {err:.3e} (tol {tol:.3e}); "
                      f"{time.perf_counter() - t_fam:.1f} s for the family")
                del gpu, cpu
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(snapdir, ignore_errors=True)
        print(f"[encdec] phases 6t-6u: {time.perf_counter() - t_phase:.1f} s wall")

    encdec_families()

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

    # 6l. the run lifecycle at full width (4 layers), its run directories under a
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

    # 8b. MoE training: configs/ablation/moe-backbone.toml as shipped
    # (moe-8x1b: 22 blocks, 8 experts top-2, d_ff 5632; w8a8, bf16, batch 48,
    # expert_capacity 1.25, its cached head) on the ventilator stand-in,
    # training.epochs cut to 1. The train step takes the capacity path, as
    # JAX's does when not deterministic: a block runs K1 on its four
    # attention projections and, for each of gate, up and down, K1's
    # quantizer once over the E x C dispatch rows and its GEMM per expert,
    # their straight-through backward a bf16 bmm; K2 once (the cached head
    # as prefix, the reference-graph backward). val() and test() serve
    # through K6 and K3. train() through the captured steps, train_graphed
    # over 8 steps (replays bit-equal, the launches of one replay), serve();
    # then K1's GEMM at the capacity shape (C slots an expert), listed as
    # w8a8_gemm[moe-train]
    t_phase = time.perf_counter()
    tr = get_trainer("chip-smoke-moe-train", shipped_config(Config, MOE_TOML), device=dev)
    xl = tr.model.llm_cfg
    n_layers, E_x, k_x = xl.n_layers, xl.n_experts, xl.n_experts_per_tok
    P_t, L_t = window_shapes(tr)
    bsz = tr.config.training.batch_size
    C_t = tfm.moe_capacity(bsz * L_t, E_x, k_x, xl.expert_capacity)
    n_steps = len(tr.train_pipeline)
    print(f"[moe-train] {MOE_TOML.relative_to(ROOT)}: {xl.n_layers} blocks, {E_x} experts "
          f"top-{k_x}, d {xl.d_model}, d_ff {xl.d_ff}, w8a8 bf16; ventilator stand-in "
          f"({len(tr.train_dataset)} / {len(tr.val_dataset)} / {len(tr.test_dataset)} "
          f"windows), batch {bsz}, head P={P_t}, region L={L_t}: T={bsz * L_t} tokens, "
          f"capacity {xl.expert_capacity} -> C={C_t} slots an expert; cut: training.epochs "
          f"-> 1 ({n_steps} steps)")
    trainable = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                 if p.requires_grad}
    check(trainable and not any(n.startswith("llm.") for n in trainable),
          "[moe-train] the backbone must be frozen")
    torch.cuda.reset_peak_memory_stats()
    counts, wall = drive(tr.train)
    train_peak = torch.cuda.max_memory_allocated()
    check(len(tr.losses) == n_steps and finite(tr.losses), f"[moe-train] losses {tr.losses}")
    check_scores("moe-train", tr, tr.val_scores[0], "val")
    state = tr.model.state_dict()
    unchanged = [n for n, t in trainable.items() if torch.equal(state[n], t)]
    check(len(unchanged) <= 1, f"[moe-train] trainable parameters unmoved: {unchanged}")
    for name in ("w8a8_quantize", "w8a8_gemm", "rope_attention", "grouped_matmul_gate_up",
                 "grouped_matmul_down", "reprogramming_attention"):
        check(counts[name] > 0, f"[moe-train] {name} not launched in train(): {counts}")
    print(f"[moe-train] train() {n_steps} captured steps of {bsz} and val() over "
          f"{len(tr.val_dataset)} windows in {wall:.2f} s wall; losses {tr.losses}; val "
          f"{tr.val_scores[0]}; peak {train_peak / 2**30:.2f} GiB; train captures "
          f"{tr.train_graphs.capture_ms} ms; launches {counts}")
    train_counts = counts
    del trainable, state
    # a step: per block 4 + 3 quantizer calls, 4 + 3 x E GEMMs, one K2; no
    # K6 (the capacity path) and no K3 (training runs the einsum graph)
    per_step = {"w8a8_quantize": 7 * n_layers, "w8a8_gemm": (4 + 3 * E_x) * n_layers,
                "rope_attention": n_layers, "grouped_matmul_gate_up": 0,
                "grouped_matmul_down": 0, "reprogramming_attention": 0}
    train_graphed(tr, "moe", 8, per_step)
    tr.step_graphs.clear()
    counts, _, scores, _ = serve(tr, "moe-train")
    check_scores("moe-train", tr, scores, "test")
    check(counts["grouped_matmul_gate_up"] > 0 and counts["reprogramming_attention"] > 0,
          f"[moe-train] test() must serve through K6 and K3: {counts}")
    del tr
    torch.cuda.empty_cache()
    # K1's GEMM per expert at the capacity shape: gate and up (d x d_ff),
    # then down (d_ff x d), f32 out as act_quant_bmm writes it; bit-equal
    check_k1_gemm("[moe-train]", C_t, ((xl.d_model, xl.d_ff, 2), (xl.d_ff, xl.d_model, 1)),
                  f"per expert per block at the train step's C={C_t} slots: gate and up, "
                  f"then down; {E_x} experts x {n_layers} blocks a step", torch.float32)
    set_launches(train_counts, {"w8a8_gemm[moe-train]": "w8a8_gemm"})
    print(f"[moe-train] phase 8b: {time.perf_counter() - t_phase:.1f} s wall")

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

    # 9b. the 7B w8a8 finetune with llm.int8_backward and grad_accum_steps 2:
    # n_points 4000 gives four shuffled micro-batches of 8, two windows
    t_phase = time.perf_counter()
    tr = get_trainer("chip-smoke-int8bwd", derived_config(
        Config, bench_config(Config, n_points=4000), training={"grad_accum_steps": 2},
        llm={"int8_backward": True}), device=dev)
    projs = [m for m in tr.model.llm.modules() if isinstance(m, tfm.QuantLinear)]
    check(len(projs) == 7 * n_block and all(m.act_quant == "int8_bwd" for m in projs),
          "int8_backward must reach every projection")

    def fusion(tr):
        return {n: p.detach().clone() for n, p in tr.model.named_parameters()
                if p.requires_grad}

    def backbone_sums(tr):  # exact float64 sums of every llm. tensor
        return {n: torch.sum(t, dtype=torch.float64)
                for n, t in tr.model.state_dict().items() if n.startswith("llm.")}
    start_w, frozen = fusion(tr), backbone_sums(tr)
    torch.cuda.reset_peak_memory_stats()
    counts, wall = drive(tr.train)
    peak_train = torch.cuda.max_memory_allocated()
    n_micro, per = len(tr.train_pipeline), 7 * n_block
    dx_launches = counts["w8a8_gemm"] - counts["w8a8_quantize"]
    kn_gib = sum(m.kn_copy.numel() for m in projs) / 2**30
    print(f"[int8bwd-train] train() {n_micro} micro-batches of {B} (grad_accum_steps 2) and "
          f"val() in {wall:.2f} s wall; losses {tr.losses}; launches {counts}; the [K, N] "
          f"copies {kn_gib:.3f} GiB; peak {peak_train / 2**30:.2f} GiB ({smi})")
    check(n_micro == 4 and tr.optimizer.mini_step == 0 and finite(tr.losses),
          f"{n_micro} micro-batches, mini_step {tr.optimizer.mini_step}, losses {tr.losses}")
    check(counts["w8a8_quantize_grad"] == per * n_micro and dx_launches == per * n_micro,
          f"the int8 dx must launch {per} x {n_micro}: {counts}")
    state = fusion(tr)
    check(all(not torch.equal(state[n], t) for n, t in start_w.items()
              if n.startswith(("mapping_layer", "output_projection"))),
          "the fusion layers did not move")
    check(backbone_sums(tr) == frozen, "the backbone changed")
    # a captured odd micro-step moves nothing, the even one applies the mean
    a_odd, a_even = (tr.train_model_inputs(b) for b in itertools.islice(tr.train_pipeline, 2))
    before = fusion(tr)
    tr.train_step(a_odd, a_odd["valid"])
    check(all(torch.equal(t, before[n]) for n, t in fusion(tr).items()),
          "an accumulate-only micro-step moved a parameter")
    tr.train_step(a_even, a_even["valid"])
    check(any(not torch.equal(t, before[n]) for n, t in fusion(tr).items()),
          "the window's last micro-step moved nothing")
    train_graphed(tr, "int8bwd", 8, {"w8a8_quantize_grad": per, "w8a8_quantize": per,
                                     "w8a8_gemm": 2 * per, "rope_attention": n_block})
    check(backbone_sums(tr) == frozen and len(tr.train_graphs) >= 2,
          f"the backbone changed, or {len(tr.train_graphs)} train graphs (one a phase)")
    # the dx at one 7B block's shapes (M = B x the 112-token region), on the
    # trained model's block-0 weights: q, k, v, o (K 4096, N 4096), gate, up
    # (K 4096, N 11008), down (K 11008, N 4096); g at bf16, as the mixed step's
    M9 = B * L
    blk = tr.model.llm.blocks[0]
    layer_ws = [blk.attn.q_proj, blk.attn.k_proj, blk.attn.v_proj, blk.attn.o_proj,
                blk.mlp.gate_proj, blk.mlp.up_proj, blk.mlp.down_proj]
    q_ms = q_dev = q_plain = q_bytes = 0.0
    g_ms = g_plain = g_lib = g_bytes = g_ops = 0.0
    cos_min = 1.0
    for m in layer_ws:
        N9, K9 = m.weight_q.shape
        gr = torch.randn(M9, N9, device=dev, generator=g).to(torch.bfloat16)
        sc, kn = m.scale.float(), m.weight_kn()
        gq, gs = k1.quantize_grad_rows(gr, sc, kn.shape[1])
        gq0, gs0 = k1.quantize_grad_rows_plain(gr, sc, kn.shape[1])
        check(torch.equal(gq, gq0) and torch.equal(gs, gs0),
              f"the gradient rows' quantizer not bit-equal at [{M9}, {N9}]")
        dx = k1.int8_dx(gr, kn, sc, torch.bfloat16)
        dx0 = k1.int8_gemm_plain(gq0, kn, gs0, torch.ones(K9, device=dev), torch.bfloat16)
        check(torch.equal(dx, dx0), f"the int8 dx not bit-equal at [{M9}, {K9}, {N9}]")
        ste = (gr.float() * sc) @ m.weight_q.float()
        d32 = k1.int8_dx(gr, kn, sc).double().flatten()
        cos_min = min(cos_min, float(d32 @ ste.double().flatten()
                                     / (d32.norm() * ste.double().norm())))
        ones = torch.ones(K9, device=dev)
        q_ms += cuda_ms(torch, lambda: k1.quantize_grad_rows(gr, sc, kn.shape[1]))
        # device time: the calls queued behind a sleeping kernel (check_k1's)
        q_dev += queued_ms(torch, lambda: k1.quantize_grad_rows(gr, sc, kn.shape[1]))
        q_plain += cuda_ms(torch, lambda: k1.quantize_grad_rows_plain(gr, sc, kn.shape[1]))
        q_bytes += M9 * N9 * 2 + N9 * 4 + M9 * kn.shape[1] + M9 * 4
        g_ms += cuda_ms(torch, lambda: k1.int8_gemm(gq, kn, gs, ones, torch.bfloat16))
        g_plain += cuda_ms(torch, lambda: k1.int8_gemm_plain(gq, kn, gs, ones,
                                                              torch.bfloat16), iters=3)
        g_lib += cuda_ms(torch, lambda: (torch._int_mm(gq, kn.T).float()
                                         * gs[:, None]).to(torch.bfloat16))
        g_bytes += M9 * kn.shape[1] + K9 * kn.shape[1] + M9 * 4 + K9 * 4 + M9 * K9 * 2
        g_ops += 2 * M9 * K9 * kn.shape[1]
    check(cos_min > 0.999, f"cos(int8 dx, straight-through dx) {cos_min} <= 0.999")
    record("w8a8_quantize_grad", "medtsllm_tpu_torch/csrc/w8a8.cu",
           "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", 0.0, 0.0, q_ms, q_plain,
           bound(q_bytes, 0, "int8"), None,
           f" (per decoder block, 7 calls at M={M9}, g bf16; codes and scales bit-equal; "
           f"device time, queued: {q_dev:.4f} ms)")
    record("w8a8_gemm[dx]", "medtsllm_tpu_torch/csrc/w8a8.cu",
           "medtsllm_tpu/ops/pallas/smallm_matmul.py:56", 0.0, 0.0, g_ms, g_plain,
           bound(g_bytes, g_ops, "int8"), g_lib,
           f" (per decoder block, the 7 dx GEMMs at M={M9} on the [K, N] copies, bf16 out; "
           f"bit-equal; cos with the straight-through dx >= {cos_min:.6f}; library = "
           "torch._int_mm + the row rescale)")
    set_launches(counts, {"w8a8_quantize_grad": "w8a8_quantize_grad"})
    next(e for e in kernels if e["name"] == "w8a8_gemm[dx]")["launches"] = dx_launches
    del tr, projs, layer_ws, blk, gr, gq, gq0, dx, dx0, ste, d32, kn
    torch.cuda.empty_cache()
    # the batched dh at one moe-8x1b layer: E 8 experts, C 2160 slots
    E9, C9, K9, N9 = 8, 2160, 2048, 5632
    gr = torch.randn(E9, C9, N9, device=dev, generator=g)
    wq = torch.randint(-127, 128, (E9, N9, K9), device=dev, dtype=torch.int8, generator=g)
    sc = torch.rand(E9, N9, device=dev, generator=g) * 1e-2
    kn = k1.kn_weight(wq)
    dh = tfm.int8_dh(gr, kn, sc)
    gq0, gs0 = k1.quantize_grad_rows_plain(gr.reshape(E9 * C9, N9), sc, N9)
    gq0, gs0 = gq0.reshape(E9, C9, N9), gs0.reshape(E9, C9)
    ones = torch.ones(K9, device=dev)
    check(all(torch.equal(dh[e], k1.int8_gemm_plain(gq0[e], kn[e], gs0[e], ones))
              for e in range(E9)), "the batched int8 dh is not bit-equal")
    dh_ms = cuda_ms(torch, lambda: tfm.int8_dh(gr, kn, sc), iters=5)
    print(f"[int8bwd] the batched dh at one moe-8x1b layer (E {E9}, C {C9}, K {K9}, N {N9}): "
          f"bit-equal to its plain version, {dh_ms:.4f} ms; phase 9b "
          f"{time.perf_counter() - t_phase:.1f} s wall ({smi})")
    del gr, wq, sc, kn, dh, gq0, gs0
    torch.cuda.empty_cache()

    # 9c. QLoRA on the 7B: load_in_4bit (absmax int4), LoRA rank 8, alpha 16,
    # rslora on q and v, ranger21, batch 8, four captured steps
    t_phase = time.perf_counter()
    tr = get_trainer("chip-smoke-qlora", derived_config(
        Config, bench_config(Config, quant_type="int4", n_points=4000),
        training={"optimizer": "ranger21"}, lora=LORA), device=dev)
    q_proj = tr.model.llm.blocks[0].attn.q_proj
    check(isinstance(q_proj, tfm.LoRALinear) and q_proj.base.bits == 4,
          f"QLoRA's q_proj {type(q_proj).__name__}")
    lora_b = {n: p for n, p in tr.model.named_parameters() if n.endswith("lora_b")}
    check(len(lora_b) == 2 * n_block, f"{len(lora_b)} lora_b tensors")
    torch.cuda.reset_peak_memory_stats()
    train_graphed(tr, "qlora", 4, {"w4a8_gemm": per, "w8a8_quantize": per,
                                   "w8a8_gemm": 0, "rope_attention": n_block})
    check(all(p.detach().abs().max().item() > 0 for p in lora_b.values()),
          "a lora_b did not move")
    print(f"[qlora] ranger21 over the fusion layers and {len(lora_b)} adapter pairs: "
          f"every lora_b moved; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"phase 9c {time.perf_counter() - t_phase:.1f} s wall ({smi})")
    del tr, q_proj, lora_b
    torch.cuda.empty_cache()
    # nf4 at 2 layers with LoRA: one f32 train step, card vs CPU (the table
    # dequant and the f32 matmul on both: summation order only, 1e-3 of each
    # gradient's largest element, as phase 10)
    small = derived_config(Config, bench_config(
        Config, llm="llama-1b", batch=2, history=64, dtype="float32", n_points=256,
        num_tokens=128, d_ff=64, llm_layers=2, quant_type="nf4", dropout=0.0), lora=LORA)
    gpu = get_trainer("chip-smoke-nf4-train", small, device=dev)
    cpu = get_trainer("chip-smoke-nf4-train", small, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
    with torch.no_grad():  # adapters away from their zero init on both sides
        for (n, pg), pc in zip(gpu.model.named_parameters(), cpu.model.parameters()):
            if n.endswith("lora_b"):
                pc.copy_(torch.randn(pc.shape) * 0.01)
                pg.copy_(pc)
    batch = next(iter(gpu.train_pipeline))
    ag, ac = gpu.train_model_inputs(batch), cpu.train_model_inputs(batch)
    lg, lc = float(gpu.train_step(ag, ag["valid"])), float(cpu.train_step(ac, ac["valid"]))
    # (the reprogramming key bias's exact gradient is 0: noise on both sides,
    # left out as in phase 10)
    worst = max((p.grad.cpu() - q.grad).abs().max().item()
                / max(q.grad.abs().max().item(), 1e-30)
                for (n, p), q in zip(gpu.model.named_parameters(), cpu.model.parameters())
                if p.requires_grad and not n.endswith("key_projection.bias"))
    check(abs(lg - lc) <= 1e-5 * abs(lc) and worst <= 1e-3,
          f"nf4 LoRA slice: loss card {lg} CPU {lc}, worst gradient {worst}")
    print(f"[qlora-nf4] llama-1b 2-layer nf4 f32 with LoRA, one train step card vs CPU: "
          f"loss {lg:.6f} vs {lc:.6f}, worst gradient {worst:.3e} of its largest element")
    del gpu, cpu
    torch.cuda.empty_cache()

    # 9d. remat at full width: gpt2 (12 layers, d 768, dropout 0.1) w8a8 bf16
    # at batch 16 with LoRA (its head embedded: the decoder's forward has no
    # prefix, so remat applies), three captured steps under each setting
    t_phase = time.perf_counter()
    runs = {}
    for remat in (False, "full", "dots"):
        tr = get_trainer(f"chip-smoke-remat-{remat}", derived_config(
            Config, family_config(Config, "gpt2", lora=True), llm={"remat": remat}),
            device=dev)
        check(tr.model.llm.remat == remat and tr.model.llm.cfg.dropout == 0.1
              and not tr.model.train_prefix_cache_safe, f"remat {remat}: {tr.model.llm_cfg}")
        arrays = [tr.train_model_inputs(b) for b in itertools.islice(tr.train_pipeline, 3)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = [counted(lambda: tr.train_step(a, a["valid"])) for a in arrays]
        peak = torch.cuda.max_memory_allocated() - resident  # the steps' own
        adapters = {n: (p.detach().clone(), p.grad.clone())
                    for n, p in tr.model.named_parameters() if "lora_" in n}
        runs[remat] = (torch.stack([o[0] for o in out]), adapters, out[-1][1], peak)
        del tr, arrays, out
        torch.cuda.empty_cache()
    base = runs[False]
    for remat, (losses, adapters, c, peak) in runs.items():
        check(torch.equal(losses, base[0]), f"remat {remat}: losses {losses} vs {base[0]}")
        check(all(torch.equal(a, base[1][n][0]) and torch.equal(gr, base[1][n][1])
                  for n, (a, gr) in adapters.items()), f"remat {remat}: the adapters differ")
    n_gpt2 = 4 * 12  # c_attn, c_proj, c_fc, mlp.c_proj in 12 blocks
    want = {False: n_gpt2, "full": 2 * n_gpt2, "dots": n_gpt2}
    check(all(runs[r][2]["w8a8_gemm"] == n for r, n in want.items()),
          f"K1 GEMM launches a step: {({r: v[2]['w8a8_gemm'] for r, v in runs.items()})}")
    print("[remat-gpt2] three captured steps bit-equal under remat false / full / dots "
          f"(losses {base[0].tolist()}, the adapters and their gradients); K1 GEMM launches "
          "a step " + ", ".join(f"{r}: {v[2]['w8a8_gemm']}" for r, v in runs.items())
          + "; the steps' peak above what was resident before them "
          + ", ".join(f"{r}: {v[3] / 2**30:.3f} GiB" for r, v in runs.items())
          + f" ({smi})")
    del runs, base
    # mamba-130m, the prompt head embedded (no prefix state: remat applies)
    grads = {}
    for remat in (False, True):
        tr = get_trainer(f"chip-smoke-mamba-remat-{remat}", mamba_config(
            Config, n_points=24704, prefix_cache=False, model={"llm": {"remat": remat}}),
            device=dev)
        arrays = [tr.train_model_inputs(b) for b in itertools.islice(tr.train_pipeline, 2)]
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = [counted(lambda: tr.train_step_eager(a, a["valid"])) for a in arrays]
        grads[remat] = ([o[0] for o in out], {n: p.grad.clone() for n, p in
                                              tr.model.named_parameters() if p.requires_grad},
                        out[-1][1], torch.cuda.max_memory_allocated() - resident)
        del tr, arrays, out
        torch.cuda.empty_cache()
    (l0, g0, c0, p0), (l1, g1, c1, p1) = grads[False], grads[True]
    n_l = 24
    check(all(torch.equal(a, b) for a, b in zip(l0, l1))
          and all(torch.equal(g0[n], g1[n]) for n in g0), "mamba remat: gradients differ")
    check(c0["selective_scan_bounds"] == n_l and c1["selective_scan_bounds"] == 2 * n_l
          and c0["selective_scan_bwd"] == c1["selective_scan_bwd"] == n_l,
          f"mamba remat: K9 / K10 launches {c0} / {c1}")
    print(f"[remat-mamba] two steps bit-equal with and without remat; K9 launches a step "
          f"{c0['selective_scan_bounds']} -> {c1['selective_scan_bounds']} (the recompute), "
          f"K10 {c1['selective_scan_bwd']}; the steps' peak above what was resident "
          f"{p0 / 2**30:.3f} -> {p1 / 2**30:.3f} GiB")
    del grads, g0, g1
    # one ranger_classic step on the gpt2 model
    tr = get_trainer("chip-smoke-ranger-classic", derived_config(
        Config, family_config(Config, "gpt2", lora=True),
        training={"optimizer": "ranger_classic"}), device=dev)
    a = tr.train_model_inputs(next(iter(tr.train_pipeline)))
    before = fusion(tr)
    loss = float(tr.train_step(a, a["valid"]))
    moved = [n for n, t in fusion(tr).items() if not torch.equal(t, before[n])]
    check(math.isfinite(loss) and any("lora_b" in n for n in moved),
          f"ranger_classic: loss {loss}, moved {moved}")
    print(f"[ranger-classic] one step on gpt2 with LoRA: loss {loss:.6f}, {len(moved)} "
          f"tensors moved; phase 9d {time.perf_counter() - t_phase:.1f} s wall ({smi})")
    del tr, a, before
    torch.cuda.empty_cache()

    # 6v. quantized Mamba: configs/ablation/mamba-backbone.toml (mamba-130m,
    # all 24 layers, B 48, bf16) under load_in_8bit, then load_in_4bit with
    # quant_type int4 and nf4 (n_points 24704: four train batches, 192 test
    # windows): in_proj, x_proj and out_proj quantized (K1; K1's quantizer and
    # K5 at absmax int4; the nf4 table dequant and a bf16 matmul), dt_proj
    # dense. Each through serve() and train_graphed over 4 steps; K1 / K5 held
    # bit-equal at the three projections' shapes (x_proj N 80: under one
    # 256-column tile); a 2-layer w8a8 f32 slice card vs CPU
    t_phase = time.perf_counter()
    d_m, E_m, R_m = scfg.d_model, scfg.d_inner, scfg.rank
    n_xp = R_m + 2 * Nm  # x_proj's columns: dt rank 48 + B 16 + C 16
    M_m = Bm * Lm
    mamba_gemms = {"in_proj": (d_m, 2 * E_m), "x_proj": (E_m, n_xp), "out_proj": (E_m, d_m)}
    # the quantizer: in_proj reads the f32 normed residual, x_proj the bf16
    # conv output, out_proj the bf16 gated scan output
    check_k1("[mamba-130m]", M_m, ((torch.float32, d_m, 1), (torch.bfloat16, E_m, 2)), (),
             "3 projections")
    for name, (K_, N_) in mamba_gemms.items():
        check_k1_gemm(f"[mamba-{name}]", M_m, ((K_, N_, 1),),
                      f"mamba-130m {name}, one a block, M {M_m}")
        check_k5(f"[mamba-{name}]", M_m, ((K_, N_, 1),), f"mamba-130m {name}, M {M_m}")
    mamba_quant = {"q8": {"load_in_8bit": True},
                   "int4": {"load_in_4bit": True, "quant_type": "int4"},
                   "nf4": {"load_in_4bit": True, "quant_type": "nf4"}}
    m_layers = scfg.n_layers
    per_step = {"selective_scan_bounds": m_layers, "selective_scan_bwd": m_layers}
    for label, llm_kw in mamba_quant.items():
        t0 = time.perf_counter()
        tr = get_trainer(f"chip-smoke-mamba-{label}", mamba_config(
            Config, n_points=24704, epochs=1, model={"llm": llm_kw}), device=dev)
        block = tr.model.llm.blocks[0]
        bits = 8 if label == "q8" else 4
        check(all(getattr(block, n).bits == bits for n in mamba_gemms)
              and isinstance(block.dt_proj, tfm.Linear)
              and block.x_proj.codebook == ("nf4" if label == "nf4" else "absmax"),
              f"[mamba-{label}] the projections: {block}")
        print(f"[mamba-{label}] build {time.perf_counter() - t0:.2f} s; x_proj "
              f"{tuple(block.x_proj.weight_q.shape)} int8 storage")
        counts, *_ = serve(tr, f"mamba-{label}")
        n_gemm = m_layers * 3 * (len(tr.test_pipeline) + 1)  # the batches and the prefill
        want = {"q8": {"w8a8_quantize": n_gemm, "w8a8_gemm": n_gemm, "w4a8_gemm": 0},
                "int4": {"w8a8_quantize": n_gemm, "w8a8_gemm": 0, "w4a8_gemm": n_gemm},
                "nf4": {"w8a8_quantize": 0, "w8a8_gemm": 0, "w4a8_gemm": 0}}[label]
        check(all(counts[k] == n for k, n in want.items())
              and counts["selective_scan_h0"] == m_layers * len(tr.test_pipeline),
              f"[mamba-{label}] test() launches {counts}, want {want}")
        if label == "q8":  # each projection one GEMM of the three a block
            set_launches(counts, {"w8a8_quantize[mamba-130m]": "w8a8_quantize"})
            set_launches(counts, {f"w8a8_gemm[mamba-{n}]": "w8a8_gemm" for n in mamba_gemms},
                         share=3)
        elif label == "int4":
            set_launches(counts, {f"w4a8_gemm[mamba-{n}]": "w4a8_gemm" for n in mamba_gemms},
                         share=3)
        train_graphed(tr, f"mamba-{label}", 4, per_step)
        del tr
        torch.cuda.empty_cache()
    small = mamba_config(Config, n_points=512, batch=2, history=64, dtype="float32",
                         llm_layers=2, model={"llm": {"load_in_8bit": True}})
    gpu = get_trainer("chip-smoke-mamba-q8-small", small, device=dev)
    cpu = get_trainer("chip-smoke-mamba-q8-small", small, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.model.state_dict().items()})
    batch = next(iter(gpu.test_pipeline))
    out_gpu = gpu.eval_dispatch(batch).cpu()
    out_cpu = cpu.eval_dispatch(batch)
    err = (out_gpu - out_cpu).abs().max().item()
    # f32 but for the int8 codes: K1 is bit-equal to its plain version, the
    # dense ops sum in another order, and a last-bit activation difference
    # can flip a code (2^-6 x max, phase 16's bound for the rare flip)
    tol = 2.0 ** -6 * max(1.0, out_cpu.abs().max().item())
    check(err <= tol, f"w8a8 mamba slice: card vs CPU max err {err} > {tol}")
    print(f"[reference] mamba-130m 2-layer w8a8 f32 slice, card vs CPU: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}); phase 6v {time.perf_counter() - t_phase:.1f} s wall "
          f"({smi})")
    del gpu, cpu
    torch.cuda.empty_cache()

    # 6w. llm.fuse_projections on the main path (bench_config: the 7B w8a8
    # bf16, B 8): the fused model takes the separate one's weights, q|k|v and
    # gate|up concatenated as the loader does (loader.fuse_state_dict); K2
    # reads q / k / v as column views of qkv (their row pitch). test() of
    # both: the same scores, the quantizer and the K1 GEMM 4 launches a block
    # in place of 7; the eager eval step bit-equal; the graphed eval p50 of
    # both, interleaved in this call
    from medtsllm_tpu_torch.models.llm.loader import fuse_state_dict
    t_phase = time.perf_counter()
    # the repair: K2 reads column views of one fused projection output in
    # place, bit-equal to its launch on dense copies, and refuses a layout
    # it cannot read, naming the tensor
    qkv = torch.randn(B, L, (H + 2 * KV) * D, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = qkv.split((H * D, KV * D, KV * D), dim=-1)
    q, k, v = q.reshape(B, L, H, D), k.reshape(B, L, KV, D), v.reshape(B, L, KV, D)
    pk = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
    pv = torch.randn(1, KV, P, D, device=dev, generator=g).to(torch.bfloat16)
    cos, sin = k2.rope_tables(torch.arange(P, P + L, device=dev), D, lcfg.rope_theta)
    o_view = k2.rope_attention(q, k, v, cos, sin, pk, pv)
    o_dense = k2.rope_attention(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin, pk, pv)
    check(not q.is_contiguous() and torch.equal(o_view, o_dense),
          "K2 on the fused projection's column views differs from its launch on dense copies")
    refusals = []
    for name, bad in (("q", q.transpose(1, 2).contiguous().transpose(1, 2)),
                      ("k", torch.zeros(B, L, KV, 2 * D, device=dev,
                                        dtype=torch.bfloat16)[..., ::2])):
        args = {"q": q, "k": k, "v": v, name: bad}
        try:
            k2.rope_attention(args["q"], args["k"], args["v"], cos, sin, pk, pv)
            refusals.append(f"{name}: accepted")
        except ValueError as e:
            refusals.append(str(e))
    check(all(r.startswith(n + " ") for r, n in zip(refusals, ("q", "k"))),
          f"K2's refusals of unreadable layouts: {refusals}")
    # K2 in place, on dense tensors (the separate projections' outputs) and
    # with the three copies, timed in turns
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    k2_ms = {"in place": [], "dense": [], "copies": []}
    for _ in range(3):
        k2_ms["in place"].append(cuda_ms(torch, lambda: k2.rope_attention(q, k, v, cos, sin,
                                                                          pk, pv)))
        k2_ms["dense"].append(cuda_ms(torch, lambda: k2.rope_attention(qc, kc, vc, cos, sin,
                                                                       pk, pv)))
        k2_ms["copies"].append(cuda_ms(torch, lambda: k2.rope_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), cos, sin, pk, pv)))
    print(f"[fused] K2 on qkv's column views (row pitch {(H + 2 * KV) * D}) bit-equal to "
          f"its launch on dense copies; ms in turns, 3 rounds of 20 calls: "
          + ", ".join(f"{n} {statistics.median(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                      for n, t in k2_ms.items()) + f"; refusals: {refusals}")
    del qkv, q, k, v, qc, kc, vc, o_view, o_dense
    # K1 at the fused widths, M = B * L: qkv [d -> (H + 2 KV) D], gate|up
    # [d -> 2 d_ff]; K2 on the column views of qkv
    d, f = lcfg.d_model, lcfg.d_ff
    check_k1_gemm("[fused-qkv]", B * L, ((d, (H + 2 * KV) * D, 1),),
                  "the fused qkv, one a 7B block")
    check_k1_gemm("[fused-gateup]", B * L, ((d, 2 * f, 1),), "the fused gate|up, one a 7B block")
    check_k2("rope_attention[fused]", B, L, H, KV, D, P, lcfg.rope_theta, views=True)
    sep = get_trainer("chip-smoke-unfused", bench_config(Config), device=dev)
    fus = get_trainer("chip-smoke-fused", derived_config(
        Config, bench_config(Config), llm={"fuse_projections": True}), device=dev)
    check(fus.model.llm_cfg.fused_projections and not sep.model.llm_cfg.fused_projections,
          "the fused and the separate layouts")
    fus.load_state_dict(fuse_state_dict(sep.model.state_dict()))
    torch.cuda.empty_cache()
    batch = next(iter(sep.test_pipeline))
    outs = [tr.eval_step_eager(tr.eval_model_inputs(batch)) for tr in (sep, fus)]
    check(torch.equal(outs[0], outs[1]), f"fused vs separate eval output: max |diff| "
          f"{(outs[0].float() - outs[1].float()).abs().max().item()}")
    sep._prefix_kv_cache.clear()
    fus._prefix_kv_cache.clear()
    n_batches = len(sep.test_pipeline)
    scores, test_counts = {}, {}
    for label, tr in (("separate", sep), ("fused", fus)):
        scores[label], test_counts[label] = counted(tr.test)
    check(same_scores(scores["fused"], scores["separate"]),
          f"fused test() scores {scores['fused']} vs {scores['separate']}")
    per_block = {"separate": 7, "fused": 4}
    for label, c in test_counts.items():
        n = per_block[label] * n_block * (n_batches + 1)  # the batches and the prefill
        check(c["w8a8_quantize"] == c["w8a8_gemm"] == n
              and c["rope_attention"] == n_block * (n_batches + 1),
              f"[{label}] test() launches {c}: the quantizer and K1's GEMM "
              f"{per_block[label]} a block")
    set_launches(test_counts["fused"], {"w8a8_gemm[fused-qkv]": "w8a8_gemm",
                                        "w8a8_gemm[fused-gateup]": "w8a8_gemm"}, share=4)
    set_launches(test_counts["fused"], {"rope_attention[fused]": "rope_attention"})
    # the graphed eval step of both on one prepared batch, interleaved
    prepared = {label: tr.eval_prepare(batch) for label, tr in (("separate", sep),
                                                                ("fused", fus))}
    times = {"separate": [], "fused": []}
    for _ in range(30):
        for label, tr in (("fused", fus), ("separate", sep)):
            start.record()
            tr.eval_dispatch(prepared=prepared[label])
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    p50s = {label: statistics.median(t[5:]) for label, t in times.items()}
    print(f"[fused] 7B w8a8 bf16 B {B}: test() {n_batches} batches, scores equal; eager eval "
          f"output bit-equal; launches a step (one batch) quantizer / K1 GEMM: separate "
          f"{7 * n_block} / {7 * n_block}, fused {4 * n_block} / {4 * n_block} (test(): "
          f"{test_counts['separate']['w8a8_gemm']} -> {test_counts['fused']['w8a8_gemm']}); "
          f"graphed eval p50 separate {p50s['separate']:.3f} ms, fused {p50s['fused']:.3f} ms "
          f"(25 replays each after 5, interleaved; {smi})")
    del sep, fus, outs, prepared
    torch.cuda.empty_cache()
    # 2-layer cuts: LoRA (q, v) on the fused qkv: one captured train step, the
    # k slice's adapter gradient exactly 0; absmax int4 fused = separate
    lora = {"enabled": True, "rank": 8, "alpha": 16, "layers": "auto"}
    tr = get_trainer("chip-smoke-fused-lora", derived_config(
        Config, bench_config(Config, n_points=3200, llm_layers=2),
        llm={"fuse_projections": True}, lora=lora), device=dev)
    a = tr.train_model_inputs(next(iter(tr.train_pipeline)))
    loss = float(tr.train_step(a, a["valid"]))
    nq, nk, _ = tr.model.llm.blocks[0].attn.qkv_sizes
    grads = [b.attn.qkv_proj.lora_b.grad for b in tr.model.llm.blocks]
    check(math.isfinite(loss) and all(torch.all(gr[:, nq:nq + nk] == 0) for gr in grads)
          and all(gr[:, :nq].abs().sum() > 0 and gr[:, nq + nk:].abs().sum() > 0
                  for gr in grads),
          f"fused LoRA: loss {loss}; the k slice's adapter gradient must be 0 and q / v's not")
    print(f"[fused-lora] 2-layer 7B w8a8 with LoRA (q, v) on the fused qkv: one captured step, "
          f"loss {loss:.6f}; lora_b's gradient exactly 0 on the k slice, nonzero on q and v")
    del tr, a, grads
    cut4 = bench_config(Config, llm_layers=2, quant_type="int4")
    sep = get_trainer("chip-smoke-unfused-int4", cut4, device=dev)
    fus = get_trainer("chip-smoke-fused-int4", derived_config(
        Config, cut4, llm={"fuse_projections": True}), device=dev)
    fus.load_state_dict(fuse_state_dict(sep.model.state_dict()))
    batch = next(iter(sep.test_pipeline))
    outs = []
    counts4 = {}
    for label, tr in (("separate", sep), ("fused", fus)):
        arrays = tr.eval_model_inputs(batch)  # the head's prefill, not counted
        out, counts4[label] = counted(lambda: tr.eval_step_eager(arrays))
        outs.append(out)
    check(torch.equal(outs[0], outs[1]) and counts4["fused"]["w4a8_gemm"] == 2 * 4
          and counts4["separate"]["w4a8_gemm"] == 2 * 7,
          f"int4 fused vs separate: max |diff| "
          f"{(outs[0].float() - outs[1].float()).abs().max().item()}, K5 launches "
          f"{counts4['fused']['w4a8_gemm']} / {counts4['separate']['w4a8_gemm']}")
    print(f"[fused-int4] 2-layer 7B absmax int4: fused eval output bit-equal to separate; "
          f"K5 {counts4['separate']['w4a8_gemm']} -> {counts4['fused']['w4a8_gemm']} a step; "
          f"phase 6w {time.perf_counter() - t_phase:.1f} s wall")
    del sep, fus, outs
    torch.cuda.empty_cache()

    # 6x. the profiler hooks on bidmc.toml (mixed, 4 layers of the 7B, w8a8
    # so that K1 runs): train() with setup.profile_dir traces step 2 (a
    # replay of the captured step) into a Chrome trace that must name
    # K1's and K2's kernels; then setup.debug_nans: a clean captured step
    # passes, a batch with a NaN raises FloatingPointError
    from medtsllm_tpu_torch.runtime import profiler as prof_mod
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        raw = task_config(Config, BIDMC_TOML, n_points=8320, llm_layers=4,
                          model={"llm": {"load_in_8bit": True}}).to_dict()
        raw["setup"]["profile_dir"] = tmp
        tr = get_trainer("chip-smoke-profile", Config(raw), device=dev)
        counts, wall = drive(tr.train)
        check(finite(tr.losses) and counts["w8a8_gemm"] > 0 and counts["rope_attention"] > 0,
              f"[profile] train(): losses {tr.losses}, launches {counts}")
        path = Path(tmp) / prof_mod.TRACE_NAME
        names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
        k1_names = sorted(n for n in names if "w8a8_gemm_kernel" in n)
        k2_names = sorted(n for n in names if "rope_attention" in n and "kernel" in n)
        check(k1_names and k2_names, f"[profile] the trace names no K1 {k1_names} or K2 "
              f"{k2_names} kernel: {sorted(names)[:40]}")
        print(f"[profile] train() {len(tr.losses)} steps in {wall:.2f} s wall; step 2 traced "
              f"to {path.name} ({path.stat().st_size / 2**20:.2f} MiB, {len(names)} distinct "
              f"names); K1 {k1_names[0][:60]!r}, K2 {k2_names[0][:60]!r}")
        del tr
    raw = task_config(Config, BIDMC_TOML, n_points=8320, llm_layers=4,
                      model={"llm": {"load_in_8bit": True}}).to_dict()
    raw["setup"]["debug_nans"] = True
    tr = get_trainer("chip-smoke-debug-nans", Config(raw), device=dev)
    batch = next(iter(tr.train_pipeline))
    a = tr.train_model_inputs(batch)
    for _ in range(2):  # the warm-up and capture, then a replay
        check(math.isfinite(float(tr.train_step(a, a["valid"]))), "[debug-nans] a clean step")
    bad = dict(batch, x_enc=np.array(batch["x_enc"], copy=True))
    bad["x_enc"][0, 5, 0] = np.nan
    a = tr.train_model_inputs(bad)
    try:
        tr.train_step(a, a["valid"])
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    check(raised is not None, "[debug-nans] a NaN in the batch did not raise")
    print(f"[debug-nans] two clean captured steps passed; the NaN batch's replay raised "
          f"FloatingPointError ({raised}); phase 6x {time.perf_counter() - t_phase:.1f} s wall")
    del tr, a
    torch.cuda.empty_cache()

    # 6y. serving export (runtime/export.py): each trainer's eager eval
    # forward (and its prefill) through torch.export, its kernels recorded as
    # medtsllm:: custom ops, saved, loaded back and served on the card. The
    # main path (bench_config: the 7B w8a8 bf16, B 8, head cached) at full
    # width and depth: the loaded program bit-equal to eval_step_eager and to
    # the graphed eval_step (verify_roundtrip: through the loaded prefill),
    # K1's quantizer and GEMM, K2 and K3 in its graph, their launch counters
    # moved by the loaded program alone, the export seconds, the artifact's
    # bytes against the params' (it holds no weight) and the loaded
    # program's p50 beside the live graphed step's; then mamba-130m at full
    # width (4 layers: the gated scan from the exported state prefill) and
    # cheap cuts that reach the other forward kernels: the per-clip bank on
    # 4 layers of ecgmit-seg.toml (K2 with a per-row prefix, the prefill at
    # [1, P], each row bit-equal to the live bank's), gpt2 at 768 keys (6s,
    # 4 layers: K4 through the dispatcher), 2 layers of the 7B at int4 (K5)
    # and of moe-8x1b (K6 and its requant)
    from medtsllm_tpu_torch.runtime.export import (export_serving, load_serving,
                                                   serve_prefix, serving_params,
                                                   verify_roundtrip)
    t_phase = time.perf_counter()
    export_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-export-"))

    def export_case(label, tr, ops, moved, p50=False, also=None):
        """Export ``tr`` (one test batch fixes the shapes), check the graph
        names ``ops`` and the round trip is exact, then serve the batch from
        the loaded artifact: bit-equal to the eager and the graphed step,
        each counter of ``moved`` launched by the loaded program; ``also(
        loaded, params, batch)`` checks more on the same artifact."""
        batch = next(iter(tr.test_pipeline))
        out = export_dir / label
        t0 = time.perf_counter()
        manifest = export_serving(tr, out, batch=batch)
        export_s = time.perf_counter() - t0
        names = set(manifest["custom_ops"]) | set(manifest.get("prefill", {}).get(
            "custom_ops", ()))
        check(ops <= names, f"[{label}-export] the graph calls {sorted(names)}, not "
              f"{sorted(ops)}")
        loaded = load_serving(out)
        diff = verify_roundtrip(tr, out, batch=batch, loaded=loaded)
        check(diff == 0.0, f"[{label}-export] round trip max |diff| {diff}")
        params = serving_params(tr.model)
        live = tr.eval_model_inputs(batch)
        arrays = dict(live)
        if "prefill" in loaded:
            arrays["prefix_kv"] = serve_prefix(loaded, params,
                                               tr.model_inputs(batch)["prefix_ids"], dev)
        with torch.no_grad():
            got, counts = counted(lambda: loaded["eval_step"](params, arrays))
        eager, graphed = tr.eval_step_eager(live), tr.eval_step(live)
        check(torch.equal(got, eager) and torch.equal(got, graphed),
              f"[{label}-export] loaded vs eager max |diff| "
              f"{(got.float() - eager.float()).abs().max().item()}, vs graphed "
              f"{(got.float() - graphed.float()).abs().max().item()}")
        check(all(counts[n] > 0 for n in moved), f"[{label}-export] the loaded program's "
              f"launches {counts}: {sorted(moved)} must move")
        art = sum(f.stat().st_size for f in out.iterdir())
        wbytes = sum(t.numel() * t.element_size() for t in params.values())
        consts = manifest["constants"]["bytes"] + manifest.get("prefill", {}).get(
            "constants", {}).get("bytes", 0)
        check(art < wbytes / 10 and consts < 2**20, f"[{label}-export] the artifact "
              f"{art} B (constants {consts} B) against {wbytes} B of params")
        line = (f"[{label}-export] export {export_s:.2f} s; artifact {art / 2**20:.2f} MiB "
                f"({sorted(p.name for p in out.iterdir())}; constants {consts} B) against "
                f"{wbytes / 2**30:.3f} GiB of params; ops {sorted(names)}; round trip 0.0, "
                f"loaded = eager = graphed; the loaded step's launches "
                f"{ {n: counts[n] for n in counts if counts[n]} }")
        if p50:
            with torch.no_grad():
                ms_loaded = cuda_ms(torch, lambda: loaded["eval_step"](params, arrays),
                                    iters=10, warmup=2)
            with torch.inference_mode():
                ms_eager = cuda_ms(torch, lambda: tr.eval_step_eager(live), iters=10,
                                   warmup=2)
            ms_graphed = cuda_ms(torch, lambda: tr.eval_step(live), iters=10, warmup=2)
            line += (f"; eval step ms (CUDA events, mean of 10): loaded {ms_loaded:.2f}, "
                     f"live eager {ms_eager:.2f}, live graphed {ms_graphed:.2f} ({smi})")
        print(line)
        if also is not None:
            also(loaded, params, batch)
        shutil.rmtree(out)
        return counts

    main_ops = {"medtsllm::quantize_rows", "medtsllm::w8a8_gemm", "medtsllm::rope_attention",
                "medtsllm::reprogramming_attention"}
    main_moved = {"w8a8_quantize", "w8a8_gemm", "rope_attention", "reprogramming_attention"}
    tr = get_trainer("chip-smoke-export", bench_config(Config), device=dev)
    export_case("main", tr, main_ops, main_moved, p50=True)
    del tr
    torch.cuda.empty_cache()
    tr = get_trainer("chip-smoke-export-mamba", mamba_config(Config, llm_layers=4),
                     device=dev)
    export_case("mamba-130m", tr, {"medtsllm::selective_ssm_gated",
                                   "medtsllm::reprogramming_attention"},
                {"selective_scan_h0", "reprogramming_attention"})
    del tr
    tr = get_trainer("chip-smoke-export-clips", task_config(
        Config, ECG_SEG_TOML, n_points=8 * 512, n_clips=8, llm_layers=4), device=dev)

    def bank_rows(loaded, params, batch):
        """Each per-clip head row through the exported [1, P] prefill, bit-equal
        to the live bank's row."""
        ids = tr.model_inputs(batch)["prefix_ids"]
        spec = loaded["manifest"]["prefill"]
        check(ids.ndim == 2 and spec["per_clip"] and spec["prefix_ids_shape"]
              == [1, ids.shape[1]], f"[clips-export] the prefill {spec}")
        live = tr.eval_model_inputs(batch)["prefix_kv"]
        with torch.no_grad():
            for b in range(ids.shape[0]):
                row = loaded["prefill"](params, torch.as_tensor(ids[b:b + 1], device=dev))
                check(all(torch.equal(x, y[b:b + 1]) for lx, ly in zip(row, live)
                          for x, y in zip(lx, ly)), f"[clips-export] bank row {b} differs")
        print(f"[clips-export] {ids.shape[0]} rows of the exported [1, {ids.shape[1]}] "
              "prefill bit-equal to the live bank's")
    export_case("clips", tr, {"medtsllm::rope_attention"}, {"rope_attention"},
                also=bank_rows)
    del tr
    tr = get_trainer("chip-smoke-export-gpt2-long", family_config(
        Config, "gpt2", batch=8, history=gpt2_long_history, n_points=12 * 2 * gpt2_long_history,
        n_clips=12, n_features=1, input_stats=False, d_ff=32, load_in_8bit=False,
        llm_layers=4), device=dev)
    export_case("gpt2-long", tr, {"medtsllm::flash_attention"}, {"flash_attention"})
    del tr
    tr = get_trainer("chip-smoke-export-int4", bench_config(Config, llm_layers=2,
                                                           quant_type="int4"), device=dev)
    export_case("int4", tr, {"medtsllm::w4a8_gemm", "medtsllm::quantize_rows"},
                {"w4a8_gemm", "w8a8_quantize"})
    del tr
    tr = get_trainer("chip-smoke-export-moe", moe_config(Config, llm_layers=2), device=dev)
    export_case("moe", tr, {"medtsllm::gmm", "medtsllm::requant_tiles"},
                {"grouped_matmul_gate_up", "grouped_matmul_down", "grouped_matmul_requant"})
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(export_dir)
    print(f"[export] phase 6y: {time.perf_counter() - t_phase:.1f} s wall ({smi})")

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
        for n, grad_c in grads_c.items():
            diff = (grads_g[n] - grad_c).abs().max().item()
            if n.endswith("key_projection.bias"):
                check(max(grad_c.abs().max().item(), grads_g[n].abs().max().item()) <= 1e-4 * top,
                      f"{label}: {n} should hold rounding noise only")
                continue
            rel = diff / max(grad_c.abs().max().item(), 1e-30)
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

    # 20. the ops library no model reaches, card vs CPU (no kernel launches)
    ops_library(torch, dev, drive, smi.splitlines()[0])

    check(all(e["launches"] for e in kernels), f"unlaunched kernels: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
