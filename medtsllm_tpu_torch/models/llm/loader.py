"""A local HF snapshot's weights into the port's backbones (port of
``_hf_to_tree``, ``_load_safetensors`` and the loading half of
``load_backbone`` in ``medtsllm_tpu/models/llm/loader.py``, with
``restore_partial``'s rules of ``medtsllm_tpu/runtime/checkpoint.py``).

``hf_to_tree`` maps the HF state-dict names of every style the port builds
(mamba, t5 / mt5, bart, gpt2, opt, gpt_neox, llama / mistral and mixtral's
experts) to the JAX package's flax tree, numpy leaves, bit for bit as the
JAX function does: torch Linear weights transposed to [in, out] (gpt2's
Conv1D ones are already), neox's per-head packed q|k|v split, mixtral's
experts stacked on a leading E axis, mamba's depthwise conv to [K, 1, E];
under ``cfg.fused_projections`` llama's q | k | v and gate | up
column-concatenated into ``qkv_proj`` / ``gateup_proj`` before any
quantization, so the per-channel scales concatenate too.
With ``quantize`` 8 or 4 each projection kernel is quantized at load by
``quantize_weight`` (``QuantDense.quantize``: absmax int8; absmax int4, or
the nearest entry of the nf4 / fp4 codebook, packed in split halves),
experts one by one. ``weights.from_flax`` then gives the
state-dict layout, so it comes from one place.

``load_snapshot_`` merges that into a module in place with
``restore_partial``'s rules: a name the module lacks raises, as does a shape
that differs; each tensor is copied at the module's dtype for it; what the
snapshot lacks (LoRA adapters, MedTsLLM's fusion layers) keeps its init. A
snapshot that is found but cannot be read or mapped raises: no path falls
back to the random backbone.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from ...ops.kernels.w4a8 import CODEBOOKS, pack4_split
from .config import find_snapshot
from .safetensors import load_safetensors

def _pack4(q: np.ndarray) -> np.ndarray:
    """[K, N] int8 in [-8, 7] -> [ceil(K/2), N] in ``w4a8.pack4_split``'s
    split halves (JAX's ``pack4_split`` layout, along K)."""
    return pack4_split(torch.from_numpy(np.ascontiguousarray(q.T))).numpy().T


def quantize_weight(w: np.ndarray, bits: int = 8, codebook: str = "absmax"):
    """w [in, out] f32 -> (int8 storage, f32 scale [out]) as
    ``QuantDense.quantize``: bits 8 q [in, out]; bits 4 packed [ceil(in/2),
    out]; a codebook stores (nearest entry of w / absmax) - 8, its scale the
    channel's absmax. The codebook's distances are taken 256 input rows at
    a time (elementwise, so the codes are the same)."""
    if codebook != "absmax":
        assert bits == 4 and codebook in CODEBOOKS, (bits, codebook)
        table = np.asarray(CODEBOOKS[codebook], dtype=np.float32)
        scale = np.max(np.abs(w), axis=0).astype(np.float32)
        scale = np.where(scale == 0, 1.0, scale)
        wn = w / scale[None, :]
        codes = np.concatenate([
            np.argmin(np.abs(wn[r:r + 256, :, None] - table[None, None, :]), axis=-1)
            for r in range(0, max(wn.shape[0], 1), 256)])
        return _pack4((codes - 8).astype(np.int8)), scale
    qmax = 127.0 if bits == 8 else 7.0
    absmax = np.max(np.abs(w), axis=0)
    scale = (absmax / qmax).astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale[None, :]), -qmax, qmax).astype(np.int8)
    if bits == 4:
        q = _pack4(q)
    return q, scale


def hf_to_tree(cfg, tensors: dict, quantize: int = 0) -> dict:
    """HF state-dict names (prefixes stripped) -> the flax tree of the
    backbone ``cfg`` describes (``_hf_to_tree`` of the JAX package); numpy
    leaves. A name the style needs and the snapshot lacks raises KeyError."""
    tree: dict = {}
    codebook = getattr(cfg, "quant4_codebook", "absmax") if quantize == 4 else "absmax"

    def put(path: str, value) -> None:
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)

    def put_kernel(path: str, w) -> None:
        if quantize:
            q, scale = quantize_weight(np.asarray(w, dtype=np.float32), quantize, codebook)
            put(path.removesuffix("kernel") + "kernel_q", q)
            put(path.removesuffix("kernel") + "scale", scale)
        else:
            put(path, w)

    if cfg.style == "mamba":
        put("wte", tensors["embeddings.weight"])
        put("norm_f/weight", tensors["norm_f.weight"])
        for i in range(cfg.n_layers):
            p = f"layers.{i}.mixer."
            put(f"h_{i}/norm/weight", tensors[f"layers.{i}.norm.weight"])
            put(f"h_{i}/A_log", tensors[p + "A_log"])
            put(f"h_{i}/D", tensors[p + "D"])
            put(f"h_{i}/conv_kernel", tensors[p + "conv1d.weight"].transpose(2, 1, 0))
            if p + "conv1d.bias" in tensors:
                put(f"h_{i}/conv_bias", tensors[p + "conv1d.bias"])
            for n in ("in_proj", "x_proj", "out_proj"):
                put_kernel(f"h_{i}/{n}/kernel", tensors[p + f"{n}.weight"].T)
                if p + f"{n}.bias" in tensors:
                    put(f"h_{i}/{n}/bias", tensors[p + f"{n}.bias"])
            put(f"h_{i}/dt_proj/kernel", tensors[p + "dt_proj.weight"].T)
            put(f"h_{i}/dt_proj/bias", tensors[p + "dt_proj.bias"])
        return tree
    n_dec = getattr(cfg, "n_dec_layers", None) or cfg.n_layers
    if cfg.style == "t5":
        put("wte", tensors["shared.weight"])
        put("enc_norm/weight", tensors["encoder.final_layer_norm.weight"])
        put("dec_norm/weight", tensors["decoder.final_layer_norm.weight"])
        put("enc_rel_bias", tensors[
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
        put("dec_rel_bias", tensors[
            "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
        ffn = ("wi_0", "wi_1", "wo") if cfg.t5_gated else ("wi", "wo")
        for side, n_blocks, ffn_layer in (("enc", cfg.n_layers, 1), ("dec", n_dec, 2)):
            for i in range(n_blocks):
                p = f"{'encoder' if side == 'enc' else 'decoder'}.block.{i}."
                dst = f"{side}_h_{i}"
                put(f"{dst}/input_layernorm/weight", tensors[p + "layer.0.layer_norm.weight"])
                for n in ("q", "k", "v", "o"):
                    put_kernel(f"{dst}/attn/{n}_proj/base/kernel",
                               tensors[p + f"layer.0.SelfAttention.{n}.weight"].T)
                if side == "dec":
                    put(f"{dst}/cross_attention_layernorm/weight",
                        tensors[p + "layer.1.layer_norm.weight"])
                    for n in ("q", "k", "v", "o"):
                        put_kernel(f"{dst}/cross_attn/{n}_proj/base/kernel",
                                   tensors[p + f"layer.1.EncDecAttention.{n}.weight"].T)
                put(f"{dst}/post_attention_layernorm/weight",
                    tensors[p + f"layer.{ffn_layer}.layer_norm.weight"])
                for n in ffn:
                    put_kernel(f"{dst}/mlp/{n}/kernel",
                               tensors[p + f"layer.{ffn_layer}.DenseReluDense.{n}.weight"].T)
        return tree
    if cfg.style == "bart":
        put("wte", tensors["shared.weight"])
        for side, hf_side in (("enc", "encoder"), ("dec", "decoder")):
            put(f"{side}_wpe", tensors[f"{hf_side}.embed_positions.weight"])
            put(f"{side}_ln_emb/scale", tensors[f"{hf_side}.layernorm_embedding.weight"])
            put(f"{side}_ln_emb/bias", tensors[f"{hf_side}.layernorm_embedding.bias"])

        def attn(dst, src):
            for hf_n, fx_n in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                               ("v_proj", "v_proj"), ("out_proj", "o_proj")):
                put_kernel(f"{dst}/{fx_n}/base/kernel", tensors[f"{src}.{hf_n}.weight"].T)
                put(f"{dst}/{fx_n}/base/bias", tensors[f"{src}.{hf_n}.bias"])

        for side, hf_side, n_blocks in (("enc", "encoder", cfg.n_layers),
                                        ("dec", "decoder", n_dec)):
            for i in range(n_blocks):
                dst, src = f"{side}_h_{i}", f"{hf_side}.layers.{i}."
                put(f"{dst}/ln_1/scale", tensors[src + "self_attn_layer_norm.weight"])
                put(f"{dst}/ln_1/bias", tensors[src + "self_attn_layer_norm.bias"])
                put(f"{dst}/ln_2/scale", tensors[src + "final_layer_norm.weight"])
                put(f"{dst}/ln_2/bias", tensors[src + "final_layer_norm.bias"])
                attn(f"{dst}/attn", src + "self_attn")
                put_kernel(f"{dst}/mlp/c_fc/kernel", tensors[src + "fc1.weight"].T)
                put(f"{dst}/mlp/c_fc/bias", tensors[src + "fc1.bias"])
                put_kernel(f"{dst}/mlp/c_proj/kernel", tensors[src + "fc2.weight"].T)
                put(f"{dst}/mlp/c_proj/bias", tensors[src + "fc2.bias"])
                if side == "dec":
                    put(f"{dst}/ln_cross/scale", tensors[src + "encoder_attn_layer_norm.weight"])
                    put(f"{dst}/ln_cross/bias", tensors[src + "encoder_attn_layer_norm.bias"])
                    attn(f"{dst}/cross_attn", src + "encoder_attn")
        return tree
    if cfg.style == "opt":
        put("wte", tensors["decoder.embed_tokens.weight"])
        put("wpe", tensors["decoder.embed_positions.weight"])
        put("ln_f/scale", tensors["decoder.final_layer_norm.weight"])
        put("ln_f/bias", tensors["decoder.final_layer_norm.bias"])
        for i in range(cfg.n_layers):
            p = f"decoder.layers.{i}."
            put(f"h_{i}/ln_1/scale", tensors[p + "self_attn_layer_norm.weight"])
            put(f"h_{i}/ln_1/bias", tensors[p + "self_attn_layer_norm.bias"])
            put(f"h_{i}/ln_2/scale", tensors[p + "final_layer_norm.weight"])
            put(f"h_{i}/ln_2/bias", tensors[p + "final_layer_norm.bias"])
            for hf_n, fx_n in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                               ("v_proj", "v_proj"), ("out_proj", "o_proj")):
                put_kernel(f"h_{i}/attn/{fx_n}/base/kernel",
                           tensors[p + f"self_attn.{hf_n}.weight"].T)
                put(f"h_{i}/attn/{fx_n}/base/bias", tensors[p + f"self_attn.{hf_n}.bias"])
            put_kernel(f"h_{i}/mlp/c_fc/kernel", tensors[p + "fc1.weight"].T)
            put(f"h_{i}/mlp/c_fc/bias", tensors[p + "fc1.bias"])
            put_kernel(f"h_{i}/mlp/c_proj/kernel", tensors[p + "fc2.weight"].T)
            put(f"h_{i}/mlp/c_proj/bias", tensors[p + "fc2.bias"])
        return tree
    if cfg.style == "neox":
        put("wte", tensors["embed_in.weight"])
        put("ln_f/scale", tensors["final_layer_norm.weight"])
        put("ln_f/bias", tensors["final_layer_norm.bias"])
        H, D, M = cfg.n_heads, cfg.head_dim, cfg.d_model
        for i in range(cfg.n_layers):
            p = f"layers.{i}."
            put(f"h_{i}/ln_1/scale", tensors[p + "input_layernorm.weight"])
            put(f"h_{i}/ln_1/bias", tensors[p + "input_layernorm.bias"])
            put(f"h_{i}/ln_2/scale", tensors[p + "post_attention_layernorm.weight"])
            put(f"h_{i}/ln_2/bias", tensors[p + "post_attention_layernorm.bias"])
            # q|k|v packed per head ([H, 3, D] on the output axis)
            qkv_w = np.asarray(tensors[p + "attention.query_key_value.weight"]).reshape(
                H, 3, D, M)
            qkv_b = np.asarray(tensors[p + "attention.query_key_value.bias"]).reshape(H, 3, D)
            for j, fx_n in enumerate(("q_proj", "k_proj", "v_proj")):
                put_kernel(f"h_{i}/attn/{fx_n}/base/kernel", qkv_w[:, j].reshape(H * D, M).T)
                put(f"h_{i}/attn/{fx_n}/base/bias", qkv_b[:, j].reshape(H * D))
            put_kernel(f"h_{i}/attn/o_proj/base/kernel", tensors[p + "attention.dense.weight"].T)
            put(f"h_{i}/attn/o_proj/base/bias", tensors[p + "attention.dense.bias"])
            put_kernel(f"h_{i}/mlp/c_fc/kernel", tensors[p + "mlp.dense_h_to_4h.weight"].T)
            put(f"h_{i}/mlp/c_fc/bias", tensors[p + "mlp.dense_h_to_4h.bias"])
            put_kernel(f"h_{i}/mlp/c_proj/kernel", tensors[p + "mlp.dense_4h_to_h.weight"].T)
            put(f"h_{i}/mlp/c_proj/bias", tensors[p + "mlp.dense_4h_to_h.bias"])
        return tree
    if cfg.style == "gpt2":
        put("wte", tensors["wte.weight"])
        put("wpe", tensors["wpe.weight"])
        put("ln_f/scale", tensors["ln_f.weight"])
        put("ln_f/bias", tensors["ln_f.bias"])
        for i in range(cfg.n_layers):
            p = f"h.{i}."
            for n in ("ln_1", "ln_2"):
                put(f"h_{i}/{n}/scale", tensors[p + f"{n}.weight"])
                put(f"h_{i}/{n}/bias", tensors[p + f"{n}.bias"])
            for n in ("attn.c_attn", "attn.c_proj"):  # Conv1D: already [in, out]
                dst = f"h_{i}/{n.replace('.', '/')}/base"
                put_kernel(f"{dst}/kernel", tensors[p + f"{n}.weight"])
                put(f"{dst}/bias", tensors[p + f"{n}.bias"])
            for n in ("c_fc", "c_proj"):
                put_kernel(f"h_{i}/mlp/{n}/kernel", tensors[p + f"mlp.{n}.weight"])
                put(f"h_{i}/mlp/{n}/bias", tensors[p + f"mlp.{n}.bias"])
        return tree
    # llama / mistral (and mixtral's experts)
    put("wte", tensors["embed_tokens.weight"])
    put("norm/weight", tensors["norm.weight"])
    fused = getattr(cfg, "fused_projections", False)
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        put(f"h_{i}/input_layernorm/weight", tensors[p + "input_layernorm.weight"])
        put(f"h_{i}/post_attention_layernorm/weight",
            tensors[p + "post_attention_layernorm.weight"])
        if fused:  # loader.py:536-546 of the JAX package
            put_kernel(f"h_{i}/attn/qkv_proj/base/kernel", np.concatenate(
                [tensors[p + f"self_attn.{n}.weight"].T for n in ("q_proj", "k_proj", "v_proj")],
                axis=1))
            put_kernel(f"h_{i}/attn/o_proj/base/kernel", tensors[p + "self_attn.o_proj.weight"].T)
        else:
            for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
                put_kernel(f"h_{i}/attn/{n}/base/kernel",
                           tensors[p + f"self_attn.{n}.weight"].T)
        if getattr(cfg, "n_experts", 0) > 1:
            put(f"h_{i}/mlp/gate", tensors[p + "block_sparse_moe.gate.weight"].T)
            for hf_n, fx_n in (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")):
                w = np.stack([tensors[p + f"block_sparse_moe.experts.{e}.{hf_n}.weight"].T
                              for e in range(cfg.n_experts)])  # [E, in, out]
                if quantize in (4, 8):  # expert by expert, as any projection
                    qs = [quantize_weight(np.asarray(w[e], dtype=np.float32), quantize,
                                          codebook) for e in range(cfg.n_experts)]
                    put(f"h_{i}/mlp/{fx_n}_q", np.stack([q for q, _ in qs]))
                    put(f"h_{i}/mlp/{fx_n}_scale", np.stack([s for _, s in qs]))
                else:
                    put(f"h_{i}/mlp/{fx_n}", w)
        elif fused:  # loader.py:584-590
            put_kernel(f"h_{i}/mlp/gateup_proj/kernel", np.concatenate(
                [tensors[p + "mlp.gate_proj.weight"].T, tensors[p + "mlp.up_proj.weight"].T],
                axis=1))
            put_kernel(f"h_{i}/mlp/down_proj/kernel", tensors[p + "mlp.down_proj.weight"].T)
        else:
            for n in ("gate_proj", "up_proj", "down_proj"):
                put_kernel(f"h_{i}/mlp/{n}/kernel", tensors[p + f"mlp.{n}.weight"].T)
    return tree


# the separate projections each fused one concatenates, in its column order
FUSED_GROUPS = {"attn.qkv_proj": ("attn.q_proj", "attn.k_proj", "attn.v_proj"),
                "mlp.gateup_proj": ("mlp.gate_proj", "mlp.up_proj")}


def fuse_state_dict(state: dict) -> dict:
    """A llama backbone's state dict with separate projections -> the same
    weights in the fused layout (``fused_projections``): q | k | v into
    ``attn.qkv_proj`` and gate | up into ``mlp.gateup_proj``, each leaf
    (dense ``weight`` [N, K], ``weight_q`` [N, K] or packed [N, ceil(K/2)],
    ``scale`` [N]) concatenated along the output rows, as ``hf_to_tree``
    concatenates the kernels before quantizing. The values are copied, not
    drawn: the fused model computes what the separate one does. A backbone
    with LoRA adapters raises (the fused adapter has its own shape)."""
    if any("lora_" in name for name in state):
        raise ValueError("fuse_state_dict takes a backbone without LoRA adapters")
    out, used = {}, set()
    for name, value in state.items():
        for fused, parts in FUSED_GROUPS.items():
            head, sep, leaf = name.partition("." + parts[0] + ".")
            if sep:
                names = [f"{head}.{part}.{leaf}" for part in parts]
                out[f"{head}.{fused}.{leaf}"] = torch.cat([state[n] for n in names])
                used.update(names)
    out.update({k: v for k, v in state.items() if k not in used})
    return out


def load_backbone_weights_(module: torch.nn.Module, cfg, llm_id: str, cache_dir: str | None,
                           quantize: int = 0) -> None:
    """A trainer's hook (``pretrained_param_loader`` of the JAX models),
    after the random init: the weights of the snapshot ``find_snapshot``
    finds for ``llm_id`` into the backbone ``module`` (``load_snapshot_``);
    without a snapshot, or with one of a ``config.json`` only (it set the
    shapes), the init stays and JAX's warning is given."""
    snap = find_snapshot(llm_id, cache_dir)
    if snap is None or not any(Path(snap).glob("*.safetensors")):
        warnings.warn(f"LLM {llm_id!r}: no local weights found — using random init "
                      "(shapes/throughput faithful; task quality not meaningful)")
        return
    load_snapshot_(module, cfg, snap, quantize)


def load_snapshot_(module: torch.nn.Module, cfg, snap: Path, quantize: int = 0) -> list[str]:
    """The snapshot's weights into ``module`` (a backbone) in place;
    returns the state-dict names set. Raises ValueError when the snapshot
    cannot be read or lacks a tensor its style maps, KeyError on a name the
    module lacks, ValueError on a shape mismatch (nothing is written then)."""
    from ...runtime.checkpoint import restore_partial
    from ...weights import from_flax
    try:
        tensors = load_safetensors(snap)
    except (OSError, ValueError) as e:
        raise ValueError(f"snapshot {snap}: its weights cannot be read: {e}") from e
    try:
        tree = hf_to_tree(cfg, tensors, quantize)
    except KeyError as e:
        raise ValueError(f"snapshot {snap}: no tensor {e.args[0]!r}, which the "
                         f"{cfg.style} backbone maps") from None
    template = module.state_dict()
    state = {}
    for name, value in from_flax(tree).items():
        if name not in template:  # a LoRA-adapted projection keeps its base's scope
            scope, _, leaf = name.rpartition(".")
            if f"{scope}.base.{leaf}" in template:
                name = f"{scope}.base.{leaf}"
        state[name] = value
    _, loaded = restore_partial(template, state)
    return loaded
