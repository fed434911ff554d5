"""Serving export: the eval step as a deployable artifact
(``medtsllm_tpu/runtime/export.py``'s port, on ``torch.export``).

``export_serving`` traces the trainer's eager eval forward
(``tasks.base.eval_forward``, not the captured CUDA graph) through
``torch.func.functional_call``, so the parameters and buffers are inputs of
the program, as in JAX's ``eval_step.call(params, arrays)``: the artifact
holds the program, not the weights. Every hand-written kernel the forward
reaches is a ``torch.library`` custom op (``medtsllm::...``,
``ops/kernels``), recorded in the graph as one call: the loaded program
launches the same kernels on a card, and their plain versions (the ops' CPU
kernels) on the CPU. When the model serves the prompt head from a cache the
prefill (``MedTsLLM.prefill``) is exported too; a per-clip head ([B, P]
rows) at row shape [1, P], as JAX's.

Artifact layout (one directory):
    eval_step.pt2   eval_step(params, arrays) -> preds
    prefill.pt2     (when prefix-cached) prefill(params, prefix_ids)
                    -> per-layer state to pass as arrays["prefix_kv"]
    manifest.json   shapes, dtypes, device, calling convention, the custom
                    ops and the kernel library they need

``load_serving`` needs torch and ``medtsllm_tpu_torch.ops.kernels`` (which
registers the ops), nothing of the model code.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..ops.kernels import _build  # the package registers the medtsllm:: ops

EVAL_FILE, PREFILL_FILE, MANIFEST_FILE = "eval_step.pt2", "prefill.pt2", "manifest.json"


class _Program(torch.nn.Module):
    """``fn(params, *args)`` as a module that holds no tensor of its own:
    the export lifts nothing of the model into the artifact."""

    def __init__(self, fn):
        super().__init__()
        self._fn = (fn,)  # in a tuple, out of nn.Module's registries

    def forward(self, params, *args):
        return self._fn[0](params, *args)


class _Prefill(torch.nn.Module):
    """The model's ``prefill`` as a forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids):
        return self.model.prefill(ids)


def serving_params(model: torch.nn.Module) -> dict:
    """The program's ``params``: every parameter and buffer of the model by
    name (a kernel's derived weight copy, a non-persistent buffer, too), so
    that no weight becomes a constant of the artifact. Each is detached and
    keeps the model's ``requires_grad`` flag: ``aten.linear`` picks its
    kernels when it runs, and folds a strided 3-D input into one GEMM only
    when the weight requires grad (else a batched GEMM, other bits on a
    card), so the program serves the live model's bits given its flags."""
    return {name: t.detach().requires_grad_(t.requires_grad) for name, t in
            [*model.named_parameters(), *model.named_buffers()]}


def _eval_fn(model):
    def step(params, arrays):
        return torch.func.functional_call(model, params, (arrays,))
    return step


def _prefill_fn(model):
    wrapper = _Prefill(model)

    def prefill(params, ids):
        return torch.func.functional_call(
            wrapper, {f"model.{k}": v for k, v in params.items()}, (ids,))
    return prefill


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _spec_manifest(tree) -> dict:
    """Leaf path ("key/0/1", as JAX's) -> [shape, dtype]."""
    flat = pytree.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            [list(leaf.shape), _dtype_name(leaf.dtype)] for path, leaf in flat}


def _custom_ops(ep) -> list[str]:
    """The ``medtsllm::`` ops the exported graph calls."""
    names = {node.target.name().split(".")[0] for node in ep.graph.nodes
             if node.op == "call_function" and hasattr(node.target, "name")
             and node.target.name().startswith("medtsllm::")}
    return sorted(names)


def _export(fn, params: dict, args: tuple, model: torch.nn.Module):
    """``torch.export`` (non-strict) of ``fn(params, *args)`` under no_grad.
    Raises if the artifact would carry a tensor of the model: parameters and
    buffers are inputs, and the lifted constants (lookup tables, cached
    device constants) must not be any of them."""
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), (params, *args), strict=False)
    if ep.state_dict:
        raise RuntimeError(f"the program holds parameters {sorted(ep.state_dict)}")
    own = {t.untyped_storage().data_ptr() for t in params.values() if t.numel()}
    own |= {t.untyped_storage().data_ptr() for t in model.state_dict().values()
            if t.numel()}
    consts = [t for t in ep.constants.values() if isinstance(t, torch.Tensor)]
    held = [t for t in consts if t.numel() and t.untyped_storage().data_ptr() in own]
    if held:
        raise RuntimeError(f"{len(held)} tensors of the model became constants of the "
                           "program: the artifact must not hold weights")
    const_bytes = sum(t.numel() * t.element_size() for t in consts)
    ep.example_inputs = None  # the trace's inputs, the params among them: not saved
    return ep, {"count": len(consts), "bytes": int(const_bytes)}


def export_serving(trainer, out_dir, batch=None) -> dict:
    """Export ``trainer``'s serving programs to ``out_dir``; returns the
    manifest. One real batch fixes the shapes (the pipeline emits batches
    of one shape, so one program serves every batch of the run's
    batch_size)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if batch is None:
        batch = next(iter(trainer.val_pipeline))
    model = trainer.model
    arrays = trainer.eval_model_inputs(batch)
    host_ids = trainer.model_inputs(batch).get("prefix_ids")
    cached = "prefix_kv" in arrays
    per_clip = cached and host_ids.ndim == 2
    ids = None
    if cached:
        ids = torch.as_tensor(host_ids[:1] if per_clip else host_ids, device=trainer.device)
    # one eager forward (and prefill) first: what a module or a kernel
    # wrapper makes at its first call (derived weight copies, device tables)
    # is then made of real tensors, never of the trace's
    with torch.no_grad():
        trainer.eval_step_eager(arrays)
        if cached:
            model.prefill(ids)
    params = serving_params(model)
    device = trainer.device.type

    ep, consts = _export(_eval_fn(model), params, (arrays,), model)
    torch.export.save(ep, out / EVAL_FILE)
    manifest = {
        "model": trainer.config.model,
        "task": trainer.config.task,
        "platforms": [device],
        "nr_devices": 1,
        "mesh": None,
        "torch_version": torch.__version__,
        "version_note": "the medtsllm:: custom ops need medtsllm_tpu_torch.ops.kernels "
                        "imported (it registers them) and, on a card, the kernel library "
                        "built from the same csrc/ sources (kernel_library); the plain "
                        "versions serve the CPU",
        "batch_size": int(trainer.config.training.batch_size),
        "calling_convention": "eval_step(params, arrays) -> preds",
        "arrays": _spec_manifest(arrays),
        "prefix_cached": cached,
        "custom_ops": _custom_ops(ep),
        "kernel_library": _build.library_path().name,
        "params": {k: [list(t.shape), _dtype_name(t.dtype), t.requires_grad]
                   for k, t in params.items()},
        "constants": consts,
    }
    if cached:
        # the artifact takes the per-layer prefix state as an input; the
        # deployment rebuilds it once per weight load through the exported
        # prefill. A 1-D head [P] is prefilled once; per-clip head rows
        # [B, P] are exported at row shape [1, P]: a deployment prefills
        # each distinct row once, banks the results (the LRU of
        # tasks/base.py's _clip_bank_lookup) and stacks the batch's rows
        # on axis 0 to form arrays["prefix_kv"]
        pep, pconsts = _export(_prefill_fn(model), params, (ids,), model)
        torch.export.save(pep, out / PREFILL_FILE)
        manifest["prefill"] = {
            "calling_convention": (
                "prefill(params, prefix_ids[1, P]) -> one clip row; bank rows per "
                "distinct clip (LRU), stack the batch's rows on axis 0 -> "
                "arrays['prefix_kv']" if per_clip else
                "prefill(params, prefix_ids) -> arrays['prefix_kv']"),
            "prefix_ids_shape": list(ids.shape),
            "per_clip": bool(per_clip),
            "custom_ops": _custom_ops(pep),
            "constants": pconsts,
        }
    (out / MANIFEST_FILE).write_text(json.dumps(manifest, indent=1))
    return manifest


def load_serving(out_dir) -> dict:
    """Load an exported serving directory -> {"eval_step": callable
    ``(params, arrays)``, "prefill": callable ``(params, prefix_ids)`` when
    exported, "manifest": dict}."""
    out = Path(out_dir)
    loaded = {"manifest": json.loads((out / MANIFEST_FILE).read_text()),
              "eval_step": torch.export.load(out / EVAL_FILE).module()}
    if (out / PREFILL_FILE).exists():
        loaded["prefill"] = torch.export.load(out / PREFILL_FILE).module()
    return loaded


def stack_rows(rows: list):
    """Per-clip prefill rows (each per layer a tuple of [1, ...] tensors) ->
    the batch's per-layer tuples stacked on axis 0, as the banked step
    gathers them."""
    return tuple(tuple(torch.cat([r[i][j] for r in rows]) for j in range(len(layer)))
                 for i, layer in enumerate(rows[0]))


def serve_prefix(loaded: dict, params: dict, host_ids: np.ndarray, device):
    """``arrays["prefix_kv"]`` through the loaded prefill: the head at
    once, or each distinct clip row once (a bank), the batch's rows
    stacked."""
    if not loaded["manifest"]["prefill"]["per_clip"]:
        return loaded["prefill"](params, torch.as_tensor(host_ids, device=device))
    bank = {}
    for row in host_ids:
        key = row.tobytes()
        if key not in bank:
            bank[key] = loaded["prefill"](params, torch.as_tensor(row[None], device=device))
    return stack_rows([bank[row.tobytes()] for row in host_ids])


def verify_roundtrip(trainer, out_dir, batch=None, loaded=None) -> float:
    """Serve one batch through the loaded artifact (its prefill, then its
    eval step) and through the live trainer (``eval_step``: on a card the
    captured graph); returns the max abs difference, which must be 0.0.
    ``loaded``: ``load_serving(out_dir)`` when the caller holds it already
    (a large program takes seconds to load)."""
    if batch is None:
        batch = next(iter(trainer.val_pipeline))
    if loaded is None:
        loaded = load_serving(out_dir)
    live = trainer.eval_model_inputs(batch)
    arrays = dict(live)
    params = serving_params(trainer.model)
    if "prefill" in loaded:
        arrays["prefix_kv"] = serve_prefix(loaded, params,
                                           trainer.model_inputs(batch)["prefix_ids"],
                                           trainer.device)
    with torch.no_grad():
        got = loaded["eval_step"](params, arrays)
    want = trainer.eval_step(live)
    return float((got.float() - want.float()).abs().max())
