"""Serving-export CLI of the port (the root ``export.py``'s, on a CUDA
card): rebuild a trained run and write its deployable serving artifact
(``torch.export`` programs, ``runtime/export.py``), then round-trip one
batch through the loaded artifact.

    python -m medtsllm_tpu_torch.export <run_id> [out_dir] [ckpt] [basepath] [--device cpu]

Writes eval_step.pt2 (and prefill.pt2 when the model serves the prompt head
from a cache) and manifest.json to ``out_dir`` (``<basepath>/<run_id>/
export`` by default); ``ckpt`` is ``latest`` (the default) or ``best``,
``basepath`` the logdir holding ``<run_id>/`` (``./outputs/logs`` by
default). Raises unless the loaded program's output equals the live
trainer's bit for bit.
"""

from __future__ import annotations

import sys
import tomllib
from pathlib import Path

from .runtime.export import export_serving, verify_roundtrip
from .tasks import task_lookup
from .train import _split_device


def main(run_id, out_dir=None, save_id=None, _basepath=None, device="cuda"):
    basepath = Path(_basepath) if _basepath is not None else Path.cwd() / "outputs" / "logs"
    config = tomllib.loads((basepath / run_id / "config.toml").read_text())
    trainer = task_lookup[config["task"]].from_run_id(run_id, ckpt=save_id,
                                                      basepath=_basepath, device=device)
    out = Path(out_dir) if out_dir else basepath / run_id / "export"
    batch = next(iter(trainer.val_pipeline))
    manifest = export_serving(trainer, out, batch=batch)
    diff = verify_roundtrip(trainer, out, batch=batch)
    print(f"Exported {sorted(p.name for p in out.iterdir())} -> {out}")
    print(f"Platforms: {manifest['platforms']}; prefix_cached: {manifest['prefix_cached']}")
    print(f"Round-trip max |diff| on one batch: {diff}")
    if diff != 0.0:
        raise RuntimeError(f"the loaded program differs from the live trainer by {diff}: "
                           "it must be bit-identical")
    return manifest


if __name__ == "__main__":
    args, device = _split_device(sys.argv[1:])
    if not 1 <= len(args) <= 4:
        raise ValueError("usage: python -m medtsllm_tpu_torch.export <run_id> [out_dir] "
                         f"[ckpt] [basepath] [--device cpu]; got {sys.argv[1:]}")
    main(*args, device=device)
