"""Checkpoint files (port of ``medtsllm_tpu/runtime/checkpoint.py``).

A trainer writes ``latest`` every epoch and ``best`` on an improvement of
its metric; a checkpoint holds the run's meta (``run_id``, ``epoch``,
``step``, ``best_score``, ``datetime``) and the parameters the model keeps
(``MedTsLLM.checkpoint_tree``: not the frozen backbone, which a restore
rebuilds from ``setup.seed``).

The file layout is JAX's: an 8-byte little-endian header length, the meta
as JSON, then the payload. The payload is not JAX's: it is ``torch.save`` of
``{state-dict name: CPU tensor}``, each tensor at its storage dtype, read
back with ``torch.load(..., weights_only=True)``. A checkpoint written by
the JAX package (flax msgpack) is refused with an error that says so.

Writes are atomic (a temporary file, then ``os.replace``), so a SIGUSR1
save cannot leave a torn ``latest``. Asynchronous saves copy the tensors to
the host when called (after the work already queued on the current stream,
which is the stream the captured steps replay on, so the copy is a step
boundary) and serialise and write on ONE ordered worker thread: saves to
one path land in the order they were made. A synchronous save drains that
queue first.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
from pathlib import Path

import torch

# one FIFO worker: per-save threads could os.replace out of order and leave
# an older epoch as ``latest`` / ``best``
_save_queue: queue.Queue = queue.Queue()
_save_errors: list[BaseException] = []
_worker_lock = threading.Lock()
_worker: threading.Thread | None = None

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's payload is a zip archive


def _write(path: Path, state: dict, meta: dict) -> None:
    header = json.dumps(meta).encode()
    # a temporary name of this process and thread: two writers of one path
    # (another process's run of the same id) never share a temporary file
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        torch.save(state, f)
    os.replace(tmp, path)


def _drain() -> None:
    while True:
        item = _save_queue.get()
        try:
            _write(*item)
        except Exception as e:  # surfaced by wait_for_saves
            _save_errors.append(e)
        finally:
            _save_queue.task_done()


def _ensure_worker() -> None:
    global _worker
    with _worker_lock:
        if _worker is None or not _worker.is_alive():
            _worker = threading.Thread(target=_drain, daemon=True,
                                       name="checkpoint-writer")
            _worker.start()


def save_checkpoint(path, state: dict, meta: dict, async_: bool = False) -> None:
    """Write ``state`` ({name: tensor}) and ``meta`` to ``path`` atomically.
    The host copy is made now; with ``async_`` the serialisation and the
    write run on the ordered worker, so training goes on at once."""
    path = Path(path)
    # each tensor copied to the host at its dtype: a card's after the work
    # queued on the current stream; a CPU tensor cloned too, since training
    # updates the parameters in place
    host = {k: v.detach().to("cpu", copy=True) for k, v in state.items()}
    if not async_:
        # a pending async save of the same path must not land after this
        # one: drain for the order only. A stale async error must not stop
        # the one save that has to succeed (the preemption save); it still
        # surfaces at the next wait_for_saves
        if _worker is not None and _worker.is_alive():
            _save_queue.join()
        _write(path, host, meta)
        return
    _ensure_worker()
    _save_queue.put((path, host, meta))


def wait_for_saves() -> None:
    """Block until every async write is on disk. Raises if any failed (a run
    must not report a clean finish with no checkpoint), and clears the
    errors: they belong to the run that waited, not to the next trainer
    built in this process."""
    if _worker is not None and _worker.is_alive():
        _save_queue.join()
    if _save_errors:
        errors, _save_errors[:] = list(_save_errors), []
        raise RuntimeError(f"{len(errors)} async checkpoint write(s) failed: "
                           + "; ".join(repr(e) for e in errors)) from errors[0]


def load_checkpoint(path) -> tuple[dict, dict]:
    """(state {name: CPU tensor}, meta) of a checkpoint file."""
    path = Path(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = f.read(n)
        try:
            meta = json.loads(header.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: not a checkpoint (no JSON meta header)") from e
        blob = f.read()
    if blob[:4] != _ZIP_MAGIC:
        raise ValueError(
            f"{path}: its payload is not a torch.save archive; a checkpoint "
            "written by the JAX package (flax msgpack) cannot be read by "
            "medtsllm_tpu_torch")
    # the archive's offsets count from its own start, past the header
    state = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    return state, meta


def restore_partial(template: dict, saved: dict, skip_prefixes=()):
    """Non-strict restore in place (``restore_partial`` of the JAX package):
    every saved name must be in ``template`` (an unexpected one raises
    ``KeyError``) at its shape (else ``ValueError``); names in
    ``skip_prefixes`` (matched on whole ``.``-separated segments: "llm"
    skips "llm.wte", not "llm_adapter.w") are passed over; template entries
    the checkpoint lacks keep their values. Everything is checked before
    anything is written; then each saved tensor is copied into its template
    tensor (``copy_`` under ``no_grad``, at the template's dtype and device,
    as ``nn.Module.load_state_dict`` does), so a parameter keeps its
    address. Returns (template, the names loaded)."""
    def skipped(name: str) -> bool:
        return any(name == p or name.startswith(p + ".") for p in skip_prefixes)

    loaded = []
    for name, value in saved.items():
        if skipped(name):
            continue
        if name not in template:
            raise KeyError(f"Unexpected key in checkpoint: {name}")
        if tuple(value.shape) != tuple(template[name].shape):
            raise ValueError(f"Shape mismatch for {name}: {tuple(value.shape)} vs "
                             f"{tuple(template[name].shape)}")
        loaded.append(name)
    with torch.no_grad():
        for name in loaded:
            template[name].copy_(saved[name])
    return template, loaded
