"""Fixed-shape batches and their background prefetch (a copy of
``medtsllm_tpu/data/pipeline.py``)."""

from __future__ import annotations

import queue
import threading

import numpy as np

# batch keys stacked into arrays; the others (clip descriptions, the
# pretraining mixture's ``dataset`` and ``dataset_description``) stay host
# lists
ARRAY_KEYS = ("x_enc", "y", "labels")


class BatchPipeline:
    """Fixed-shape batches: the final batch is padded by repeating its last
    window, with ``valid`` marking the real rows. In index order, or with
    ``shuffle`` in an order drawn anew each epoch from one
    ``np.random.default_rng(seed)``, the JAX pipeline's draws. The
    ``ARRAY_KEYS`` are stacked; the rest stay lists."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        B, n = self.batch_size, len(order)
        for i in range(0, n, B):
            idx = order[i:i + B]
            n_valid = len(idx)
            idx = np.concatenate([idx, np.repeat(idx[-1], B - n_valid)])
            valid = np.zeros(B, dtype=bool)
            valid[:n_valid] = True
            items = [self.dataset[int(j)] for j in idx]
            batch = {k: np.stack([it[k] for it in items]) if k in ARRAY_KEYS
                     else [it[k] for it in items] for k in items[0]}
            yield dict(batch, index=idx.astype(np.int32), valid=valid)


def prefetch(iterator, size: int = 2):
    """Yield ``iterator``'s items, produced ahead by a daemon thread into a
    queue of ``size``, so host batch assembly overlaps the device's work.

    An exception in the producer re-raises in the consumer (a dead producer
    must not look like a clean end of epoch), and a consumer that stops
    early (close or GC of this generator) sets the stop event, so neither
    the thread nor its queued batches leak."""
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    error: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:
            error.append(e)
        finally:
            put(end)

    threading.Thread(target=producer, name="medtsllm-prefetch", daemon=True).start()
    try:
        while (item := q.get()) is not end:
            yield item
        if error:
            raise error[0]
    finally:
        stop.set()
