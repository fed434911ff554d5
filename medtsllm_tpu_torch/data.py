"""Host data for the slice: the synthetic dataset family on the
reconstruction task (train, val and test splits), fixed-shape batches
(shuffled for training), the background prefetch of batches and window
stitching.

A copy of the parts of ``medtsllm_tpu/data`` (synthetic.py rng_for /
sine_mixture, base.py StandardScaler and windowing, readers/synthetic.py,
pipeline.py BatchPipeline and prefetch, windowing.py AlignedWindows /
stitch_windows)
the serving path runs, so the port runs without the JAX package. The same
config gives the same numbers as the JAX package's data
(tests/test_torch_medtsllm.py).
"""

from __future__ import annotations

import queue
import threading
import zlib

import numpy as np


def rng_for(family: str, split: str = "") -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(f"{family}:{split}:fixture".encode()))


def sine_mixture(rng, n: int, n_features: int, n_components: int = 4,
                 period_range=(20, 400), noise: float = 0.1) -> np.ndarray:
    """Smooth multichannel series: random sinusoid mixture + trend + noise."""
    t = np.arange(n, dtype=np.float64)[:, None]
    out = np.zeros((n, n_features))
    for _ in range(n_components):
        periods = rng.uniform(*period_range, size=n_features)
        phases = rng.uniform(0, 2 * np.pi, size=n_features)
        amps = rng.uniform(0.3, 1.5, size=n_features)
        out += amps * np.sin(2 * np.pi * t / periods + phases)
    out += rng.uniform(-0.5, 0.5, size=n_features) / n * t
    out += rng.normal(0, noise, size=(n, n_features))
    return out


class SyntheticDataset:
    """The synthetic sinusoid-mixture family, reconstruction windows
    [i * step, i * step + pred_len), z-scored with train-split statistics;
    test windows do not overlap (step = pred_len)."""

    description = "A synthetic sinusoid-mixture dataset used for testing."

    def __init__(self, config, split: str):
        if config.data.dataset != "synthetic" or config.task != "reconstruction":
            raise NotImplementedError(
                f"dataset {config.data.dataset!r} / task {config.task!r}: the "
                "port reads the synthetic reconstruction data (ROADMAP queue 1, "
                "\"The other tasks, the mixed dtype, the data and the CLIs\")")
        if config.data.mode != "multivariate" or config.data.cols != "all":
            raise NotImplementedError("the port reads multivariate, all-column data")
        ds = config.get("datasets", {}).get("synthetic", {})
        if ds.get("clips", False):
            raise NotImplementedError("clip datasets are ROADMAP queue 1, \"The other "
                                      "tasks, the mixed dtype, the data and the CLIs\"")
        if config.history_len != config.pred_len:
            raise ValueError("reconstruction requires history_len == pred_len")
        self.split = split
        self.pred_len = config.pred_len
        self.step_size = config.pred_len if split == "test" else config.data.step
        n = int(ds.get("n_points", 2048))
        C = int(ds.get("n_features", 3))

        def series(s):
            return sine_mixture(rng_for("synthetic:synthetic", s), n, C,
                                period_range=(16, 256), noise=0.1)

        data = series(split)
        if config.data.normalize:
            train = data if split == "train" else series("train")
            mean, std = train.mean(axis=0), train.std(axis=0)
            data = (data - mean) / np.where(std == 0.0, 1.0, std)
        self.data = data.astype(np.float32)
        self._len = max(0, (self.n_points - self.pred_len) // self.step_size + 1)

    def __len__(self) -> int:
        return self._len

    @property
    def n_points(self) -> int:
        return self.data.shape[0]

    @property
    def n_features(self) -> int:
        return self.data.shape[1]

    def x_starts(self, idx) -> np.ndarray:
        return np.asarray(idx) * self.step_size

    def __getitem__(self, idx: int) -> dict:
        s = int(idx) * self.step_size
        return {"x_enc": self.data[s:s + self.pred_len]}


class BatchPipeline:
    """Fixed-shape batches: the final batch is padded by repeating its last
    window, with ``valid`` marking the real rows. In index order, or with
    ``shuffle`` in an order drawn anew each epoch from one
    ``np.random.default_rng(seed)``, the JAX pipeline's draws."""

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
            yield {"x_enc": np.stack([self.dataset[j]["x_enc"] for j in idx]),
                   "index": idx.astype(np.int32), "valid": valid}


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


def stitch_windows(values: np.ndarray, starts: np.ndarray, n_points: int,
                   n_channels: int) -> np.ndarray:
    """Scatter [W, L, C] window values into one [n_points, C] series; later
    windows overwrite earlier ones; uncovered points stay NaN."""
    out = np.full((n_points, n_channels), np.nan, dtype=np.float32)
    time_idx = np.asarray(starts)[:, None] + np.arange(values.shape[1])[None, :]
    out[time_idx.ravel()] = values.reshape(-1, n_channels)
    return out
