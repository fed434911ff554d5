"""Host data: the synthetic dataset family on the reconstruction,
anomaly-detection, segmentation and semantic-segmentation tasks (train,
val and test splits, with their labels), as one series or as clips
(``datasets.synthetic.clips``: windows that never cross a clip, each with
its clip's description), fixed-shape batches (shuffled for training), the
background prefetch of batches and window stitching.

A copy of the parts of ``medtsllm_tpu/data`` (synthetic.py rng_for /
sine_mixture / inject_anomalies / periodic_boundaries /
segment_class_labels / patient_descriptions, base.py StandardScaler, label
conversion, windowing and item access, readers/synthetic.py, pipeline.py
BatchPipeline and prefetch, windowing.py ClipWindows /
steps_to_boundary_labels / stitch_windows / dedup_eval_series) the port
runs, so it runs without the JAX package. The same config gives the same
arrays as the JAX package's ``get_dataset`` (tests/test_torch_tasks.py,
tests/test_torch_clip.py).
"""

from __future__ import annotations

import queue
import threading
import zlib

import numpy as np

# batch keys stacked into arrays; the others (descriptions) stay host lists
ARRAY_KEYS = ("x_enc", "y", "labels")


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


def inject_anomalies(rng, data: np.ndarray, rate: float = 0.02, min_len: int = 5,
                     max_len: int = 50):
    """Insert contiguous anomalous segments (spikes / level shifts) in
    place. Returns (data, labels [n] int)."""
    n = data.shape[0]
    labels = np.zeros(n, dtype=np.int64)
    n_anom_pts = int(rate * n)
    pts = 0
    while pts < n_anom_pts:
        length = int(rng.integers(min_len, max_len + 1))
        start = int(rng.integers(0, max(1, n - length)))
        kind = rng.integers(0, 2)
        seg = slice(start, start + length)
        if kind == 0:
            data[seg] += rng.normal(0, 3.0, size=data[seg].shape)
        else:
            data[seg] += rng.uniform(2.0, 5.0) * rng.choice([-1.0, 1.0])
        labels[seg] = 1
        pts += length
    return data, labels


def periodic_boundaries(rng, n: int, mean_period: float, jitter: float = 0.2) -> np.ndarray:
    """Binary boundary indicators with jittered periodic spacing."""
    labels = np.zeros(n, dtype=np.int64)
    pos = float(rng.uniform(0.3, 1.0) * mean_period)
    while pos < n:
        labels[int(pos)] = 1
        pos += mean_period * float(rng.uniform(1 - jitter, 1 + jitter))
    return labels


def segment_class_labels(rng, n: int, n_classes: int, mean_seg: float) -> np.ndarray:
    """Piecewise-constant class labels, the classes in turn."""
    labels = np.zeros(n, dtype=np.int64)
    pos = cls = 0
    while pos < n:
        length = max(3, int(rng.normal(mean_seg, mean_seg * 0.3)))
        labels[pos:pos + length] = cls
        cls = (cls + 1) % n_classes
        pos += length
    return labels


def patient_descriptions(ids, prefix="Patient description") -> dict:
    return {int(i): f"{prefix}: synthetic subject {int(i)} with stable vitals."
            for i in np.unique(ids)}


class ClipWindows:
    """Windows that never cross a clip (``clip_ids`` non-decreasing): each
    clip holds ``(len - pred_len) // step + 1`` windows, indexed clip after
    clip. ``mask`` marks the points a stitched series keeps: within the
    span a clip's windows cover, those with ``(t % step) // pred_len ==
    0``; a clip's trailing remainder never."""

    def __init__(self, clip_ids: np.ndarray, pred_len: int, step: int):
        clip_ids = np.asarray(clip_ids)
        if not (np.diff(clip_ids) >= 0).all():
            raise ValueError("clip_ids must be non-decreasing")
        change = np.flatnonzero(np.diff(clip_ids)) + 1
        self.clip_starts = np.concatenate([[0], change])
        clip_lens = np.concatenate([change, [len(clip_ids)]]) - self.clip_starts
        segs = (clip_lens - pred_len) // step + 1
        if (segs < 1).any():
            raise ValueError(f"clip shorter than window: min clip len {clip_lens.min()} "
                             f"< pred_len {pred_len}")
        self.step = step
        self.segs_cumsum = np.concatenate([[0], np.cumsum(segs)])
        covered = (segs - 1) * step + pred_len
        proto = ((np.arange(int(covered.max())) % step) // pred_len) == 0
        self.mask = np.concatenate([part for cp, n in zip(covered, clip_lens)
                                    for part in (proto[:cp], np.zeros(n - cp, dtype=bool))])

    def __len__(self) -> int:
        return int(self.segs_cumsum[-1])

    def x_starts(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        clip = np.searchsorted(self.segs_cumsum, idx, side="right") - 1
        return self.clip_starts[clip] + (idx - self.segs_cumsum[clip]) * self.step


def steps_to_boundary_labels(labels_binary: np.ndarray) -> np.ndarray:
    """Boundary indicators -> the distance to the next boundary (the end of
    the series counts as one) over the length of the segment it ends."""
    n = len(labels_binary)
    changepts = np.append(np.flatnonzero(labels_binary), n)
    seg_idx = np.searchsorted(changepts, np.arange(n), side="left")
    cp = changepts[seg_idx]
    prev_cp = np.where(seg_idx > 0, changepts[np.maximum(seg_idx - 1, 0)], 0)
    seg_len = (cp - prev_cp).astype(np.float32)
    return ((cp - np.arange(n)) / seg_len).astype(np.float32)


class SyntheticDataset:
    """The synthetic sinusoid-mixture family for one (task, split): windows
    [i * step, i * step + pred_len) (step = pred_len on the test split),
    z-scored with train-split statistics, with the task's labels:
    anomalies injected into val and test (anomaly detection), jittered
    periodic boundaries (segmentation; as distances to the next one in
    ``steps-to-boundary`` mode) or piecewise-constant classes (semantic
    segmentation, ``datasets.synthetic.n_classes``, default 2).

    With ``datasets.synthetic.clips`` the series is ``n_clips`` (default 4)
    equal clips, the last taking the remainder (``clip_ids``), each with a
    patient description (``clip_descriptions``); the windows never cross a
    clip (``ClipWindows``), every item carries its clip's description, and a
    stitched series keeps the points of ``mask``."""

    description = "A synthetic sinusoid-mixture dataset used for testing."
    univariate = False

    def __init__(self, config, split: str):
        self.task = config.task
        if config.data.dataset != "synthetic":
            raise NotImplementedError(
                f"dataset {config.data.dataset!r}: the port reads the synthetic family "
                "(ROADMAP queue 1, \"The file readers\")")
        if config.data.mode != "multivariate" or config.data.cols != "all":
            raise NotImplementedError("the port reads multivariate, all-column data "
                                      "(ROADMAP queue 1, \"MedTsLLM's remaining modes\")")
        ds = config.get("datasets", {}).get("synthetic", {})
        if config.history_len != config.pred_len:
            raise ValueError(f"{self.task} requires history_len == pred_len")
        self.task_config = config.get("tasks", {}).get(self.task, {})
        self.dataset_config = ds
        self.split = split
        self.pred_len = config.pred_len
        self.step_size = config.pred_len if split == "test" else config.data.step
        got = self.generate(split)
        data = got["data"]
        if config.data.normalize:
            train = data if split == "train" else self.generate("train")["data"]
            mean, std = train.mean(axis=0), train.std(axis=0)
            data = (data - mean) / np.where(std == 0.0, 1.0, std)
        self.data = data.astype(np.float32)
        self.labels = got.get("labels")
        if self.labels is not None:
            n_labels = len(np.unique(self.labels))
            self.labels = self.labels.astype(np.int64 if n_labels > 2 else np.int32)
        self.clip_ids = got.get("clip_ids")
        self.clip_descriptions = got.get("clip_descriptions")
        if self.clip_ids is not None:
            self.clip_ids = self.clip_ids.astype(np.int32)
        # clip windows for every task but forecasting, which the port lacks
        self.clip_dataset = self.clip_ids is not None and self.task != "forecasting"
        if self.task == "segmentation":
            mode = self.task_config.mode
            if mode == "steps-to-boundary":
                self.labels = steps_to_boundary_labels(self.labels)
            elif mode != "boundary-prediction":
                raise ValueError(f"Segmentation mode {mode} not supported")
        if self.clip_dataset:
            self.windows = ClipWindows(self.clip_ids, self.pred_len, self.step_size)
            self._len = len(self.windows)
        else:
            self._len = max(0, (self.n_points - self.pred_len) // self.step_size + 1)

    def generate(self, split: str) -> dict:
        n = int(self.dataset_config.get("n_points", 2048))
        C = int(self.dataset_config.get("n_features", 3))
        rng = rng_for("synthetic:synthetic", split)
        data = sine_mixture(rng, n, C, period_range=(16, 256), noise=0.1)
        out = {"data": data}
        if self.task == "anomaly_detection":
            if split != "train":
                out["data"], out["labels"] = inject_anomalies(rng, data, rate=0.05)
        elif self.task == "segmentation":
            out["labels"] = periodic_boundaries(rng, n, mean_period=100)
        elif self.task == "semantic_segmentation":
            out["labels"] = segment_class_labels(rng, n, self.n_classes, mean_seg=64)
        if self.dataset_config.get("clips", False):
            n_clips = int(self.dataset_config.get("n_clips", 4))
            ids = np.repeat(np.arange(n_clips), n // n_clips)
            out["clip_ids"] = np.pad(ids, (0, n - len(ids)), constant_values=n_clips - 1)
            out["clip_descriptions"] = patient_descriptions(out["clip_ids"])
        return out

    def __len__(self) -> int:
        return self._len

    @property
    def n_points(self) -> int:
        return self.data.shape[0]

    @property
    def n_features(self) -> int:
        return self.data.shape[1]

    real_features = n_features

    @property
    def n_classes(self) -> int:
        if self.task == "semantic_segmentation":
            return int(self.dataset_config.get("n_classes", 2))
        return 0

    @property
    def mask(self) -> np.ndarray:
        return self.windows.mask

    def x_starts(self, idx) -> np.ndarray:
        if self.clip_dataset:
            return self.windows.x_starts(idx)
        return np.asarray(idx) * self.step_size

    def __getitem__(self, idx: int) -> dict:
        s = int(self.x_starts(int(idx)))
        out = {"x_enc": self.data[s:s + self.pred_len]}
        if self.labels is not None:
            out["labels"] = self.labels[s:s + self.pred_len]
        if self.clip_descriptions is not None:
            out["descriptions"] = self.clip_descriptions[int(self.clip_ids[s])]
        return out


class BatchPipeline:
    """Fixed-shape batches: the final batch is padded by repeating its last
    window, with ``valid`` marking the real rows. In index order, or with
    ``shuffle`` in an order drawn anew each epoch from one
    ``np.random.default_rng(seed)``, the JAX pipeline's draws. The
    ``ARRAY_KEYS`` are stacked; the rest (``descriptions``) stay lists."""

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
            items = [self.dataset[j] for j in idx]
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


def stitch_windows(values: np.ndarray, starts: np.ndarray, n_points: int,
                   n_channels: int | None = None, features: np.ndarray | None = None,
                   fill=np.nan) -> np.ndarray:
    """Scatter per-window values [W, L] or [W, L, C] into one series [n_points]
    (``n_channels`` None) or [n_points, n_channels]; with ``features`` [W]
    each window fills its own channel. Later windows overwrite earlier ones;
    uncovered points keep ``fill``."""
    starts = np.asarray(starts)
    shape = (n_points,) if n_channels is None else (n_points, n_channels)
    out = np.full(shape, fill, dtype=np.float32)
    if len(starts) == 0:
        return out
    time_idx = starts[:, None] + np.arange(values.shape[1])[None, :]
    if n_channels is None:
        out[time_idx.ravel()] = values.reshape(-1)
    elif features is not None:
        feat_idx = np.broadcast_to(np.asarray(features)[:, None], time_idx.shape)
        out[time_idx.ravel(), feat_idx.ravel()] = values.reshape(-1)
    else:
        out[time_idx.ravel()] = values.reshape(time_idx.size, -1)
    return out


def dedup_eval_series(arr: np.ndarray, step: int, pred_len: int) -> np.ndarray:
    """step > pred_len: cut to a multiple of step, then keep the first
    pred_len points of every step-sized block."""
    arr = arr[:arr.shape[0] - arr.shape[0] % step]
    return arr.reshape(-1, step, *arr.shape[1:])[:, :pred_len].reshape(-1, *arr.shape[1:])
