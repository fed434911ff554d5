"""Deterministic synthetic series (a copy of ``medtsllm_tpu/data/synthetic.py``):
the stand-ins each dataset family generates when its files are absent,
seeded per (family, split) so the train split's normalisation statistics
are the same from any split, and the same arrays as the JAX package's."""

from __future__ import annotations

import zlib

import numpy as np


def rng_for(family: str, split: str = "") -> np.random.Generator:
    # crc32, not hash(): Python's string hash is salted per process
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


def clip_series(rng, n_clips: int, clip_len: int, n_features: int,
                clip_id_fn=lambda i: i, **sine_kw):
    """Per-clip series one after another; returns (data, clip_ids)."""
    datas, ids = [], []
    for i in range(n_clips):
        datas.append(sine_mixture(rng, clip_len, n_features, **sine_kw))
        ids.append(np.full(clip_len, clip_id_fn(i), dtype=np.int64))
    return np.concatenate(datas, axis=0), np.concatenate(ids)


def patient_descriptions(ids, prefix="Patient description") -> dict:
    return {int(i): f"{prefix}: synthetic subject {int(i)} with stable vitals."
            for i in np.unique(ids)}
