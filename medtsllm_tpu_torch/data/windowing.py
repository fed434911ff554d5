"""Window index math (a copy of ``medtsllm_tpu/data/windowing.py``):
forecasting, aligned, clip and univariate windows as vectorised start
positions, the steps-to-boundary labels, the stitching of per-window
values into one series and the step > pred_len de-duplication."""

from __future__ import annotations

import numpy as np


class ForecastWindows:
    """Forecasting windows: x = [s, s + hist), y = [s + hist, s + hist +
    pred) at s = i * step, ``(n - hist - pred + 1) // step`` of them."""

    def __init__(self, n_points: int, history_len: int, pred_len: int, step: int):
        self.step = step
        self._len = max(0, (n_points - history_len - pred_len + 1) // step)

    def __len__(self) -> int:
        return self._len

    def x_starts(self, idx) -> np.ndarray:
        return np.asarray(idx) * self.step


class AlignedWindows:
    """Input and target over the same range [s, s + pred) at s = i * step
    (reconstruction, anomaly detection, both segmentations,
    classification, imputation): ``(n - pred) // step + 1`` of them."""

    def __init__(self, n_points: int, pred_len: int, step: int):
        self.step = step
        self._len = max(0, (n_points - pred_len) // step + 1)

    def __len__(self) -> int:
        return self._len

    def x_starts(self, idx) -> np.ndarray:
        return np.asarray(idx) * self.step


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


class UnivariateWindows:
    """A C-feature dataset's windows as C x len(base) one-feature windows:
    window w of feature f has the flat index w * C + f."""

    def __init__(self, base, n_features: int):
        self.base = base
        self.n_features = n_features

    def __len__(self) -> int:
        return len(self.base) * self.n_features

    def x_starts(self, idx) -> np.ndarray:
        return self.base.x_starts(np.asarray(idx) // self.n_features)

    def features(self, idx) -> np.ndarray:
        return np.asarray(idx) % self.n_features

    @property
    def mask(self) -> np.ndarray:
        return self.base.mask


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
