"""Host-side eval post-processing on numpy arrays (port of
``medtsllm_tpu/tasks/postproc.py``): the point adjust of anomaly
detection, the moving average, segment IoUs, boundary points to segments,
score smoothing and quantile peaks.
"""

from __future__ import annotations

import math

import numpy as np


def adjust_anomalies(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Point adjust: every ground-truth anomaly segment that holds at least
    one predicted point is marked predicted throughout. The JAX package's
    numpy path, its index-0 quirk included: the reference's backward fill
    never visits index 0, so a segment that starts at 0 keeps pred[0]."""
    pred = np.asarray(pred).astype(np.int32)
    g = np.asarray(gt).astype(np.int32).astype(bool)
    rising = np.flatnonzero(np.diff(np.concatenate([[0], g.view(np.int8)])) == 1)
    if len(rising) == 0:
        return pred.astype(np.int64)
    seg_id = np.cumsum(np.concatenate([[0], np.diff(g.astype(np.int8)) == 1]))
    hit = pred.astype(bool) & g
    seg_hit = np.zeros(seg_id.max() + 1, dtype=bool)
    np.maximum.at(seg_hit, seg_id[hit], True)
    adj = pred.astype(bool) | (g & seg_hit[seg_id])
    if g[0]:
        adj[0] = bool(pred[0])
    return adj.astype(np.int64)


def running_mean(xs: np.ndarray, window_size: int) -> np.ndarray:
    """Zero-padded 'same' moving average; an even window grows by one."""
    if window_size % 2 == 0:
        window_size += 1
    pad = window_size // 2
    return np.convolve(np.pad(xs, pad, mode="constant"), np.ones(window_size) / window_size,
                       mode="valid")


def all_pairs_iou(segments1: np.ndarray, segments2: np.ndarray) -> np.ndarray:
    """IoU of every pair of [start, end) segments: [n1, n2]."""
    s1, e1 = segments1[:, 0:1], segments1[:, 1:2]
    s2, e2 = segments2[None, :, 0], segments2[None, :, 1]
    inter = np.maximum(np.minimum(e1, e2) - np.maximum(s1, s2), 0)
    return inter / ((e1 - s1) + (e2 - s2) - inter)


def points_to_segments(points: np.ndarray, n: int) -> np.ndarray:
    """Boundary points -> consecutive [start, end) segments, the series'
    edges included."""
    pts = np.concatenate([[0], np.asarray(points, dtype=np.int64).ravel(), [n - 1]])
    return np.stack([pts[:-1], pts[1:]], axis=1)


def smooth_scores(pred_scores: np.ndarray, smoothing_window: int = 25,
                  smoothing_method: str = "mean") -> np.ndarray:
    """Edge-padded sliding mean or max; any other method returns the
    scores as they are."""
    if smoothing_method not in ("mean", "max"):
        return pred_scores
    lpad = math.floor((smoothing_window - 1) / 2)
    rpad = math.ceil((smoothing_window - 1) / 2)
    win = np.lib.stride_tricks.sliding_window_view(
        np.pad(pred_scores, (lpad, rpad), mode="edge"), smoothing_window)
    return win.mean(axis=-1) if smoothing_method == "mean" else win.max(axis=-1)


def find_peaks_threshold(pred_scores: np.ndarray, quantile: float = 0.5) -> np.ndarray:
    """The centres of the runs above the scores' ``quantile``."""
    above = (pred_scores > np.quantile(pred_scores, quantile)).astype(np.int64)
    edges = np.flatnonzero(np.diff(above))
    edges = edges[: (len(edges) // 2) * 2].reshape(-1, 2)
    return edges.mean(axis=1).astype(np.int64)
