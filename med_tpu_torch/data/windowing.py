"""Window scan over per-subject, per-gesture frame runs: the window
families' windows, and frame predictions rolled up to windows (the port's
copy of ``med_tpu.data.windowing``).

Windowing rules (reference MED/dataset/dataset_utils.py:161-258):

- windows never cross subjects (trials); the frame stream is grouped by the
  subject column, preserving first-appearance order;
- within a subject, scanning starts at the first frame whose gesture label is
  non-zero;
- a window of ``window_size`` frames is emitted only when the gesture at its
  first and last frame match; on mismatch the start advances by 1, on
  emission by ``stride``;
- scanning stops when ``start >= n_frames_subject - window_size``;
- window labels are taken from the window's first frame.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def window_scan(
    gestures: np.ndarray, window_size: int, stride: int
) -> np.ndarray:
    """Return emitted window start indices for one subject's gesture vector.

    ``gestures`` is the (T,) per-frame gesture-label vector of a single
    subject. Implements the reference's while-loop semantics
    (dataset_utils.py:214-239) exactly.
    """
    g = np.ascontiguousarray(np.asarray(gestures).reshape(-1), dtype=np.int32)
    n = g.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)

    nz = np.flatnonzero(g)
    if nz.size == 0:
        return np.empty(0, dtype=np.int64)
    start = int(nz[0])

    starts: List[int] = []
    while start < n - window_size:
        end = start + window_size
        if g[start] != g[end - 1]:
            start += 1
            continue
        starts.append(start)
        start += stride
    return np.asarray(starts, dtype=np.int64)


def subject_runs(subjects: Sequence[str]) -> List[Tuple[str, np.ndarray]]:
    """Group frame indices by subject, preserving first-appearance order
    (reference dataset_utils.py:193-194 uses pandas ``unique`` + index masks;
    frames of a subject are contiguous but we match the general behavior)."""
    arr = np.asarray(subjects)
    order: List[str] = []
    seen = set()
    for s in arr:
        if s not in seen:
            seen.add(s)
            order.append(s)
    return [(s, np.flatnonzero(arr == s)) for s in order]


def window_data(
    image_data: np.ndarray,
    kinematics_data: np.ndarray,
    g_labels: np.ndarray,
    e_labels: np.ndarray,
    subjects: Sequence[str],
    window_size: int = 10,
    stride: int = 6,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Window a whole fold's frame stream: ``(image_windows (N, W, 2048),
    kinematics_windows (N, W, 26), g_labels_windows (N, 1),
    e_labels_windows (N, C), subject_windows (N,))``, labels from each
    window's first frame (reference dataset_utils.py:161-258)."""
    g = np.asarray(g_labels).reshape(-1)
    all_starts: List[np.ndarray] = []
    all_subjects: List[str] = []
    for subject, idx in subject_runs(subjects):
        starts_local = window_scan(g[idx], window_size, stride)
        if starts_local.size:
            all_starts.append(idx[starts_local])
            all_subjects.extend([subject] * len(starts_local))

    if not all_starts:
        feat_i = image_data.shape[-1] if image_data is not None else 0
        return (
            np.empty((0, window_size, feat_i), dtype=np.float32),
            np.empty((0, window_size, kinematics_data.shape[-1]), dtype=np.float32),
            np.empty((0, 1), dtype=np.int64),
            np.empty((0,) + np.asarray(e_labels).shape[1:], dtype=e_labels.dtype),
            np.empty((0,), dtype=object),
        )

    starts = np.concatenate(all_starts)
    gather = starts[:, None] + np.arange(window_size)[None, :]
    image_windows = np.asarray(image_data)[gather]
    kinematics_windows = np.asarray(kinematics_data)[gather]
    g_windows = g[starts].reshape(-1, 1).astype(np.int64)
    e_windows = np.asarray(e_labels)[starts]
    subject_windows = np.asarray(all_subjects, dtype=object)
    return image_windows, kinematics_windows, g_windows, e_windows, subject_windows


def window_predictions(
    predictions: np.ndarray,
    e_labels: np.ndarray,
    gestures: np.ndarray,
    subjects: Sequence[str],
    window_size: int = 10,
    stride: int = 6,
    binary: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Roll frame-level predictions up to window level using the same scan
    rules, mean-pooling predictions within the window (threshold 0.5 for
    binary, round for multi-class) and taking labels from the window start
    (reference modeling_utils.py:2695-2777)."""
    preds = np.asarray(predictions, dtype=np.float64).reshape(-1)
    labels = np.asarray(e_labels).reshape(-1)
    g = np.asarray(gestures).reshape(-1)

    out_preds: List[float] = []
    out_labels: List[float] = []
    out_gestures: List[float] = []
    out_subjects: List[str] = []
    for subject, idx in subject_runs(subjects):
        starts_local = window_scan(g[idx], window_size, stride)
        for s in starts_local:
            sl = idx[s : s + window_size]
            m = preds[sl].mean()
            if binary:
                m = 1.0 if m >= 0.5 else 0.0
            else:
                m = float(np.round(m))
            out_preds.append(m)
            out_labels.append(labels[idx[s]])
            out_gestures.append(g[idx[s]])
            out_subjects.append(subject)

    return (
        np.asarray(out_preds).reshape(-1, 1),
        np.asarray(out_labels).reshape(-1, 1),
        np.asarray(out_gestures).reshape(-1, 1),
        np.asarray(out_subjects, dtype=object),
    )
