"""Window scan over per-subject, per-gesture frame runs, for rolling frame
predictions up to windows (the port's copy of the part of
``med_tpu.data.windowing`` that the frame driver's report needs).

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
