"""Frame->window prediction rollup and windowed metrics (the port's copy of
``med_tpu.eval.rollup``: numpy only).

Reference ``frame2window`` / ``compute_window_metrics``
(modeling_utils.py:2780-2917): frame-level predictions of the frame models
are re-windowed with the same scan rules as training windows (mean-pool +
threshold/round) and scored per fold, then aggregated sample-weighted.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..data.windowing import window_predictions
from ..ops.metrics import metrics_from_cm
from .summary import weighted_mean_std


def frame_to_window(
    fold_dumps: Dict[str, dict],
    window_size: int = 10,
    stride: int = 6,
    binary: bool = True,
) -> Dict[str, dict]:
    """fold -> {'preds','labels','gestures','subjects'} frame dumps
    re-windowed per fold."""
    out = {}
    for fold, d in fold_dumps.items():
        pw, lw, gw, sw = window_predictions(
            d["preds"], d["labels"], d["gestures"], d["subjects"],
            window_size=window_size, stride=stride, binary=binary,
        )
        out[fold] = {"preds": pw, "labels": lw, "gestures": gw, "subjects": sw}
    return out


def compute_window_metrics(
    fold_dumps: Dict[str, dict],
    window_size: int = 10,
    stride: int = 6,
    binary: bool = True,
    n_classes: int = 2,
) -> Tuple[Dict[str, str], np.ndarray]:
    """Windowed F1/Acc/Jaccard, weighted mean ± std across folds + summed CM
    (reference modeling_utils.py:2828-2917)."""
    windowed = frame_to_window(fold_dumps, window_size, stride, binary)
    f1s, accs, jacs, cms, weights = [], [], [], [], []
    avg = "binary" if binary else "weighted"
    for fold, d in windowed.items():
        y = d["labels"].reshape(-1).astype(int)
        p = d["preds"].reshape(-1).astype(int)
        k = max(n_classes, y.max() + 1 if len(y) else 1, p.max() + 1 if len(p) else 1)
        cm = np.zeros((k, k), np.int64)
        for yi, pi in zip(y, p):
            cm[yi, pi] += 1
        m = metrics_from_cm(cm, avg)
        f1s.append(m["f1"])
        accs.append(m["accuracy"])
        jacs.append(m["jaccard"])
        cms.append(cm)
        weights.append(len(y))
    mf1, sf1 = weighted_mean_std(f1s, weights)
    ma, sa = weighted_mean_std(accs, weights)
    mj, sj = weighted_mean_std(jacs, weights)
    summary = {
        "F1": f"{mf1:.3f} ± {sf1:.3f}",
        "Accuracy": f"{ma:.3f} ± {sa:.3f}",
        "Jaccard": f"{mj:.3f} ± {sj:.3f}",
    }
    max_k = max(c.shape[0] for c in cms)
    total = np.zeros((max_k, max_k), np.int64)
    for c in cms:
        total[: c.shape[0], : c.shape[1]] += c
    return summary, total
