"""Multi-model ensembling over stored predictions (port of
``med_tpu.eval.ensemble``; reference ensemble.ipynb), in numpy as there.

- ``soft_vote``: average the positive-class probabilities of two runs and
  threshold at 0.5 (cell 6: video-CNN + kinematics-CNN), in float64;
- ``cascade_ensemble``: a binary model gates a multi-class model: windows
  the binary stage predicts clean are class 0, otherwise the multi-class
  prediction stands (cell 15: binary COG -> multiclass COG);
- ``reconcile_nd``: a binary run that kept Needle-Drop-only rows, cut to
  the rows of a multiclass run that dropped them;
- ``score_predictions``: metrics and confusion matrix of a prediction dump.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..data.labels import powerset_error_labels
from ..ops.metrics import metrics_from_cm


def soft_vote(probs_a: np.ndarray, probs_b: np.ndarray, threshold: float = 0.5):
    """(p_a + p_b)/2 >= threshold."""
    p = (np.asarray(probs_a, np.float64) + np.asarray(probs_b, np.float64)) / 2
    return (p >= threshold).astype(np.int64), p


def cascade_ensemble(binary_preds: np.ndarray, multiclass_preds: np.ndarray):
    """binary==1 ? multiclass : 0 (reference ensemble.ipynb cell 15)."""
    b = np.asarray(binary_preds).astype(np.int64)
    m = np.asarray(multiclass_preds).astype(np.int64)
    return np.where(b == 1, m, 0)


def reconcile_nd(dump_binary: Dict, dump_multiclass: Dict) -> Dict:
    """Align a ``delete_ND=False`` binary run's dump onto a ``delete_ND=True``
    multiclass run's rows (reference ensemble.ipynb cell 15 "Pre i-iv").

    The drop mask is recomputed from the binary dump's raw 5-column labels
    by the powerset rule (``powerset_error_labels(..., delete_ND=True)``):
    it marks the rows whose only error is Needle-Drop, which the multiclass
    run's loader deleted. Returns a new binary dump cut to the remaining
    rows; raises ``ValueError`` when the dump has no raw labels or the
    remaining rows do not number the multiclass run's."""
    raw = dump_binary.get("raw_labels")
    if raw is None:
        raise ValueError(
            "cannot reconcile ND-dropped runs: the binary dump carries no "
            "raw_labels to recompute the Needle-Drop mask from"
        )
    _, nd_mask = powerset_error_labels(np.asarray(raw), delete_ND=True)
    keep = ~nd_mask
    n_mc = len(np.asarray(dump_multiclass["preds"]))
    if int(keep.sum()) != n_mc:
        raise ValueError(
            f"ND reconciliation failed: binary run keeps {int(keep.sum())} "
            f"rows after dropping Needle-Drop-only rows but the multiclass "
            f"run has {n_mc}"
        )
    out = dict(dump_binary)
    for key in ("preds", "probs", "labels", "raw_labels", "gestures", "subjects"):
        v = dump_binary.get(key)
        if v is not None and len(v) == len(keep):
            out[key] = np.asarray(v)[keep]
    return out


def score_predictions(labels: np.ndarray, preds: np.ndarray, n_classes: int,
                      average: str) -> Tuple[Dict[str, float], np.ndarray]:
    """(metrics, confusion matrix) of ``preds`` against ``labels``; the
    matrix counted by one ``np.bincount`` over label * n + pred."""
    y = np.asarray(labels).astype(int).reshape(-1)
    p = np.asarray(preds).astype(int).reshape(-1)
    cm = np.bincount(y * n_classes + p, minlength=n_classes * n_classes)
    cm = cm.reshape(n_classes, n_classes).astype(np.int64)
    return metrics_from_cm(cm, average), cm
