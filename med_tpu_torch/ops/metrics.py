"""Classification metrics (port of ``med_tpu.ops.metrics``).

The train and eval steps build integer confusion matrices on the device; the
epoch loop stacks them and brings them to the host once per epoch, where
:func:`metrics_from_cm` derives sklearn's F1 / accuracy / Jaccard.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor, n_classes: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, C) int32 confusion matrix, rows = true class, cols = predicted
    class, as a one-hot contraction; ``mask`` zeroes out padded examples."""
    eye = torch.eye(n_classes, dtype=torch.float32, device=labels.device)
    lab_oh = eye[labels.reshape(-1).long()]
    pred_oh = eye[preds.reshape(-1).long()]
    if mask is not None:
        lab_oh = lab_oh * mask.reshape(-1, 1).to(torch.float32)
    return torch.einsum("nc,nd->cd", lab_oh, pred_oh).to(torch.int32)


def metrics_from_cm(cm: np.ndarray, average: str = "binary") -> Dict[str, float]:
    """F1 / accuracy / Jaccard from a confusion matrix.

    ``average``: 'binary' (positive class = 1), 'macro', 'weighted'.
    Matches sklearn: zero-division yields 0; macro/weighted average over
    labels present in y_true or y_pred (sklearn's default label set).
    """
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    acc = float(np.trace(cm) / total) if total else 0.0

    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
        jaccard = np.where(tp + fp + fn > 0, tp / (tp + fp + fn), 0.0)

    if average == "binary":
        return {"f1": float(f1[1]), "accuracy": acc, "jaccard": float(jaccard[1])}

    support = cm.sum(axis=1)
    present = (support > 0) | (cm.sum(axis=0) > 0)
    if not present.any():
        return {"f1": 0.0, "accuracy": acc, "jaccard": 0.0}
    if average == "macro":
        return {"f1": float(f1[present].mean()), "accuracy": acc,
                "jaccard": float(jaccard[present].mean())}
    if average == "weighted":
        w = support[present]
        wsum = w.sum()
        if wsum == 0:
            return {"f1": 0.0, "accuracy": acc, "jaccard": 0.0}
        return {"f1": float((f1[present] * w).sum() / wsum), "accuracy": acc,
                "jaccard": float((jaccard[present] * w).sum() / wsum)}
    raise ValueError(f"unknown average {average!r}")


def f1_from_cm(cm: np.ndarray, average: str = "binary") -> float:
    return metrics_from_cm(cm, average)["f1"]


def f1_from_cm_device(cm: torch.Tensor, average: str = "binary") -> torch.Tensor:
    """Tensor twin of :func:`f1_from_cm` (same definitions), for selection on
    the device; counts stay int32 and only the ratios are float32."""
    cm = cm.to(torch.int32)
    tp_i = torch.diagonal(cm)
    fp_i = cm.sum(dim=0) - tp_i
    fn_i = cm.sum(dim=1) - tp_i
    tp, fp, fn = (a.to(torch.float32) for a in (tp_i, fp_i, fn_i))
    zero = torch.zeros_like(tp)
    precision = torch.where(tp_i + fp_i > 0, tp / torch.clamp(tp + fp, min=1), zero)
    recall = torch.where(tp_i + fn_i > 0, tp / torch.clamp(tp + fn, min=1), zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / torch.clamp(precision + recall, min=1e-30),
                     zero)
    if average == "binary":
        return f1[1]
    support = cm.sum(dim=1)
    present = (support > 0) | (cm.sum(dim=0) > 0)
    if average == "macro":
        n_present = torch.clamp(present.to(torch.float32).sum(), min=1.0)
        return torch.where(present, f1, zero).sum() / n_present
    if average == "weighted":
        w = torch.where(present, support.to(torch.float32), zero)
        return (f1 * w).sum() / torch.clamp(w.sum(), min=1e-30)
    raise ValueError(f"unknown average {average!r}")
