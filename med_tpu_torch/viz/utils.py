"""Training-curve and confusion-matrix plots (port of
``med_tpu.viz.utils``, the same figures pixel for pixel).

Reference MED/visualization/utils.py:9-107: per-fold F1/loss curves and
train/test confusion-matrix heatmaps with the powerset class labels. Uses
matplotlib's Agg backend (headless) and plain mathtext (no TeX dependency),
imported inside the plotting calls, so the module imports without it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

BINARY_LABELS = ["No Error", "Error"]
POWERSET_LABELS = ["No Error", "OOV", "MA", "NP", "OOV + MA", "MA + NP"]
SPECIFIC_LABELS = ["OOV", "MA", "NP", "OOV + MA", "MA + NP"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_results_LOSO(
    train_f1: Sequence[float],
    test_f1: Sequence[float],
    train_loss: Sequence[float],
    test_loss: Sequence[float],
    setting: str,
    out: str,
    image_folder: str,
) -> str:
    plt = _plt()
    os.makedirs(image_folder, exist_ok=True)
    fig = plt.figure(figsize=(10, 6))
    ax = fig.add_subplot(2, 2, 1)
    ax.plot(train_f1, label="Train F1", marker="o")
    ax.plot(test_f1, label="Test F1", marker="o")
    ax.set_title(f"{setting} - Fold {out} - F1 Score")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("F1 Score")
    ax.legend()
    ax = fig.add_subplot(2, 2, 2)
    ax.plot(train_loss, label="Train Loss", marker="o")
    ax.plot(test_loss, label="Test Loss", marker="o")
    ax.set_title(f"{setting} - Fold {out} - Loss")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.legend()
    fig.tight_layout()
    path = os.path.join(image_folder, f"{setting}_fold_{out}_results.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def _plot_one_cm(cm: np.ndarray, labels: List[str], title: str, path: str):
    plt = _plt()
    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(max(6, len(labels) * 1.4),) * 2)
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(labels)), labels, rotation=45, fontsize=11)
    ax.set_yticks(range(len(labels)), labels, fontsize=11)
    ax.set_xlabel("Predicted label")
    ax.set_ylabel("True label")
    thresh = cm.max() / 2 if cm.max() else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:d}", ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_title(title, fontsize=16)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_cm(
    cm_train: np.ndarray,
    cm_test: np.ndarray,
    image_folder: str,
    binary: Optional[str] = None,
    labels: Optional[List[str]] = None,
) -> List[str]:
    os.makedirs(image_folder, exist_ok=True)
    paths = []
    for split, cm in (("Train", cm_train), ("Test", cm_test)):
        if cm is None:
            continue
        cm = np.asarray(cm)
        if binary:
            lab = BINARY_LABELS
            title = f"Confusion Matrix - {split} - {binary}"
            path = os.path.join(
                image_folder, f"LOSO_{split}_Confusion_Matrix_{binary}.png"
            )
        else:
            lab = labels or (
                POWERSET_LABELS if cm.shape[0] == 6 else SPECIFIC_LABELS
            )
            title = f"Confusion Matrix - {split}"
            path = os.path.join(image_folder, f"LOSO_{split}_Confusion_Matrix.png")
        _plot_one_cm(cm, lab[: cm.shape[0]], title, path)
        paths.append(path)
    return paths
