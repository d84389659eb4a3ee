"""Cross-fold summary statistics (the port's copy of
``med_tpu.eval.summary``: numpy only).

Reference ``create_summary_df`` (modeling_utils.py:2979-3025): per-metric
sample-weighted mean ± weighted std across the LOSO folds, plus plain
mean ± std for train time and inference rate.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def weighted_mean_std(values: Sequence[float], weights: Sequence[float]) -> Tuple[float, float]:
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    mean = np.average(v, weights=w)
    std = np.average((v - mean) ** 2, weights=w) ** 0.5
    return float(mean), float(std)


def create_summary(
    fold_results: Dict[str, dict],
    samples_train: Dict[str, int],
    samples_test: Dict[str, int],
) -> Dict[str, Dict[str, str]]:
    """Train/Test x {F1, Accuracy, Jaccard, Train Time, Inference Rate}
    formatted as 'mean ± std' strings, mirroring the reference table."""
    folds = list(fold_results)
    w_tr = [samples_train[f] for f in folds]
    w_te = [samples_test[f] for f in folds]

    def wrow(key, weights, split):
        vals = [fold_results[f][f"{split}_{key}"] for f in folds]
        m, s = weighted_mean_std(vals, weights)
        return f"{m:.3f} ± {s:.3f}"

    train_times = [fold_results[f].get("train_time", np.nan) for f in folds]
    inf_keys = [k for k in fold_results[folds[0]] if k.startswith("test_inference")]
    inf_rates = (
        [fold_results[f][inf_keys[0]] for f in folds] if inf_keys else [np.nan]
    )
    return {
        "Train": {
            "F1": wrow("f1", w_tr, "train"),
            "Accuracy": wrow("acc", w_tr, "train"),
            "Jaccard": wrow("jaccard", w_tr, "train"),
            "Train Time": f"{np.mean(train_times):.2f} ± {np.std(train_times):.2f}",
            "Inference Rate": "",
        },
        "Test": {
            "F1": wrow("f1", w_te, "test"),
            "Accuracy": wrow("acc", w_te, "test"),
            "Jaccard": wrow("jaccard", w_te, "test"),
            "Train Time": "",
            "Inference Rate": f"{np.mean(inf_rates):.3f} ± {np.std(inf_rates):.3f}",
        },
    }


def summary_to_text(summary: Dict[str, Dict[str, str]]) -> str:
    cols = ["F1", "Accuracy", "Jaccard", "Train Time", "Inference Rate"]
    lines = ["\t" + "\t".join(cols)]
    for row in ("Train", "Test"):
        lines.append(row + "\t" + "\t".join(summary[row][c] for c in cols))
    return "\n".join(lines)
