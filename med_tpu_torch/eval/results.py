"""Cross-run result analysis (port of ``med_tpu.eval.results``; reference
notebooks/results.ipynb, modeling_utils.py:2377-2692), over the best-model
prediction dumps that both packages write into a run's ``artifacts/``:

- per-fold and weighted cross-fold metric tables for any set of runs;
- per-error-type F1 of a binary model (results.ipynb cells 8/12);
- majority-class baselines (cells 23-26);
- paired t-tests between configurations (cells 14-22);
- alignment checks, prediction overlap and probability histograms of two
  runs (ensemble.ipynb).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import RAW_ERROR_COLUMNS
from ..tracking import RunTracker
from .ensemble import score_predictions
from .summary import weighted_mean_std


def load_run_dumps(runs_root: str, run_id: str, setting: str,
                   folds: Sequence[str]) -> Dict[str, dict]:
    run_dir = RunTracker.find_run(runs_root, run_id)
    out = {}
    for fold in folds:
        with open(os.path.join(run_dir, "artifacts",
                               f"best_model_{setting}_{fold}.json")) as f:
            out[fold] = json.load(f)
    return out


def per_error_type_f1(fold_dumps: Dict[str, dict]) -> Dict[str, Tuple[float, float]]:
    """Binary predictions scored against each raw error column, weighted
    mean ± std across folds (results.ipynb cell 8)."""
    per_col: Dict[str, List[float]] = {c: [] for c in RAW_ERROR_COLUMNS}
    weights = []
    for d in fold_dumps.values():
        raw = np.asarray(d["raw_labels"])
        preds_binary = (np.asarray(d["preds"]).astype(int) > 0).astype(int)
        weights.append(len(preds_binary))
        for c, name in enumerate(RAW_ERROR_COLUMNS):
            m, _ = score_predictions(raw[:, c], preds_binary, 2, "binary")
            per_col[name].append(m["f1"])
    return {name: weighted_mean_std(vals, weights) for name, vals in per_col.items()}


def majority_baseline(fold_dumps: Dict[str, dict], n_classes: int = 2,
                      average: str = "binary") -> Dict[str, Tuple[float, float]]:
    """Always-predict-the-majority-class baseline (results.ipynb cells
    23-26)."""
    f1s, accs, weights = [], [], []
    for d in fold_dumps.values():
        y = np.asarray(d["labels"]).astype(int)
        maj = np.bincount(y, minlength=n_classes).argmax()
        m, _ = score_predictions(y, np.full_like(y, maj), n_classes, average)
        f1s.append(m["f1"])
        accs.append(m["accuracy"])
        weights.append(len(y))
    return {"f1": weighted_mean_std(f1s, weights),
            "accuracy": weighted_mean_std(accs, weights)}


def paired_t_test(per_fold_a: Sequence[float], per_fold_b: Sequence[float]):
    """Paired t-test over per-fold metrics (results.ipynb cells 14-22).
    Returns (t statistic, p value)."""
    from scipy import stats

    t, p = stats.ttest_rel(np.asarray(per_fold_a), np.asarray(per_fold_b))
    return float(t), float(p)


def model_comparison_table(runs: Dict[str, Tuple[str, str]], runs_root: str,
                           setting: str, folds: Sequence[str],
                           average: str = "binary",
                           n_classes: int = 2) -> Dict[str, Dict[str, str]]:
    """rows: '<model> / <modality>' -> weighted F1/Acc/Jaccard strings,
    recomputed from the stored prediction dumps (results.ipynb cells 1-2)."""
    table = {}
    for label, (run_id, _) in runs.items():
        dumps = load_run_dumps(runs_root, run_id, setting, folds)
        f1s, accs, jacs, weights = [], [], [], []
        for d in dumps.values():
            y = np.asarray(d["labels"]).astype(int)
            m, _ = score_predictions(y, np.asarray(d["preds"]).astype(int),
                                     n_classes, average)
            f1s.append(m["f1"])
            accs.append(m["accuracy"])
            jacs.append(m["jaccard"])
            weights.append(len(y))
        row = {}
        for name, vals in (("F1", f1s), ("Accuracy", accs), ("Jaccard", jacs)):
            mu, sd = weighted_mean_std(vals, weights)
            row[name] = f"{mu:.3f} ± {sd:.3f}"
        table[label] = row
    return table


def check_run_alignment(dumps_a: Dict[str, dict], dumps_b: Dict[str, dict]) -> None:
    """Raise ``ValueError`` unless two runs' dumps are positionally aligned:
    the same subjects, gestures and labels fold by fold (reference
    ensemble.ipynb cells 4-5)."""
    for fold in dumps_a:
        if fold not in dumps_b:
            raise ValueError(f"fold {fold} missing from second run")
        a, b = dumps_a[fold], dumps_b[fold]
        for key in ("subjects", "gestures", "labels"):
            va, vb = a.get(key), b.get(key)
            if va is None or vb is None:
                continue
            if len(va) != len(vb) or list(map(str, va)) != list(map(str, vb)):
                raise ValueError(
                    f"fold {fold}: {key} differ between runs — the dumps are "
                    f"not positionally aligned"
                )


def prediction_overlap(dumps_a: Dict[str, dict], dumps_b: Dict[str, dict]) -> dict:
    """Error-overlap analysis between two binary runs (ensemble.ipynb
    overlap cells): fractions of windows both get right, only one gets
    right, and both miss."""
    both_right = one_right = both_wrong = total = 0
    for fold in dumps_a:
        y = np.asarray(dumps_a[fold]["labels"]).astype(int)
        ra = np.asarray(dumps_a[fold]["preds"]).astype(int) == y
        rb = np.asarray(dumps_b[fold]["preds"]).astype(int) == y
        both_right += int((ra & rb).sum())
        one_right += int((ra ^ rb).sum())
        both_wrong += int((~ra & ~rb).sum())
        total += len(y)
    return {"both_correct": both_right / total,
            "exactly_one_correct": one_right / total,
            "both_wrong": both_wrong / total,
            "n": total}


def probability_histograms(dumps: Dict[str, dict], image_path: str,
                           bins: int = 20) -> str:
    """Positive-class probability distributions split by true label
    (ensemble.ipynb probability-distribution plots)."""
    from ..viz.utils import _plt

    plt = _plt()
    probs = np.concatenate([np.asarray(d["probs"], dtype=float).reshape(-1)
                            for d in dumps.values()])
    labels = np.concatenate([np.asarray(d["labels"]).astype(int).reshape(-1)
                             for d in dumps.values()])
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(probs[labels == 0], bins=bins, alpha=0.6, label="No Error", density=True)
    ax.hist(probs[labels == 1], bins=bins, alpha=0.6, label="Error", density=True)
    ax.set_xlabel("P(error)")
    ax.set_ylabel("density")
    ax.legend()
    fig.tight_layout()
    fig.savefig(image_path)
    plt.close(fig)
    return image_path
