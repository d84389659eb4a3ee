"""Siamese pair construction and materialization, in numpy (port of
``med_tpu.data.siamese``; reference ``create_siamese_pairs`` /
``load_siamese_pairs``, dataset_utils.py:282-353, 534-757):

- *train pairs*: every non-contiguous window pair (j >= i+2) from different
  subjects, different gestures, or different instances of the same gesture;
  label 0 = both clean, 1 = exactly one erroneous (both-erroneous skipped).
  ``med_tpu`` scans them in C++ where its native helper builds and in
  numpy otherwise; the port keeps the numpy scan, whose pairs are the same.
- *test pairs*: each test window paired with ``n_comparisons`` random clean
  training windows (majority vote at eval, modeling_utils.py:1180-1250).
- *balanced sampling*: n_pairs/2 per label with replacement.

Randomness is numpy's ``default_rng(seed)``, drawn in ``med_tpu``'s order,
so both packages build the same pairs from the same windows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _subject_ids(subjects) -> np.ndarray:
    arr = np.asarray(subjects)
    order: Dict[object, int] = {}
    out = np.empty(len(arr), np.int32)
    for i, s in enumerate(arr):
        out[i] = order.setdefault(s, len(order))
    return out


def _runs_and_changes(subj_ids: np.ndarray, gest: np.ndarray):
    """run id (new run on subject/gesture change) and W[j] = gesture changes
    since the start of j's subject segment."""
    n = len(gest)
    run = np.zeros(n, np.int64)
    seg = np.zeros(n, np.int64)
    w = np.zeros(n, np.int64)
    for j in range(1, n):
        subj_change = subj_ids[j] != subj_ids[j - 1]
        gest_change = gest[j] != gest[j - 1]
        run[j] = run[j - 1] + (1 if (subj_change or gest_change) else 0)
        seg[j] = seg[j - 1] + (1 if subj_change else 0)
        w[j] = 0 if subj_change else w[j - 1] + (1 if gest_change else 0)
    return run, seg, w


def create_train_pairs(
    g_labels: np.ndarray,
    e_binary: np.ndarray,
    subjects,
) -> Dict[str, np.ndarray]:
    """All valid training pairs with their instance bookkeeping.

    Returns dict of arrays: pos_1, pos_2, instance_1, instance_2, label,
    (+ subject/gesture columns resolvable from positions).
    """
    gest = np.asarray(g_labels).reshape(-1).astype(np.int32)
    err = np.asarray(e_binary).reshape(-1).astype(np.int32)
    subj = _subject_ids(subjects)
    return _train_pairs_numpy(gest, err, subj)


def _train_pairs_numpy(gest, err, subj) -> Dict[str, np.ndarray]:
    """The pair scan, vectorized over j for each i."""
    n = len(gest)
    run, seg, w = _runs_and_changes(subj, gest)
    # inst1[i]: resets on subject change, increments on gesture change == w
    inst1_arr = w.astype(np.int32)

    pos1l, pos2l, i1l, i2l, labl = [], [], [], [], []
    j_idx_all = np.arange(n)
    for i in range(n - 2):
        j = j_idx_all[i + 2 :]
        create = (subj[j] != subj[i]) | (gest[j] != gest[i]) | (run[j] != run[i])
        both_clean = (err[i] == 0) & (err[j] == 0)
        one_err = err[i] + err[j] == 1
        keep = create & (both_clean | one_err)
        jj = j[keep]
        if not len(jj):
            continue
        # instance_2 bookkeeping: starts at 1 at j=i+2, resets at subject
        # boundaries after that
        anchor = i + 2
        same_seg = seg[jj] == seg[anchor]
        inst2 = np.where(same_seg, w[jj] - w[anchor] + 1, w[jj]).astype(np.int32)
        pos1l.append(np.full(len(jj), i, np.int64))
        pos2l.append(jj.astype(np.int64))
        i1l.append(np.full(len(jj), inst1_arr[i], np.int32))
        i2l.append(inst2)
        labl.append(np.where(both_clean[keep], 0, 1).astype(np.int32))
    if not pos1l:
        empty = np.empty(0, np.int64)
        return {"position_1": empty, "position_2": empty,
                "instance_1": empty.astype(np.int32),
                "instance_2": empty.astype(np.int32),
                "label": empty.astype(np.int32)}
    return {
        "position_1": np.concatenate(pos1l),
        "position_2": np.concatenate(pos2l),
        "instance_1": np.concatenate(i1l),
        "instance_2": np.concatenate(i2l),
        "label": np.concatenate(labl),
    }


def create_test_pairs(
    g_labels_test: np.ndarray,
    e_binary_test: np.ndarray,
    subjects_test,
    e_binary_train: np.ndarray,
    n_comparisons: int = 20,
    seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Each test window vs ``n_comparisons`` random clean train windows
    (reference dataset_utils.py:674-737). position_1 indexes the train
    windows, position_2 the test windows."""
    err_te = np.asarray(e_binary_test).reshape(-1).astype(np.int32)
    clean_train = np.flatnonzero(np.asarray(e_binary_train).reshape(-1) == 0)
    rng = np.random.default_rng(seed)
    n_te = len(err_te)

    pos1l, pos2l, labl = [], [], []
    for i in range(n_te):
        if len(clean_train) < n_comparisons:
            continue
        chosen = clean_train[rng.permutation(len(clean_train))[:n_comparisons]]
        pos1l.append(chosen.astype(np.int64))
        pos2l.append(np.full(n_comparisons, i, np.int64))
        labl.append(np.full(n_comparisons, int(err_te[i] == 1), np.int32))
    if not pos1l:
        e = np.empty(0, np.int64)
        return {"position_1": e, "position_2": e, "label": e.astype(np.int32)}
    return {
        "position_1": np.concatenate(pos1l),
        "position_2": np.concatenate(pos2l),
        "label": np.concatenate(labl),
    }


def sample_balanced_pairs(
    pairs: Dict[str, np.ndarray], n_pairs: int, seed: int = 42
) -> Dict[str, np.ndarray]:
    """n_pairs/2 per label, sampled with replacement (reference
    dataset_utils.py:310-315)."""
    rng = np.random.default_rng(seed)
    lab = pairs["label"]
    sel = []
    for value in (0, 1):
        idx = np.flatnonzero(lab == value)
        if len(idx) == 0:
            continue
        sel.append(rng.choice(idx, size=n_pairs // 2, replace=True))
    sel = np.concatenate(sel)
    return {k: v[sel] for k, v in pairs.items()}


def materialize_pairs(
    pairs: Dict[str, np.ndarray],
    images_a: np.ndarray,
    kinematics_a: np.ndarray,
    images_b: Optional[np.ndarray] = None,
    kinematics_b: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather (P, 2, W, F) pair tensors (reference load_siamese_pairs,
    dataset_utils.py:322-353). For test pairs, side b = test arrays."""
    if images_b is None:
        images_b, kinematics_b = images_a, kinematics_a
    p1, p2 = pairs["position_1"], pairs["position_2"]
    img = np.stack([images_a[p1], images_b[p2]], axis=1)
    kin = np.stack([kinematics_a[p1], kinematics_b[p2]], axis=1)
    return img, kin, pairs["label"].astype(np.int64)


# ---------------------------------------------------------------- CSV interop
_PAIR_COLUMNS = (
    "subject_1", "gesture_label_1", "position_1", "instance_1",
    "subject_2", "gesture_label_2", "position_2", "instance_2", "label",
)


def save_pairs_csv(path: str, pairs: Dict[str, np.ndarray],
                   subjects, g_labels) -> None:
    """Write the reference's train_pairs.csv / test_pairs_{n}.csv layout
    (dataset_utils.py:654-665): subject/gesture columns resolved from the
    window positions."""
    subjects = np.asarray(subjects)
    g = np.asarray(g_labels).reshape(-1)
    p1, p2 = pairs["position_1"], pairs["position_2"]
    inst1 = pairs.get("instance_1", np.zeros(len(p1), np.int32))
    inst2 = pairs.get("instance_2", np.zeros(len(p1), np.int32))
    with open(path, "w") as f:
        f.write(",".join(_PAIR_COLUMNS) + "\n")
        for k in range(len(p1)):
            f.write(
                f"{subjects[p1[k]]},{g[p1[k]]},{p1[k]},{inst1[k]},"
                f"{subjects[p2[k]]},{g[p2[k]]},{p2[k]},{inst2[k]},"
                f"{pairs['label'][k]}\n"
            )


def load_pairs_csv(path: str) -> Dict[str, np.ndarray]:
    """Read reference-format pair CSVs back into the pairs dict."""
    import csv

    rows = {"position_1": [], "position_2": [], "instance_1": [],
            "instance_2": [], "label": []}
    with open(path) as f:
        for row in csv.DictReader(f):
            rows["position_1"].append(int(row["position_1"]))
            rows["position_2"].append(int(row["position_2"]))
            rows["instance_1"].append(int(row.get("instance_1", 0) or 0))
            rows["instance_2"].append(int(row.get("instance_2", 0) or 0))
            rows["label"].append(int(row["label"]))
    return {
        "position_1": np.asarray(rows["position_1"], np.int64),
        "position_2": np.asarray(rows["position_2"], np.int64),
        "instance_1": np.asarray(rows["instance_1"], np.int32),
        "instance_2": np.asarray(rows["instance_2"], np.int32),
        "label": np.asarray(rows["label"], np.int32),
    }
