"""Per-trial array files and fold loading (the port's copy of
``med_tpu.data.trials``: host-only numpy, the same files on disk).

The reference stores one pickle per trial per fold with keys
``image_feats (N, 2048) / kinematics_feats (N, 26) / g_labels (N,) /
e_labels (N, 5) / frames (N,)`` (preprocessing_utils.py:686-858), listed by
``train.csv``/``test.csv``, plus an external COG-feature variant keyed
``'feature'`` (dataset_utils.py:84-87). Standardization statistics are
fold-level ``mean/std_features.pth`` and ``mean/std_kinematics.pth``
(dataset_utils.py:457-464).

This module reads BOTH formats and defines the native one: a flat ``.npz``
per trial with the same five arrays (no pickle, mmap-friendly), with
fold statistics in ``stats.npz``.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TRIAL_KEYS = ("image_feats", "kinematics_feats", "g_labels", "e_labels", "frames")


@dataclass
class Trial:
    name: str                    # e.g. 'Needle_Passing_B001'
    image_feats: np.ndarray      # (N, 2048) float32
    kinematics: np.ndarray       # (N, 26) float32
    g_labels: np.ndarray         # (N,) int
    e_labels: np.ndarray         # (N, 5) int
    frames: Optional[np.ndarray] = None

    @property
    def n_frames(self) -> int:
        return len(self.kinematics)


def save_trial_npz(path: str, trial: Trial) -> None:
    np.savez_compressed(
        path,
        image_feats=trial.image_feats.astype(np.float32),
        kinematics_feats=trial.kinematics.astype(np.float32),
        g_labels=np.asarray(trial.g_labels).reshape(-1),
        e_labels=np.asarray(trial.e_labels).reshape(-1, 5),
        frames=(trial.frames if trial.frames is not None
                else np.arange(trial.n_frames)),
    )


def _to_numpy(x) -> np.ndarray:
    """Accept numpy / torch tensors found in reference pickles."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def load_trial(path: str, video_path: Optional[str] = None) -> Trial:
    """Load one trial from .npz or reference .pkl.

    ``video_path`` optionally points at an alternate trial file supplying
    the 2048-d features under the 'feature' key (the external COG features,
    reference dataset_utils.py:73-114); labels/kinematics come from `path`.
    """
    name = os.path.basename(path)
    for ext in (".npz", ".pkl"):
        if name.endswith(ext):
            name = name[: -len(ext)]

    def read(p) -> Dict[str, np.ndarray]:
        if p.endswith(".npz"):
            with np.load(p, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        with open(p, "rb") as f:
            return pickle.load(f)

    data = read(path)
    feats_src = data
    if video_path is not None:
        feats_src = read(video_path)

    if "feature" in feats_src:
        img = _to_numpy(feats_src["feature"])
    else:
        img = _to_numpy(feats_src["image_feats"])
    n = img.shape[0]
    if img.ndim <= 2:  # feature vectors; raw (N,H,W,3) frames stay 4-D
        img = img.reshape(n, -1)
    img = img.astype(np.float32)

    return Trial(
        name=name,
        image_feats=img,
        kinematics=_to_numpy(data["kinematics_feats"]).astype(np.float32),
        g_labels=_to_numpy(data["g_labels"]).reshape(-1).astype(np.int64),
        e_labels=_to_numpy(data["e_labels"]).reshape(-1, 5).astype(np.int64),
        frames=_to_numpy(data["frames"]).reshape(-1) if "frames" in data else None,
    )


def _resolve_trial_path(fold_dir: str, fname: str) -> str:
    """Accept .pkl listings against .npz files on disk and vice versa."""
    p = os.path.join(fold_dir, fname)
    if os.path.exists(p):
        return p
    stem, _ = os.path.splitext(p)
    for ext in (".npz", ".pkl"):
        if os.path.exists(stem + ext):
            return stem + ext
    raise FileNotFoundError(p)


def fold_file_list(fold_dir: str, csv_name: str) -> List[str]:
    """train.csv / test.csv: one trial filename per line, no header
    (reference dataset_utils.py:52)."""
    with open(os.path.join(fold_dir, csv_name)) as f:
        return [line.strip() for line in f if line.strip()]


def load_fold(
    fold_dir: str, csv_name: str, video_dir: Optional[str] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate all trials of a fold split into contiguous arrays
    (reference ``load_data``, dataset_utils.py:36-157).

    Returns (images (N, 2048), kinematics (N, 26), g_labels (N,),
    e_labels (N, 5), subjects (N,) object array of trial names).
    """
    images, kins, gs, es, subjects = [], [], [], [], []
    for fname in fold_file_list(fold_dir, csv_name):
        path = _resolve_trial_path(fold_dir, fname)
        vpath = _resolve_trial_path(video_dir, fname) if video_dir else None
        t = load_trial(path, vpath)
        n = t.n_frames
        images.append(t.image_feats[:n])
        kins.append(t.kinematics)
        gs.append(t.g_labels[:n])
        es.append(t.e_labels[:n])
        subjects.extend([t.name] * n)
    return (
        np.concatenate(images, axis=0),
        np.concatenate(kins, axis=0),
        np.concatenate(gs, axis=0),
        np.concatenate(es, axis=0),
        np.asarray(subjects, dtype=object),
    )


def load_fold_trials(
    fold_dir: str, csv_name: str, video_dir: Optional[str] = None
) -> List[Trial]:
    """Per-trial loading for the frame-level pipeline (reference
    CustomFrameDataset: one item = one whole trial)."""
    out = []
    for fname in fold_file_list(fold_dir, csv_name):
        path = _resolve_trial_path(fold_dir, fname)
        vpath = _resolve_trial_path(video_dir, fname) if video_dir else None
        out.append(load_trial(path, vpath))
    return out


# ------------------------------------------------------------------ stats
def load_fold_stats(fold_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Fold standardization statistics.

    Native: ``stats.npz`` with image_mean/image_std/kin_mean/kin_std.
    Reference interop: the four ``*.pth`` torch files
    (dataset_utils.py:457-460).
    """
    npz = os.path.join(fold_dir, "stats.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            return {
                "image": {"mean": z["image_mean"], "std": z["image_std"]},
                "kinematics": {"mean": z["kin_mean"], "std": z["kin_std"]},
            }
    pth = os.path.join(fold_dir, "mean_features.pth")
    if os.path.exists(pth):
        def t(p):
            return _to_numpy(
                torch.load(os.path.join(fold_dir, p), map_location="cpu",
                           weights_only=False)
            ).astype(np.float32)

        return {
            "image": {"mean": t("mean_features.pth"), "std": t("std_features.pth")},
            "kinematics": {"mean": t("mean_kinematics.pth"),
                           "std": t("std_kinematics.pth")},
        }
    raise FileNotFoundError(f"no stats.npz or *.pth statistics in {fold_dir}")


def compute_fold_stats(images: np.ndarray, kinematics: np.ndarray) -> dict:
    """Per-feature mean/std over the training split (how the reference's
    precomputed .pth stats were produced)."""
    return {
        "image": {"mean": images.mean(0), "std": images.std(0) + 1e-8},
        "kinematics": {"mean": kinematics.mean(0), "std": kinematics.std(0) + 1e-8},
    }


def save_fold_stats(fold_dir: str, stats: dict) -> None:
    np.savez(
        os.path.join(fold_dir, "stats.npz"),
        image_mean=stats["image"]["mean"],
        image_std=stats["image"]["std"],
        kin_mean=stats["kinematics"]["mean"],
        kin_std=stats["kinematics"]["std"],
    )
