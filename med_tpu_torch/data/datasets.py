"""A fold's trials from disk and one trial as a padded, fixed-shape frame
batch (port of the frame part of ``med_tpu.data.datasets``). Host-side
numpy, as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..config import ERROR_TYPE_TO_COLUMN, ExperimentConfig
from .labels import powerset_error_labels, skill_one_hot
from .trials import compute_fold_stats, load_fold, load_fold_stats, load_fold_trials


@dataclasses.dataclass
class FrameTrial:
    """One whole processed trial (reference CustomFrameDataset.__getitem__)."""

    name: str
    images: np.ndarray        # (T, 2048) raw
    kinematics: np.ndarray    # (T, 26) standardized
    g_labels: np.ndarray      # (T,)
    e_powerset: np.ndarray    # (T, 7)
    skill: np.ndarray         # (T, 3)
    e_raw: Optional[np.ndarray] = None   # (T, 5)

    @property
    def n_frames(self):
        return len(self.kinematics)

    def labels_for(self, error_type: str) -> np.ndarray:
        if error_type == "global":
            return self.e_powerset[:, -1].astype(np.int64)
        if error_type in ("all_errors", "sequential"):
            return np.argmax(self.e_powerset[:, :6], axis=1).astype(np.int64)
        col = ERROR_TYPE_TO_COLUMN[error_type]
        return self.e_powerset[:, col].astype(np.int64)


def standardize(x: np.ndarray, stats: Dict[str, np.ndarray]) -> np.ndarray:
    return ((x - stats["mean"]) / stats["std"]).astype(np.float32)


def build_frame_fold(
    fold_dir: str,
    cfg: ExperimentConfig,
    csv_name: str,
    video_dir: Optional[str] = None,
    stats: Optional[dict] = None,
) -> List[FrameTrial]:
    """The trials ``csv_name`` lists, processed as the reference's
    CustomFrameDataset does: powerset labels, the ND filter, kinematics
    standardised with the fold's statistics (recomputed from ``train.csv``
    when the fold has no statistics file), images left as they are
    (CustomFrameDataset.py:93-95), per-frame skill one-hot."""
    if stats is None:
        try:
            stats = load_fold_stats(fold_dir)
        except FileNotFoundError:
            img, kin, _, _, _ = load_fold(fold_dir, "train.csv", video_dir)
            stats = compute_fold_stats(img, kin)
    out = []
    for t in load_fold_trials(fold_dir, csv_name, video_dir):
        pw, nd_mask = powerset_error_labels(t.e_labels, delete_ND=True)
        if cfg.delete_ND:
            keep = ~nd_mask
        else:
            # the reference always computes the mask but only filters when
            # delete_ND (CustomFrameDataset.py:84-91 passes delete_ND=True to
            # powerset but gates the filtering on self.delete_ND)
            pw, _ = powerset_error_labels(t.e_labels, delete_ND=False)
            keep = np.ones(t.n_frames, bool)
        out.append(
            FrameTrial(
                name=t.name,
                images=t.image_feats[keep].astype(np.float32),
                kinematics=standardize(t.kinematics[keep], stats["kinematics"]),
                g_labels=t.g_labels[keep],
                e_powerset=pw[keep],
                skill=skill_one_hot(t.name, int(keep.sum())),
                e_raw=t.e_labels[keep],
            )
        )
    return out


def bucket_length(t: int, bucket: int = 256, cap: int = 8192) -> int:
    return min(max(-(-t // bucket) * bucket, bucket), cap)


def frame_batch(
    trial: FrameTrial,
    cfg: ExperimentConfig,
    bucket: int = 256,
    gate: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """One trial as a padded fixed-shape frame batch, truncated at
    ``cfg.max_frames``."""
    T = trial.n_frames
    Tp = bucket_length(T, bucket, cfg.max_frames)
    T = min(T, Tp)

    def pad(x, value=0):
        if x.ndim == 1:
            return np.pad(x[:T], (0, Tp - T), constant_values=value)
        return np.pad(x[:T], ((0, Tp - T), (0, 0)), constant_values=value)

    labels = trial.labels_for(cfg.error_type)
    batch = {
        "images": pad(trial.images)[None],
        "kinematics": pad(trial.kinematics)[None],
        "labels": pad(labels).astype(np.int64),
        "mask": np.pad(np.ones(T, np.float32), (0, Tp - T)),
        "true_len": np.asarray(T, np.int32),
        "_name": trial.name,
        "_gestures": pad(trial.g_labels),
    }
    if gate is not None:
        batch["gate"] = pad(gate.astype(np.float32))
    return batch
