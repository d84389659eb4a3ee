"""One trial as a padded, fixed-shape frame batch (port of the frame part of
``med_tpu.data.datasets``). Host-side numpy, as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..config import ERROR_TYPE_TO_COLUMN, ExperimentConfig


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
