"""Label helpers the frame batch needs (port of ``med_tpu.data.labels``)."""

from __future__ import annotations

import numpy as np

from ..config import SKILL_LEVELS, SKILL_ORDER


def skill_one_hot(subject: str, n_frames: int) -> np.ndarray:
    """Per-frame one-hot skill level from the subject letter of a trial name
    like ``Needle_Passing_B001`` (reference CustomFrameDataset.py:97-111)."""
    skill = SKILL_LEVELS[subject[-4]]
    out = np.zeros((n_frames, 3), dtype=np.float32)
    out[:, SKILL_ORDER.index(skill)] = 1.0
    return out
