"""Label helpers of the frame and window pipelines (port of
``med_tpu.data.labels``).

The raw per-frame label matrix has 5 columns ``[Out_Of_View, Needle_Drop,
Multiple_Attempts, Needle_Position, Error]`` (reference
MED/dataset/preprocessing_utils.py:686-693). Training consumes a 7-column
powerset encoding produced by an asymmetric elif-ladder (reference
MED/dataset/dataset_utils.py:760-845), whose branch order is load-bearing:
OOV+NP maps to NP (class 3) but MA+NP keeps its own class (5); OOV+ND / MA+ND
collapse onto OOV / MA; a frame whose only error is Needle-Drop keeps just
the global flag (``delete_ND=False``) or is zeroed and recorded in a drop
mask (``delete_ND=True``); a flagged frame matching no branch keeps only the
global flag.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from ..config import ERROR_TYPE_TO_COLUMN, SKILL_LEVELS, SKILL_ORDER


def skill_one_hot(subject: str, n_frames: int) -> np.ndarray:
    """Per-frame one-hot skill level from the subject letter of a trial name
    like ``Needle_Passing_B001`` (reference CustomFrameDataset.py:97-111)."""
    skill = SKILL_LEVELS[subject[-4]]
    out = np.zeros((n_frames, 3), dtype=np.float32)
    out[:, SKILL_ORDER.index(skill)] = 1.0
    return out


# Raw column indices.
OOV, ND, MA, NP_, ERR = 0, 1, 2, 3, 4


def powerset_error_labels(
    e_labels: np.ndarray, delete_ND: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Map raw (N, 5) multi-hot error labels to the (N, 7) one-hot powerset.

    Returns ``(powerset, nd_mask)`` where ``nd_mask`` marks frames whose only
    error is Needle-Drop (True only when ``delete_ND``); callers filter those
    rows out of every aligned array (reference dataset_utils.py:442-453).
    """
    e = np.asarray(e_labels)
    if e.ndim != 2 or e.shape[1] != 5:
        raise ValueError(f"expected (N, 5) raw error labels, got {e.shape}")
    e = e.astype(np.int64)
    n = e.shape[0]

    out = np.zeros((n, 7), dtype=np.int32)
    err = e[:, ERR] == 1
    active = e[:, :4].astype(bool)
    single = e[:, :4].sum(axis=1) == 1

    # Branch cascade in reference order; each branch excludes earlier ones.
    is_oov = active[:, OOV] & (single | active[:, ND])
    is_ma = ~is_oov & active[:, MA] & (single | active[:, ND])
    is_np = ~is_oov & ~is_ma & active[:, NP_] & (single | active[:, OOV])
    is_oov_ma = ~is_oov & ~is_ma & ~is_np & active[:, OOV] & active[:, MA]
    is_ma_np = (
        ~is_oov & ~is_ma & ~is_np & ~is_oov_ma & active[:, MA] & active[:, NP_]
    )
    is_nd_only = (
        ~is_oov & ~is_ma & ~is_np & ~is_oov_ma & ~is_ma_np & active[:, ND]
    )

    out[err & is_oov, 1] = 1
    out[err & is_ma, 2] = 1
    out[err & is_np, 3] = 1
    out[err & is_oov_ma, 4] = 1
    out[err & is_ma_np, 5] = 1

    nd_mask = np.zeros(n, dtype=bool)
    if delete_ND:
        nd_mask = err & is_nd_only
        out[err & ~nd_mask, 6] = 1  # global flag, zeroed on dropped ND frames
    else:
        out[err, 6] = 1

    out[~err, 0] = 1
    return out, nd_mask


def select_error_labels(
    e_labels: np.ndarray, error_type: str, dataset_type: str = "window"
) -> np.ndarray:
    """The label column(s) of ``error_type`` in powerset labels (reference
    modeling_utils.py:137-191, ``define_error_labels``): 'global' the last
    column, 'all_errors' columns 0..5, an error name its column. Window
    labels (N, 7) index axis 1, frame labels (B, T, 7) axis 2."""
    if error_type not in ERROR_TYPE_TO_COLUMN:
        raise ValueError(f"error_type {error_type!r} not supported; "
                         f"one of {list(ERROR_TYPE_TO_COLUMN)}")
    col: Union[int, tuple] = ERROR_TYPE_TO_COLUMN[error_type]
    idx = col if isinstance(col, int) else list(col)
    e = np.asarray(e_labels)
    if dataset_type == "window":
        return e[:, idx]
    if dataset_type == "frame":
        return e[:, :, idx]
    raise ValueError(f"unknown dataset_type {dataset_type!r}")


def class_distributions(e_labels_powerset: np.ndarray) -> Tuple[tuple, list]:
    """Class-balance statistics of a window split (reference
    CustomWindowDataset.py:41-46): the binary distribution (1 - pos, pos)
    over the global column, and the reciprocal frequencies of the 6
    specific classes."""
    e = np.asarray(e_labels_powerset, dtype=np.float64)
    pos = e[:, -1].sum() / len(e)
    binary = (1.0 - pos, pos)
    specific = (len(e) / (e[:, :-1].sum(axis=0) + 1e-5)).tolist()
    return binary, specific
