"""A fold from disk as window splits or trials, and their fixed-shape
batches (port of ``med_tpu.data.datasets``): window batches of
``batch_size`` with the last one padded and masked, one trial as a padded
frame batch. Host-side numpy, as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import ExperimentConfig
from .labels import (class_distributions, powerset_error_labels, select_error_labels,
                     skill_one_hot)
from .trials import compute_fold_stats, load_fold, load_fold_stats, load_fold_trials
from .windowing import window_data


def _labels_for(e_powerset: np.ndarray, error_type: str) -> np.ndarray:
    """Integer training labels per error_type (reference
    define_error_labels + the argmax in the ES/sequential loops)."""
    if error_type in ("all_errors", "sequential"):
        return np.argmax(e_powerset[:, :6], axis=1).astype(np.int64)
    return select_error_labels(e_powerset, error_type).astype(np.int64)


@dataclasses.dataclass
class WindowFold:
    """One split of windowed, powerset-labeled, standardized data
    (reference CustomWindowDataset, CustomWindowDataset.py:3-74)."""

    images: np.ndarray        # (N, W, 2048) standardized
    kinematics: np.ndarray    # (N, W, 26) standardized
    g_labels: np.ndarray      # (N, 1)
    e_powerset: np.ndarray    # (N, 7)
    subjects: np.ndarray      # (N,) object
    e_raw: Optional[np.ndarray] = None   # (N, 5) raw multi-hot error labels

    def __len__(self):
        return len(self.images)

    @property
    def binary_error_distribution(self) -> tuple:
        return class_distributions(self.e_powerset)[0]

    @property
    def specific_error_distribution(self) -> list:
        return class_distributions(self.e_powerset)[1]

    def labels_for(self, error_type: str) -> np.ndarray:
        return _labels_for(self.e_powerset, error_type)


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
        return _labels_for(self.e_powerset, error_type)


def standardize(x: np.ndarray, stats: Dict[str, np.ndarray]) -> np.ndarray:
    return ((x - stats["mean"]) / stats["std"]).astype(np.float32)


def _fold_stats(fold_dir: str, video_dir: Optional[str], stats: Optional[dict]) -> dict:
    """The fold's statistics: ``stats``, its file, or recomputed from its
    ``train.csv``."""
    if stats is not None:
        return stats
    try:
        return load_fold_stats(fold_dir)
    except FileNotFoundError:
        img, kin, _, _, _ = load_fold(fold_dir, "train.csv", video_dir)
        return compute_fold_stats(img, kin)


def build_window_fold(
    fold_dir: str,
    cfg: ExperimentConfig,
    video_dir: Optional[str] = None,
    stats: Optional[dict] = None,
) -> Tuple[WindowFold, WindowFold]:
    """load -> window -> powerset -> drop Needle-Drop (``delete_ND``) ->
    standardize, for the train and test splits (reference
    retrieve_dataloaders_window, dataset_utils.py:405-531)."""
    stats = _fold_stats(fold_dir, video_dir, stats)
    out = []
    for csv in ("train.csv", "test.csv"):
        img, kin, g, e, subj = load_fold(fold_dir, csv, video_dir)
        iw, kw, gw, ew, sw = window_data(img, kin, g, e, subj, cfg.window_size, cfg.stride)
        pw, nd_mask = powerset_error_labels(ew, delete_ND=cfg.delete_ND)
        if cfg.delete_ND:
            keep = ~nd_mask
            iw, kw, gw, pw, sw, ew = (iw[keep], kw[keep], gw[keep], pw[keep], sw[keep],
                                      ew[keep])
        out.append(WindowFold(
            images=standardize(iw, stats["image"]),
            kinematics=standardize(kw, stats["kinematics"]),
            g_labels=gw, e_powerset=pw, subjects=sw, e_raw=np.asarray(ew)))
    return out[0], out[1]


def batch_schedule(n: int, batch_size: int, shuffle: bool, seed: int = 42,
                   epoch: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(steps, B) indices and 0/1 mask of an epoch over ``n`` examples: the
    order of ``np.random.default_rng(seed + epoch)`` when shuffled, the last
    step padded with index 0 and masked out (reference seeded DataLoader,
    dataset_utils.py:526-527)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    steps = -(-n // batch_size)
    pad = steps * batch_size - n
    sel = np.concatenate([idx, np.zeros(pad, np.int64)]).reshape(steps, batch_size)
    mask = np.concatenate([np.ones(n, np.float32),
                           np.zeros(pad, np.float32)]).reshape(steps, batch_size)
    return sel, mask


def array_batches(arrays: Dict[str, np.ndarray], batch_size: int, shuffle: bool,
                  seed: int = 42, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape batches of ``arrays`` (each indexed on axis 0) by
    :func:`batch_schedule`, with "mask", "_index" and "_valid"."""
    n = len(next(iter(arrays.values())))
    sel, mask = batch_schedule(n, batch_size, shuffle, seed, epoch)
    for s, m in zip(sel, mask):
        yield {**{k: v[s] for k, v in arrays.items()},
               "mask": m, "_index": s, "_valid": int(m.sum())}


def window_arrays(fold: WindowFold, error_type: str,
                  extras: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """A split's per-window arrays: images, kinematics, the labels of
    ``error_type`` and any ``extras`` (the sequential stage's gate)."""
    return {"images": fold.images, "kinematics": fold.kinematics,
            "labels": fold.labels_for(error_type),
            **{k: np.asarray(v) for k, v in (extras or {}).items()}}


def window_batches(
    fold: WindowFold,
    cfg: ExperimentConfig,
    shuffle: bool,
    seed: int = 42,
    epoch: int = 0,
    extras: Optional[Dict[str, np.ndarray]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """A split's fixed-shape batches (:func:`array_batches`), ``extras``
    sliced alongside."""
    return array_batches(window_arrays(fold, cfg.error_type, extras), cfg.batch_size,
                         shuffle, seed, epoch)


def n_window_batches(fold: WindowFold, cfg: ExperimentConfig) -> int:
    return -(-len(fold) // cfg.batch_size)


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
    stats = _fold_stats(fold_dir, video_dir, stats)
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
