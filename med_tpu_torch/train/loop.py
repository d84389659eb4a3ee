"""Frame-level epoch loop (port of the frame part of ``med_tpu.train.loop``):
train one fold with per-epoch learning rate, train and eval passes, metric
rows and best-checkpoint selection by test weighted-F1 or loss.

Losses and confusion matrices stay on the device through an epoch and come
to the host together at its end: a ``float()`` per step would make the host
wait for the card after every trial. Frame metrics are pooled over all
frames for both splits (reference modeling_utils.py:1566-1574).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.datasets import FrameTrial, bucket_length, frame_batch
from ..ops.metrics import metrics_from_cm
from ..utils.jax_params import export_jax_params
from .checkpoint import load_train_state, save_train_state
from .engine import Experiment
from .optim import epoch_lr, set_lr


def _epoch_metrics(cms: List[np.ndarray], average: str, per_batch: bool) -> Dict[str, float]:
    if per_batch:
        vals = [metrics_from_cm(cm, average) for cm in cms]
        out = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
        if average == "binary":
            out["f1_weighted"] = float(
                np.mean([metrics_from_cm(cm, "weighted")["f1"] for cm in cms]))
        out["cm"] = np.sum(cms, axis=0)
        return out
    total = np.sum(cms, axis=0)
    out = dict(metrics_from_cm(total, average))
    if average == "binary":
        out["f1_weighted"] = metrics_from_cm(total, "weighted")["f1"]
    out["cm"] = total
    return out


def _average_for(cfg: ExperimentConfig) -> str:
    if cfg.error_type == "global" or cfg.siamese:
        return "binary"
    return "macro"


def _better(cfg: ExperimentConfig, candidate: Dict, best: Optional[Dict]) -> bool:
    if best is None:
        return True
    if cfg.loss_or_f1 == "loss":
        return candidate["test_loss"] < best["test_loss"]
    return candidate.get("test_f1_weighted", candidate["test_f1"]) > best.get(
        "test_f1_weighted", best["test_f1"])


def _common_bucket(cfg: ExperimentConfig, trials: List[FrameTrial]) -> Optional[int]:
    """med_tpu pads every trial of a fold to one bucket when it fuses the
    epoch; the bucket length changes the fast path and the FPN, so the port
    pads the same way to get the same numbers."""
    if not cfg.fused_epoch:
        return None
    return bucket_length(max(t.n_frames for t in trials), cap=cfg.max_frames)


def train_frame_fold(cfg: ExperimentConfig, train_trials: List[FrameTrial],
                     test_trials: List[FrameTrial], device=None, *, tracker=None,
                     frozen=None, gates=None, tag: str = "",
                     exp: Optional[Experiment] = None, resume: bool = False,
                     mesh=None) -> Dict[str, Any]:
    """Frame-level training of one fold (COG, batch = one trial), on CUDA
    unless ``device="cpu"``. Weights are drawn from ``cfg.seed``; each epoch
    sets its learning rate, visits the training trials in the order of
    ``np.random.default_rng(cfg.seed + epoch)`` and evaluates the test
    trials. Returns {"best", "history", "checkpoint", "exp"}; the checkpoint
    is the best epoch's tree in med_tpu's layout.

    ``exp``: an :class:`Experiment` shared by all folds of a run (its
    ``device`` then holds); it is drawn anew from ``cfg.seed`` here.
    ``tracker``: every epoch's scalar columns are logged to it, and with a
    ``tag`` the full training state is written to the run's
    ``last_state_<tag>.npz`` after every epoch. ``resume``: restore that
    snapshot and go on at the epoch after it; ``best`` starts empty again,
    as in med_tpu. ``frozen``, ``gates`` and ``mesh`` belong to families and
    layouts the port does not have yet."""
    for name, value, item in (("frozen", frozen, "A6 (other frame families)"),
                              ("gates", gates, "A6 (other frame families)"),
                              ("mesh", mesh, "A12 (multi-GPU)")):
        if value is not None:
            raise NotImplementedError(
                f"train_frame_fold({name}=...) is not ported yet: ROADMAP.md "
                f"Queue {item}")
    exp = exp or Experiment(cfg, device=device)
    exp.init_weights(cfg.seed)
    average = _average_for(cfg)
    bucket = _common_bucket(cfg, train_trials + test_trials) or 256

    start_epoch = 0
    resume_path = (tracker.checkpoint_path(f"last_state_{tag}.npz")
                   if tracker and tag else None)
    if resume and resume_path and os.path.exists(resume_path):
        start_epoch = load_train_state(resume_path, exp)
        print(f"[{tag}] resumed at epoch {start_epoch}")

    best, best_ckpt, history = None, None, []
    for epoch in range(start_epoch, cfg.n_epochs):
        set_lr(exp.optimizer, epoch_lr(cfg, epoch))
        t0 = time.time()
        order = np.random.default_rng(cfg.seed + epoch).permutation(len(train_trials))
        steps = [exp.train_step(frame_batch(train_trials[i], cfg, bucket=bucket))
                 for i in order]
        cms = torch.stack([m["cm"] for m in steps]).cpu().numpy()
        step_losses = torch.stack([m["loss"] for m in steps]).cpu().numpy()
        train_time = time.time() - t0
        train_m = _epoch_metrics(list(cms), average, per_batch=False)

        ev = evaluate_frame_fold(cfg, exp, test_trials, common_bucket=bucket)
        row = {
            "epoch": epoch,
            "train_loss": float(np.mean(step_losses.astype(np.float64))),
            "train_f1": train_m["f1"],
            "train_f1_weighted": train_m.get("f1_weighted", train_m["f1"]),
            "train_acc": train_m["accuracy"],
            "train_jaccard": train_m["jaccard"],
            "train_time": train_time,
            **{f"test_{k}": v for k, v in ev["metrics"].items()},
        }
        history.append(row)
        if tracker:
            tracker.log_metrics({k: v for k, v in row.items() if np.isscalar(v)},
                                step=epoch)
        if _better(cfg, row, best):
            best = dict(row)
            best.update({k: ev[k] for k in ("preds", "probs", "labels", "raw_labels",
                                            "gestures", "subjects", "cm")})
            best_ckpt = {**export_jax_params(exp.net), "batch_stats": {}}
        if resume_path:
            save_train_state(resume_path, exp, epoch)
    return {"best": best, "history": history, "checkpoint": best_ckpt, "exp": exp}


def evaluate_frame_fold(cfg: ExperimentConfig, exp: Experiment,
                        test_trials: List[FrameTrial],
                        common_bucket: Optional[int] = None) -> Dict:
    """Eval pass over the test trials: pooled metrics, the mean loss, the
    inference time per frame, and the per-frame prediction dump."""
    average = _average_for(cfg)
    t0 = time.time()
    batches = [frame_batch(t, cfg, bucket=common_bucket or 256) for t in test_trials]
    outs = [exp.eval_step(b) for b in batches]
    cms = torch.stack([m["cm"] for m in outs]).cpu().numpy()
    losses = torch.stack([m["loss"] for m in outs]).cpu().numpy()
    host = [(m["preds"].cpu().numpy(), m["probs"].cpu().numpy()) for m in outs]
    t_infer = time.time() - t0

    preds, probs, labels, gests, subjects, raw_labels = [], [], [], [], [], []
    n_frames = 0
    for trial, batch, (p, q) in zip(test_trials, batches, host):
        T = int(batch["true_len"])
        preds.append(p[:T])
        probs.append(q[:T])
        labels.append(batch["labels"][:T])
        gests.append(batch["_gestures"][:T])
        if trial.e_raw is not None:
            raw_labels.append(trial.e_raw[:T])
        subjects.extend([trial.name] * T)
        n_frames += T
    pooled = _epoch_metrics(list(cms), average, per_batch=False)
    return {
        "metrics": {
            "loss": float(np.mean(losses.astype(np.float64))),
            "f1": pooled["f1"],
            "f1_weighted": pooled.get("f1_weighted", pooled["f1"]),
            "acc": pooled["accuracy"],
            "jaccard": pooled["jaccard"],
            "inference_ms_per_frame": t_infer / max(n_frames, 1) * 1e3,
        },
        "preds": np.concatenate(preds),
        "probs": np.concatenate(probs),
        "labels": np.concatenate(labels),
        "raw_labels": np.concatenate(raw_labels) if raw_labels else None,
        "gestures": np.concatenate(gests),
        "subjects": np.asarray(subjects, dtype=object),
        "cm": pooled["cm"],
    }
