"""Epoch loops (port of ``med_tpu.train.loop``): train one fold with
per-epoch learning rate, train and eval passes, metric rows and
best-checkpoint selection by test weighted-F1 or loss, for the window
families (:func:`train_window_fold`) and the frame families
(:func:`train_frame_fold`).

Losses and confusion matrices stay on the device through an epoch and come
to the host together at its end: a ``float()`` per step would make the host
wait for the card after every batch or trial. Window *train* metrics are
averaged over per-batch values (reference modeling_utils.py:398-402), test
metrics pooled (:781-786); frame metrics are pooled over all frames for
both splits (:1566-1574).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.datasets import (FrameTrial, WindowFold, array_batches, batch_schedule,
                             bucket_length, frame_batch, window_arrays)
from ..ops.metrics import metrics_from_cm
from ..utils.prefetch import prefetch_to_device
from .checkpoint import load_train_state, save_train_state
from .engine import Experiment
from .optim import epoch_lr, set_lr


def _class_counts(cfg: ExperimentConfig, train_fold: WindowFold) -> Optional[np.ndarray]:
    """The window families' loss weights from the train fold, with
    ``pos_weight``: its binary distribution for 'global', else the 6
    reciprocal class frequencies, classes 1, 3, 4 and 5 divided by
    ``es_weight_scale`` (train_window_ES.ipynb cell 2's "/1.5")."""
    if not cfg.pos_weight:
        return None
    if cfg.error_type == "global":
        return np.asarray(train_fold.binary_error_distribution, np.float32)
    dist = np.asarray(train_fold.specific_error_distribution, np.float32).copy()
    if cfg.es_weight_scale != 1.0 and dist.shape[0] >= 6:
        dist[[1, 3, 4, 5]] /= cfg.es_weight_scale
    return dist


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
    """The window families' rule (med_tpu/train/loop.py:73-76): a siamese
    model is binary whatever its error type. The frame path does not use
    it: see :func:`_frame_average`."""
    if cfg.error_type == "global" or cfg.siamese:
        return "binary"
    return "macro"


def _frame_average(cfg: ExperimentConfig) -> str:
    """The frame families' F1 average, as med_tpu's frame loop takes it:
    binary for the global error type alone, macro otherwise."""
    return "binary" if cfg.error_type == "global" else "macro"


def _score(cfg: ExperimentConfig, row: Dict) -> float:
    """The selection score of an epoch's row: test loss, or test weighted-F1."""
    if cfg.loss_or_f1 == "loss":
        return row["test_loss"]
    return row.get("test_f1_weighted", row["test_f1"])


def _better(cfg: ExperimentConfig, candidate: Dict, best: Optional[Dict]) -> bool:
    """med_tpu's per-epoch selection: the first epoch always wins."""
    if best is None:
        return True
    if cfg.loss_or_f1 == "loss":
        return _score(cfg, candidate) < _score(cfg, best)
    return _score(cfg, candidate) > _score(cfg, best)


def _common_bucket(cfg: ExperimentConfig, trials: List[FrameTrial]) -> Optional[int]:
    """med_tpu pads every trial of a fold to one bucket when it fuses the
    epoch or stacks trial groups; the bucket length changes the fast path
    and the FPN, so the port pads the same way to get the same numbers."""
    if not cfg.fused_epoch and cfg.trial_batch <= 1:
        return None
    return bucket_length(max(t.n_frames for t in trials), cap=cfg.max_frames)


def _with_true_gates(cfg: ExperimentConfig, gates, train_trials, test_trials):
    """``gates`` with med_tpu's fallback filled in: in the sequential regime
    a trial without a gate takes its true-error gate (labels != 0) — every
    train trial, and the test trials too where med_tpu builds the fold's
    batches in one place (``fused_epoch``; its unfused eval pass has no
    fallback)."""
    if gates is None or cfg.error_type != "sequential":
        return gates
    out = {split: dict(gates.get(split, {})) for split in ("train", "test")}
    for split, trials in (("train", train_trials),
                          ("test", test_trials if cfg.fused_epoch else [])):
        for trial in trials:
            if trial.name not in out[split]:
                out[split][trial.name] = (
                    trial.labels_for("sequential") != 0).astype(np.float32)
    return out


def _batches(cfg: ExperimentConfig, trials: List[FrameTrial], bucket: int,
             gates=None) -> List[Dict[str, np.ndarray]]:
    """Each trial's frame batch, with its gate from ``gates`` where there is
    one."""
    return [frame_batch(t, cfg, bucket=bucket,
                        gate=None if gates is None else gates.get(t.name))
            for t in trials]


def _group(batches: List[Dict[str, np.ndarray]], G: int) -> Dict[str, np.ndarray]:
    """<= G trial batches stacked on a new leading axis, a short group padded
    with zero-weight repeats of its first trial (med_tpu's make_group)."""
    weights = [1.0] * len(batches) + [0.0] * (G - len(batches))
    batches = batches + [batches[0]] * (G - len(batches))
    out = {k: np.stack([b[k] for b in batches]) for k in batches[0]
           if not k.startswith("_")}
    out["trial_weight"] = np.asarray(weights, np.float32)
    return out


def train_frame_fold(cfg: ExperimentConfig, train_trials: List[FrameTrial],
                     test_trials: List[FrameTrial], device=None, *, tracker=None,
                     frozen=None, gates=None, tag: str = "",
                     exp: Optional[Experiment] = None, resume: bool = False,
                     mesh=None) -> Dict[str, Any]:
    """Frame-level training of one fold (COG, TeCNo or TransSVNet, batch =
    one trial), on CUDA unless ``device="cpu"``. Weights are drawn from ``cfg.seed``; each epoch
    sets its learning rate, visits the training trials in the order of
    ``np.random.default_rng(cfg.seed + epoch)`` and evaluates the test
    trials. Returns {"best", "history", "checkpoint", "exp"}; the checkpoint
    is the best epoch's tree in med_tpu's layout.

    Selection follows med_tpu's frame driver. With ``fused_epoch`` and
    ``fused_run`` (the defaults) it is its whole-run rule (the fused run's
    on-device scan, replayed by ``_fused_run_history``): the score starts
    at +inf for the loss and -inf for F1, and an epoch wins only by strict
    improvement, so a non-finite score never wins; when no epoch wins, the
    fold returns the parameters from before its first epoch with that
    epoch's row, and ``best["all_epochs_non_finite"]`` is set. Otherwise it
    is the per-epoch ``_better``, under which the first epoch always wins.

    ``exp``: an :class:`Experiment` shared by all folds of a run (its
    ``device`` then holds); it is drawn anew from ``cfg.seed`` here.
    ``tracker``: every epoch's scalar columns are logged to it, and with a
    ``tag`` the full training state is written to the run's
    ``last_state_<tag>.npz`` after every epoch. ``resume``: restore that
    snapshot and go on at the epoch after it; ``best`` starts empty again,
    as in med_tpu. ``frozen``: TransSVNet's frozen TeCNo as med_tpu's
    ``{"tecno_params": <params tree>}``. ``gates``: the sequential regime's
    {"train": {trial name: (T,) 0/1}, "test": {...}} (see
    :func:`_with_true_gates`). ``mesh``: data-parallel trials (trial-DP,
    ``--trial-dp``): the state is replicated (the FeatureExtractor
    tensor-parallel over ``model``, ``parallel/mesh.py``) and each rank
    steps its ``G / n_data`` trials of every group; the numbers are the
    single-rank loop's. It takes the per-epoch loop: ``fused_epoch`` and
    ``fused_run`` must be off, as in med_tpu.

    With ``trial_batch`` = G > 1 every trial is padded to the fold's common
    bucket; a step takes the next G trials of the epoch's order and the
    eval pass the test trials G at a time, short groups padded with
    zero-weight repeats (see :mod:`.engine`)."""
    if mesh is not None and (cfg.fused_epoch or cfg.fused_run):
        raise ValueError("mesh trial-DP uses the per-epoch loop; set "
                         "fused_epoch/fused_run False")
    exp = exp or Experiment(cfg, device=device)
    if mesh is not None:
        from ..parallel.mesh import shard_state

        shard_state(exp, mesh)
    if frozen is not None:
        exp.load_frozen(frozen)
    exp.init_weights(cfg.seed)
    average = _frame_average(cfg)
    bucket = _common_bucket(cfg, train_trials + test_trials) or 256
    G = cfg.trial_batch
    gates = _with_true_gates(cfg, gates, train_trials, test_trials)
    train_gates = None if gates is None else gates["train"]

    start_epoch = 0
    resume_path = (tracker.checkpoint_path(f"last_state_{tag}.npz")
                   if tracker and tag else None)
    if resume and resume_path and os.path.exists(resume_path):
        start_epoch = load_train_state(resume_path, exp)
        print(f"[{tag}] resumed at epoch {start_epoch}")

    # med_tpu runs its whole-run program, and its selection, only with fused
    # epochs (med_tpu/train/loop.py::train_frame_fold)
    whole_run = cfg.fused_epoch and cfg.fused_run
    use_loss = cfg.loss_or_f1 == "loss"
    run_best = np.inf if use_loss else -np.inf
    initial = exp.checkpoint() if whole_run else None
    best, best_ckpt, history, first = None, None, [], None
    for epoch in range(start_epoch, cfg.n_epochs):
        set_lr(exp.optimizer, epoch_lr(cfg, epoch))
        t0 = time.time()
        order = np.random.default_rng(cfg.seed + epoch).permutation(len(train_trials))
        batches = _batches(cfg, [train_trials[i] for i in order], bucket, train_gates)
        if G > 1:
            batches = [_group(batches[s:s + G], G) for s in range(0, len(batches), G)]
        steps = [exp.train_step(b) for b in
                 prefetch_to_device(batches, cfg.prefetch_depth, exp.device)]
        cms = torch.stack([m["cm"] for m in steps]).cpu().numpy()
        step_losses = torch.stack([m["loss"] for m in steps]).cpu().numpy()
        train_time = time.time() - t0
        train_m = _epoch_metrics(list(cms), average, per_batch=False)

        ev = evaluate_frame_fold(cfg, exp, test_trials, gates, common_bucket=bucket)
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
        dump = {k: ev[k] for k in ("preds", "probs", "labels", "raw_labels",
                                   "gestures", "subjects", "cm")}
        first = first or {**row, **dump}
        if whole_run:
            score = _score(cfg, row)
            won = score < run_best if use_loss else score > run_best
            run_best = score if won else run_best
        else:
            won = _better(cfg, row, best)
        if won:
            best = {**row, **dump}
            best_ckpt = exp.checkpoint()
        if resume_path:
            save_train_state(resume_path, exp, epoch)
    if whole_run and history and best is None:
        print(f"[{tag}] every epoch score non-finite: returned checkpoint is "
              "the initial params; prediction dump marked degenerate")
        best = {**first, "all_epochs_non_finite": True}
        best_ckpt = initial
    return {"best": best, "history": history, "checkpoint": best_ckpt, "exp": exp}


def evaluate_frame_fold(cfg: ExperimentConfig, exp: Experiment,
                        test_trials: List[FrameTrial], gates=None,
                        common_bucket: Optional[int] = None) -> Dict:
    """Eval pass over the test trials (G at a time with ``trial_batch`` =
    G > 1; each with its gate from ``gates["test"]`` in the sequential
    regime): pooled metrics, the mean loss, the inference time per frame,
    and the per-frame prediction dump."""
    average = _frame_average(cfg)
    G = cfg.trial_batch
    t0 = time.time()
    batches = _batches(cfg, test_trials, common_bucket or 256,
                       None if gates is None else gates["test"])
    steps = ([_group(batches[s:s + G], G) for s in range(0, len(batches), G)]
             if G > 1 else batches)
    outs = [exp.eval_step(b) for b in
            prefetch_to_device(steps, cfg.prefetch_depth, exp.device)]
    cms = torch.stack([m["cm"] for m in outs]).cpu().numpy()
    losses = torch.stack([m["loss"] for m in outs]).cpu().numpy()
    host = []     # (preds, probs) a trial; a group's padding repeats come last
    for m in outs:
        p, q = m["preds"].cpu().numpy(), m["probs"].cpu().numpy()
        host.extend(zip(p, q) if G > 1 else [(p, q)])
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


# --------------------------------------------------------------------- window
class _Split:
    """One split's per-example arrays for the fold's epochs. With
    ``resident`` (``fused_epoch``) they go up to the device once, here, and
    each batch is gathered there by its epoch's index schedule, as
    ``med_tpu``'s ``FusedWindowEpoch`` gathers them; otherwise each batch
    is sliced on the host and goes up at its step."""

    def __init__(self, arrays: Dict[str, np.ndarray], device: torch.device,
                 resident: bool):
        self.n = len(arrays["labels"])
        self.device, self.resident = device, resident
        self.arrays = ({k: torch.as_tensor(np.asarray(v), device=device)
                        for k, v in arrays.items()} if resident else arrays)

    def batches(self, cfg: ExperimentConfig, shuffle: bool, epoch: int = 0):
        """The epoch's batches (each with its "mask") by
        :func:`batch_schedule` of ``cfg.seed`` + ``epoch``."""
        if not self.resident:
            yield from prefetch_to_device(
                array_batches(self.arrays, cfg.batch_size, shuffle, cfg.seed, epoch),
                cfg.prefetch_depth, self.device)
            return
        sel, mask = batch_schedule(self.n, cfg.batch_size, shuffle, cfg.seed, epoch)
        sel = torch.as_tensor(sel, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        for s, m in zip(sel, mask):
            yield {**{k: v[s] for k, v in self.arrays.items()}, "mask": m}


def _pair_arrays(data) -> Dict[str, np.ndarray]:
    """Materialized pairs (images (P, 2, W, F), kinematics, labels) as
    arrays; their batches follow the windows' protocol (med_tpu's
    ``_siamese_batches``)."""
    return {"images": data[0], "kinematics": data[1], "labels": data[2]}


def _window_split(cfg: ExperimentConfig, exp: Experiment, fold: Optional[WindowFold],
                  pairs=None, extras=None) -> _Split:
    arrays = (_pair_arrays(pairs) if cfg.siamese else
              window_arrays(fold, cfg.error_type, extras))
    return _Split(arrays, exp.device, cfg.fused_epoch)


def siamese_vote(pair_preds, position_2, window_labels):
    """Majority vote of pair predictions grouped by test-window position."""
    pos = np.asarray(position_2)
    uniq = np.unique(pos)
    votes = np.zeros(len(uniq), np.int64)
    labels = np.zeros(len(uniq), np.int64)
    for k, u in enumerate(uniq):
        sel = pos == u
        votes[k] = int(np.asarray(pair_preds)[sel].mean() >= 0.5)
        labels[k] = int(window_labels[u])
    return votes, labels


def train_window_fold(cfg: ExperimentConfig, train_fold: WindowFold,
                      test_fold: WindowFold, device=None, *, tracker=None,
                      tag: str = "LOSO_1Out", exp: Optional[Experiment] = None,
                      siamese_data: Optional[dict] = None,
                      extras: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                      resume: bool = False) -> Dict[str, Any]:
    """Full training of one fold for the window families (SimpleCNN,
    SimpleLSTM and the siamese twins), on CUDA unless ``device="cpu"``.
    Weights are drawn from ``cfg.seed``, the loss weights from the train
    fold (:func:`_class_counts`); each epoch sets its learning rate, trains
    on the order of ``default_rng(cfg.seed + epoch)`` and evaluates the test
    split. Returns {"best", "history", "checkpoint", "exp"}; the checkpoint
    is the best epoch's tree in med_tpu's layout, running statistics and
    class counts included.

    ``siamese_data`` (with ``cfg.siamese``): {"train": (images (P, 2, W, F),
    kinematics, labels), "test": (...), "test_position_2": (Pt,),
    "test_window_labels": (Nw,)} replaces the window batches with pair
    batches; the test metrics are the vote's (:func:`siamese_vote`).
    ``extras``: {"train": {name: (N,)}, "test": ...} more per-window arrays
    (the sequential stage's gate). ``tracker``, ``tag``, ``resume`` and
    ``exp`` as :func:`train_frame_fold` takes them.

    ``fused_epoch`` (the default) uploads each split to the device once a
    fold and gathers every batch there; without it each batch goes up from
    the host. Selection follows med_tpu's window loop. With ``fused_epoch``
    and ``fused_run`` (the defaults) it is its whole-run rule
    (``FusedWindowRun``/``FusedSiameseRun``): the score starts at -inf for
    F1 (the siamese vote's weighted F1) and +inf for the loss, an epoch wins
    only by strict improvement, and a non-finite train loss does not halt
    the run; when no epoch wins, the fold returns the parameters from before
    its first epoch with that epoch's row, and ``best["all_epochs_non_finite"]``
    is set. Otherwise it is the per-epoch ``_better``, under which the first
    epoch always wins, and the NaN watchdog stops the fold at the first
    non-finite train loss. ``med_tpu``'s fold bucketing (``fold_pad_quantum``)
    pads a fold so that XLA compiles one program a shape; its extra steps
    are exact no-ops, and the port runs none of them."""
    exp = exp or Experiment(cfg, device=device)
    exp.init_weights(cfg.seed, _class_counts(cfg, train_fold))
    average = _average_for(cfg)
    extras = extras or {}
    train = _window_split(cfg, exp, train_fold, (siamese_data or {}).get("train"),
                          extras.get("train"))
    test = _window_split(cfg, exp, test_fold, (siamese_data or {}).get("test"),
                         extras.get("test"))

    start_epoch = 0
    resume_path = (tracker.checkpoint_path(f"last_state_{tag}.npz")
                   if tracker and tag else None)
    if resume and resume_path and os.path.exists(resume_path):
        start_epoch = load_train_state(resume_path, exp)
        print(f"[{tag}] resumed at epoch {start_epoch}")

    whole_run = cfg.fused_epoch and cfg.fused_run
    use_loss = cfg.loss_or_f1 == "loss"
    run_best = np.inf if use_loss else -np.inf
    initial = exp.checkpoint() if whole_run else None
    best, best_ckpt, history, first, nan_warned = None, None, [], None, False
    for epoch in range(start_epoch, cfg.n_epochs):
        set_lr(exp.optimizer, epoch_lr(cfg, epoch))
        t0 = time.time()
        steps = [exp.train_step(b) for b in train.batches(cfg, True, epoch)]
        cms = torch.stack([m["cm"] for m in steps]).cpu().numpy()
        step_losses = torch.stack([m["loss"] for m in steps]).cpu().numpy()
        train_time = time.time() - t0
        train_m = _epoch_metrics(list(cms), average, per_batch=True)
        train_loss = float(np.mean(step_losses.astype(np.float64)))
        if not np.isfinite(train_loss):
            if not whole_run:
                # NaN watchdog: halt and keep the best checkpoint so far
                print(f"[{tag}] non-finite train loss at epoch {epoch}; stopping")
                break
            if not nan_warned:
                print(f"[{tag}] non-finite train loss at epoch {epoch} "
                      "(whole run continues; epoch cannot be selected)")
                nan_warned = True

        ev = evaluate_window_fold(cfg, exp, test_fold, siamese_data, split=test)
        row = {
            "epoch": epoch,
            "train_loss": train_loss,
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
        dump = {k: ev.get(k) for k in ("preds", "probs", "labels", "raw_labels",
                                       "gestures", "subjects", "cm")}
        first = first or {**row, **dump}
        if whole_run:
            score = _score(cfg, row)
            won = score < run_best if use_loss else score > run_best
            run_best = score if won else run_best
        else:
            won = _better(cfg, row, best)
        if won:
            best = {**row, **dump}
            best_ckpt = exp.checkpoint()
        if resume_path:
            save_train_state(resume_path, exp, epoch)
    if whole_run and history and best is None:
        print(f"[{tag}] every epoch score non-finite: returned checkpoint is "
              "the initial params; prediction dump marked degenerate")
        best = {**first, "all_epochs_non_finite": True}
        best_ckpt = initial
    return {"best": best, "history": history, "checkpoint": best_ckpt, "exp": exp}


def evaluate_window_fold(cfg: ExperimentConfig, exp: Experiment,
                         test_fold: Optional[WindowFold], siamese_data=None,
                         extras: Optional[Dict[str, np.ndarray]] = None,
                         split: Optional[_Split] = None) -> Dict:
    """Pooled eval pass over the test windows (or, with ``cfg.siamese``,
    the test pairs of ``siamese_data``, then the vote a test window) with
    the running statistics: metrics, the mean loss, the inference time per
    window or pair, and the ordered prediction dump. ``split``: the test
    split :func:`train_window_fold` holds for its epochs; by default it is
    built here from ``test_fold`` and ``extras``."""
    average = _average_for(cfg)
    split = split or _window_split(cfg, exp, test_fold,
                                   (siamese_data or {}).get("test"), extras)
    t0 = time.time()
    preds, probs, cms, losses = [], [], [], []
    for batch in split.batches(cfg, False):
        m = exp.eval_step(batch)
        preds.append(m["preds"])
        probs.append(m["probs"])
        cms.append(m["cm"])
        losses.append(m["loss"])
    # in order, so the padding is the last batch's tail
    preds = torch.cat(preds)[:split.n].cpu().numpy()
    probs = torch.cat(probs)[:split.n].cpu().numpy()
    cms = list(torch.stack(cms).cpu().numpy())
    losses = torch.stack(losses).cpu().numpy()
    t_infer = time.time() - t0
    pooled = _epoch_metrics(cms, average, per_batch=False)
    metrics = {
        "loss": float(np.mean(losses.astype(np.float64))),
        "f1": pooled["f1"],
        "f1_weighted": pooled.get("f1_weighted", pooled["f1"]),
        "acc": pooled["accuracy"],
        "jaccard": pooled["jaccard"],
        "inference_ms_per_window": t_infer / max(split.n, 1) * 1e3,
    }
    if cfg.siamese:
        # majority vote per test window (reference modeling_utils.py:1180-1250)
        vote_preds, vote_labels = siamese_vote(
            preds, siamese_data["test_position_2"], siamese_data["test_window_labels"])
        vote_cm = np.zeros((2, 2), np.int64)
        for y, p in zip(vote_labels, vote_preds):
            vote_cm[y, p] += 1
        vm = metrics_from_cm(vote_cm, "binary")
        metrics.update({"f1": vm["f1"], "acc": vm["accuracy"], "jaccard": vm["jaccard"],
                        "f1_weighted": metrics_from_cm(vote_cm, "weighted")["f1"]})
        return {"metrics": metrics, "preds": preds, "probs": probs,
                "labels": siamese_data["test"][2], "cm": vote_cm,
                "vote_preds": vote_preds, "vote_labels": vote_labels}
    return {
        "metrics": metrics,
        "preds": preds,
        "probs": probs,
        "labels": test_fold.labels_for(cfg.error_type),
        "raw_labels": test_fold.e_raw,
        "gestures": test_fold.g_labels.reshape(-1),
        "subjects": test_fold.subjects,
        "cm": pooled["cm"],
    }
