"""Sequence-parallel training mode for the frame families (port of
``med_tpu.parallel.sp_train``): the fold loop of ``train/loop.py`` with every
trial's time axis split over the ranks of the mesh's ``data`` axis.

- Trials are padded to one bucket, a multiple of ``32 · n_shards`` (the
  bit-packed dropout words and the fast path's pool stay shard-local), and
  ``true_len < T`` is handled by the masked losses: the per-track labels
  and masks are made on the host by :func:`_track_targets`, exactly as the
  engine resamples them in its step;
- dropout draws are functions of (seed, step, global T)
  (``seqpar.sp_dropout_generator``), so a trajectory is the same however
  many shards the time axis splits into, given one bucket;
- eval sums the confusion matrices with one psum and gathers each trial's
  predictions; the history rows, the per-epoch selection (the first epoch
  always wins) and the checkpoints are ``train_frame_fold``'s, and the
  parameters come from the same init, so checkpoints and ``last_state``
  snapshots pass both ways between this loop and the single-rank one.

TeCNo, TransSVNet and COG (global, all_errors, a named error type, and the
sequential regime with its gates). COG's SRM and skill prompts, and trial
groups, stay on the single-rank and trial-DP paths, as in ``med_tpu``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..ops.metrics import confusion_matrix
from ..train import losses
from ..train.checkpoint import load_train_state, save_train_state
from ..train.engine import Experiment
from ..train.loop import _better, _epoch_metrics, _frame_average
from ..train.optim import epoch_lr, set_lr
from .comm import all_gather, all_reduce_grads, psum
from .seqpar import shard_sequence, soft_ce, sp_dropout_generator, sp_tecno_forward
from .sp_cog import sp_cog_dropout, sp_cog_loss_masked
from .sp_tsvn import sp_tsvn_forward


def _track_targets(labels: np.ndarray, mask: np.ndarray, true_len: int, t_track: int,
                   gate: Optional[np.ndarray] = None, shift: bool = False):
    """A track's (labels, mask) on its own grid, as the engine makes them in
    its step: the nearest-resampled labels (shifted to 0..4 in the
    sequential regime), the ``true_out`` window, and the resampled gate."""
    t_pad = labels.shape[0]
    lbl = np.maximum(labels - 1, 0) if shift else labels
    tl = losses.nearest_resample_dynamic(torch.as_tensor(lbl), torch.tensor(true_len),
                                         t_track).numpy()
    true_out = max((int(true_len) * t_track) // t_pad, 1)
    tm = (np.arange(t_track) < true_out).astype(np.float32)
    if gate is not None:
        g = torch.as_tensor((gate * mask).astype(np.float32))
        tm = losses.nearest_resample_dynamic(g, torch.tensor(true_len), t_track).numpy() * tm
    return tl.astype(np.int64), tm


class SPFrameTrainer:
    """SP train and eval steps of one frame family on this rank's blocks.
    Parameters, optimizer and frozen stage are an :class:`Experiment`'s,
    replicated on every rank."""

    def __init__(self, cfg: ExperimentConfig, mesh, device=None, exp: Optional[Experiment] = None):
        if cfg.trial_batch != 1:
            raise ValueError("SP trains one (sharded) trial per step")
        if cfg.model_name == "COG" and (cfg.SRM or cfg.use_skill_prompt):
            raise NotImplementedError("SP COG covers the base chain (SRM/skill variants "
                                      "stay on the single-chip path)")
        self.cfg, self.mesh = cfg, mesh
        self.group = mesh.group("data")
        self.n_shards = mesh.shape["data"]
        self.quantum = 32 * self.n_shards
        self.exp = exp or Experiment(cfg, device=device)
        self.family = self.exp.family
        if self.family not in ("tecno", "tsvn", "cog"):
            raise ValueError("SP training covers the frame families")
        self.device = self.exp.device

    # ------------------------------------------------------------- batches
    def bucket_for(self, trials) -> int:
        t = max(tr.n_frames for tr in trials)
        t = min(t, self.cfg.max_frames) if self.cfg.max_frames else t
        return -(-t // self.quantum) * self.quantum

    def make_batch(self, trial, bucket: int, gate=None) -> Dict[str, Any]:
        """A trial padded to ``bucket`` (no batch axis: the trial is the
        step), with COG's per-track targets."""
        cfg = self.cfg
        T = min(trial.n_frames, bucket)

        def pad(x):
            return np.pad(x[:T], ((0, bucket - T),) + ((0, 0),) * (x.ndim - 1))

        labels = pad(trial.labels_for(cfg.error_type)).astype(np.int64)
        mask = pad(np.ones(T, np.float32))
        batch = {"labels": labels, "mask": mask, "kinematics": pad(trial.kinematics),
                 "images": pad(trial.images)}
        g = None
        if gate is not None:
            g = batch["gate"] = pad(np.asarray(gate, np.float32))
        elif cfg.error_type == "sequential":
            g = batch["gate"] = (labels != 0).astype(np.float32) * mask
        if self.family == "cog":
            seq = cfg.error_type == "sequential"
            pool = self.exp.net.model.fast_pool
            batch["tl_full"], batch["tm_full"] = _track_targets(labels, mask, T, bucket, g, seq)
            batch["tl_fast"], batch["tm_fast"] = _track_targets(labels, mask, T,
                                                                bucket // pool, g, seq)
        batch.update(_true_len=T, _name=trial.name, _gestures=pad(trial.g_labels))
        return batch

    def shard(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's block of every array, on the device ('_' keys stay)."""
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                out[k] = v
                continue
            dtype = torch.int64 if k in ("labels", "tl_full", "tl_fast") else torch.float32
            out[k] = shard_sequence(torch.as_tensor(v, dtype=dtype), self.group).to(self.device)
        return out

    # --------------------------------------------------------------- steps
    def _assemble(self, batch):
        cfg = self.cfg
        if cfg.data_type == "kinematics":
            return batch["kinematics"]
        images = batch["images"]
        if cfg.uses_feature_extractor():
            images = self.exp.net.fe(images)
        if cfg.data_type == "video":
            return images
        return torch.cat([images, batch["kinematics"]], dim=-1)

    def _forward_loss(self, batch, dropout):
        """(loss, the final prediction track's local logits)."""
        cfg, g = self.cfg, self.group
        model = self.exp.net.model
        x = self._assemble(batch)
        if self.family == "tecno":
            logits = sp_tecno_forward(model, x, g, dropout)
            loss = torch.stack([soft_ce(s, batch["labels"], batch["mask"], g)
                                for s in logits]).mean()
            return loss, logits[-1]
        if self.family == "tsvn":
            with torch.no_grad():
                tecno = sp_tecno_forward(self.exp.frozen, x, g)[-1]
            out = sp_tsvn_forward(model, tecno, x, g)
            return soft_ce(out, batch["labels"], batch["mask"], g), out
        loss, out_list = sp_cog_loss_masked(
            model, x, batch["tl_full"], batch["tm_full"], batch["tl_fast"], batch["tm_fast"],
            g, cfg.smooth_lambda, dropout=dropout)
        return loss, out_list[0]

    def _metrics(self, final, batch):
        """(psum'd confusion matrix, local preds, local probs)."""
        cfg = self.cfg
        labels, mask = batch["labels"], batch["mask"]
        final = final.detach()
        probs = torch.softmax(final, dim=-1)
        if cfg.error_type == "sequential":
            preds = torch.argmax(final, dim=-1) + 1
            gated = torch.where(batch["gate"] > 0, preds, torch.zeros_like(preds))
            return psum(confusion_matrix(labels, gated, 6, mask), self.group), preds, probs
        n_classes = 2 if cfg.error_type == "global" else cfg.out_features
        preds = torch.argmax(final, dim=-1)
        cm = psum(confusion_matrix(labels, preds, n_classes, mask), self.group)
        return cm, preds, probs[..., 1] if n_classes == 2 else probs

    def dropout(self, step: int, T: int):
        """This step's dropout rows: the whole trial's draw, seeded by (seed,
        step), cut to this rank's block."""
        model = self.exp.net.model
        gen = sp_dropout_generator(self.cfg.seed, step, self.device)
        if self.family == "cog":
            return sp_cog_dropout(model, T, gen, self.group)
        if self.family == "tecno":
            return {k: shard_sequence(v["stack"][:, 0], self.group, axis=1)
                    for k, v in model.dropout_masks(T, gen, 1).items()}
        return None

    def _adam_step(self) -> int:
        state = self.exp.optimizer.state
        p = self.exp.optimizer.param_groups[0]["params"][0]
        return int(state[p]["step"]) if p in state else 0

    def train_step(self, batch, dropout=None) -> Dict[str, torch.Tensor]:
        """One SP step on this rank's blocks; ``dropout`` None draws this
        step's masks (the optimizer's step count picks the draw)."""
        if dropout is None:
            dropout = self.dropout(self._adam_step(), batch["labels"].shape[0] * self.n_shards)
        opt = self.exp.optimizer
        opt.zero_grad(set_to_none=False)
        loss, final = self._forward_loss(batch, dropout)
        loss.backward()
        all_reduce_grads(self.exp.net.parameters(), self.group)
        opt.step()
        cm, _, _ = self._metrics(final, batch)
        return {"loss": loss.detach(), "cm": cm}

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """{"loss", "cm", "preds", "probs"}: the whole trial's predictions."""
        loss, final = self._forward_loss(batch, None)
        cm, preds, probs = self._metrics(final, batch)
        return {"loss": loss, "cm": cm, "preds": all_gather(preds, self.group),
                "probs": all_gather(probs, self.group)}


def train_sp_frame_fold(cfg: ExperimentConfig, train_trials: List, test_trials: List, mesh,
                        device=None, *, tracker=None, frozen=None, gates=None, tag: str = "",
                        resume: bool = False, bucket: Optional[int] = None,
                        exp: Optional[Experiment] = None) -> Dict[str, Any]:
    """``train_frame_fold`` with the time axis split over ``mesh``'s ``data``
    axis: the same per-epoch learning rate, trial order, metrics, selection
    and snapshots, SP steps. ``bucket`` pins the padded length (a multiple
    of the trainer's quantum): dropout depends on the padded T, so runs on
    different shard counts agree when they share a bucket."""
    trainer = SPFrameTrainer(cfg, mesh, device, exp)
    exp = trainer.exp
    if frozen is not None:
        exp.load_frozen(frozen)
    exp.init_weights(cfg.seed)
    average = _frame_average(cfg)
    if bucket is None:
        bucket = trainer.bucket_for(list(train_trials) + list(test_trials))
    elif bucket % trainer.quantum:
        raise ValueError(f"bucket {bucket} not a multiple of the trainer quantum "
                         f"{trainer.quantum}")

    def batches_for(trials, split):
        return [trainer.make_batch(t, bucket, None if gates is None
                                   else gates.get(split, {}).get(t.name)) for t in trials]

    train_batches = [trainer.shard(b) for b in batches_for(train_trials, "train")]
    test_host = batches_for(test_trials, "test")
    test_batches = [trainer.shard(b) for b in test_host]

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
        order = np.random.default_rng(cfg.seed + epoch).permutation(len(train_batches))
        steps = [trainer.train_step(train_batches[i]) for i in order]
        cms = torch.stack([m["cm"] for m in steps]).cpu().numpy()
        step_losses = torch.stack([m["loss"] for m in steps]).cpu().numpy()
        train_time = time.time() - t0
        train_loss = float(np.mean(step_losses.astype(np.float64)))
        if not np.isfinite(train_loss):
            print(f"[{tag}] non-finite train loss at epoch {epoch}; stopping")
            break
        train_m = _epoch_metrics(list(cms), average, per_batch=False)
        ev = evaluate_sp_frame_fold(cfg, trainer, test_trials, test_batches, test_host)
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
            tracker.log_metrics({k: v for k, v in row.items() if np.isscalar(v)}, step=epoch)
        if _better(cfg, row, best):
            best = {**row, **{k: ev[k] for k in ("preds", "probs", "labels", "raw_labels",
                                                 "gestures", "subjects", "cm")}}
            best_ckpt = exp.checkpoint()
        if resume_path:
            save_train_state(resume_path, exp, epoch)
    return {"best": best, "history": history, "checkpoint": best_ckpt, "exp": trainer}


def evaluate_sp_frame_fold(cfg: ExperimentConfig, trainer: SPFrameTrainer, test_trials,
                           test_batches, host_batches) -> Dict:
    """The pooled SP eval pass (``evaluate_frame_fold``'s): confusion
    matrices psum'd, predictions gathered a trial and cut to its length."""
    average = _frame_average(cfg)
    t0 = time.time()
    outs = [trainer.eval_step(b) for b in test_batches]
    cms = torch.stack([m["cm"] for m in outs]).cpu().numpy()
    step_losses = torch.stack([m["loss"] for m in outs]).cpu().numpy()
    t_infer = time.time() - t0
    preds, probs, labels, gests, subjects, raw_labels = [], [], [], [], [], []
    n_frames = 0
    for trial, m, hb in zip(test_trials, outs, host_batches):
        T = int(hb["_true_len"])
        preds.append(m["preds"].cpu().numpy()[:T])
        probs.append(m["probs"].cpu().numpy()[:T])
        labels.append(hb["labels"][:T])
        gests.append(hb["_gestures"][:T])
        if trial.e_raw is not None:
            raw_labels.append(trial.e_raw[:T])
        subjects.extend([trial.name] * T)
        n_frames += T
    pooled = _epoch_metrics(list(cms), average, per_batch=False)
    return {
        "metrics": {
            "loss": float(np.mean(step_losses.astype(np.float64))),
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
