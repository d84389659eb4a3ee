"""Fold-parallel training: the LOSO folds of a window experiment trained as
one batched program (port of ``med_tpu.parallel.folds``).

Every fold's parameters, BatchNorm statistics and Adam moments are stacked
on a leading fold axis, and one step of every fold is one call of
``torch.func.vmap`` over a ``torch.func.functional_call`` of the window net
and its loss, so each matmul, pool and norm of the step runs once for all
the folds (the LSTM unrolled into matmuls, which vmap batches; torch.lstm
has no batching rule). Adam runs on the stacked tensors.

Folds differ in their window counts, so every fold is padded to one step
budget (the most steps of any fold); a fold's surplus step is fully
masked, and its update is gated off: the parameters, statistics, moments
and step count of that fold stay exactly as they were. Each fold starts
from the sequential loop's weights (``cfg.seed``) and draws its dropout
masks from its own generator seeded alike, so its trajectory is its
sequential run's. Across ranks the folds ride the mesh's ``data`` axis:
each rank trains its own folds, with no collective until the results are
gathered.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import ExperimentConfig
from ..data.datasets import WindowFold, batch_schedule, window_arrays
from ..models.window_models import LSTMLayer
from ..train.engine import Experiment, window_loss
from ..train.loop import _class_counts, _epoch_metrics, _average_for, _score
from ..train.optim import epoch_lr
from .mesh import set_stats_group

_BETAS, _EPS = (0.9, 0.999), 1e-8


def stack_trees(trees: List):
    """Stack identical nested dicts of arrays or tensors on a new leading
    fold axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return np.stack([np.asarray(t) for t in trees])


def unstack_tree(tree, index: int):
    """Fold ``index``'s slice of a stacked tree."""
    if isinstance(tree, dict):
        return {k: unstack_tree(v, index) for k, v in tree.items()}
    return tree[index]


class _WindowForward(nn.Module):
    """The window net with its input assembly in one forward, so that one
    functional call covers the FeatureExtractor and the model. Each rank
    holds its folds' batches whole: its BatchNorms take no group."""

    def __init__(self, exp: Experiment):
        super().__init__()
        self.net = copy.deepcopy(exp.net)
        self.cfg = exp.cfg
        set_stats_group(self.net, None)
        for m in self.net.modules():
            if isinstance(m, LSTMLayer):
                m.unrolled = True

    def forward(self, images, kinematics, train: bool, masks=None):
        cfg = self.cfg
        if cfg.data_type == "kinematics":
            x = kinematics
        else:
            x = self.net.fe(images) if cfg.uses_feature_extractor() else images
            if cfg.data_type != "video":
                x = torch.cat([x, kinematics], dim=-1)
        return self.net(x, train=train, masks=masks)


class FoldParallel:
    """The window family's train and eval steps over a stacked fold state,
    one batched program a step. A state is a dict: "params", "buffers",
    "exp_avg", "exp_avg_sq" (name -> (F, ...) tensors), "step" (F,) numpy
    Adam step counts, "class_counts" ((F, k) or None) and "generators" (a
    dropout generator a fold)."""

    def __init__(self, exp: Experiment):
        if exp.family != "window":
            raise ValueError("fold-parallel runs support the window family")
        self.exp, self.cfg, self.device = exp, exp.cfg, exp.device
        self.module = _WindowForward(exp).to(exp.device)
        self._train = torch.func.vmap(self._train_one)
        self._eval = torch.func.vmap(self._eval_one)

    # ----------------------------------------------------------------- state
    def init_states(self, seeds: List[int], class_counts: Optional[List] = None) -> Dict:
        """Each fold's state as ``Experiment.init_weights(seed, counts)``
        draws it, stacked."""
        exp, states = self.exp, []
        counts = class_counts or [None] * len(seeds)
        for seed, cc in zip(seeds, counts):
            exp.init_weights(seed, cc)
            states.append({
                "params": {f"net.{k}": v.detach().clone()
                           for k, v in exp.net.named_parameters()},
                "buffers": {f"net.{k}": v.detach().clone() for k, v in exp.net.named_buffers()},
                "class_counts": exp.class_counts})
        params = stack_trees([s["params"] for s in states])
        cc = (None if states[0]["class_counts"] is None
              else torch.stack([s["class_counts"] for s in states]))
        return {"params": params, "buffers": stack_trees([s["buffers"] for s in states]),
                "exp_avg": {k: torch.zeros_like(v) for k, v in params.items()},
                "exp_avg_sq": {k: torch.zeros_like(v) for k, v in params.items()},
                "step": np.zeros(len(seeds)), "class_counts": cc,
                "generators": [torch.Generator(device=self.device).manual_seed(self.cfg.seed)
                               for _ in seeds],
                "draws": np.zeros(len(seeds), np.int64)}

    def checkpoint(self, state: Dict, index: int) -> Dict:
        """Fold ``index``'s parameters and statistics as a med_tpu checkpoint
        tree (the class counts among its constants)."""
        exp = self.exp
        with torch.no_grad():
            for k, v in exp.net.named_parameters():
                v.copy_(state["params"][f"net.{k}"][index])
            for k, v in exp.net.named_buffers():
                v.copy_(state["buffers"][f"net.{k}"][index])
        exp.class_counts = (None if state["class_counts"] is None
                            else state["class_counts"][index])
        return exp.checkpoint()

    # ---------------------------------------------------------------- steps
    def _loss(self, out, batch, cc):
        return window_loss(self.cfg, "window", out, batch, cc)

    def _train_one(self, params, buffers, batch, masks, cc):
        def objective(p):
            # the BatchNorms move their running statistics in place: on
            # copies made inside the transform, returned as the new buffers
            moved = {k: v.clone() for k, v in buffers.items()}
            out = torch.func.functional_call(
                self.module, (p, moved), (batch["images"], batch["kinematics"]),
                {"train": True, "masks": masks})
            loss, metrics = self._loss(out, batch, cc)
            return loss, (metrics["cm"], moved)

        grads, (loss, (cm, moved)) = torch.func.grad_and_value(objective, has_aux=True)(params)
        return grads, loss, cm, moved

    def _eval_one(self, params, buffers, batch, cc):
        out = torch.func.functional_call(self.module, (params, buffers),
                                         (batch["images"], batch["kinematics"]),
                                         {"train": False})
        loss, metrics = self._loss(out, batch, cc)
        return loss, metrics["cm"], metrics["preds"], metrics["probs"]

    def draw_masks(self, state: Dict, real: np.ndarray, B: int):
        """Each real fold's next dropout masks from its own generator, as its
        sequential run draws them, stacked on the fold axis. Folds whose
        generators have drawn alike share one draw (one launch for all of
        them while the folds step in lockstep)."""
        F = len(real)
        model = self.exp.net.model
        draws, by_count = {}, {}
        for f in np.flatnonzero(real):
            by_count.setdefault(int(state["draws"][f]), []).append(f)
        for folds in by_count.values():
            lead = state["generators"][folds[0]]
            masks = model.dropout_masks(B, lead)
            for f in folds:
                draws[f] = masks
                if f != folds[0]:
                    state["generators"][f].set_state(lead.get_state())
                state["draws"][f] += 1
        shared = next(iter(draws.values()))
        if len(by_count) == 1:
            return [m.unsqueeze(0).expand(F, *m.shape) for m in shared]
        return [torch.stack([draws.get(f, shared)[i] for f in range(F)])
                for i in range(len(shared))]

    def train_step(self, state: Dict, batch: Dict, lr: float,
                   real: Optional[np.ndarray] = None, masks=None) -> Dict:
        """One step of every fold on ``batch`` ((F, B, ...) tensors with
        "mask"), at learning rate ``lr``. ``real`` (F,) bool: the folds that
        step (a surplus step leaves its fold's state exactly as it was);
        ``masks``: the stacked dropout masks (drawn by :meth:`draw_masks`
        when None). Returns {"loss": (F,), "cm": (F, C, C)}."""
        F = len(state["step"])
        real = np.ones(F, bool) if real is None else np.asarray(real, bool)
        if masks is None:
            masks = self.draw_masks(state, real, batch["mask"].shape[1])
        cc = state["class_counts"]
        train = self._train if cc is not None else torch.func.vmap(
            self._train_one, in_dims=(0, 0, 0, 0, None))
        grads, loss, cm, buffers = train(state["params"], state["buffers"], batch, masks, cc)
        gate = None if real.all() else torch.as_tensor(real, device=self.device)

        def keep(new, old):
            if gate is None:
                return new
            return torch.where(gate.reshape((F,) + (1,) * (old.dim() - 1)), new, old)

        with torch.no_grad():
            state["buffers"] = {k: keep(v, state["buffers"][k]) for k, v in buffers.items()}
            self._adam(state, grads, lr, real, keep)
        return {"loss": loss, "cm": cm}

    def _adam(self, state, grads, lr: float, real: np.ndarray, keep) -> None:
        """torch.optim.Adam's update with coupled L2 on the stacked tensors.
        While every fold steps at one step count, its foreach arithmetic on
        the stacked lists (a few launches for all the parameters); else each
        fold at its own count, the folds that do not step kept as they
        were."""
        b1, b2 = _BETAS
        wd = self.cfg.weight_decay
        F = len(real)
        step = state["step"] + real
        if real.all() and np.all(step == step[0]):
            self._adam_foreach(state, grads, lr, float(step[0]))
            state["step"] = step
            return
        n = np.maximum(step, 1)
        step_size = torch.as_tensor(lr / (1 - b1 ** n), dtype=torch.float32, device=self.device)
        bc2_sqrt = torch.as_tensor(np.sqrt(1 - b2 ** n), dtype=torch.float32,
                                   device=self.device)
        for name, p in state["params"].items():
            g = grads[name]
            if wd != 0:
                g = g + wd * p
            shape = (F,) + (1,) * (p.dim() - 1)
            m = torch.lerp(state["exp_avg"][name], g, 1 - b1)
            v = state["exp_avg_sq"][name] * b2 + (1 - b2) * g * g
            denom = v.sqrt() / bc2_sqrt.reshape(shape) + _EPS
            new = p - step_size.reshape(shape) * (m / denom)
            state["params"][name] = keep(new, p)
            state["exp_avg"][name] = keep(m, state["exp_avg"][name])
            state["exp_avg_sq"][name] = keep(v, state["exp_avg_sq"][name])
        state["step"] = step

    def _adam_foreach(self, state, grads, lr: float, step: float) -> None:
        """torch.optim.Adam's foreach update (coupled L2), every fold at
        ``step``, in torch's order of operations."""
        b1, b2 = _BETAS
        names = list(state["params"])
        params = [state["params"][n] for n in names]
        g = [grads[n] for n in names]
        m = [state["exp_avg"][n] for n in names]
        v = [state["exp_avg_sq"][n] for n in names]
        if self.cfg.weight_decay != 0:
            g = torch._foreach_add(g, params, alpha=self.cfg.weight_decay)
        torch._foreach_lerp_(m, g, 1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, 1 - b2)
        step_size = lr / (1 - b1 ** step)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, (1 - b2 ** step) ** 0.5)
        torch._foreach_add_(denom, _EPS)
        torch._foreach_addcdiv_(params, m, denom, -step_size)

    @torch.no_grad()
    def eval_step(self, state: Dict, batch: Dict) -> Dict:
        """Every fold's eval step on ``batch`` ((F, B, ...) with "mask"):
        {"loss": (F,), "cm", "preds", "probs"}."""
        cc = state["class_counts"]
        fn = self._eval if cc is not None else torch.func.vmap(
            self._eval_one, in_dims=(0, 0, 0, None))
        loss, cm, preds, probs = fn(state["params"], state["buffers"], batch, cc)
        return {"loss": loss, "cm": cm, "preds": preds, "probs": probs}


class FoldParallelWindowRun:
    """Every fold of a window experiment, every epoch, eval and best-epoch
    selection, one batched program a step (``med_tpu``'s
    ``FoldParallelWindowRun``). Selection is the whole-run rule of the
    sequential loop's default: the score starts at -inf for F1 (+inf for
    the loss) and an epoch wins only by strict improvement."""

    def __init__(self, exp: Experiment, cfg: ExperimentConfig, folds: List,
                 seed: Optional[int] = None):
        if cfg.siamese:
            raise ValueError("fold-parallel runs take the plain window family")
        self.exp, self.cfg = exp, cfg
        self.fp = FoldParallel(exp)
        B = cfg.batch_size
        self.n_train = [len(tf) for tf, _ in folds]
        self.n_test = [len(ef) for _, ef in folds]
        self.S = max(-(-n // B) for n in self.n_train)
        self.S2 = max(-(-n // B) for n in self.n_test)
        self.folds = folds
        dev = exp.device

        def arrays(fold: WindowFold, rows: int):
            out = {}
            for k, v in window_arrays(fold, cfg.error_type).items():
                v = np.asarray(v)
                out[k] = np.pad(v, ((0, rows - len(v)),) + ((0, 0),) * (v.ndim - 1))
            return out

        self.train_arrays = {k: torch.as_tensor(v, device=dev) for k, v in stack_trees(
            [arrays(tf, self.S * B) for tf, _ in folds]).items()}
        self.test_arrays = {k: torch.as_tensor(v, device=dev) for k, v in stack_trees(
            [arrays(ef, self.S2 * B) for _, ef in folds]).items()}
        self.seed = cfg.seed if seed is None else seed

    def _schedule(self, counts: List[int], steps: int, shuffle: bool, epoch: int):
        """(F, steps, B) indices and masks: each fold's own schedule, then
        fully masked surplus steps."""
        B = self.cfg.batch_size
        sels, masks = [], []
        for n in counts:
            sel, mask = batch_schedule(n, B, shuffle, self.cfg.seed, epoch)
            pad = steps - len(sel)
            sels.append(np.concatenate([sel, np.zeros((pad, B), np.int64)]))
            masks.append(np.concatenate([mask, np.zeros((pad, B), np.float32)]))
        return np.stack(sels), np.stack(masks)

    def _batch(self, arrays, sel, mask):
        F = sel.shape[0]
        fold = torch.arange(F, device=self.exp.device)[:, None]
        sel_t = torch.as_tensor(sel, device=self.exp.device)
        out = {k: v[fold, sel_t] for k, v in arrays.items()}
        out["mask"] = torch.as_tensor(mask, device=self.exp.device)
        return out

    def run(self, n_epochs: Optional[int] = None) -> List[Dict]:
        """Train every fold; returns, a fold each, {"best", "history",
        "checkpoint"} as ``train_window_fold`` returns them."""
        cfg, fp = self.cfg, self.fp
        F = len(self.folds)
        E = cfg.n_epochs if n_epochs is None else n_epochs
        average = _average_for(cfg)
        use_loss = cfg.loss_or_f1 == "loss"
        state = fp.init_states([self.seed] * F,
                               [_class_counts(cfg, tf) for tf, _ in self.folds])
        run_best = [np.inf if use_loss else -np.inf] * F
        histories = [[] for _ in range(F)]
        best = [None] * F
        best_ckpt = [None] * F
        first = [None] * F
        initial = [fp.checkpoint(state, f) for f in range(F)]
        steps_f = [-(-n // cfg.batch_size) for n in self.n_train]
        esteps_f = [-(-n // cfg.batch_size) for n in self.n_test]
        ev_sel, ev_mask = self._schedule(self.n_test, self.S2, False, 0)
        for epoch in range(E):
            lr = epoch_lr(cfg, epoch)
            t0 = time.time()
            sel, mask = self._schedule(self.n_train, self.S, True, epoch)
            outs = []
            for s in range(self.S):
                real = mask[:, s].any(axis=1)
                outs.append(fp.train_step(state, self._batch(self.train_arrays, sel[:, s],
                                                             mask[:, s]), lr, real))
            cms = torch.stack([o["cm"] for o in outs], 1).cpu().numpy()
            losses = torch.stack([o["loss"] for o in outs], 1).cpu().numpy()
            train_time = (time.time() - t0) / F
            t0 = time.time()
            evs = [fp.eval_step(state, self._batch(self.test_arrays, ev_sel[:, s],
                                                   ev_mask[:, s])) for s in range(self.S2)]
            e_loss = torch.stack([e["loss"] for e in evs], 1).cpu().numpy()
            e_cm = torch.stack([e["cm"] for e in evs], 1).cpu().numpy()
            e_preds = torch.cat([e["preds"] for e in evs], 1).cpu().numpy()
            e_probs = torch.cat([e["probs"] for e in evs], 1).cpu().numpy()
            t_infer = (time.time() - t0) / F
            for f, (_, test_fold) in enumerate(self.folds):
                st, se = steps_f[f], esteps_f[f]
                train_m = _epoch_metrics(list(cms[f, :st]), average, per_batch=True)
                pooled = _epoch_metrics(list(e_cm[f, :se]), average, per_batch=False)
                row = {
                    "epoch": epoch,
                    "train_loss": float(np.mean(losses[f, :st].astype(np.float64))),
                    "train_f1": train_m["f1"],
                    "train_f1_weighted": train_m.get("f1_weighted", train_m["f1"]),
                    "train_acc": train_m["accuracy"],
                    "train_jaccard": train_m["jaccard"],
                    "train_time": train_time,
                    "test_loss": float(np.mean(e_loss[f, :se].astype(np.float64))),
                    "test_f1": pooled["f1"],
                    "test_f1_weighted": pooled.get("f1_weighted", pooled["f1"]),
                    "test_acc": pooled["accuracy"],
                    "test_jaccard": pooled["jaccard"],
                    "test_inference_ms_per_window": t_infer / max(self.n_test[f], 1) * 1e3,
                }
                histories[f].append(row)
                n = self.n_test[f]
                dump = {"preds": e_preds[f, :n], "probs": e_probs[f, :n],
                        "labels": test_fold.labels_for(cfg.error_type),
                        "raw_labels": test_fold.e_raw,
                        "gestures": test_fold.g_labels.reshape(-1),
                        "subjects": test_fold.subjects, "cm": pooled["cm"]}
                first[f] = first[f] or {**row, **dump}
                score = _score(cfg, row)
                if score < run_best[f] if use_loss else score > run_best[f]:
                    run_best[f] = score
                    best[f] = {**row, **dump}
                    best_ckpt[f] = fp.checkpoint(state, f)
        results = []
        for f in range(F):
            if best[f] is None:
                best[f] = {**first[f], "all_epochs_non_finite": True}
                best_ckpt[f] = initial[f]
            results.append({"best": best[f], "history": histories[f],
                            "checkpoint": best_ckpt[f]})
        return results
