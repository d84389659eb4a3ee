"""Shared CLI plumbing: argparse <-> ExperimentConfig, fold orchestration,
artifact writing (port of ``med_tpu.cli.common``: the same flags, defaults,
printed lines and written files, the ``images/`` plots among them, plus
``--device``)."""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np

from ..config import LOSO_FOLDS, ExperimentConfig
from ..data.datasets import build_frame_fold, build_window_fold
from ..eval.rollup import compute_window_metrics
from ..eval.summary import create_summary, summary_to_text
from ..tracking import RunTracker
from ..train.checkpoint import save_checkpoint
from ..train.engine import WINDOW_MODELS, Experiment
from ..train.loop import train_frame_fold, train_window_fold

_CONFIG_FIELDS = [
    ("model_name", str), ("data_type", str), ("error_type", str),
    ("frequency", int), ("n_epochs", int), ("batch_size", int),
    ("lr", float), ("weight_decay", float), ("video_dims", int),
    ("out_features", int), ("hidden_size", int), ("num_layers", int),
    ("mstcn_stages", int), ("mstcn_layers", int), ("mstcn_f_maps", int),
    ("num_R", int), ("num_layers_R", int), ("num_layers_Basic", int),
    ("d_model", int), ("d_q", int), ("sequence_length", int),
    ("smooth_lambda", float), ("n_pairs", int), ("n_comparisons", int),
    ("seed", int), ("loss_or_f1", str), ("run_id", str), ("trial_batch", int),
    ("es_weight_scale", float),
]
_BOOL_FIELDS = ["lr_scheduler", "pos_weight", "delete_ND", "siamese",
                "mstcn_causal_conv", "use_pallas", "SRM", "use_skill_prompt",
                "fused_epoch", "fused_run"]
# flags of med_tpu's multi-chip layouts, parsed so that they fail by name
_MULTI_GPU_FLAGS = ("mesh", "fold_parallel", "trial_dp", "sequence_parallel")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data-root", required=True,
                   help="directory containing one subdir per fold")
    p.add_argument("--video-root", default=None,
                   help="optional external 2048-d feature trials (COG features)")
    p.add_argument("--folds", default=",".join(LOSO_FOLDS),
                   help="comma-separated fold names")
    p.add_argument("--setting", default="LOSO")
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--experiment", default=None)
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue the experiment's latest run: resume its "
                        "folds from their last_state snapshots")
    p.add_argument("--device", default=None,
                   help="torch device to train on. Default: CUDA, which must "
                        "be there; 'cpu' runs the kernels' plain versions")
    p.add_argument("--mesh", default=None,
                   help="multi-GPU device mesh (not ported yet)")
    for flag in ("--fold-parallel", "--trial-dp", "--sequence-parallel"):
        p.add_argument(flag, action="store_true", default=False,
                       help="multi-GPU layout (not ported yet)")
    defaults = ExperimentConfig()
    for name, typ in _CONFIG_FIELDS:
        p.add_argument(f"--{name.replace('_', '-').lower()}", dest=name,
                       type=typ, default=getattr(defaults, name, None))
    for name in _BOOL_FIELDS:
        flag = name.replace("_", "-").lower()
        p.add_argument(f"--{flag}", dest=name, action="store_true",
                       default=getattr(defaults, name))
        p.add_argument(f"--no-{flag}", dest=name, action="store_false")
    return p


def config_from_args(args, **overrides) -> ExperimentConfig:
    kw = {}
    for name, _ in _CONFIG_FIELDS:
        v = getattr(args, name, None)
        if v is not None:
            kw[name] = v
    for name in _BOOL_FIELDS:
        kw[name] = getattr(args, name)
    kw.update(overrides)
    return ExperimentConfig(**kw)


def _latest_run(experiment_dir: str) -> Optional[str]:
    """The id of the experiment's most recently started run, or None."""
    if not os.path.isdir(experiment_dir):
        return None
    runs = [r for r in os.listdir(experiment_dir)
            if os.path.exists(os.path.join(experiment_dir, r, "params.json"))]
    return max(runs, default=None, key=lambda r: os.path.getmtime(
        os.path.join(experiment_dir, r, "params.json")))


def make_tracker(args, cfg: ExperimentConfig) -> RunTracker:
    """A new run directory; with ``--resume`` the experiment's latest run,
    where the folds' ``last_state`` snapshots lie (a new run when there is
    none). med_tpu's CLI always starts a new run, so its ``--resume`` never
    finds a snapshot; its fold loop resumes only when called from Python."""
    experiment = args.experiment or (
        f"{cfg.model_name}_{cfg.frequency}Hz_{cfg.data_type}"
    )
    run_id = None
    if getattr(args, "resume", False):
        run_id = _latest_run(os.path.join(args.runs_root, experiment))
    tracker = RunTracker(root=args.runs_root, experiment=experiment, run_id=run_id)
    tracker.log_params(cfg.to_dict())
    print(f"run: {tracker.dir}")
    return tracker


def _dump_best(tracker: RunTracker, tag: str, best: dict, cfg) -> None:
    dump = {
        k: v for k, v in best.items()
        if np.isscalar(v) or isinstance(v, (int, float))
    }
    for k in ("preds", "probs", "labels", "gestures", "raw_labels"):
        if best.get(k) is not None:
            dump[k] = np.asarray(best[k]).tolist()
    if best.get("subjects") is not None:
        dump["subjects"] = [str(s) for s in best["subjects"]]
    dump["cm"] = np.asarray(best["cm"]).tolist()
    tracker.log_dict(dump, f"best_model_{tag}.json")


def _refuse_multi_gpu(args) -> None:
    for name in _MULTI_GPU_FLAGS:
        if getattr(args, name, None):
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet: "
                             "ROADMAP.md Queue A12 (multi-GPU)")


def _save_best(tracker: RunTracker, tag: str, res: dict, cfg: ExperimentConfig) -> dict:
    """Write a fold's best checkpoint (with its meta) and prediction dump;
    returns its best row."""
    best = res["best"]
    if best is None:
        raise SystemExit(f"[{tag}] nothing left to train: the snapshot is at or "
                         f"past --n-epochs {cfg.n_epochs}, or the first epoch's "
                         "train loss was not finite")
    ckpt = res["checkpoint"]
    save_checkpoint(tracker.checkpoint_path(f"best_model_{tag}.npz"), ckpt["params"],
                    ckpt["batch_stats"], ckpt.get("constants"),
                    meta={"cfg": cfg.to_dict()})
    _dump_best(tracker, tag, best, cfg)
    return best


def _plot_fold(tracker: RunTracker, history, setting: str, out: str, best: dict) -> None:
    """Per-fold curves and the best epoch's test confusion matrix into the
    run's ``images/`` (train_window.ipynb cell 2 plotting). As in
    ``med_tpu``, plotting never ends a training run: a failure (matplotlib
    missing, say) prints one line and the run goes on."""
    try:
        from ..viz import plot_cm, plot_results_LOSO

        image_dir = os.path.join(tracker.dir, "images")
        plot_results_LOSO([h["train_f1"] for h in history], [h["test_f1"] for h in history],
                          [h["train_loss"] for h in history],
                          [h["test_loss"] for h in history], setting, out, image_dir)
        cm = np.asarray(best["cm"])
        plot_cm(None, cm, image_dir, binary="global" if cm.shape[0] == 2 else None)
    except Exception as e:  # host-side plots only: no device work is hidden
        print(f"plotting skipped: {e}")


def run_window_folds(args, cfg: ExperimentConfig,
                     extras_fn: Optional[Callable[[str, object, object], dict]] = None,
                     siamese_fn: Optional[Callable] = None):
    """Train all folds of a window experiment; save checkpoints, artifacts
    and the weighted summary (the fold loop of train_window.ipynb cell 2).
    One :class:`Experiment` serves every fold. ``extras_fn(fold,
    train_fold, test_fold)`` gives a fold's extra per-window arrays (the
    sequential stage's gates), ``siamese_fn(fold, train_fold, test_fold)``
    its materialized pairs (see ``train_window_fold``). Returns
    (fold_results, tracker)."""
    _refuse_multi_gpu(args)
    folds = [f for f in args.folds.split(",") if f]
    shared_exp = Experiment(cfg, device=getattr(args, "device", None))
    tracker = make_tracker(args, cfg)
    fold_results, samples_tr, samples_te = {}, {}, {}
    for out in folds:
        train_fold, test_fold = build_window_fold(os.path.join(args.data_root, out), cfg,
                                                  args.video_root)
        tag = f"{args.setting}_{out}"
        print(f"[{tag}] train windows={len(train_fold)} test={len(test_fold)}")
        res = train_window_fold(
            cfg, train_fold, test_fold, tracker=tracker, tag=tag,
            siamese_data=siamese_fn(out, train_fold, test_fold) if siamese_fn else None,
            extras=extras_fn(out, train_fold, test_fold) if extras_fn else None,
            exp=shared_exp, resume=getattr(args, "resume", False))
        best = _save_best(tracker, tag, res, cfg)
        _plot_fold(tracker, res["history"], args.setting, out, best)
        fold_results[out] = best
        samples_tr[out] = len(train_fold)
        samples_te[out] = len(test_fold)
        print(f"[{tag}] best test F1={best['test_f1']:.3f} "
              f"acc={best['test_acc']:.3f}")
    summary = create_summary(fold_results, samples_tr, samples_te)
    tracker.log_dict(summary, "summary.json")
    print(summary_to_text(summary))
    return fold_results, tracker


def run_frame_folds(args, cfg: ExperimentConfig,
                    frozen_fn: Optional[Callable[[str], dict]] = None,
                    gates_fn: Optional[Callable[[str, list, list], dict]] = None
                    ) -> Dict[str, dict]:
    """Train all folds of a frame experiment; save checkpoints, artifacts,
    the weighted summary and the frame->window rollup (the fold loop of
    train_frame.ipynb cells 2-4). ``frozen_fn(fold)`` gives a fold's frozen
    stage (TransSVNet's TeCNo); ``gates_fn(fold, train_trials,
    test_trials)`` its gates (the sequential regime's, see
    ``train_frame_fold``). Returns (fold_results, tracker)."""
    _refuse_multi_gpu(args)
    if cfg.model_name in WINDOW_MODELS:
        raise SystemExit(f"{cfg.model_name} is a window model (ROADMAP.md A7): train "
                         "it with med_tpu_torch.cli.train_window")
    folds = [f for f in args.folds.split(",") if f]
    # before the run directory is made: without a GPU (and without --device
    # cpu) this raises, and nothing is left on disk
    shared_exp = Experiment(cfg, device=getattr(args, "device", None))
    tracker = make_tracker(args, cfg)
    fold_results, samples_tr, samples_te = {}, {}, {}
    frame_dumps = {}
    for out in folds:
        fold_dir = os.path.join(args.data_root, out)
        train_trials = build_frame_fold(fold_dir, cfg, "train.csv", args.video_root)
        test_trials = build_frame_fold(fold_dir, cfg, "test.csv", args.video_root)
        tag = f"{args.setting}_{out}"
        print(f"[{tag}] train trials={len(train_trials)} test={len(test_trials)}")
        res = train_frame_fold(cfg, train_trials, test_trials, tracker=tracker,
                               frozen=frozen_fn(out) if frozen_fn else None,
                               gates=gates_fn(out, train_trials, test_trials)
                               if gates_fn else None,
                               tag=tag, exp=shared_exp,
                               resume=getattr(args, "resume", False))
        best = _save_best(tracker, tag, res, cfg)
        _plot_fold(tracker, res["history"], args.setting, out, best)
        fold_results[out] = best
        samples_tr[out] = sum(t.n_frames for t in train_trials)
        samples_te[out] = sum(t.n_frames for t in test_trials)
        frame_dumps[out] = {k: best[k] for k in
                            ("preds", "labels", "gestures", "subjects")}
        print(f"[{tag}] best test F1={best['test_f1']:.3f}")
    summary = create_summary(fold_results, samples_tr, samples_te)
    tracker.log_dict(summary, "summary.json")
    print(summary_to_text(summary))

    # frame -> window rollup (train_frame.ipynb cell 4)
    binary = cfg.error_type == "global"
    wsum, wcm = compute_window_metrics(
        frame_dumps, cfg.window_size, cfg.stride, binary=binary,
        n_classes=2 if binary else 6,
    )
    tracker.log_dict({"windowed": wsum, "cm": wcm.tolist()},
                     "windowed_metrics.json")
    print("windowed:", wsum)
    return fold_results, tracker
