"""Shared CLI plumbing: argparse <-> ExperimentConfig, fold orchestration,
artifact writing (port of ``med_tpu.cli.common``: the same flags, defaults,
printed lines and written files, the ``images/`` plots among them, plus
``--device``).

Several GPUs: one process a rank, under ``torchrun``::

    torchrun --nproc-per-node N -m med_tpu_torch.cli.train_frame \
        --sequence-parallel ...

(NCCL, one GPU a rank; without torchrun the CLI runs one rank.) Rank 0
alone writes the run (tracker, checkpoints, artifacts, summary); every
rank meets the others at a barrier before it exits."""

from __future__ import annotations

import argparse
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch.distributed as dist

from ..config import LOSO_FOLDS, ExperimentConfig
from ..data.datasets import build_frame_fold, build_window_fold
from ..eval.rollup import compute_window_metrics
from ..eval.summary import create_summary, summary_to_text
from ..parallel import launch
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
    add_mesh_flag(p)
    p.add_argument("--fold-parallel", action="store_true", default=False,
                   help="window families: train ALL folds as one batched program "
                        "(the fold axis over the mesh 'data' axis, "
                        "parallel/folds.py::FoldParallelWindowRun)")
    p.add_argument("--trial-dp", action="store_true", default=False,
                   help="frame families: split the --trial-batch axis over the mesh "
                        "'data' axis (data-parallel trials)")
    p.add_argument("--sequence-parallel", action="store_true", default=False,
                   help="frame families: split each trial's TIME axis over the mesh "
                        "'data' axis (parallel/sp_train.py)")
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


def add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default=None,
                   help="rank mesh for multi-GPU training: 'auto' (every rank, data x "
                        "model) or a shape like '4,2' (data,model) that holds every "
                        "rank of the torchrun world. Default: one rank")


def mesh_from_args(args):
    """The mesh ``--mesh`` asks for (None without the flag), over the ranks
    of the ``torchrun`` world (one rank without torchrun). 'auto' lays them
    out as (data, model) with model = 2 when the count is even
    (parallel/mesh.py::make_mesh); 'N' or 'N,M' pins the shape, which must
    hold every rank."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from ..parallel.mesh import make_mesh

    launch.init_from_env(getattr(args, "device", None))
    if spec == "auto":
        return make_mesh()
    shape = tuple(int(s) for s in spec.split(","))
    need, have = math.prod(shape), launch.world_size()
    if need > have:
        raise SystemExit(f"--mesh {spec} needs {need} ranks, have {have} (start them "
                         f"with torchrun --nproc-per-node {need})")
    if need < have:
        raise SystemExit(f"--mesh {spec} holds {need} ranks, the world has {have}: "
                         "every rank takes a place in the mesh")
    return make_mesh(shape)


def _default_mesh(args, mesh=None):
    """``mesh`` (``--mesh``'s), or every rank of the world in med_tpu's
    'auto' layout (one rank without torchrun)."""
    if mesh is None:
        from ..parallel.mesh import make_mesh

        launch.init_from_env(getattr(args, "device", None))
        mesh = make_mesh()
    return mesh


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
    if not launch.is_main():
        return _RankTracker(_broadcast(None))
    run_id = None
    if getattr(args, "resume", False):
        run_id = _latest_run(os.path.join(args.runs_root, experiment))
    tracker = RunTracker(root=args.runs_root, experiment=experiment, run_id=run_id)
    tracker.log_params(cfg.to_dict())
    print(f"run: {tracker.dir}")
    _broadcast(tracker.dir)
    return tracker


def _broadcast(obj):
    """Rank 0's ``obj`` on every rank (itself without a process group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _RankTracker:
    """Another rank's view of rank 0's run: it reads the run's snapshots and
    writes nothing."""

    def __init__(self, run_dir: str):
        self.dir = run_dir

    def checkpoint_path(self, name: str) -> str:
        return os.path.join(self.dir, "checkpoints", name)

    def log_params(self, *_args, **_kw) -> None:
        pass

    log_metrics = log_metric = log_dict = log_params


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


def _save_best(tracker: RunTracker, tag: str, res: dict, cfg: ExperimentConfig) -> dict:
    """Write a fold's best checkpoint (with its meta) and prediction dump;
    returns its best row."""
    best = res["best"]
    if best is None:
        raise SystemExit(f"[{tag}] nothing left to train: the snapshot is at or "
                         f"past --n-epochs {cfg.n_epochs}, or the first epoch's "
                         "train loss was not finite")
    if not launch.is_main():
        return best
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


def _finish(tracker, fold_results, samples_tr, samples_te) -> dict:
    """The weighted summary (rank 0 writes it)."""
    summary = create_summary(fold_results, samples_tr, samples_te)
    if launch.is_main():
        tracker.log_dict(summary, "summary.json")
        print(summary_to_text(summary))
    return summary


def run_window_folds(args, cfg: ExperimentConfig,
                     extras_fn: Optional[Callable[[str, object, object], dict]] = None,
                     siamese_fn: Optional[Callable] = None):
    """Train all folds of a window experiment; save checkpoints, artifacts
    and the weighted summary (the fold loop of train_window.ipynb cell 2).
    One :class:`Experiment` serves every fold. ``extras_fn(fold,
    train_fold, test_fold)`` gives a fold's extra per-window arrays (the
    sequential stage's gates), ``siamese_fn(fold, train_fold, test_fold)``
    its materialized pairs (see ``train_window_fold``). ``--fold-parallel``
    goes to :func:`run_window_folds_parallel`. Returns (fold_results,
    tracker)."""
    if getattr(args, "fold_parallel", False):
        return run_window_folds_parallel(args, cfg, extras_fn=extras_fn,
                                         siamese_fn=siamese_fn)
    launch.init_from_env(getattr(args, "device", None))
    mesh_from_args(args)            # a --mesh the world cannot hold exits here
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
        if launch.is_main():
            _plot_fold(tracker, res["history"], args.setting, out, best)
        fold_results[out] = best
        samples_tr[out] = len(train_fold)
        samples_te[out] = len(test_fold)
        print(f"[{tag}] best test F1={best['test_f1']:.3f} "
              f"acc={best['test_acc']:.3f}")
    _finish(tracker, fold_results, samples_tr, samples_te)
    launch.barrier()
    return fold_results, tracker


def run_window_folds_parallel(args, cfg: ExperimentConfig,
                              extras_fn: Optional[Callable] = None,
                              siamese_fn: Optional[Callable] = None):
    """``--fold-parallel``: every LOSO fold trained as one batched program
    (parallel/folds.py::FoldParallelWindowRun; the fold axis over the mesh's
    'data' axis, each rank its own folds, no collective until the results
    meet on rank 0), then the sequential driver's per-fold artifacts."""
    if siamese_fn is not None or extras_fn is not None:
        raise SystemExit("--fold-parallel supports the plain window family "
                         "(no siamese pairs / sequential gates)")
    if getattr(args, "resume", False):
        raise SystemExit("--fold-parallel does not support --resume "
                         "(the whole run is one device program)")
    import time
    import warnings

    from ..parallel.folds import FoldParallelWindowRun

    mesh = mesh_from_args(args)
    names = [f for f in args.folds.split(",") if f]
    n_data = 1 if mesh is None else mesh.shape["data"]
    mine = names
    if n_data > 1:
        if len(names) % n_data:
            warnings.warn(f"{len(names)} folds not divisible by data axis {n_data}; "
                          "every rank trains every fold")
        else:
            per = len(names) // n_data
            mine = names[mesh.coord("data") * per:(mesh.coord("data") + 1) * per]
        print(f"fold-parallel mesh: {mesh.shape}")
    exp = Experiment(cfg, device=getattr(args, "device", None))
    tracker = make_tracker(args, cfg)
    folds = {}
    for out in names:
        tf, ef = build_window_fold(os.path.join(args.data_root, out), cfg, args.video_root)
        folds[out] = (tf, ef)
        print(f"[{args.setting}_{out}] train windows={len(tf)} test={len(ef)}")
    t0 = time.time()
    results = dict(zip(mine, FoldParallelWindowRun(exp, cfg, [folds[o] for o in mine]).run()))
    if n_data > 1 and len(mine) < len(names):
        gathered = [None] * launch.world_size()
        dist.all_gather_object(gathered, results)
        results = {k: v for part in gathered for k, v in part.items()}
    print(f"fold-parallel wall: {time.time() - t0:.2f} s")
    fold_results, samples_tr, samples_te = {}, {}, {}
    for out in names:
        tag = f"{args.setting}_{out}"
        for row in results[out]["history"]:
            tracker.log_metrics({k: v for k, v in row.items() if np.isscalar(v)},
                                step=row["epoch"])
        best = _save_best(tracker, tag, results[out], cfg)
        if launch.is_main():
            _plot_fold(tracker, results[out]["history"], args.setting, out, best)
        fold_results[out] = best
        samples_tr[out], samples_te[out] = len(folds[out][0]), len(folds[out][1])
        print(f"[{tag}] best test F1={best['test_f1']:.3f} acc={best['test_acc']:.3f}")
    _finish(tracker, fold_results, samples_tr, samples_te)
    launch.barrier()
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
    ``train_frame_fold``). ``--sequence-parallel`` splits each trial's time
    axis over the mesh's 'data' axis (parallel/sp_train.py), ``--trial-dp``
    the trial groups (``train_frame_fold(mesh=)``); one or the other.
    Returns (fold_results, tracker)."""
    if cfg.model_name in WINDOW_MODELS:
        raise SystemExit(f"{cfg.model_name} is a window model (ROADMAP.md A7): train "
                         "it with med_tpu_torch.cli.train_window")
    launch.init_from_env(getattr(args, "device", None))
    if getattr(args, "sequence_parallel", False) and getattr(args, "trial_dp", False):
        raise SystemExit("--sequence-parallel and --trial-dp are mutually exclusive")
    given = mesh_from_args(args)
    mesh = sp_mesh = None
    if getattr(args, "sequence_parallel", False):
        sp_mesh = _default_mesh(args, given)
        print(f"sequence-parallel mesh: {sp_mesh.shape} "
              f"(T sharded over 'data'={sp_mesh.shape['data']})")
    elif getattr(args, "trial_dp", False):
        mesh = _default_mesh(args, given)
        n_data = mesh.shape["data"]
        if cfg.trial_batch % n_data:
            print(f"--trial-dp: trial_batch {cfg.trial_batch} not a multiple of the "
                  f"data axis {n_data}; batches will replicate (see "
                  "parallel/mesh.py::shard_batch)")
        if cfg.fused_epoch or cfg.fused_run:
            cfg = cfg.replace(fused_epoch=False, fused_run=False)
        print(f"trial-DP mesh: {mesh.shape} (trial_batch={cfg.trial_batch})")
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
        frozen = frozen_fn(out) if frozen_fn else None
        gates = gates_fn(out, train_trials, test_trials) if gates_fn else None
        if sp_mesh is not None:
            from ..parallel.sp_train import train_sp_frame_fold

            res = train_sp_frame_fold(cfg, train_trials, test_trials, sp_mesh,
                                      tracker=tracker, frozen=frozen, gates=gates, tag=tag,
                                      resume=getattr(args, "resume", False), exp=shared_exp)
        else:
            res = train_frame_fold(cfg, train_trials, test_trials, tracker=tracker,
                                   frozen=frozen, gates=gates, tag=tag, exp=shared_exp,
                                   resume=getattr(args, "resume", False), mesh=mesh)
        best = _save_best(tracker, tag, res, cfg)
        if launch.is_main():
            _plot_fold(tracker, res["history"], args.setting, out, best)
        fold_results[out] = best
        samples_tr[out] = sum(t.n_frames for t in train_trials)
        samples_te[out] = sum(t.n_frames for t in test_trials)
        frame_dumps[out] = {k: best[k] for k in
                            ("preds", "labels", "gestures", "subjects")}
        print(f"[{tag}] best test F1={best['test_f1']:.3f}")
    _finish(tracker, fold_results, samples_tr, samples_te)

    # frame -> window rollup (train_frame.ipynb cell 4)
    binary = cfg.error_type == "global"
    wsum, wcm = compute_window_metrics(
        frame_dumps, cfg.window_size, cfg.stride, binary=binary,
        n_classes=2 if binary else 6,
    )
    if launch.is_main():
        tracker.log_dict({"windowed": wsum, "cm": wcm.tolist()},
                         "windowed_metrics.json")
        print("windowed:", wsum)
    launch.barrier()
    return fold_results, tracker
