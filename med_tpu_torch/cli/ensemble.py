"""Multi-model ensembling over stored run artifacts (port of
``med_tpu.cli.ensemble``, the same flags, defaults and printed lines, plus
``--device``; reference ensemble.ipynb): soft vote of two binary runs'
probabilities (cell 6) and the binary -> multiclass cascade (cell 15),
scored per fold with weighted mean ± std.

Offline (the default) it re-scores the runs' stored prediction dumps on the
host. ``--serve`` runs the members live from their checkpoints on CUDA
(``--device cpu`` for the CPU): over a fold's stored windows
(``--data-root``), or from raw frames through the ResNet-50 trunk
(``--pixels-root``, bf16 by default, ``--fp32-trunk``, or ``--int8-trunk``).
``--int8-fe`` serves the members' FeatureExtractors on the int8 PTQ path.
Two choices differ from ``med_tpu``: the int8 feature store feeds the
server only when every member that takes images has an int8
FeatureExtractor (others would read the codes as features), and a train
split shorter than one window skips the int8 FE's calibration."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import LOSO_FOLDS, run_config
from ..eval.ensemble import cascade_ensemble, reconcile_nd, score_predictions, soft_vote
from ..eval.results import check_run_alignment, prediction_overlap
from ..eval.summary import weighted_mean_std
from ..tracking import RunTracker
from .common import add_mesh_flag, mesh_from_args


def _load_fold_dump(runs_root, run_id, setting, out):
    run_dir = RunTracker.find_run(runs_root, run_id)
    with open(os.path.join(run_dir, "artifacts", f"best_model_{setting}_{out}.json")) as f:
        return json.load(f)


def fe_calibration(feats: np.ndarray, stats: dict, window_size: int):
    """The int8 FE's calibration batch: up to 64 standardized windows of the
    train split's trunk features, what it sees at serve time; None when the
    split is shorter than one window (no calibration, fp32 FE)."""
    from ..data.datasets import standardize

    nw = min(64, len(feats) // window_size)
    if nw == 0:
        return None
    return standardize(feats[: nw * window_size].reshape(nw, window_size, -1), stats["image"])


def _serve_pixels(args, folds, cfg):
    """Live pixels -> prediction serving: per fold, the fine-tuned ResNet-50
    trunk (bf16, fp32, or the int8 PTQ trunk with --int8-trunk) runs
    in-process ahead of the window ensemble, with the fold's standardization
    statistics computed live from the train split's trunk features."""
    from ..data.labels import powerset_error_labels
    from ..data.trials import compute_fold_stats, load_fold_trials
    from ..eval.serving import PixelFrontEnd, load_ensemble, predict_trial_from_pixels

    f1s, accs, weights = [], [], []
    for out in folds:
        fold_dir = os.path.join(args.pixels_root, out)
        train_trials = load_fold_trials(fold_dir, "train.csv")
        test_trials = load_fold_trials(fold_dir, "test.csv")
        kw = dict(batch_size=args.serve_batch_size, device=args.device)
        if not args.bf16_trunk:
            kw["dtype"] = torch.float32
        if args.int8_trunk:
            kw.update(int8=True, calib_frames=train_trials[0].image_feats[:32])
        fe = PixelFrontEnd.from_checkpoint(args.resnet_ckpt.format(fold=out), mesh=args.mesh,
                                           **kw)
        feats = np.concatenate([fe.features(t.image_feats) for t in train_trials])
        kins = np.concatenate([t.kinematics for t in train_trials])
        stats = compute_fold_stats(feats, kins)
        calib = fe_calibration(feats, stats, cfg.window_size) if args.int8_fe else None
        server = load_ensemble(args.runs_root, [args.run_a, args.run_b], args.setting, out,
                               mode="soft_vote", mesh=args.mesh, int8_fe_calib=calib,
                               device=args.device)
        all_preds, all_labels = [], []
        for t in test_trials:
            starts, preds, _ = predict_trial_from_pixels(
                fe, server, t.image_feats, t.kinematics, t.g_labels, cfg, stats)
            pw, nd_mask = powerset_error_labels(t.e_labels[starts], delete_ND=cfg.delete_ND)
            keep = ~nd_mask if cfg.delete_ND else np.ones(len(pw), bool)
            all_preds.append(preds[keep])
            all_labels.append(pw[keep, -1].astype(np.int64))
        labels = np.concatenate(all_labels)
        m, _ = score_predictions(labels, np.concatenate(all_preds), 2, "binary")
        f1s.append(m["f1"])
        accs.append(m["accuracy"])
        weights.append(len(labels))
        trunk = "int8" if args.int8_trunk else ("bf16" if args.bf16_trunk else "fp32")
        print(f"[{out}] pixel-serve f1={m['f1']:.3f} acc={m['accuracy']:.3f} trunk={trunk}")
    for name, vals in [("F1", f1s), ("Accuracy", accs)]:
        mu, sd = weighted_mean_std(vals, weights)
        print(f"pixel-serve soft_vote binary {name}: {mu:.3f} ± {sd:.3f}")


def _feature_store(server, images: np.ndarray) -> np.ndarray:
    """The fold's windows as the int8 feature store, quantized once by the
    layer-0 scale (which depends on the calibration batch alone, so one
    store serves every member), when every member that takes images has an
    int8 FeatureExtractor; the fp32 windows otherwise. The store gives the
    same probabilities as the fp32 windows."""
    from ..ops.quant import quantize_fe_input

    takers = [m for m in server.members if m.cfg.data_type != "kinematics"]
    if not takers or any(m.qfe is None for m in takers):
        return images
    return quantize_fe_input(takers[0].qfe, torch.from_numpy(images)).numpy()


def _serve(args, folds):
    """Live ensemble inference (eval/serving.py::EnsembleServer): the members
    re-run from their stored checkpoints over the fold's test windows,
    instead of re-scoring stored probabilities."""
    from ..data.datasets import build_window_fold
    from ..eval.serving import load_ensemble

    if args.mode != "soft_vote":
        raise SystemExit("--serve supports soft_vote (binary members)")
    args.mesh = mesh_from_args(args)
    if args.mesh is not None:
        print(f"serving mesh: {args.mesh.shape}")
    cfg = run_config(RunTracker.find_run(args.runs_root, args.run_a))
    if args.pixels_root:
        if not args.resnet_ckpt:
            raise SystemExit("--pixels-root needs --resnet-ckpt")
        return _serve_pixels(args, folds, cfg)
    f1s, accs, weights = [], [], []
    for out in folds:
        train_fold, test_fold = build_window_fold(os.path.join(args.data_root, out), cfg, None)
        calib = np.asarray(train_fold.images[:64], np.float32) if args.int8_fe else None
        server = load_ensemble(args.runs_root, [args.run_a, args.run_b], args.setting, out,
                               mode="soft_vote", mesh=args.mesh, int8_fe_calib=calib,
                               device=args.device)
        imgs = np.asarray(test_fold.images, np.float32)
        if args.int8_fe:
            imgs = _feature_store(server, imgs)
        preds, _ = server.predict(imgs, np.asarray(test_fold.kinematics, np.float32))
        n = len(test_fold)
        m, _ = score_predictions(np.asarray(test_fold.labels_for("global")), preds, 2,
                                 "binary")
        f1s.append(m["f1"])
        accs.append(m["accuracy"])
        weights.append(n)
        print(f"[{out}] serve f1={m['f1']:.3f} acc={m['accuracy']:.3f}")
    for name, vals in [("F1", f1s), ("Accuracy", accs)]:
        mu, sd = weighted_mean_std(vals, weights)
        print(f"serve soft_vote binary {name}: {mu:.3f} ± {sd:.3f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--setting", default="LOSO")
    p.add_argument("--folds", default=",".join(LOSO_FOLDS))
    p.add_argument("--mode", choices=["soft_vote", "cascade"], required=True)
    p.add_argument("--run-a", required=True,
                   help="binary run (video model / binary stage)")
    p.add_argument("--run-b", required=True,
                   help="binary run (kinematics model) or multiclass run")
    p.add_argument("--serve", action="store_true", default=False,
                   help="live inference from the stored checkpoints "
                        "(eval/serving.py) instead of offline re-scoring")
    p.add_argument("--data-root", default=None, help="fold data for --serve")
    add_mesh_flag(p)
    p.add_argument("--device", default=None,
                   help="torch device for --serve. Default: CUDA, which must be there; "
                        "'cpu' runs the kernels' plain versions")
    p.add_argument("--pixels-root", default=None,
                   help="--serve from RAW-FRAME fold dirs: the fine-tuned "
                        "ResNet-50 trunk runs live ahead of the ensemble "
                        "(no offline feature export)")
    p.add_argument("--resnet-ckpt", default=None,
                   help="resnet_finetune checkpoint for --pixels-root; "
                        "'{fold}' expands per fold")
    p.add_argument("--int8-fe", action="store_true", default=False,
                   help="serve members through the int8 PTQ FeatureExtractor, "
                        "calibrated on the train split")
    p.add_argument("--int8-trunk", action="store_true", default=False,
                   help="serve pixels through the int8 PTQ trunk (ops/quant.py)")
    p.add_argument("--bf16-trunk", action="store_true", default=True,
                   help="bf16 trunk compute for --pixels-root (default)")
    p.add_argument("--fp32-trunk", dest="bf16_trunk", action="store_false")
    p.add_argument("--serve-batch-size", type=int, default=128,
                   help="trunk batch for --pixels-root")
    args = p.parse_args(argv)

    folds = [f for f in args.folds.split(",") if f]
    if args.serve:
        if not (args.data_root or args.pixels_root):
            raise SystemExit("--serve needs --data-root or --pixels-root")
        return _serve(args, folds)
    dumps_a = {o: _load_fold_dump(args.runs_root, args.run_a, args.setting, o) for o in folds}
    dumps_b = {o: _load_fold_dump(args.runs_root, args.run_b, args.setting, o) for o in folds}

    if args.mode == "soft_vote":
        check_run_alignment(dumps_a, dumps_b)
        ov = prediction_overlap(dumps_a, dumps_b)
        print(f"overlap: both={ov['both_correct']:.3f} "
              f"one={ov['exactly_one_correct']:.3f} "
              f"neither={ov['both_wrong']:.3f}")
    else:
        # cascade: a delete_ND=False binary run is longer than a
        # delete_ND=True multiclass run; reconcile onto the multiclass
        # window set (reference ensemble.ipynb cell 15 mask surgery)
        for out in folds:
            na = len(np.asarray(dumps_a[out]["preds"]))
            nb = len(np.asarray(dumps_b[out]["preds"]))
            if na != nb:
                dumps_a[out] = reconcile_nd(dumps_a[out], dumps_b[out])
                print(f"[{out}] reconciled ND rows: binary {na} -> "
                      f"{len(np.asarray(dumps_a[out]['preds']))}")

    f1s, accs, jacs, weights = [], [], [], []
    mc_f1s, mc_accs, mc_jacs = [], [], []
    for out in folds:
        da, db = dumps_a[out], dumps_b[out]
        labels_a = np.asarray(da["labels"])
        if args.mode == "soft_vote":
            preds, _ = soft_vote(np.asarray(da["probs"]), np.asarray(db["probs"]))
            m, _ = score_predictions(labels_a, preds, 2, "binary")
        else:
            labels_mc = np.asarray(db["labels"])
            casc = cascade_ensemble(np.asarray(da["preds"]), np.asarray(db["preds"]))
            # binary metric vs the binary run's own (reconciled) labels
            # (reference cell 15 scores vs test_all_labels_specific_binary)
            y_bin = labels_a if len(labels_a) == len(casc) else (labels_mc > 0).astype(int)
            m, _ = score_predictions(y_bin, (casc > 0).astype(int), 2, "binary")
            mc_m, _ = score_predictions(labels_mc, casc, 6, "weighted")
            mc_f1s.append(mc_m["f1"])
            mc_accs.append(mc_m["accuracy"])
            mc_jacs.append(mc_m["jaccard"])
        f1s.append(m["f1"])
        accs.append(m["accuracy"])
        jacs.append(m["jaccard"])
        weights.append(len(labels_a))
        print(f"[{out}] f1={m['f1']:.3f} acc={m['accuracy']:.3f}")

    for name, vals in [("F1", f1s), ("Accuracy", accs), ("Jaccard", jacs)]:
        mu, sd = weighted_mean_std(vals, weights)
        print(f"{args.mode} binary {name}: {mu:.3f} ± {sd:.3f}")
    if args.mode == "cascade":
        for name, vals in [("F1", mc_f1s), ("Accuracy", mc_accs), ("Jaccard", mc_jacs)]:
            mu, sd = weighted_mean_std(vals, weights)
            print(f"cascade multiclass {name}: {mu:.3f} ± {sd:.3f}")


if __name__ == "__main__":
    main()
