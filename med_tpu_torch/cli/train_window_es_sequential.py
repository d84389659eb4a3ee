"""Stage-2 sequential window training (reference
train_window_ES_sequential.ipynb): a 5-class error-specific model trained on
true-error windows only; at eval a trained per-fold *binary* model (the
best checkpoint of a ``train_window`` run, ``--run-id``) gates the 5-class
head, and windows it predicts clean are class 0 (modeling_utils.py:543-684,
907-1053). The counterpart of ``python -m
med_tpu.cli.train_window_es_sequential``:

    python -m med_tpu_torch.cli.train_window_es_sequential --data-root <folds> \\
        --run-id <a binary run of train_window>

It trains, and runs the binary stage, on the GPU and raises without one;
``--device cpu`` runs on the CPU instead."""

from __future__ import annotations

import os

import numpy as np

from ..config import ExperimentConfig, run_config
from ..tracking import RunTracker
from ..train.checkpoint import load_best_checkpoint
from ..train.engine import Experiment
from ..train.loop import evaluate_window_fold
from .common import base_parser, config_from_args, run_window_folds


def _binary_cfg_from_run(runs_root: str, run_id: str) -> ExperimentConfig:
    return run_config(RunTracker.find_run(runs_root, run_id))


def _gate_fn(args, cfg_seq: ExperimentConfig):
    """(fold, train split, test split) -> the fold's gates: the binary
    stage's predictions over this stage's (Needle-Drop filtered) test
    windows, from its run's best checkpoint of that fold and its
    ``params.json`` config; the true errors of the train windows
    (``use_true_binary_labels_train``)."""
    run_dir = RunTracker.find_run(args.runs_root, args.run_id)
    cfg_bin = _binary_cfg_from_run(args.runs_root, args.run_id)
    # the gate must be computed on the sequential stage's window set
    cfg_bin = cfg_bin.replace(delete_ND=cfg_seq.delete_ND,
                              batch_size=cfg_seq.batch_size)
    exp_bin = Experiment(cfg_bin, device=args.device)

    def fn(out, train_fold, test_fold):
        exp_bin.load_params(load_best_checkpoint(
            os.path.join(run_dir, "checkpoints"), args.setting, out,
            model_name=cfg_bin.model_name))
        ev = evaluate_window_fold(cfg_bin, exp_bin, test_fold)
        gate_test = np.asarray(ev["preds"]).astype(np.float32)
        gate_train = (train_fold.labels_for("sequential") != 0).astype(np.float32)
        return {"train": {"gate": gate_train}, "test": {"gate": gate_test}}

    return fn


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(model_name="SimpleLSTM", delete_ND=True)
    args = p.parse_args(argv)
    if not args.run_id:
        raise SystemExit("--run-id of the trained binary stage is required")
    cfg = config_from_args(args, error_type="sequential",
                           dataset_type="window", out_features=5)
    return run_window_folds(args, cfg, extras_fn=_gate_fn(args, cfg))


if __name__ == "__main__":
    main()
