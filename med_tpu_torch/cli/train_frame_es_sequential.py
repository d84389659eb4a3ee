"""Stage-2 sequential frame-level COG (reference
train_frame_ES_sequential.ipynb): a 5-class COG trained on true-error frames
(``use_true_binary_labels_train``), eval-gated by a trained binary COG
run's per-frame predictions (``--run-id``), the gates made on this stage's
frame set (Needle-Drop frames dropped as here). The counterpart of
``python -m med_tpu.cli.train_frame_es_sequential``:

    python -m med_tpu_torch.cli.train_frame_es_sequential --data-root <folds> \\
        --run-id <a binary COG run of train_frame>

It trains, and runs the binary stage, on the GPU and raises without one;
``--device cpu`` runs the kernels' plain PyTorch versions instead."""

from __future__ import annotations

import os

import numpy as np

from ..config import ExperimentConfig, run_config
from ..data.datasets import frame_batch
from ..tracking import RunTracker
from ..train.checkpoint import load_best_checkpoint
from ..train.engine import Experiment
from .common import base_parser, config_from_args, run_frame_folds


def _gates_fn(args, cfg_seq: ExperimentConfig):
    """(fold, train trials, test trials) -> the fold's gates: the binary
    stage's predictions on each test trial, from its run's best checkpoint
    of that fold and its ``params.json`` config (with this stage's
    ``delete_ND``), trimmed to the trial's frames; each train trial's
    true-error frames."""
    run_dir = RunTracker.find_run(args.runs_root, args.run_id)
    cfg_bin = run_config(run_dir).replace(delete_ND=cfg_seq.delete_ND)
    exp_bin = Experiment(cfg_bin, device=args.device)

    def fn(out, train_trials, test_trials):
        exp_bin.load_params(load_best_checkpoint(
            os.path.join(run_dir, "checkpoints"), args.setting, out,
            model_name=cfg_bin.model_name))
        gates = {"train": {}, "test": {}}
        for trial in test_trials:
            b = frame_batch(trial, cfg_bin)
            m = exp_bin.eval_step({k: b[k] for k in ("images", "kinematics")})
            gates["test"][trial.name] = (
                m["preds"].cpu().numpy()[:trial.n_frames].astype(np.float32))
        for trial in train_trials:   # true-label gating during training
            gates["train"][trial.name] = (
                trial.labels_for("sequential") != 0).astype(np.float32)
        return gates

    return fn


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(model_name="COG", data_type="multimodal", delete_ND=True,
                   mstcn_stages=8, lr_scheduler=False, weight_decay=0.0,
                   n_epochs=7, smooth_lambda=0.0)
    args = p.parse_args(argv)
    if not args.run_id:
        raise SystemExit("--run-id of the trained binary COG stage is required")
    cfg = config_from_args(args, error_type="sequential", dataset_type="frame",
                           out_features=5, batch_size=1)
    return run_frame_folds(args, cfg, gates_fn=_gates_fn(args, cfg))


if __name__ == "__main__":
    main()
