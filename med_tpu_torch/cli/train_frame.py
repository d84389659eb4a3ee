"""Binary frame-level training (reference train_frame.ipynb): TeCNo,
TransSVNet (refining a frozen TeCNo loaded from ``--run-id``), or COG over
whole trials (batch = 1), plus the frame->window metric rollup. The
counterpart of ``python -m med_tpu.cli.train_frame``:

    python -m med_tpu_torch.cli.train_frame --data-root <folds>   # TeCNo
    python -m med_tpu_torch.cli.train_frame --data-root <folds> \\
        --model-name TransSVNet --run-id <the TeCNo run>
    python -m med_tpu_torch.cli.train_frame --model-name COG \\
        --data-type multimodal --data-root <folds>
    python -m med_tpu_torch.cli.train_frame --model-name MiMoV2Flash \\
        --data-type multimodal --data-root <folds> --lr 1e-5

MiMoV2Flash (``models/mimo.py``) is built at the published widths with the
7 layers and 8 experts one chip holds (``MiMoArch``'s defaults: ~2.1 B
parameters, ~33 GB with Adam's state).

It trains on the GPU and raises without one; ``--device cpu`` runs the
kernels' plain PyTorch versions instead."""

from __future__ import annotations

import os

from ..tracking import RunTracker
from ..train.checkpoint import load_best_checkpoint
from .common import base_parser, config_from_args, run_frame_folds


def _frozen_fn(args):
    """fold -> the frozen TeCNo of that fold, the best checkpoint of run
    ``--run-id`` (an ``.npz`` of either package, or a reference ``.pt``)."""
    run_dir = RunTracker.find_run(args.runs_root, args.run_id)

    def fn(out):
        ckpt = load_best_checkpoint(os.path.join(run_dir, "checkpoints"), args.setting,
                                    out, model_name="TeCNo")
        return {"tecno_params": ckpt["params"]["model"]}

    return fn


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(model_name="TeCNo", data_type="video", video_dims=2048,
                   lr_scheduler=False, weight_decay=0.0, n_epochs=7)
    args = p.parse_args(argv)
    cfg = config_from_args(args, error_type="global", dataset_type="frame",
                           out_features=2, batch_size=1)
    frozen_fn = None
    if cfg.model_name == "TransSVNet":
        if not args.run_id:
            raise SystemExit("TransSVNet needs --run-id of a trained TeCNo run")
        frozen_fn = _frozen_fn(args)
    return run_frame_folds(args, cfg, frozen_fn=frozen_fn)


if __name__ == "__main__":
    main()
