"""6-class frame-level COG training (reference train_frame_ES.ipynb):
error-specific powerset classes, Needle-Drop frames dropped, binary + macro
metrics, windowed rollup. The counterpart of ``python -m
med_tpu.cli.train_frame_es``:

    python -m med_tpu_torch.cli.train_frame_es --data-root <folds>

It trains on the GPU and raises without one; ``--device cpu`` runs the
kernels' plain PyTorch versions instead."""

from __future__ import annotations

from .common import base_parser, config_from_args, run_frame_folds


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(model_name="COG", data_type="multimodal", delete_ND=True,
                   mstcn_stages=8, lr_scheduler=False, weight_decay=0.0,
                   n_epochs=7)
    args = p.parse_args(argv)
    cfg = config_from_args(args, error_type="all_errors", dataset_type="frame",
                           out_features=6, batch_size=1)
    return run_frame_folds(args, cfg)


if __name__ == "__main__":
    main()
