"""Binary frame-level training (reference train_frame.ipynb) over whole
trials (batch = 1), plus the frame->window metric rollup. The counterpart of
``python -m med_tpu.cli.train_frame``; of its three model families COG is
ported:

    python -m med_tpu_torch.cli.train_frame --model-name COG \\
        --data-type multimodal --data-root <folds>

It trains on the GPU and raises without one; ``--device cpu`` runs the
kernels' plain PyTorch versions instead."""

from __future__ import annotations

from .common import base_parser, config_from_args, run_frame_folds


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(model_name="TeCNo", data_type="video", video_dims=2048,
                   lr_scheduler=False, weight_decay=0.0, n_epochs=7)
    args = p.parse_args(argv)
    cfg = config_from_args(args, error_type="global", dataset_type="frame",
                           out_features=2, batch_size=1)
    if cfg.model_name != "COG":
        raise SystemExit(f"--model-name {cfg.model_name} is not ported yet: "
                         "ROADMAP.md Queue A6 (other frame families); "
                         "--model-name COG runs")
    return run_frame_folds(args, cfg)


if __name__ == "__main__":
    main()
