"""6-class (error-specific) window training (reference
train_window_ES.ipynb): powerset classes {NoErr, OOV, MA, NP, OOV+MA,
MA+NP}, Needle-Drop windows dropped, CE with optional reciprocal-frequency
class weights. The counterpart of ``python -m med_tpu.cli.train_window_es``:

    python -m med_tpu_torch.cli.train_window_es --data-root <folds>

It trains on the GPU and raises without one; ``--device cpu`` runs on the
CPU instead."""

from __future__ import annotations

from .common import base_parser, config_from_args, run_window_folds


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(model_name="SimpleLSTM", delete_ND=True)
    args = p.parse_args(argv)
    cfg = config_from_args(args, error_type="all_errors",
                           dataset_type="window", out_features=6)
    return run_window_folds(args, cfg)


if __name__ == "__main__":
    main()
