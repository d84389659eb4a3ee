"""Binary window-level training (reference train_window.ipynb): SimpleCNN,
SimpleLSTM or the siamese twins over 2-second windows, LOSO folds, the best
epoch by test weighted-F1. The siamese models build their pair sets on the
fly (``data.siamese``). The counterpart of ``python -m
med_tpu.cli.train_window``:

    python -m med_tpu_torch.cli.train_window --model-name SimpleLSTM \\
        --data-root <folds>

It trains on the GPU and raises without one; ``--device cpu`` runs on the
CPU instead."""

from __future__ import annotations

from ..data.siamese import (
    create_test_pairs,
    create_train_pairs,
    materialize_pairs,
    sample_balanced_pairs,
)
from .common import base_parser, config_from_args, run_window_folds


def _siamese_data_fn(cfg):
    """(fold, train split, test split) -> the fold's materialized pairs:
    ``n_pairs`` balanced train pairs, and each test window against
    ``n_comparisons`` clean train windows (see ``train_window_fold``)."""
    def fn(out, train_fold, test_fold):
        e_tr = train_fold.e_powerset[:, -1]
        e_te = test_fold.e_powerset[:, -1]
        pairs = create_train_pairs(train_fold.g_labels, e_tr, train_fold.subjects)
        pairs = sample_balanced_pairs(pairs, cfg.n_pairs, seed=cfg.seed)
        tr = materialize_pairs(pairs, train_fold.images, train_fold.kinematics)
        tpairs = create_test_pairs(
            test_fold.g_labels, e_te, test_fold.subjects, e_tr,
            n_comparisons=cfg.n_comparisons, seed=cfg.seed,
        )
        te = materialize_pairs(
            tpairs, train_fold.images, train_fold.kinematics,
            test_fold.images, test_fold.kinematics,
        )
        return {
            "train": tr,
            "test": te,
            "test_position_2": tpairs["position_2"],
            "test_window_labels": e_te,
        }

    return fn


def main(argv=None):
    p = base_parser(__doc__)
    args = p.parse_args(argv)
    cfg = config_from_args(args, error_type="global", dataset_type="window",
                           out_features=1)
    siamese = cfg.model_name.startswith("Siamese") or cfg.siamese
    cfg = cfg.replace(siamese=siamese)
    return run_window_folds(args, cfg,
                            siamese_fn=_siamese_data_fn(cfg) if siamese else None)


if __name__ == "__main__":
    main()
