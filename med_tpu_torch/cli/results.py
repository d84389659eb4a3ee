"""Cross-run result analysis driver (port of ``med_tpu.cli.results``, the
same flags, defaults and printed lines; reference notebooks/results.ipynb).
It reads the run layout that both packages write, on the host alone.

The reference's results notebook builds run-id tables for 7 models x 3
modalities and derives comparison tables (cells 1-2), per-error-type F1
(cells 8/12), paired t-tests (cells 14-22) and majority-class baselines
(cells 23-26); ensemble.ipynb adds prediction-overlap and probability-
distribution analyses. This driver exposes the same analyses
(eval/results.py) over stored run directories — subcommands:

  table     --run label=RUN_ID [--run ...]     cross-model comparison table
  errors    --run-id RUN_ID                    per-error-type F1 of a binary run
  majority  --run-id RUN_ID                    majority-class baseline
  ttest     --run-a RUN_ID --run-b RUN_ID      paired t-test over per-fold F1
  overlap   --run-a RUN_ID --run-b RUN_ID      prediction-overlap fractions
  hist      --run-id RUN_ID --out-image F.png  probability histograms
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

import numpy as np

from ..config import LOSO_FOLDS
from ..eval.ensemble import score_predictions
from ..eval.results import (
    check_run_alignment,
    load_run_dumps,
    majority_baseline,
    model_comparison_table,
    paired_t_test,
    per_error_type_f1,
    prediction_overlap,
    probability_histograms,
)


def _fold_f1s(dumps: Dict[str, dict], n_classes: int, average: str,
              folds: Sequence[str]):
    """Per-fold F1 recomputed from the stored prediction dumps (the paired
    t-test's samples, results.ipynb cells 14-22)."""
    return [
        score_predictions(
            np.asarray(dumps[f]["labels"]).astype(int),
            np.asarray(dumps[f]["preds"]).astype(int),
            n_classes, average,
        )[0]["f1"]
        for f in folds
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", choices=["table", "errors", "majority",
                                       "ttest", "overlap", "hist"])
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--setting", default="LOSO")
    p.add_argument("--folds", default=",".join(LOSO_FOLDS))
    p.add_argument("--run", action="append", default=[],
                   help="label=RUN_ID row for 'table' (repeatable)")
    p.add_argument("--run-id", default=None,
                   help="run for 'errors' / 'majority' / 'hist'")
    p.add_argument("--run-a", default=None)
    p.add_argument("--run-b", default=None)
    p.add_argument("--n-classes", type=int, default=2)
    p.add_argument("--average", default="binary",
                   help="binary | weighted | macro")
    p.add_argument("--out-image", default="prob_hist.png")
    args = p.parse_args(argv)

    folds = [f for f in args.folds.split(",") if f]

    def load(run_id):
        return load_run_dumps(args.runs_root, run_id, args.setting, folds)

    if args.command == "table":
        if not args.run:
            raise SystemExit("table needs at least one --run label=RUN_ID")
        runs = {}
        for spec in args.run:
            label, _, run_id = spec.partition("=")
            if not run_id:
                raise SystemExit(f"--run {spec!r}: expected label=RUN_ID")
            runs[label] = (run_id, "")
        table = model_comparison_table(
            runs, args.runs_root, args.setting, folds,
            average=args.average, n_classes=args.n_classes)
        width = max(len(k) for k in table)
        cols = list(next(iter(table.values())))
        print(" " * width + "  " + "  ".join(f"{c:>15}" for c in cols))
        for label, row in table.items():
            print(f"{label:<{width}}  "
                  + "  ".join(f"{row[c]:>15}" for c in cols))
    elif args.command == "errors":
        if not args.run_id:
            raise SystemExit("errors needs --run-id")
        for name, (mu, sd) in per_error_type_f1(load(args.run_id)).items():
            print(f"per-error-type F1 [{name}]: {mu:.3f} ± {sd:.3f}")
    elif args.command == "majority":
        if not args.run_id:
            raise SystemExit("majority needs --run-id")
        res = majority_baseline(load(args.run_id), args.n_classes,
                                args.average)
        for name, (mu, sd) in res.items():
            print(f"majority baseline {name}: {mu:.3f} ± {sd:.3f}")
    elif args.command == "ttest":
        if not (args.run_a and args.run_b):
            raise SystemExit("ttest needs --run-a and --run-b")
        da, db = load(args.run_a), load(args.run_b)
        fa = _fold_f1s(da, args.n_classes, args.average, folds)
        fb = _fold_f1s(db, args.n_classes, args.average, folds)
        t, pv = paired_t_test(fa, fb)
        print(f"per-fold F1 A: {[f'{v:.3f}' for v in fa]}")
        print(f"per-fold F1 B: {[f'{v:.3f}' for v in fb]}")
        print(f"paired t-test: t={t:.3f} p={pv:.4f}")
    elif args.command == "overlap":
        if not (args.run_a and args.run_b):
            raise SystemExit("overlap needs --run-a and --run-b")
        da, db = load(args.run_a), load(args.run_b)
        check_run_alignment(da, db)
        ov = prediction_overlap(da, db)
        print(f"overlap: both={ov['both_correct']:.3f} "
              f"one={ov['exactly_one_correct']:.3f} "
              f"neither={ov['both_wrong']:.3f} (n={ov['n']})")
    elif args.command == "hist":
        if not args.run_id:
            raise SystemExit("hist needs --run-id")
        path = probability_histograms(load(args.run_id), args.out_image)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
