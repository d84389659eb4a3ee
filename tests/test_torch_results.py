"""Cross-run results and plots in the port (med_tpu_torch.eval.results,
cli.results, viz, cli.common's fold plots) against med_tpu's on the same
run directories, on the CPU.

Tolerances: every function's result and every printed line exactly equal;
the plots equal pixel for pixel (the same matplotlib calls on the same
numbers), read back with matplotlib.image.imread.
"""

import json
import os
import types

import matplotlib.image as mpimg
import numpy as np
import pytest

from med_tpu.cli import common as jcommon
from med_tpu.cli import results as jcli
from med_tpu.eval import results as jres
from med_tpu.viz import utils as jviz
from med_tpu_torch.cli import common as tcommon
from med_tpu_torch.cli import results as tcli
from med_tpu_torch.eval import results as tres
from med_tpu_torch.viz import utils as tviz

FOLDS = ("1Out", "2Out", "3Out")


def _dump(rng, n, classes=2):
    raw = np.zeros((n, 5), np.int64)
    err = rng.random(n) < 0.4
    raw[err, 4] = 1
    raw[np.flatnonzero(err), rng.integers(0, 4, int(err.sum()))] = 1
    labels = raw[:, 4] if classes == 2 else np.where(err, rng.integers(1, classes, n), 0)
    probs = rng.random(n)
    preds = (probs > 0.5).astype(int) if classes == 2 else rng.integers(0, classes, n)
    return {"labels": labels.tolist(), "preds": preds.tolist(), "probs": probs.tolist(),
            "raw_labels": raw.tolist(), "gestures": rng.integers(1, 9, n).tolist(),
            "subjects": [f"Needle_Passing_B00{i % 3}" for i in range(n)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three runs over three folds in the run layout both packages write:
    two binary runs aligned window for window, and a 6-class run."""
    rng = np.random.default_rng(5)
    root = str(tmp_path_factory.mktemp("runs"))
    sizes = {"1Out": 80, "2Out": 65, "3Out": 95}
    aligned = {f: _dump(rng, n) for f, n in sizes.items()}
    made = {"a": aligned,
            "b": {f: dict(d, preds=rng.integers(0, 2, len(d["preds"])).tolist(),
                          probs=rng.random(len(d["preds"])).tolist())
                  for f, d in aligned.items()},
            "six": {f: _dump(rng, n, 6) for f, n in sizes.items()}}
    for run_id, dumps in made.items():
        run = os.path.join(root, "exp", run_id)
        os.makedirs(os.path.join(run, "artifacts"))
        for fold, d in dumps.items():
            with open(os.path.join(run, "artifacts", f"best_model_LOSO_{fold}.json"), "w") as f:
                json.dump(d, f)
    return root


def test_results_functions_equal_jax(runs):
    dumps = {r: tres.load_run_dumps(runs, r, "LOSO", FOLDS) for r in ("a", "b", "six")}
    for r, d in dumps.items():
        assert d == jres.load_run_dumps(runs, r, "LOSO", FOLDS)
    assert tres.per_error_type_f1(dumps["a"]) == jres.per_error_type_f1(dumps["a"])
    for r, n, avg in (("a", 2, "binary"), ("six", 6, "weighted"), ("six", 6, "macro")):
        assert tres.majority_baseline(dumps[r], n, avg) == jres.majority_baseline(dumps[r], n,
                                                                                  avg)
        spec = {"x": (r, ""), "y": ("b", "")} if n == 2 else {"x": (r, "")}
        assert tres.model_comparison_table(spec, runs, "LOSO", FOLDS, avg, n) == \
            jres.model_comparison_table(spec, runs, "LOSO", FOLDS, avg, n)
    fa, fb = [0.61, 0.55, 0.72], [0.58, 0.57, 0.66]
    assert tres.paired_t_test(fa, fb) == jres.paired_t_test(fa, fb)
    tres.check_run_alignment(dumps["a"], dumps["b"])
    assert tres.prediction_overlap(dumps["a"], dumps["b"]) == \
        jres.prediction_overlap(dumps["a"], dumps["b"])
    for fn in (tres.check_run_alignment, jres.check_run_alignment):
        with pytest.raises(ValueError, match="not positionally aligned"):
            fn(dumps["a"], dumps["six"])
        with pytest.raises(ValueError, match="missing"):
            fn(dumps["a"], {"1Out": dumps["b"]["1Out"]})


COMMANDS = [["table", "--run", "a=a", "--run", "b=b"],
            ["table", "--run", "six=six", "--n-classes", "6", "--average", "macro"],
            ["errors", "--run-id", "a"], ["majority", "--run-id", "a"],
            ["majority", "--run-id", "six", "--n-classes", "6", "--average", "weighted"],
            ["ttest", "--run-a", "a", "--run-b", "b"], ["overlap", "--run-a", "a", "--run-b", "b"]]


@pytest.mark.parametrize("argv", COMMANDS, ids=lambda a: "_".join(a[:1] + a[2:3]))
def test_results_cli_prints_what_jax_prints(runs, capsys, argv):
    argv = argv + ["--runs-root", runs, "--folds", ",".join(FOLDS)]
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv)
    assert capsys.readouterr().out == want


def _same_png(a, b):
    x, y = mpimg.imread(a), mpimg.imread(b)
    assert x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def test_results_hist_and_plots_equal_jax_pixel_for_pixel(runs, tmp_path, capsys):
    """The hist subcommand's probability histograms, the fold curves and the
    binary, 6-class and 5-class confusion matrices."""
    base = ["hist", "--run-id", "a", "--runs-root", runs, "--folds", ",".join(FOLDS)]
    jcli.main(base + ["--out-image", str(tmp_path / "jax.png")])
    tcli.main(base + ["--out-image", str(tmp_path / "port.png")])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote {tmp_path / 'jax.png'}", f"wrote {tmp_path / 'port.png'}"]
    _same_png(tmp_path / "jax.png", tmp_path / "port.png")

    curves = ([0.5, 0.6, 0.7], [0.4, 0.45, 0.5], [0.9, 0.7, 0.6], [1.0, 0.9, 0.95])
    a = tviz.plot_results_LOSO(*curves, "LOSO", "1Out", str(tmp_path / "port"))
    b = jviz.plot_results_LOSO(*curves, "LOSO", "1Out", str(tmp_path / "jax"))
    assert os.path.basename(a) == os.path.basename(b) == "LOSO_fold_1Out_results.png"
    _same_png(a, b)
    rng = np.random.default_rng(2)
    for n, binary in ((2, "global"), (6, None), (5, None)):
        train, test = rng.integers(0, 50, (n, n)), rng.integers(0, 50, (n, n))
        pa = tviz.plot_cm(train, test, str(tmp_path / f"port{n}"), binary=binary)
        pb = jviz.plot_cm(train, test, str(tmp_path / f"jax{n}"), binary=binary)
        assert [os.path.basename(p) for p in pa] == [os.path.basename(p) for p in pb]
        for x, y in zip(pa, pb):
            _same_png(x, y)


def test_driver_fold_plots_equal_jax(tmp_path, capsys):
    """cli.common._plot_fold, which the port's window and frame drivers
    call after each fold: med_tpu's file names, the same pixels; a failure
    prints one line and the run goes on."""
    history = [{"train_f1": 0.1 * i, "test_f1": 0.05 * i, "train_loss": 1 - 0.1 * i,
                "test_loss": 1.1 - 0.1 * i} for i in range(4)]
    best = {"cm": [[5, 2], [1, 7]]}
    for pkg, name in ((tcommon, "port"), (jcommon, "jax")):
        pkg._plot_fold(types.SimpleNamespace(dir=str(tmp_path / name)), history, "LOSO",
                       "2Out", best)
    files = sorted(os.listdir(tmp_path / "port" / "images"))
    assert files == sorted(os.listdir(tmp_path / "jax" / "images")) == [
        "LOSO_Test_Confusion_Matrix_global.png", "LOSO_fold_2Out_results.png"]
    for f in files:
        _same_png(tmp_path / "port" / "images" / f, tmp_path / "jax" / "images" / f)
    capsys.readouterr()
    tcommon._plot_fold(types.SimpleNamespace(dir=str(tmp_path / "bad")), history, "LOSO",
                       "2Out", {"cm": "not a matrix"})
    assert capsys.readouterr().out.startswith("plotting skipped:")
