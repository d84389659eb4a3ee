"""Fold parallelism and the parallel CLI flags in the port
(med_tpu_torch/parallel/folds.py, cli/common.py), against med_tpu's
FoldParallel and FoldParallelWindowRun and against the port's sequential
folds (med_tpu's tests/test_parallel.py::test_fold_parallel_matches_sequential
and ::test_fold_parallel_whole_run_matches_sequential_fused_runs,
tests/test_cli.py::test_fold_parallel_cli_matches_sequential and
::test_trial_dp_cli_matches_single_device):

- one batched step of two folds equals med_tpu's vmapped step from the same
  weights, batches and injected dropout masks (each fold's loss 1e-5, cm,
  every gradient 2e-5 of its leaf's largest, med_tpu's from Adam's first
  moment; the eval step after it), and each fold's own engine step;
- the folds of different sizes trained as one batched program
  (``torch.func.vmap``, no per-fold fallback: its warning is an error
  here) equal med_tpu's whole-run program on the same masks (the train
  loss of the first epoch to 1e-5, later epochs to 2e-3: med_tpu's own
  tolerances) and each fold's own sequential run. Against the sequential
  run the masks are drawn, and Adam lifts batched-against-unbatched
  rounding: SimpleCNN's first epoch 3e-5 (measured 1.1e-5), later epochs
  and the unrolled LSTM's 2e-3 (measured 5.4e-4 in its first epoch); at a
  learning rate of 0 the same runs agree to 3e-6 in every epoch;
- a surplus step leaves its fold's state exactly as it was;
- ``--fold-parallel`` and ``--trial-dp`` on one rank and on 2 spawned
  ranks (``--mesh 2,1``; rank 0 writes the run) against the sequential CLI;
- the refusals med_tpu makes.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_driver import SMALL_FLAGS, _write_fold
from test_torch_window import config_fields, fold_fields, jax_experiment, leaves

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data.datasets import WindowFold as JaxWindowFold
from med_tpu.parallel import folds as jfolds

from med_tpu_torch.cli import train_frame as fcli
from med_tpu_torch.cli import train_window as wcli
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import WindowFold, window_batches
from med_tpu_torch.eval.serving import EnsembleServer, WindowModelBundle
from med_tpu_torch.parallel import launch
from med_tpu_torch.parallel.folds import (FoldParallel, FoldParallelWindowRun, stack_trees,
                                          unstack_tree)
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.train.loop import train_window_fold
from med_tpu_torch.utils.jax_params import export_jax_params
from torch_rank_bodies import folds_suite

WINDOW = ("--device", "cpu", "--video-dims", "8", "--batch-size", "32", "--n-epochs", "2",
          "--folds", "1Out,2Out")
FRAME = (*SMALL_FLAGS, "--data-type", "kinematics", "--model-name", "TeCNo",
         "--mstcn-layers", "3", "--mstcn-f-maps", "8", "--trial-batch", "2",
         "--no-fused-epoch", "--no-fused-run", "--n-epochs", "2", "--folds", "1Out")



def _folds(rng):
    """Two folds of different sizes (3 and 2 steps an epoch)."""
    return [(WindowFold(**fold_fields(rng, n, 10)), WindowFold(**fold_fields(rng, m, 10)))
            for n, m in ((96, 40), (70, 45))]


# the unrolled LSTM sums its recurrence in another order than torch.lstm
GRAD_FRAC = {"SimpleCNN": 2e-5, "SimpleLSTM": 5e-5}


@pytest.mark.parametrize("name", ["SimpleCNN", "SimpleLSTM"])
def test_one_batched_step_is_each_folds_engine_step(name):
    """One step of both folds in one vmapped call: each fold's loss, cm and
    every gradient are its engine step's on the same masks."""
    rng = np.random.default_rng(4)
    cfg = ExperimentConfig(**config_fields(name, batch_size=32, pos_weight=True))
    folds = _folds(rng)
    exp = Experiment(cfg, device="cpu")
    fp = FoldParallel(exp)
    counts = [tloop._class_counts(cfg, tr) for tr, _ in folds]
    state = fp.init_states([cfg.seed] * 2, counts)
    batches = [next(window_batches(tr, cfg, shuffle=True)) for tr, _ in folds]
    stacked = {k: torch.as_tensor(np.stack([b[k] for b in batches]))
               for k in ("images", "kinematics", "labels", "mask")}
    masks = fp.draw_masks(state, np.ones(2, bool), cfg.batch_size)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a vmap fallback warns
        grads, loss, cm, _ = fp._train(state["params"], state["buffers"], stacked, masks,
                                       state["class_counts"])
    for f, batch in enumerate(batches):
        exp.init_weights(cfg.seed, counts[f])
        one, m = exp.compute_gradients(batch, masks=[k[f] for k in masks])
        np.testing.assert_allclose(float(loss[f]), float(one), rtol=1e-5)
        np.testing.assert_array_equal(cm[f].numpy(), m["cm"].numpy())
        for k, p in exp.net.named_parameters():
            want = p.grad.numpy()
            np.testing.assert_allclose(grads[f"net.{k}"][f].numpy(), want, rtol=1e-4,
                                       atol=GRAD_FRAC[name] * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("name", ["SimpleCNN", "SimpleLSTM"])
def test_fold_parallel_run_matches_sequential_folds(name):
    """Two epochs of both folds: each fold's history rows, best epoch and
    predictions against its own sequential run, on the masks each draws.
    Adam's first steps move a weight whose gradient is float32 noise by a
    whole learning rate either way, so the trajectories part slowly:
    SimpleCNN's first-epoch train loss to 3e-5 (measured 1.1e-5), later
    epochs to 2e-3 (med_tpu's tolerance after the first epoch); the
    unrolled LSTM sums its recurrence in another order than torch.lstm and
    parts faster, 2e-3 throughout (measured 5.4e-4 in the first epoch)."""
    rng = np.random.default_rng(9)
    cfg = ExperimentConfig(**config_fields(name, batch_size=32, n_epochs=2, lr=1e-3))
    folds = _folds(rng)
    exp = Experiment(cfg, device="cpu")
    seq = [train_window_fold(cfg, tr, te, exp=exp) for tr, te in folds]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        par = FoldParallelWindowRun(exp, cfg, folds).run()
    for s, p in zip(seq, par):
        for e, (a, b) in enumerate(zip(s["history"], p["history"])):
            tol = 3e-5 if e == 0 and name == "SimpleCNN" else 2e-3
            assert b["train_loss"] == pytest.approx(a["train_loss"], abs=tol)
            assert b["test_loss"] == pytest.approx(a["test_loss"], abs=2e-3)
        assert p["best"]["epoch"] == s["best"]["epoch"]
        assert np.mean(np.asarray(s["best"]["preds"]) == np.asarray(p["best"]["preds"])) > 0.99


@pytest.mark.parametrize("name", ["SimpleCNN", "SimpleLSTM"])
def test_fold_parallel_run_at_lr_0_is_the_sequential_run(name):
    """The same folds at a learning rate of 0: the weights stay and only the
    running statistics move, so nothing lifts the rounding, and every
    epoch's train and test losses agree with the sequential run's to 3e-6
    (measured up to 1.2e-6 of losses of 0.5-1.0, the unrolled LSTM's; the
    CNN's 8e-8): the batched program computes the sequential one's
    numbers."""
    rng = np.random.default_rng(9)
    cfg = ExperimentConfig(**config_fields(name, batch_size=32, n_epochs=2, lr=0.0))
    folds = _folds(rng)
    exp = Experiment(cfg, device="cpu")
    seq = [train_window_fold(cfg, tr, te, exp=exp) for tr, te in folds]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        par = FoldParallelWindowRun(exp, cfg, folds).run()
    for s, p in zip(seq, par):
        for a, b in zip(s["history"], p["history"]):
            for k in ("train_loss", "test_loss"):
                assert b[k] == pytest.approx(a[k], rel=0, abs=3e-6), k
            for k in ("train_f1", "test_f1", "test_acc"):
                assert b[k] == pytest.approx(a[k], abs=1e-12), k
        np.testing.assert_array_equal(s["best"]["preds"], p["best"]["preds"])


def _tied_units(batch, tree, frac=2e-6):
    """The FeatureExtractor's first-layer units whose pre-activation lies
    within ``frac`` of the layer's largest |value| on some row, in float64:
    where float32's last digits may send the relu either way. The forward
    passes ~0 there either way; only the unit's own weights' gradients
    (its bias entry and kernel column) take the row's or not."""
    dense0 = tree["params"]["fe"]["dense0"]
    pre = (batch["images"].reshape(-1, batch["images"].shape[-1]).astype(np.float64)
           @ dense0["kernel"].astype(np.float64) + dense0["bias"])
    return np.flatnonzero((np.abs(pre) < frac * np.abs(pre).max()).any(axis=0))


def _stacked_masks(masks, F=2):
    return [m.unsqueeze(0).expand(F, *m.shape) for m in masks]


@pytest.mark.parametrize("name", ["SimpleCNN", "SimpleLSTM"])
def test_one_batched_step_matches_med_tpus_fold_parallel(name):
    """One train step of two folds, in one vmapped call on each side
    (med_tpu's FoldParallel: jax.vmap over its step), from the same weights
    and class counts, on two folds' batches, with one set of dropout masks
    injected on both sides: each fold's loss (1e-5), cm and every gradient
    (2e-5 of the leaf's largest, 5e-5 for the unrolled LSTM; med_tpu's from
    Adam's first moment, 0.1 g); and the eval step from the same weights
    (losses 1e-5, predictions equal). A FeatureExtractor unit
    whose first-layer pre-activation ties at 0 on a row (``_tied_units``;
    a few of 512) leaves its own bias entry and kernel column out of the
    comparison: the two packages' float32 relus may take it either way."""
    rng = np.random.default_rng(4)
    fields = config_fields(name, batch_size=32, pos_weight=True)
    cfg = ExperimentConfig(**fields)
    folds = _folds(rng)
    counts = tloop._class_counts(cfg, folds[0][0])
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed, counts)
    tree = export_jax_params(exp.net)
    masks = exp.net.model.dropout_masks(cfg.batch_size, torch.Generator().manual_seed(4))
    batches = [next(window_batches(tr, cfg, shuffle=True)) for tr, _ in folds]
    batches = [{k: b[k] for k in ("images", "kinematics", "labels", "mask")} for b in batches]
    batches[1]["mask"][-5:] = 0.0                          # a short batch
    stacked = {k: torch.as_tensor(np.stack([b[k] for b in batches])) for k in batches[0]}

    fp = FoldParallel(exp)
    state = fp.init_states([cfg.seed] * 2, [counts] * 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ev = fp.eval_step(state, stacked)
        grads, loss, cm, _ = fp._train(state["params"], state["buffers"], stacked,
                                       _stacked_masks(masks), state["class_counts"])

    jexp, intercept, _ = jax_experiment(fields, tree, masks)
    jfp = jfolds.FoldParallel(jexp)
    jstate = jfp.init_states([jax.random.key(0)] * 2, batches, class_counts=counts)
    with intercept():
        jev = jfp.eval_step(jstate, jfp.shard_batches(batches))
        jstate, jm = jfp.train_step(jstate, jfp.shard_batches(batches))
    mu = jax.device_get(jstate.opt_state[1].mu)
    for f in range(2):
        np.testing.assert_allclose(float(loss[f]), float(jm["loss"][f]), rtol=1e-5)
        np.testing.assert_array_equal(cm[f].numpy(), np.asarray(jm["cm"][f]))
        for k, p in exp.net.named_parameters():
            p.grad = grads[f"net.{k}"][f]
        got = leaves(export_jax_params(exp.net, grads=True)["params"])
        want = {path: w[f] / 0.1 for path, w in leaves(mu).items()}
        assert set(got) == set(want)
        tied = _tied_units(batches[f], tree)
        assert len(tied) <= 16, tied                     # of 512 units
        for path, w in want.items():
            g, atol = got[path], GRAD_FRAC[name] * np.abs(w).max()
            if path.startswith("fe/dense0/"):
                g, w = np.delete(g, tied, axis=-1), np.delete(w, tied, axis=-1)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=path)
        np.testing.assert_allclose(float(ev["loss"][f]), float(jev["loss"][f]), rtol=1e-5)
        np.testing.assert_array_equal(ev["preds"][f].numpy(), np.asarray(jev["preds"][f]))


def test_fold_parallel_run_matches_med_tpus():
    """FoldParallelWindowRun against med_tpu's (its whole run, every fold
    and epoch in one vmapped program, the fold axis over 'data' of a (2, 1)
    mesh of its CPU devices) from the same weights, on two folds
    of different sizes, with one set of dropout masks for every step on
    both sides (under jax.jit an intercepted mask is a traced constant):
    each fold's train loss over its real steps (1e-5 in the first epoch,
    2e-3 after: med_tpu's own tolerances), test loss (1e-5) and selection
    score each epoch, the best epoch, its predictions and the winning
    checkpoint's running statistics (1e-5) and weights (med_tpu's
    checkpoint tolerance)."""
    rng = np.random.default_rng(9)
    fields = config_fields("SimpleCNN", batch_size=32, n_epochs=2, lr=1e-3)
    cfg = ExperimentConfig(**fields)
    raw = [(fold_fields(rng, n, 10), fold_fields(rng, m, 10)) for n, m in ((96, 40), (70, 45))]
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed)
    tree = export_jax_params(exp.net)
    masks = exp.net.model.dropout_masks(cfg.batch_size, torch.Generator().manual_seed(4))
    exp.net.model.dropout_masks = lambda B, generator: masks
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        par = FoldParallelWindowRun(exp, cfg, [(WindowFold(**a), WindowFold(**b))
                                               for a, b in raw]).run()

    jexp, intercept, _ = jax_experiment(fields, tree, masks)
    folds = [(JaxWindowFold(**a), JaxWindowFold(**b)) for a, b in raw]
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    with intercept():
        run = jfolds.FoldParallelWindowRun(jexp, JaxConfig(**fields), folds, mesh=mesh)
        samples = [{"images": tf.images[:32], "kinematics": tf.kinematics[:32],
                    "labels": tf.labels_for("global")[:32], "mask": np.ones(32, np.float32)}
                   for tf, _ in folds]
        states = jfolds.FoldParallel(jexp, mesh=mesh).init_states([jax.random.key(0)] * 2,
                                                                  samples)
        _, bckpts, outs = run.run(states, 0, cfg.n_epochs)
    _, tlosses, preds, _, _, elosses, scores = map(np.asarray, outs)
    for k, (tf, ef) in enumerate(folds):
        steps, esteps = -(-len(tf) // 32), -(-len(ef) // 32)
        history = par[k]["history"]
        for e, row in enumerate(history):
            tol = 1e-5 if e == 0 else 2e-3
            assert row["train_loss"] == pytest.approx(np.mean(tlosses[k, e, :steps]), abs=tol)
            assert row["test_loss"] == pytest.approx(np.mean(elosses[k, e, :esteps]), rel=1e-5)
            assert row["test_f1_weighted"] == pytest.approx(scores[k, e], abs=1e-6)
        best = par[k]["best"]["epoch"]
        assert best == int(np.argmax(scores[k]))
        np.testing.assert_array_equal(par[k]["best"]["preds"],
                                      preds[k, best].reshape(-1)[:len(ef)])
        want = leaves(jax.device_get(jfolds.unstack_tree(bckpts, k)))
        got = leaves(par[k]["checkpoint"])
        for path, w in want.items():
            if path.startswith("batch_stats"):
                np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-6, err_msg=path)
            elif path.startswith("params"):
                np.testing.assert_allclose(got[path], w, rtol=1e-2, atol=5e-3, err_msg=path)


def test_stack_and_unstack_trees():
    trees = [{"a": np.full(3, i), "b": {"c": torch.full((2,), float(i))}} for i in range(4)]
    stacked = stack_trees(trees)
    assert stacked["a"].shape == (4, 3) and stacked["b"]["c"].shape == (4, 2)
    for i, t in enumerate(trees):
        one = unstack_tree(stacked, i)
        np.testing.assert_array_equal(one["a"], t["a"])
        assert torch.equal(one["b"]["c"], t["b"]["c"])


def test_a_surplus_step_leaves_its_fold_exactly_as_it_was():
    rng = np.random.default_rng(2)
    cfg = ExperimentConfig(**config_fields("SimpleCNN", batch_size=8))
    fp = FoldParallel(Experiment(cfg, device="cpu"))
    state = fp.init_states([1, 2])
    batch = {k: torch.as_tensor(np.stack([v, v])) for k, v in
             {"images": rng.normal(size=(8, 10, 2048)).astype(np.float32),
              "kinematics": rng.normal(size=(8, 10, 26)).astype(np.float32),
              "labels": rng.integers(0, 2, 8), "mask": np.ones(8, np.float32)}.items()}
    fp.train_step(state, batch, 1e-3)
    before = {k: {n: v[1].clone() for n, v in state[k].items()}
              for k in ("params", "buffers", "exp_avg", "exp_avg_sq")}
    step = state["step"].copy()
    fp.train_step(state, batch, 1e-3, real=np.array([True, False]))
    for k, tree in before.items():
        for n, v in tree.items():
            assert torch.equal(state[k][n][1], v), (k, n)
    assert state["step"][1] == step[1] and state["step"][0] == step[0] + 1


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("pfolds")
    for i, out in enumerate(("1Out", "2Out")):
        _write_fold(str(root / out), rng, n_trials=3 + i, T=200)
    return str(root)


def _agree(a, b):
    for out in a:
        pa, pb = np.asarray(a[out]["preds"]), np.asarray(b[out]["preds"])
        assert pa.shape == pb.shape and np.mean(pa == pb) > 0.99
        assert a[out]["test_f1"] == pytest.approx(b[out]["test_f1"], abs=5e-3)


@pytest.fixture(scope="module")
def sequential(data, tmp_path_factory):
    runs = str(tmp_path_factory.mktemp("seq"))
    return (wcli.main(["--data-root", data, "--runs-root", runs, *WINDOW])[0],
            fcli.main(["--data-root", data, "--runs-root", runs, *FRAME])[0])


def test_fold_parallel_and_trial_dp_cli_on_one_rank(data, sequential, tmp_path, capsys):
    runs = str(tmp_path / "runs")
    res, tracker = wcli.main(["--data-root", data, "--runs-root", runs, *WINDOW,
                              "--fold-parallel"])
    _agree(res, sequential[0])
    for out in ("1Out", "2Out"):
        for sub in ("checkpoints", "artifacts"):
            name = f"best_model_LOSO_{out}." + ("npz" if sub == "checkpoints" else "json")
            assert os.path.exists(os.path.join(tracker.dir, sub, name))
    assert os.path.exists(os.path.join(tracker.dir, "artifacts", "summary.json"))
    res, _ = fcli.main(["--data-root", data, "--runs-root", runs, *FRAME, "--trial-dp"])
    _agree(res, sequential[1])
    assert "trial-DP mesh: {'data': 1, 'model': 1}" in capsys.readouterr().out


def test_fold_parallel_and_trial_dp_cli_on_two_ranks(data, sequential, tmp_path):
    """--mesh 2,1 over two spawned ranks: each rank trains one fold (the
    folds meet on rank 0), and the trial groups split over the ranks; then
    a window ensemble served on the mesh (7 windows: padded to 8, each rank
    its 4, the padding cut) equals the one-rank server."""
    runs = str(tmp_path / "runs")
    rng = np.random.default_rng(3)
    fields = config_fields("SimpleCNN")
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.init_weights(5)
    tree = exp.checkpoint()
    windows = (rng.normal(size=(7, 10, 2048)).astype(np.float32),
               rng.normal(size=(7, 10, 26)).astype(np.float32))
    out = launch.spawn(folds_suite, 2, str(tmp_path / "ranks"), args=([
        ("med_tpu_torch.cli.train_window",
         ["--data-root", data, "--runs-root", runs, *WINDOW, "--fold-parallel",
          "--mesh", "2,1"]),
        ("med_tpu_torch.cli.train_frame",
         ["--data-root", data, "--runs-root", runs, *FRAME, "--trial-dp", "--mesh", "2,1"]),
    ], (fields, tree, *windows)), device="cpu")
    served = EnsembleServer([WindowModelBundle(ExperimentConfig(**fields), tree,
                                               device="cpu")]).predict(*windows)
    for _, got in out:
        for a, b in zip(got, served):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    out = [cli for cli, _ in out]
    for k, want in enumerate(sequential):
        for rank in out:
            _agree(rank[k][0], want)
        run_dir = out[0][k][1]
        assert out[1][k][1] == run_dir                   # every rank knows rank 0's run
        assert os.path.exists(os.path.join(run_dir, "artifacts", "summary.json"))
    runs_made = [d for e in os.listdir(runs) for d in os.listdir(os.path.join(runs, e))]
    assert len(runs_made) == 2                           # rank 1 wrote none of its own


@pytest.mark.parametrize("flags, match", [
    (("--mesh", "2,1"), "needs 2 ranks, have 1"),
    (("--mesh", "3"), "needs 3 ranks, have 1"),
    (("--sequence-parallel", "--trial-dp"), "mutually exclusive"),
])
def test_frame_cli_refusals(data, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        fcli.main(["--data-root", data, "--runs-root", str(tmp_path / "runs"), *FRAME,
                   *flags])
    assert not os.path.exists(tmp_path / "runs")


@pytest.mark.parametrize("flags, match", [
    (("--fold-parallel", "--resume"), "does not support --resume"),
    (("--fold-parallel", "--model-name", "Siamese_CNN"), "plain window family"),
    (("--fold-parallel", "--mesh", "1,2"), "needs 2 ranks, have 1"),
])
def test_window_cli_refusals(data, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        wcli.main(["--data-root", data, "--runs-root", str(tmp_path / "runs"), *WINDOW,
                   *flags])
    assert not os.path.exists(tmp_path / "runs")
