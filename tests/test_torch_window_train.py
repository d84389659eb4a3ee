"""The port's window fold loop (med_tpu_torch.train.loop.train_window_fold)
against the JAX package's, and the whole-run rule on the port alone.

A 3-epoch fold of SimpleCNN and of Siamese_CNN runs in both packages from
the same weights, with one fixed set of dropout masks for every step on
both sides (under ``jax.jit`` an intercepted mask is a traced constant, the
same at every step), under ``fused_run`` on (med_tpu's whole-run program,
its window axis padded to ``fold_pad_quantum``, whose extra steps are
no-ops) and off (its per-epoch loop): every history row's losses (rtol
1e-5) and metrics, the same best epoch, equal predictions except where a
probability lies within 1e-5 of 0.5, and the best checkpoint's running
statistics. Batches are 64 windows or more: at 16, a head BatchNorm over a
few active rows amplifies float32's last-digit differences to ~1e-4 of the
loss within a few Adam steps in either package (the two agree to ~1e-7
with the learning rate at 0).
"""

import math

import numpy as np
import pytest
import torch
from test_torch_window import config_fields, fold_fields, jax_experiment, leaves

from med_tpu.cli import train_window as jcli
from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data.datasets import WindowFold as JaxWindowFold
from med_tpu.train import loop as jloop
from med_tpu_torch.cli import train_window as tcli
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import WindowFold
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.utils.jax_params import export_jax_params

EPOCHS = 3



def _folds(seed, n_train=128, n_test=72):
    rng = np.random.default_rng(seed)
    return (fold_fields(rng, n_train, 10),
            fold_fields(rng, n_test, 10, subjects=("D001", "E001")))


# SimpleCNN: multimodal, 2 steps an epoch; the twins: their head takes
# |f1 - f2|, whose derivative flips sign with float32's last digits where
# two features nearly agree, so their fold takes one step an epoch, on the
# kinematics (their FE's step: tests/test_torch_window.py)
FOLDS = {"SimpleCNN": dict(batch_size=64),
         "Siamese_CNN": dict(batch_size=128, n_pairs=128, n_comparisons=3,
                             data_type="kinematics")}


@pytest.mark.parametrize("fused_run", [True, False], ids=["whole_run", "per_epoch"])
@pytest.mark.parametrize("name", ["SimpleCNN", "Siamese_CNN"])
def test_window_fold_matches_jax(name, fused_run):
    fields = config_fields(name, n_epochs=EPOCHS, fused_run=fused_run, pos_weight=True,
                           lr=5e-4, **FOLDS[name])
    cfg = ExperimentConfig(**fields)
    tr, te = _folds(11)
    train, test = WindowFold(**tr), WindowFold(**te)
    siamese = tcli._siamese_data_fn(cfg)("1Out", train, test) if cfg.siamese else None
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed)
    tree = export_jax_params(exp.net)
    masks = exp.net.model.dropout_masks(cfg.batch_size, torch.Generator().manual_seed(4))
    exp.net.model.dropout_masks = lambda B, generator: masks
    res = tloop.train_window_fold(cfg, train, test, exp=exp, siamese_data=siamese)

    jexp, intercept, _ = jax_experiment(fields, tree, masks)
    jtrain, jtest = JaxWindowFold(**tr), JaxWindowFold(**te)
    jsiamese = (jcli._siamese_data_fn(JaxConfig(**fields))("1Out", jtrain, jtest)
                if cfg.siamese else None)
    with intercept():
        jres = jloop.train_window_fold(JaxConfig(**fields), jtrain, jtest, exp=jexp,
                                       siamese_data=jsiamese)

    assert len(res["history"]) == len(jres["history"]) == EPOCHS
    for row, jrow in zip(res["history"], jres["history"]):
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-5, err_msg=k)
        for k in ("train_f1", "train_acc", "test_f1", "test_f1_weighted", "test_acc"):
            assert row[k] == pytest.approx(jrow[k], rel=1e-12), k
    best, jbest = res["best"], jres["best"]
    assert best["epoch"] == jbest["epoch"]
    probs, jprobs = np.asarray(best["probs"]), np.asarray(jbest["probs"])
    np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-5)
    sure = np.abs(jprobs - 0.5) > 1e-5
    np.testing.assert_array_equal(np.asarray(best["preds"])[sure],
                                  np.asarray(jbest["preds"])[sure])
    np.testing.assert_array_equal(best["cm"], jbest["cm"])
    # the checkpoint is the best epoch's: evaluated, it gives that row's loss
    # (its parameters part from med_tpu's where a gradient sits at float32's
    # noise: Adam moves such an entry by up to lr a step either way)
    check = Experiment(cfg, device="cpu")
    check.load_params(res["checkpoint"])
    ev = tloop.evaluate_window_fold(cfg, check, test, siamese)
    assert ev["metrics"]["loss"] == pytest.approx(best["test_loss"], rel=1e-6)
    got = leaves(res["checkpoint"])
    for path, w in leaves(jres["checkpoint"]).items():
        if not path.startswith("params"):       # running statistics, class counts
            np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-5, err_msg=path)


def test_class_counts_and_vote_match_jax():
    rng = np.random.default_rng(2)
    tr = fold_fields(rng, 60, 10)
    for error_type in ("global", "all_errors", "sequential"):
        for scale in (1.5, 1.0):
            fields = config_fields("SimpleLSTM", error_type, pos_weight=True,
                                   es_weight_scale=scale)
            np.testing.assert_array_equal(
                tloop._class_counts(ExperimentConfig(**fields), WindowFold(**tr)),
                jloop._class_counts(JaxConfig(**fields), JaxWindowFold(**tr)))
    assert tloop._class_counts(ExperimentConfig(**config_fields("SimpleLSTM")),
                               WindowFold(**tr)) is None
    preds = rng.integers(0, 2, 50)
    pos = rng.integers(0, 12, 50)
    labels = rng.integers(0, 2, 12)
    for a, b in zip(tloop.siamese_vote(preds, pos, labels),
                    jloop.siamese_vote(preds, pos, labels)):
        np.testing.assert_array_equal(a, b)


def _run(monkeypatch, fused_run, nan_epochs):
    """A 3-epoch SimpleCNN fold on the CPU whose epochs in ``nan_epochs``
    report a non-finite train loss and eval score (the parameters stay
    finite, so later epochs train on)."""
    cfg = ExperimentConfig(**config_fields("SimpleCNN", data_type="kinematics",
                                           n_epochs=EPOCHS, fused_run=fused_run))
    tr, te = _folds(5, 40, 24)
    exp = Experiment(cfg, device="cpu")
    epoch = [-1]
    plain_lr, plain_step, plain_eval = tloop.set_lr, exp.train_step, tloop.evaluate_window_fold

    def set_lr(optimizer, lr):
        epoch[0] += 1
        plain_lr(optimizer, lr)

    def train_step(batch, masks=None):
        m = plain_step(batch, masks)
        if epoch[0] in nan_epochs:
            m["loss"] = torch.tensor(math.nan)
        return m

    def evaluate(*args, **kw):
        ev = plain_eval(*args, **kw)
        if epoch[0] in nan_epochs:
            ev["metrics"].update(loss=math.nan, f1=math.nan, f1_weighted=math.nan)
        return ev

    monkeypatch.setattr(tloop, "set_lr", set_lr)
    monkeypatch.setattr(tloop, "evaluate_window_fold", evaluate)
    exp.train_step = train_step
    initial = Experiment(cfg, device="cpu")
    initial.init_weights(cfg.seed)
    res = tloop.train_window_fold(cfg, WindowFold(**tr), WindowFold(**te), exp=exp)
    return res, initial.checkpoint()


def test_whole_run_never_selects_a_non_finite_epoch_and_runs_on(monkeypatch):
    res, _ = _run(monkeypatch, True, {0})
    assert [row["epoch"] for row in res["history"]] == [0, 1, 2]
    assert not math.isfinite(res["history"][0]["train_loss"])
    assert res["best"]["epoch"] in (1, 2)
    assert "all_epochs_non_finite" not in res["best"]


def test_whole_run_with_every_epoch_non_finite_returns_the_initial_weights(monkeypatch):
    res, initial = _run(monkeypatch, True, {0, 1, 2})
    assert len(res["history"]) == EPOCHS
    assert res["best"]["all_epochs_non_finite"] is True and res["best"]["epoch"] == 0
    got = leaves(res["checkpoint"])
    for path, w in leaves(initial).items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_per_epoch_loop_halts_at_the_first_non_finite_train_loss(monkeypatch):
    res, _ = _run(monkeypatch, False, {1})
    assert [row["epoch"] for row in res["history"]] == [0]
    assert res["best"]["epoch"] == 0


def test_fused_epoch_changes_where_batches_live_not_the_numbers():
    """With ``fused_epoch`` a split goes to the device once a fold and each
    batch is gathered there; without it each batch goes up from the host.
    The two give the same history."""
    tr, te = _folds(6, 40, 24)
    rows = []
    for flag in (True, False):
        cfg = ExperimentConfig(**config_fields("SimpleLSTM", data_type="kinematics",
                                               n_epochs=2, fused_epoch=flag))
        res = tloop.train_window_fold(cfg, WindowFold(**tr), WindowFold(**te), device="cpu")
        rows.append([(r["train_loss"], r["test_loss"], r["test_f1"]) for r in res["history"]])
    assert rows[0] == rows[1]
