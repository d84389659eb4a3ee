"""Best-epoch selection of the port's frame loop against the JAX package's,
and the bf16 compute type.

med_tpu's frame driver runs its whole-run program with fused epochs (the
default): the score starts at +inf (loss) or -inf (F1), only a strict
improvement wins, and when no epoch wins the checkpoint is the initial
parameters (``med_tpu/train/loop.py::_fused_run_history``). Without fused
epochs it takes the per-epoch ``_better``, under which epoch 0 always wins.
A small COG trains on the CPU for 3 epochs with some eval scores made
non-finite; the port's choice is held against med_tpu's on the same score
sequence, exactly.
"""

import numpy as np
import pytest
import torch

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.train import loop as jloop
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.models import build_model
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.utils.jax_params import export_jax_params

EPOCHS = 3


def _cfg(**kw):
    return ExperimentConfig(model_name="COG", dataset_type="frame", data_type="kinematics",
                            out_features=2, num_layers_Basic=2, num_layers_R=2, num_R=1,
                            d_model=16, d_q=2, sequence_length=6, n_epochs=EPOCHS, **kw)


def _trial(rng, name, T=40):
    e = np.eye(7, dtype=np.int32)[rng.integers(0, 2, T) * 6]
    return FrameTrial(name=name, images=np.zeros((T, 2048), np.float32),
                      kinematics=rng.normal(size=(T, 26)).astype(np.float32),
                      g_labels=rng.integers(1, 5, T), e_powerset=e,
                      skill=skill_one_hot(name, T))


def _train(monkeypatch, cfg, bad_epochs):
    """train_frame_fold on the CPU with the selection metric of the epochs
    in ``bad_epochs`` made NaN."""
    rng = np.random.default_rng(3)
    train = [_trial(rng, f"Needle_Passing_{c}001") for c in "BC"]
    test = [_trial(rng, "Needle_Passing_D001")]
    plain = tloop.evaluate_frame_fold
    epoch = iter(range(EPOCHS))

    def evaluate(*args, **kw):
        ev = plain(*args, **kw)
        if next(epoch) in bad_epochs:
            keys = ("loss",) if cfg.loss_or_f1 == "loss" else ("f1", "f1_weighted")
            ev["metrics"].update({k: float("nan") for k in keys})
        return ev

    monkeypatch.setattr(tloop, "evaluate_frame_fold", evaluate)
    return tloop.train_frame_fold(cfg, train, test, device="cpu")


def _jax_choice(cfg, history):
    """med_tpu's whole-run choice on the port's per-epoch scores: (best
    epoch, degenerate)."""
    scores = np.asarray([tloop._score(cfg, row) for row in history], np.float32)
    cms = np.ones((EPOCHS, 1, 2, 2), np.int64)
    losses = np.zeros((EPOCHS, 1), np.float32)
    return jloop._fused_run_history(
        JaxConfig(model_name="COG", dataset_type="frame", loss_or_f1=cfg.loss_or_f1),
        EPOCHS, 0, cms, losses, cms, losses, scores, "binary", False, 1.0,
        "inference_ms_per_frame", 1, None, [])


def _initial_params(cfg):
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed)
    return export_jax_params(exp.net)["params"]


def _same_tree(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        return all(_same_tree(a[k], b[k]) for k in b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("criterion", ["loss", "f1"])
def test_all_non_finite_epochs_return_the_initial_parameters(monkeypatch, criterion):
    cfg = _cfg(loss_or_f1=criterion)
    res = _train(monkeypatch, cfg, bad_epochs={0, 1, 2})
    assert _jax_choice(cfg, res["history"]) == (0, True)
    best = res["best"]
    assert best["all_epochs_non_finite"] is True and best["epoch"] == 0
    assert best["preds"].shape == best["labels"].shape
    assert _same_tree(res["checkpoint"]["params"], _initial_params(cfg))


@pytest.mark.parametrize("criterion", ["loss", "f1"])
def test_a_non_finite_first_epoch_is_passed_over(monkeypatch, criterion):
    cfg = _cfg(loss_or_f1=criterion)
    res = _train(monkeypatch, cfg, bad_epochs={0})
    best_i, degenerate = _jax_choice(cfg, res["history"])
    assert not degenerate and best_i > 0
    assert res["best"]["epoch"] == best_i
    assert "all_epochs_non_finite" not in res["best"]
    assert not _same_tree(res["checkpoint"]["params"], _initial_params(cfg))


@pytest.mark.parametrize("flags", [dict(fused_run=False), dict(fused_epoch=False)])
def test_without_the_whole_run_epoch_zero_wins_as_in_jax(monkeypatch, flags):
    """med_tpu's per-epoch loop: a NaN epoch 0 wins and nothing beats it."""
    cfg = _cfg(loss_or_f1="loss", **flags)
    res = _train(monkeypatch, cfg, bad_epochs={0})
    jcfg = JaxConfig(model_name="COG", dataset_type="frame", loss_or_f1="loss")
    best = None
    for row in res["history"]:
        if jloop._better(jcfg, row, best):
            best = row
    assert res["best"]["epoch"] == best["epoch"] == 0
    assert "all_epochs_non_finite" not in res["best"]


def test_bfloat16_compute_keeps_float32_parameters_and_logits():
    """compute_dtype="bfloat16" (once refused, naming A6) builds COG with
    float32 parameters whose TCN paths compute in bf16 through the model's
    own layer loop; its logits are float32, and a train step runs."""
    cfg = _cfg(compute_dtype="bfloat16")
    assert cfg.to_dict()["compute_dtype"] == "bfloat16"
    net = build_model(cfg)
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert net.TCN.stack.dtype == torch.bfloat16 and build_model(_cfg()).TCN.stack.dtype is None
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(0)
    rng = np.random.default_rng(0)
    from med_tpu_torch.data.datasets import frame_batch
    batch = frame_batch(_trial(rng, "Needle_Passing_B001", 40), cfg, bucket=64)
    out_list, f_list = exp.net.model(torch.from_numpy(batch["kinematics"]))
    assert {t.dtype for t in out_list} == {torch.float32}
    assert f_list[0].dtype == torch.bfloat16
    m = exp.train_step(batch)
    assert np.isfinite(m["loss"].item())
    assert {p.dtype for p in exp.net.parameters()} == {torch.float32}
