"""The port's SP training mode (med_tpu_torch/parallel/sp_train.py) on
spawned gloo ranks (med_tpu's tests/test_sp_train.py):

- COG's masked SP objective on padded trials (true_len < T) against the
  port's single-rank engine loss: the global regime and the sequential one
  with its gates (every gradient leaf to 1e-5 of its largest);
- a TeCNo SP fold (dropout on, 2 epochs) is the same on 1, 2 and 4 shards
  given one bucket: the dropout draws are functions of (seed, step,
  global T) alone (med_tpu's tolerances: losses to 2e-4, predictions);
- an SP fold's ``last_state`` snapshot resumes in the single-rank
  ``train_frame_fold``.
"""

import numpy as np
import pytest
import torch

from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.parallel import launch
from med_tpu_torch.parallel.mesh import make_mesh
from med_tpu_torch.parallel.sp_train import SPFrameTrainer, train_sp_frame_fold
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.train.loop import train_frame_fold
from torch_rank_bodies import sp_train_suite

BUCKET = 128
TECNO = dict(model_name="TeCNo", dataset_type="frame", data_type="kinematics", out_features=2,
             mstcn_stages=2, mstcn_layers=4, mstcn_f_maps=8, n_epochs=2, lr=1e-3,
             lr_scheduler=False, fused_epoch=False, fused_run=False)
COG = dict(model_name="COG", dataset_type="frame", data_type="kinematics", out_features=2,
           num_layers_Basic=3, num_layers_R=2, num_R=1, mstcn_f_maps=8, d_model=16, d_q=2,
           sequence_length=5)
SEQ = {**COG, "error_type": "sequential", "out_features": 5, "delete_ND": True}


def _trial(rng, T, name):
    e = np.zeros((T, 7), np.int32)
    err = np.repeat(rng.random(T // 8 + 1) < 0.4, 8)[:T]
    e[err, rng.integers(0, 5, int(err.sum()))] = 1
    e[:, -1] = err
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    kin[:, :5] += err[:, None] * 2.0
    return FrameTrial(name=name, images=np.zeros((T, 2048), np.float32), kinematics=kin,
                      g_labels=rng.integers(1, 9, T), e_powerset=e, skill=skill_one_hot(name, T))


def _masks(model, T, seed):
    """Whole-trial COG masks in SP's layout (channel keeps (C,))."""
    gen = torch.Generator().manual_seed(seed)
    return {k: {"stack": v["stack"][:, 0].numpy(),
                **({"channel": v["channel"].reshape(-1).numpy()} if "channel" in v else {})}
            for k, v in model.dropout_masks(T, gen, 1).items()}


class _Tracker:
    def __init__(self, d):
        self.d = d

    def checkpoint_path(self, name):
        return f"{self.d}/{name}"

    def log_metrics(self, *a, **k):
        pass


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(23)
    train = [_trial(rng, T, f"Needle_Passing_{c}001") for T, c in ((100, "B"), (120, "C"),
                                                                    (90, "D"))]
    test = [_trial(rng, 110, "Needle_Passing_E001")]
    masked = {}
    for name, fields in (("global", COG), ("sequential", SEQ)):
        cfg = ExperimentConfig(**fields)
        trainer = SPFrameTrainer(cfg, make_mesh(), device="cpu")
        gates = [None, None]
        if name == "sequential":     # a true-error gate and one that is not
            gates = [(t.labels_for("sequential") != 0).astype(np.float32) for t in train[:2]]
            gates[1] = (rng.random(train[1].n_frames) > 0.5).astype(np.float32)
        batches = [{k: v for k, v in trainer.make_batch(t, BUCKET, g).items()
                    if not k.startswith("_")} for t, g in zip(train[:2], gates)]
        masks = [_masks(trainer.exp.net.model, BUCKET, s) for s in (1, 2)]
        masked[name] = (fields, batches, masks, [frame_batch(t, cfg, bucket=BUCKET, gate=g)
                                                 for t, g in zip(train[:2], gates)])
    ranks = {}
    for n in (2, 4):
        snap = tmp_path_factory.mktemp(f"snap{n}")
        ranks[n] = (launch.spawn(sp_train_suite, n, str(tmp_path_factory.mktemp(f"spt{n}")),
                                 args=((TECNO, train, test, BUCKET, str(snap), "sp"),
                                       [m[:3] for m in masked.values()]),
                                 device="cpu"), snap)
    return train, test, masked, ranks


def _one_rank_cog(fields, batch, masks):
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.init_weights(3)
    port = {k: {"stack": torch.from_numpy(v["stack"])[:, None],
                **({"channel": torch.from_numpy(v["channel"]).reshape(1, 1, -1)}
                   if "channel" in v else {})} for k, v in masks.items()}
    loss, _ = exp.compute_gradients(batch, masks=port)
    return float(loss), {k: p.grad.numpy().copy() for k, p in exp.net.named_parameters()}


def _close(got, want, name, frac=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("regime", ["global", "sequential"])
def test_sp_cog_masked_loss_matches_the_engine(setup, regime, n):
    """Padded trials (true_len < T), nearest-resampled track labels, the
    sequential gates: SP's masked objective is the engine's."""
    _, _, masked, ranks = setup
    fields, _, masks, engine_batches = masked[regime]
    for k, (batch, mk) in enumerate(zip(engine_batches, masks)):
        loss, grads = _one_rank_cog(fields, batch, mk)
        for r in ranks[n][0]:
            got = r[1][list(masked).index(regime)][k]
            _close(got["loss"], loss, "loss")
            for name, g in grads.items():
                _close(got["grads"][name], g, name)


@pytest.fixture(scope="module")
def one_shard(setup, tmp_path_factory):
    train, test, _, _ = setup
    return train_sp_frame_fold(ExperimentConfig(**TECNO), train, test, make_mesh(),
                               device="cpu", bucket=BUCKET,
                               tracker=_Tracker(str(tmp_path_factory.mktemp("snap1"))),
                               tag="sp")


@pytest.mark.parametrize("n", [2, 4])
def test_sp_fold_shard_invariance(setup, one_shard, n):
    """The SP fold on n shards is the one-shard fold: same history rows,
    best epoch and predictions, checkpoints to rtol 1e-3."""
    _, _, _, ranks = setup
    res = ranks[n][0][0][0]
    assert len(res["history"]) == len(one_shard["history"]) == TECNO["n_epochs"]
    for a, b in zip(res["history"], one_shard["history"]):
        assert a["epoch"] == b["epoch"]
        for key in ("train_loss", "test_loss"):
            assert a[key] == pytest.approx(b[key], abs=2e-4), key
        assert a["test_f1"] == pytest.approx(b["test_f1"], abs=5e-3)
    assert np.mean(res["preds"] == one_shard["best"]["preds"]) > 0.999
    flat = _flat(one_shard["checkpoint"])
    for path, v in _flat(res["checkpoint"]).items():
        np.testing.assert_allclose(v, flat[path], rtol=1e-3, atol=1e-4, err_msg=path)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def test_sp_snapshot_resumes_in_the_single_rank_loop(setup):
    """The 2-shard fold's last_state (rank 0 wrote it after epoch 1) is the
    single-rank loop's snapshot: train_frame_fold(resume=True) takes its
    weights and Adam state and goes on at epoch 2."""
    train, test, _, ranks = setup
    snap = ranks[2][1]
    with np.load(f"{snap}/last_state_sp.npz") as z:
        assert int(z["epoch"]) == 1 and int(z["adam/0/step"]) == 2 * len(train)
        saved = {k[len("param/"):]: z[k] for k in z.files if k.startswith("param/")}
    cfg = ExperimentConfig(**{**TECNO, "n_epochs": 3})
    exp = Experiment(cfg, device="cpu")
    plain = exp.init_weights
    loaded = {}

    def init_weights(seed, *a):         # note the state the snapshot restores
        plain(seed, *a)
        exp.net.register_load_state_dict_post_hook(
            lambda m, _: loaded.update({k: v.numpy().copy() for k, v in m.state_dict().items()}))

    exp.init_weights = init_weights
    res = train_frame_fold(cfg, train, test, exp=exp, tracker=_Tracker(str(snap)), tag="sp",
                           resume=True)
    assert [row["epoch"] for row in res["history"]] == [2]
    assert np.isfinite(res["history"][0]["train_loss"])
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
