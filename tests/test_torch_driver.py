"""The port's COG fold driver (med_tpu_torch.cli.train_frame and the host
modules under it) against the JAX package's: trial files and fold loading,
labels, the summary and the frame->window rollup, the run directory, the
command line on the CPU at a small size, resume, and the flags and families
that are not ported yet.

Inputs are made from a numpy seed. Host-side numpy code must agree exactly;
predictions served by med_tpu from the port's checkpoint agree within 1e-5 on
probabilities (float32, summed in another order).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from med_tpu.cli import results as jresults
from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data import datasets as jdata
from med_tpu.data import labels as jlabels
from med_tpu.data import trials as jtrials
from med_tpu.data import windowing as jwindowing
from med_tpu.eval import rollup as jrollup
from med_tpu.eval import summary as jsummary
from med_tpu.eval.serving import FrameModelServer as JaxServer
from med_tpu.tracking import RunTracker as JaxTracker
from med_tpu.train import checkpoint as jckpt
from med_tpu_torch.cli import common as tcommon
from med_tpu_torch.cli import train_frame as tcli
from med_tpu_torch.config import LOSO_FOLDS, ExperimentConfig, compute_window_size_stride
from med_tpu_torch.data import datasets as tdata
from med_tpu_torch.data import labels as tlabels
from med_tpu_torch.data import trials as ttrials
from med_tpu_torch.data import windowing as twindowing
from med_tpu_torch.eval import rollup as trollup
from med_tpu_torch.eval import summary as tsummary
from med_tpu_torch.parallel.mesh import make_mesh
from med_tpu_torch.tracking import RunTracker
from med_tpu_torch.train import checkpoint as tckpt
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.train.loop import train_frame_fold
from med_tpu_torch.utils.jax_params import export_jax_params

SMALL_FLAGS = ("--model-name", "COG", "--data-type", "multimodal", "--device", "cpu",
               "--num-layers-basic", "2", "--num-layers-r", "2", "--num-r", "1",
               "--mstcn-stages", "3", "--d-model", "16", "--d-q", "2",
               "--sequence-length", "6", "--no-use-pallas")


def _raw_trial(rng, name, T):
    g = np.repeat(rng.integers(1, 6, T // 20 + 1), 20)[:T]
    e = np.zeros((T, 5), np.int64)
    err = rng.random(T) < 0.4
    e[err, 4] = 1
    e[np.flatnonzero(err), rng.integers(0, 4, int(err.sum()))] = 1
    e[np.flatnonzero(err)[::7], 1] = 1                 # some Needle-Drop frames
    kin = (rng.normal(size=(T, 26)) + e[:, 4:5] * 2.0).astype(np.float32)
    return ttrials.Trial(name, rng.normal(size=(T, 2048)).astype(np.float32), kin, g, e)


def _write_fold(fold_dir, rng, n_trials, T=140, stats=True):
    os.makedirs(fold_dir)
    names = [f"Needle_Passing_{'BCDE'[i % 4]}00{i + 1}" for i in range(n_trials)]
    for name in names:
        ttrials.save_trial_npz(os.path.join(fold_dir, name + ".npz"),
                               _raw_trial(rng, name, T))
    with open(os.path.join(fold_dir, "train.csv"), "w") as f:
        f.write("\n".join(n + ".npz" for n in names[:-1]))
    with open(os.path.join(fold_dir, "test.csv"), "w") as f:
        f.write(names[-1] + ".pkl")        # a .pkl listing against the .npz on disk
    if stats:
        img, kin, _, _, _ = ttrials.load_fold(fold_dir, "train.csv")
        ttrials.save_fold_stats(fold_dir, ttrials.compute_fold_stats(img, kin))
    return fold_dir


@pytest.fixture(scope="module")
def two_folds(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("folds")
    for i, out in enumerate(("1Out", "2Out")):
        _write_fold(str(root / out), rng, n_trials=3 + i)
    return str(root)


def _same_trials(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name
        for field in ("image_feats", "images", "kinematics", "g_labels", "e_labels",
                      "e_powerset", "skill", "e_raw", "frames"):
            if hasattr(b, field):
                x, y = getattr(a, field), getattr(b, field)
                assert (x is None) == (y is None), field
                if y is not None:
                    assert x.dtype == y.dtype and x.shape == y.shape, field
                    np.testing.assert_array_equal(x, y, err_msg=field)


# ------------------------------------------------------ labels, trials, folds
def test_powerset_error_labels_match_jax(rng):
    e = rng.integers(0, 2, size=(500, 5))
    for delete_ND in (True, False):
        got, got_mask = tlabels.powerset_error_labels(e, delete_ND=delete_ND)
        want, want_mask = jlabels.powerset_error_labels(e, delete_ND=delete_ND)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)
    with pytest.raises(ValueError):
        tlabels.powerset_error_labels(np.zeros((4, 3)))


def test_trial_files_and_fold_loading_match_jax(two_folds, tmp_path, rng):
    fold = os.path.join(two_folds, "2Out")
    assert ttrials.fold_file_list(fold, "train.csv") == jtrials.fold_file_list(fold, "train.csv")
    _same_trials(ttrials.load_fold_trials(fold, "test.csv"),
                 jtrials.load_fold_trials(fold, "test.csv"))
    for got, want in zip(ttrials.load_fold(fold, "train.csv"),
                         jtrials.load_fold(fold, "train.csv")):
        np.testing.assert_array_equal(got, want)
    got_stats, want_stats = ttrials.load_fold_stats(fold), jtrials.load_fold_stats(fold)
    for kind in ("image", "kinematics"):
        for k in ("mean", "std"):
            np.testing.assert_array_equal(got_stats[kind][k], want_stats[kind][k])

    # a trial written by either package reads the same in the other
    t = _raw_trial(rng, "Needle_Passing_G009", 30)
    ttrials.save_trial_npz(str(tmp_path / "port.npz"), t)
    jtrials.save_trial_npz(str(tmp_path / "jax.npz"), jtrials.Trial(
        t.name, t.image_feats, t.kinematics, t.g_labels, t.e_labels))
    _same_trials([ttrials.load_trial(str(tmp_path / "jax.npz"))],
                 [jtrials.load_trial(str(tmp_path / "jax.npz"))])
    _same_trials([jtrials.load_trial(str(tmp_path / "port.npz"))],
                 [ttrials.load_trial(str(tmp_path / "port.npz"))])

    # a reference pickle holding torch tensors, and external features under
    # the 'feature' key of a --video-root file
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({"image_feats": torch.from_numpy(t.image_feats),
                     "kinematics_feats": torch.from_numpy(t.kinematics),
                     "g_labels": t.g_labels, "e_labels": torch.from_numpy(t.e_labels),
                     "frames": np.arange(30)}, f)
    with open(tmp_path / "video.pkl", "wb") as f:
        pickle.dump({"feature": torch.from_numpy(t.image_feats * 2)}, f)
    got = ttrials.load_trial(str(tmp_path / "ref.pkl"), str(tmp_path / "video.pkl"))
    _same_trials([got], [jtrials.load_trial(str(tmp_path / "ref.pkl"),
                                           str(tmp_path / "video.pkl"))])
    np.testing.assert_array_equal(got.image_feats, t.image_feats * 2)
    np.testing.assert_array_equal(got.kinematics, t.kinematics)
    with pytest.raises(FileNotFoundError):
        ttrials._resolve_trial_path(fold, "Needle_Passing_Z000.npz")


@pytest.mark.parametrize("delete_ND", [False, True])
@pytest.mark.parametrize("with_stats", [True, False])
def test_build_frame_fold_matches_jax(tmp_path, rng, delete_ND, with_stats):
    fold = _write_fold(str(tmp_path / "1Out"), rng, n_trials=3, T=90, stats=with_stats)
    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", delete_ND=delete_ND)
    jcfg = JaxConfig(model_name="COG", dataset_type="frame", delete_ND=delete_ND)
    for csv in ("train.csv", "test.csv"):
        got = tdata.build_frame_fold(fold, cfg, csv)
        _same_trials(got, jdata.build_frame_fold(fold, jcfg, csv))
    raw = ttrials.load_fold_trials(fold, "test.csv")[0]
    assert (got[0].n_frames < raw.n_frames) == delete_ND
    if not delete_ND:
        np.testing.assert_array_equal(got[0].images, raw.image_feats)    # not standardised
    assert abs(float(tdata.build_frame_fold(fold, cfg, "train.csv")[0].kinematics.mean())) < 0.5


# ------------------------------------------------- summary, rollup, tracker
def _fold_results(rng, folds):
    keys = ("train_f1", "train_acc", "train_jaccard", "test_f1", "test_acc",
            "test_jaccard", "train_time", "test_inference_ms_per_frame")
    return {f: {k: float(rng.random()) for k in keys} for f in folds}


def test_summary_and_window_rollup_match_jax(rng):
    folds = ("1Out", "2Out", "3Out")
    res = _fold_results(rng, folds)
    n_tr = {f: int(rng.integers(100, 900)) for f in folds}
    n_te = {f: int(rng.integers(100, 900)) for f in folds}
    got = tsummary.create_summary(res, n_tr, n_te)
    assert got == jsummary.create_summary(res, n_tr, n_te)
    assert tsummary.summary_to_text(got) == jsummary.summary_to_text(got)
    assert tsummary.weighted_mean_std([1, 2, 4], [1, 1, 2]) == \
        jsummary.weighted_mean_std([1, 2, 4], [1, 1, 2])

    dumps = {}
    for f in folds:
        n = 300
        subjects = np.repeat(np.asarray(["a", "b", "c"], dtype=object), n // 3)
        g = np.repeat(rng.integers(0, 5, n // 10), 10)
        dumps[f] = {"preds": rng.integers(0, 2, n), "labels": rng.integers(0, 2, n),
                    "gestures": g, "subjects": subjects}
    np.testing.assert_array_equal(twindowing.window_scan(dumps["1Out"]["gestures"][:100], 10, 6),
                                  jwindowing.window_scan(dumps["1Out"]["gestures"][:100], 10, 6))
    got_w, want_w = trollup.frame_to_window(dumps), jrollup.frame_to_window(dumps)
    for f in folds:
        for k in ("preds", "labels", "gestures", "subjects"):
            np.testing.assert_array_equal(got_w[f][k], want_w[f][k])
    for binary in (True, False):
        got_s, got_cm = trollup.compute_window_metrics(dumps, 10, 6, binary=binary)
        want_s, want_cm = jrollup.compute_window_metrics(dumps, 10, 6, binary=binary)
        assert got_s == want_s
        np.testing.assert_array_equal(got_cm, want_cm)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_run_tracker_writes_the_jax_layout(tmp_path):
    params = ExperimentConfig(model_name="COG").to_dict()
    roots = []
    for cls, name in ((RunTracker, "port"), (JaxTracker, "jax")):
        t = cls(root=str(tmp_path / name), experiment="exp", run_id="r1")
        t.log_params(params)
        t.log_metrics({"a": np.float32(1.5), "b": 2}, step=3)
        t.log_dict({"x": np.arange(3), "y": {"z": np.int64(4)}}, "d.json")
        assert t.checkpoint_path("c.npz").endswith(os.path.join("r1", "checkpoints", "c.npz"))
        roots.append(str(tmp_path / name))
    assert _tree(roots[0]) == _tree(roots[1]) == [
        "exp/r1/artifacts/d.json", "exp/r1/metrics.jsonl", "exp/r1/params.json"]
    for rel in ("exp/r1/artifacts/d.json", "exp/r1/params.json"):
        assert open(os.path.join(roots[0], rel)).read() == \
            open(os.path.join(roots[1], rel)).read()
    rows = [[{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in open(os.path.join(r, "exp/r1/metrics.jsonl"))] for r in roots]
    assert rows[0] == rows[1] and len(rows[0]) == 2
    # each package reads the other's run
    assert JaxTracker.load_artifact(roots[0], "exp", "r1", "d.json") == \
        RunTracker.load_artifact(roots[1], "exp", "r1", "d.json") == {"x": [0, 1, 2], "y": {"z": 4}}
    assert RunTracker.find_run(roots[1], "r1") == JaxTracker.find_run(roots[1], "r1")
    with pytest.raises(FileNotFoundError):
        RunTracker.find_run(roots[0], "nope")


def test_config_writes_the_jax_params_keys():
    assert LOSO_FOLDS == ("1Out", "2Out", "3Out", "4Out", "5Out")
    assert compute_window_size_stride(5) == (10, 6)
    kw = dict(model_name="COG", dataset_type="frame", pos_weight=True, delete_ND=True,
              run_id="abc", frequency=15)
    got, want = ExperimentConfig(**kw).to_dict(), JaxConfig(**kw).to_dict()
    assert list(got) == list(want) and got == want
    assert got["window_size"] == 30 and got["stride"] == 20


# ------------------------------------------------------------ the CLI
def _cli(root, runs, *extra):
    return tcli.main(["--data-root", root, "--runs-root", runs, "--folds", "1Out,2Out",
                      *SMALL_FLAGS, *extra])


@pytest.fixture(scope="module")
def cli_run(two_folds, tmp_path_factory):
    runs = str(tmp_path_factory.mktemp("runs"))
    results, tracker = _cli(two_folds, runs, "--n-epochs", "2")
    return results, tracker, runs


def test_cli_writes_the_run_layout(cli_run, capsys):
    results, tracker, runs = cli_run
    assert set(results) == {"1Out", "2Out"}
    assert tracker.dir == os.path.join(runs, "COG_5Hz_multimodal", tracker.run_id)
    want = ["metrics.jsonl", "params.json"]
    for out in ("1Out", "2Out"):
        want += [f"artifacts/best_model_LOSO_{out}.json",
                 f"checkpoints/best_model_LOSO_{out}.npz",
                 f"checkpoints/best_model_LOSO_{out}.npz.json",
                 f"checkpoints/last_state_LOSO_{out}.npz"]
    want += ["artifacts/summary.json", "artifacts/windowed_metrics.json"]
    # med_tpu's plots: each fold's curves, the best epoch's test matrix
    want += ["images/LOSO_fold_1Out_results.png", "images/LOSO_fold_2Out_results.png",
             "images/LOSO_Test_Confusion_Matrix_global.png"]
    assert _tree(tracker.dir) == sorted(want)

    params = json.load(open(os.path.join(tracker.dir, "params.json")))
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()
                        if k not in ("window_size", "stride", "in_features")})
    assert params == json.loads(json.dumps(jcfg.to_dict()))
    assert (params["model_name"], params["error_type"], params["out_features"],
            params["batch_size"], params["n_epochs"], params["lr_scheduler"],
            params["weight_decay"], params["video_dims"]) == \
        ("COG", "global", 2, 1, 2, False, 0.0, 2048)
    meta = json.load(open(os.path.join(tracker.dir, "checkpoints",
                                       "best_model_LOSO_1Out.npz.json")))
    assert meta == {"cfg": params}

    rows = [json.loads(line) for line in open(os.path.join(tracker.dir, "metrics.jsonl"))]
    assert {r["step"] for r in rows} == {0, 1}
    assert {r["key"] for r in rows} == {
        "epoch", "train_loss", "train_f1", "train_f1_weighted", "train_acc",
        "train_jaccard", "train_time", "test_loss", "test_f1", "test_f1_weighted",
        "test_acc", "test_jaccard", "test_inference_ms_per_frame"}
    assert len(rows) == 2 * 2 * 13
    dump = json.load(open(os.path.join(tracker.dir, "artifacts", "best_model_LOSO_2Out.json")))
    assert {"preds", "probs", "labels", "gestures", "raw_labels", "subjects", "cm",
            "epoch", "test_f1", "train_loss"} <= set(dump)
    assert len(dump["preds"]) == len(dump["labels"]) == 140
    summary = json.load(open(os.path.join(tracker.dir, "artifacts", "summary.json")))
    assert set(summary) == {"Train", "Test"} and "±" in summary["Test"]["F1"]
    windowed = json.load(open(os.path.join(tracker.dir, "artifacts", "windowed_metrics.json")))
    assert set(windowed) == {"windowed", "cm"} and np.sum(windowed["cm"]) > 10

    # med_tpu's results driver reads the run
    jresults.main(["table", "--runs-root", runs, "--folds", "1Out,2Out",
                   "--run", f"cog={tracker.run_id}"])
    out = capsys.readouterr().out
    assert "cog" in out and "F1" in out and "±" in out


def test_cli_checkpoint_served_by_jax_gives_the_ports_predictions(cli_run, two_folds):
    results, tracker, _ = cli_run
    params = json.load(open(os.path.join(tracker.dir, "params.json")))
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()
                        if k not in ("window_size", "stride", "in_features")})
    for out in ("1Out", "2Out"):
        fold = os.path.join(two_folds, out)
        tree = jckpt.load_best_checkpoint(os.path.join(tracker.dir, "checkpoints"),
                                          "LOSO", out)
        trial = jtrials.load_fold_trials(fold, "test.csv")[0]
        preds, probs = JaxServer(jcfg, tree, stats=jtrials.load_fold_stats(fold)
                                 ).predict_trial(trial.image_feats, trial.kinematics)
        best = results[out]
        np.testing.assert_allclose(best["probs"], np.asarray(probs), rtol=0, atol=1e-5)
        sure = np.abs(best["probs"] - 0.5) > 1e-5
        np.testing.assert_array_equal(best["preds"][sure], np.asarray(preds)[sure])
        dump = json.load(open(os.path.join(tracker.dir, "artifacts",
                                           f"best_model_LOSO_{out}.json")))
        np.testing.assert_array_equal(dump["preds"], best["preds"])


def _metric_rows(run_dir, step):
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    return [(r["key"], r["value"]) for r in rows
            if r["step"] == step and r["key"] not in ("train_time",
                                                      "test_inference_ms_per_frame")]


def test_cli_resume_continues_bit_for_bit(cli_run, two_folds, tmp_path, capsys):
    _, whole, _ = cli_run
    runs = str(tmp_path / "runs")
    _, first = _cli(two_folds, runs, "--n-epochs", "1")
    capsys.readouterr()
    results, resumed = _cli(two_folds, runs, "--n-epochs", "2", "--resume")
    out = capsys.readouterr().out
    assert "[LOSO_1Out] resumed at epoch 1" in out and "[LOSO_2Out] resumed at epoch 1" in out
    assert resumed.dir == first.dir and len(os.listdir(os.path.dirname(first.dir))) == 1
    assert results["1Out"]["epoch"] == 1           # best starts empty again
    assert _metric_rows(resumed.dir, 1) == _metric_rows(whole.dir, 1)
    assert len(_metric_rows(resumed.dir, 1)) == 2 * 11
    for fold in ("1Out", "2Out"):
        with np.load(os.path.join(whole.dir, "checkpoints", f"last_state_LOSO_{fold}.npz")) as a, \
                np.load(os.path.join(resumed.dir, "checkpoints",
                                     f"last_state_LOSO_{fold}.npz")) as b:
            assert set(a.files) == set(b.files) and int(a["epoch"]) == 1
            assert any(k.startswith("adam/") and k.endswith("/step") for k in a.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # nothing left to train: the driver says so instead of writing an empty run
    with pytest.raises(SystemExit, match="nothing left to train"):
        _cli(two_folds, runs, "--n-epochs", "2", "--resume")
    # without a snapshot to continue, --resume starts a new run
    _, fresh = _cli(two_folds, str(tmp_path / "other"), "--n-epochs", "1", "--resume",
                    "--folds", "1Out")
    assert os.path.exists(os.path.join(fresh.dir, "artifacts", "summary.json"))


def test_train_state_snapshot_restores_everything(tmp_path, rng):
    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", data_type="kinematics",
                           out_features=2, num_layers_Basic=2, num_layers_R=2, num_R=1,
                           d_model=16, d_q=2, sequence_length=6, weight_decay=1e-2)
    trial = tdata.FrameTrial(
        name="Needle_Passing_B001", images=np.zeros((50, 2048), np.float32),
        kinematics=rng.normal(size=(50, 26)).astype(np.float32),
        g_labels=rng.integers(1, 5, 50), skill=tlabels.skill_one_hot("Needle_Passing_B001", 50),
        e_powerset=np.eye(7, dtype=np.int32)[rng.integers(0, 2, 50) * 6])
    batch = tdata.frame_batch(trial, cfg, bucket=64)
    a = Experiment(cfg, device="cpu")
    a.init_weights(1)
    a.train_step(batch)
    tckpt.save_train_state(str(tmp_path / "s.npz"), a, epoch=4)
    b = Experiment(cfg, device="cpu")
    b.init_weights(2)
    assert tckpt.load_train_state(str(tmp_path / "s"), b) == 5
    # the FeatureExtractor-free net's every parameter (dead ones too) has its
    # Adam state in the snapshot
    with np.load(str(tmp_path / "s.npz")) as z:
        n_params = len(list(a.net.parameters()))
        assert sum(k.endswith("/exp_avg") for k in z.files) == n_params
    ma, mb = a.train_step(batch), b.train_step(batch)
    assert ma["loss"].item() == mb["loss"].item()
    for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)


def test_best_checkpoint_is_not_overwritten_by_later_steps(rng):
    """On the CPU a parameter's numpy view shares its memory; the exported
    tree must be a copy, or the best epoch's checkpoint follows the optimiser."""
    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", data_type="kinematics",
                           out_features=2, num_layers_Basic=2, num_layers_R=2, num_R=1,
                           d_model=16, d_q=2, sequence_length=6)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(1)
    tree = export_jax_params(exp.net)
    before = tree["params"]["model"]["TCN"]["stack"]["b3"].copy()
    with torch.no_grad():
        for p in exp.net.parameters():
            p.add_(1.0)
    np.testing.assert_array_equal(tree["params"]["model"]["TCN"]["stack"]["b3"], before)


def test_train_frame_fold_refuses_what_is_not_ported(rng):
    """Trial-DP (mesh=, once refused naming A12) takes the per-epoch loop,
    as med_tpu's does."""
    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", out_features=2)
    with pytest.raises(ValueError, match="fused_epoch/fused_run False"):
        train_frame_fold(cfg, [], [], device="cpu", mesh=make_mesh())
    # a frozen stage is TransSVNet's alone
    with pytest.raises(ValueError, match="TransSVNet"):
        train_frame_fold(cfg, [], [], device="cpu", frozen={"tecno_params": {}})


def test_train_frame_fold_takes_the_sequential_gates(two_folds):
    """gates= (once refused, naming A6) drives the sequential regime: a test
    trial's gate closes its frames (predicted 0 in the 6-class cm), and a
    train trial without one takes its true-error gate."""
    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", data_type="kinematics",
                           error_type="sequential", out_features=5, delete_ND=True,
                           num_layers_Basic=2, num_layers_R=2, num_R=1, d_model=16,
                           d_q=2, sequence_length=6, n_epochs=1)
    fold = os.path.join(two_folds, "1Out")
    train = tdata.build_frame_fold(fold, cfg, "train.csv")
    test = tdata.build_frame_fold(fold, cfg, "test.csv")
    closed = {"train": {}, "test": {t.name: np.zeros(t.n_frames, np.float32) for t in test}}
    res = train_frame_fold(cfg, train, test, device="cpu", gates=closed)
    best = res["best"]
    n = sum(t.n_frames for t in test)
    assert best["preds"].shape == (n,) and set(np.unique(best["preds"])) <= set(range(1, 6))
    assert best["probs"].shape == (n, 5) and np.isfinite(res["history"][0]["train_loss"])
    # every test frame is gated shut: the cm puts them all in column 0
    cm = np.asarray(best["cm"])
    assert cm.shape == (6, 6) and cm.sum() == n and cm[:, 1:].sum() == 0


@pytest.mark.parametrize("flags, item", [
    # the parallel flags (once refused naming A12): a mesh larger than the
    # world of one rank, and sequence parallelism with trial-DP
    (("--mesh", "2,1"), "needs 2 ranks, have 1"), (("--mesh", "1,2"), "needs 2 ranks, have 1"),
    (("--sequence-parallel", "--trial-dp"), "mutually exclusive"),
    (("--mesh", "auto", "--trial-dp", "--sequence-parallel"), "mutually exclusive"),
    (("--model-name", "SimpleCNN"), "A7"),
    (("--model-name", "TransSVNet"), "--run-id"),  # its frozen TeCNo's run
])
def test_cli_names_the_roadmap_item_of_what_is_not_ported(two_folds, tmp_path, flags, item):
    argv = ["--data-root", two_folds, "--runs-root", str(tmp_path / "runs"),
            "--device", "cpu", "--model-name", "COG", *flags]
    with pytest.raises((SystemExit, NotImplementedError), match=item):
        tcli.main(argv)
    assert not os.path.exists(tmp_path / "runs")


@pytest.mark.parametrize("flags, line", [
    (("--sequence-parallel",), "sequence-parallel mesh: {'data': 1, 'model': 1}"),
    (("--trial-dp", "--trial-batch", "2"), "trial-DP mesh: {'data': 1, 'model': 1}"),
    (("--mesh", "1", "--trial-dp"), "trial-DP mesh: {'data': 1, 'model': 1}"),
])
def test_cli_parallel_flags_run_one_epoch_at_one_rank(two_folds, tmp_path, capsys, flags, line):
    """The flags once refused naming A12 run one epoch of a fold on one rank
    and write the run layout."""
    argv = ["--data-root", two_folds, "--runs-root", str(tmp_path / "runs"),
            "--folds", "1Out", "--n-epochs", "1", *SMALL_FLAGS, *flags]
    results, tracker = tcli.main(argv)
    assert line in capsys.readouterr().out
    for out in ("1Out",):
        assert np.isfinite(results[out]["test_f1"]) and np.isfinite(results[out]["train_loss"])
        assert os.path.exists(tracker.checkpoint_path(f"best_model_LOSO_{out}.npz"))
    assert os.path.exists(os.path.join(tracker.dir, "artifacts", "summary.json"))


@pytest.mark.parametrize("flags, params", [
    (("--use-skill-prompt",), {"use_skill_prompt": True}),
    (("--trial-batch", "2"), {"trial_batch": 2}),
    (("--srm",), {"SRM": True}),
])
def test_cli_runs_the_flags_that_were_refused_as_a6(two_folds, tmp_path, flags, params):
    """The COG flags the CLI once refused, naming A6, run one epoch of both
    folds at a small size and write the run layout."""
    argv = ["--data-root", two_folds, "--runs-root", str(tmp_path / "runs"),
            "--folds", "1Out,2Out", "--n-epochs", "1", *SMALL_FLAGS, *flags]
    results, tracker = tcli.main(argv)
    assert set(results) == {"1Out", "2Out"}
    with open(os.path.join(tracker.dir, "params.json")) as f:
        written = json.load(f)
    assert {k: written[k] for k in params} == params
    for fold in results:
        assert os.path.exists(tracker.checkpoint_path(f"best_model_LOSO_{fold}.npz"))
        assert np.isfinite(results[fold]["test_loss"])
    assert os.path.exists(os.path.join(tracker.dir, "artifacts", "summary.json"))


def test_cli_takes_the_reference_defaults_and_needs_a_gpu(two_folds, tmp_path):
    args = tcommon.base_parser("t").parse_args(["--data-root", two_folds])
    assert (args.folds, args.setting, args.runs_root, args.resume, args.device) == \
        ("1Out,2Out,3Out,4Out,5Out", "LOSO", "runs", False, None)
    cfg = tcommon.config_from_args(args)
    jdefault = JaxConfig()
    assert cfg.to_dict() == jdefault.to_dict()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["--data-root", two_folds, "--runs-root", str(tmp_path / "runs"),
                       "--model-name", "COG"])
        assert not os.path.exists(tmp_path / "runs")
