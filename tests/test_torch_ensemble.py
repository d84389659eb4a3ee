"""Window ensembles in the port (med_tpu_torch.eval.ensemble,
eval.serving's WindowModelBundle / EnsembleServer / load_ensemble /
predict_trial_from_pixels, cli.ensemble) against med_tpu's on the same
dumps, runs, weights and windows, on the CPU.

Tolerances: the numpy functions and the offline CLI's printed lines
exactly equal; served probabilities within 1e-5 (the members' fp32 sums in
another order), decisions equal wherever the probability is 1e-5 or more
from the threshold; the served CLI's printed lines equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_driver import _write_fold

from med_tpu.cli import ensemble as jcli
from med_tpu.cli import train_window as jtw
from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data import datasets as jdata
from med_tpu.eval import ensemble as jens
from med_tpu.eval import serving as jserv
from med_tpu.models.resnet import ResNet50 as JaxResNet50
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu_torch.cli import ensemble as tcli
from med_tpu_torch.cli import train_window as ttw
from med_tpu_torch.config import ExperimentConfig, run_config
from med_tpu_torch.data import datasets as tdata
from med_tpu_torch.eval import ensemble as tens
from med_tpu_torch.eval import serving as tserv
from med_tpu_torch.parallel.mesh import make_mesh

PROB_TOL = 1e-5



# ----------------------------------------------------------- numpy functions
def _nd_raw(rng, n):
    """Raw 5-column labels with Needle-Drop-only rows among them."""
    raw = np.zeros((n, 5), np.int64)
    err = rng.random(n) < 0.4
    raw[err, 4] = 1
    raw[np.flatnonzero(err), rng.integers(0, 4, int(err.sum()))] = 1
    nd = rng.random(n) < 0.15
    raw[nd] = [0, 1, 0, 0, 1]
    return raw


def test_ensemble_functions_equal_jax(rng):
    pa, pb = rng.random(300), rng.random(300).astype(np.float32)
    pa[:4], pb[:4] = 0.5, np.float32(0.5)
    for got, want in zip(tens.soft_vote(pa, pb), jens.soft_vote(pa, pb)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    b, m = rng.integers(0, 2, 300), rng.integers(0, 6, 300)
    np.testing.assert_array_equal(tens.cascade_ensemble(b, m), jens.cascade_ensemble(b, m))
    for n, average in ((2, "binary"), (6, "weighted"), (6, "macro")):
        y, p = rng.integers(0, n, 500), rng.integers(0, n, 500)
        y[:n], p[:n] = np.arange(n), np.arange(n)[::-1]
        (got, got_cm), (want, want_cm) = (tens.score_predictions(y, p, n, average),
                                          jens.score_predictions(y, p, n, average))
        assert got == want
        assert got_cm.dtype == want_cm.dtype
        np.testing.assert_array_equal(got_cm, want_cm)

    raw = _nd_raw(rng, 120)
    dump = {"preds": rng.integers(0, 2, 120).tolist(), "probs": rng.random(120).tolist(),
            "labels": raw[:, 4].tolist(), "raw_labels": raw.tolist(),
            "gestures": rng.integers(1, 9, 120).tolist(),
            "subjects": [f"S{i // 40}" for i in range(120)], "cm": [[1, 0], [0, 1]]}
    n_keep = int(120 - (raw == [0, 1, 0, 0, 1]).all(1).sum())
    mc = {"preds": [0] * n_keep}
    got, want = tens.reconcile_nd(dump, mc), jens.reconcile_nd(dump, mc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert len(got["preds"]) == n_keep < 120
    for bad, match in (({k: v for k, v in dump.items() if k != "raw_labels"}, "raw_labels"),
                       (dump, "ND reconciliation failed")):
        other = mc if bad is not dump else {"preds": [0] * (n_keep + 1)}
        for fn in (tens.reconcile_nd, jens.reconcile_nd):
            with pytest.raises(ValueError, match=match):
                fn(bad, other)


# --------------------------------------------------------- offline re-scoring
def _write_run(root, experiment, run_id, dumps, **params):
    run = os.path.join(root, experiment, run_id)
    os.makedirs(os.path.join(run, "artifacts"))
    with open(os.path.join(run, "params.json"), "w") as f:
        json.dump(params, f)
    for fold, dump in dumps.items():
        with open(os.path.join(run, "artifacts", f"best_model_LOSO_{fold}.json"), "w") as f:
            json.dump(dump, f)


@pytest.fixture(scope="module")
def stored_runs(tmp_path_factory):
    """Two aligned binary runs, and a binary run with Needle-Drop-only rows
    beside a 6-class run that dropped them, over two folds."""
    rng = np.random.default_rng(7)
    root = str(tmp_path_factory.mktemp("stored"))
    video, kin, binary, multi = {}, {}, {}, {}
    for fold, n in (("1Out", 90), ("2Out", 70)):
        raw = _nd_raw(rng, n)
        common = {"labels": raw[:, 4].tolist(), "gestures": rng.integers(1, 9, n).tolist(),
                  "subjects": [f"Needle_Passing_B00{i % 3}" for i in range(n)]}
        for store in (video, kin):
            p = rng.random(n)
            store[fold] = dict(common, probs=p.tolist(), preds=(p > 0.5).astype(int).tolist())
        binary[fold] = dict(video[fold], raw_labels=raw.tolist())
        keep = ~(raw == [0, 1, 0, 0, 1]).all(1)
        y6 = np.where(raw[keep, 4] == 1, rng.integers(1, 6, int(keep.sum())), 0)
        multi[fold] = {"labels": y6.tolist(), "preds": rng.integers(0, 6, int(keep.sum())).tolist()}
    for run_id, dumps in (("video", video), ("kin", kin), ("binary", binary), ("multi", multi)):
        _write_run(root, "stored", run_id, dumps, model_name="SimpleCNN")
    return root


@pytest.mark.parametrize("mode,a,b", [("soft_vote", "video", "kin"),
                                      ("cascade", "binary", "multi")])
def test_offline_cli_prints_what_jax_prints(stored_runs, capsys, mode, a, b):
    argv = ["--runs-root", stored_runs, "--folds", "1Out,2Out", "--mode", mode,
            "--run-a", a, "--run-b", b]
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert ("overlap:" in got) if mode == "soft_vote" else ("reconciled ND rows" in got)


# ------------------------------------------------------------------ serving
def _jax_checkpoint(seed, fields, W=10):
    exp = JaxExperiment(JaxConfig(**fields))
    rng = np.random.default_rng(seed)
    batch = {"images": jnp.asarray(rng.normal(size=(8, W, 2048)), jnp.float32),
             "kinematics": jnp.asarray(rng.normal(size=(8, W, 26)), jnp.float32),
             "labels": jnp.zeros(8, jnp.int32), "mask": jnp.ones(8, jnp.float32)}
    state = exp.init_state(jax.random.key(seed), batch)
    return jax.device_get({"params": state.params, "batch_stats": state.batch_stats})


def _bundles(seed, **fields):
    fields = dict(model_name="SimpleCNN", use_pallas=False, **fields)
    ckpt = _jax_checkpoint(seed, fields)
    return (jserv.WindowModelBundle(JaxConfig(**fields), ckpt),
            tserv.WindowModelBundle(ExperimentConfig(**fields), ckpt, device="cpu"))


def _close(got, want, threshold=0.5):
    (gp, gprob), (wp, wprob) = got, (np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_allclose(gprob, wprob, rtol=0, atol=PROB_TOL)
    clear = np.abs(wprob - threshold) > PROB_TOL
    np.testing.assert_array_equal(gp[clear], wp[clear])
    return clear


def test_servers_equal_jax(rng):
    """Soft vote over a multimodal SimpleCNN (FeatureExtractor 2048 -> 32)
    and a kinematics SimpleCNN; a cascade over a binary and a 6-class
    member; with the multimodal member's FE on the int8 path too (each
    package calibrates it; med_tpu's scales are then carried across, as the
    scales of two calibrations may differ in their last bits and flip a
    code)."""
    from med_tpu_torch.ops.quant import tree_to
    from med_tpu_torch.utils.jax_params import load_jax_quant_fe

    va, ta = _bundles(0)
    vb, tb = _bundles(1, data_type="kinematics")
    images = rng.normal(size=(40, 10, 2048)).astype(np.float32)
    kin = rng.normal(size=(40, 10, 26)).astype(np.float32)
    jsoft, tsoft = jserv.EnsembleServer([va, vb]), tserv.EnsembleServer([ta, tb])
    _close(tsoft.predict(images, kin), jsoft.predict(images, kin))
    vm, tm = _bundles(3, error_type="all_errors", out_features=6)
    got = tserv.EnsembleServer([ta, tm], mode="cascade").predict(images, kin)
    want = jserv.EnsembleServer([va, vm], mode="cascade").predict(images, kin)
    clear = _close(got, want)
    assert got[0].dtype == np.int32 and set(np.unique(got[0])) <= set(range(6))
    np.testing.assert_array_equal(got[0][clear & (got[1] <= 0.5)], 0)
    for m in (va, ta, vb, tb):
        m.quantize_fe(images[:8])
    assert ta.qfe is not None and tb.qfe is None
    ta.qfe = tree_to(load_jax_quant_fe(jax.device_get(va.qfe)), ta.device)
    _close(tsoft.predict(images, kin), jserv.EnsembleServer([va, vb]).predict(images, kin))


def test_mixed_ensemble_keeps_fp32_windows_for_a_member_without_an_fe(rng):
    """--int8-fe beside a member that takes the 2048-d features directly
    (video_dims 2048, no FeatureExtractor): the port feeds the int8 store
    only when every member that takes images has an int8 FE, so that
    member's probabilities equal its fp32 ones; med_tpu's rule (any member
    with a qfe) hands it the int8 codes as features."""
    _, direct = _bundles(4, video_dims=2048)
    _, with_fe = _bundles(5)
    images = rng.normal(size=(24, 10, 2048)).astype(np.float32)
    kin = rng.normal(size=(24, 10, 26)).astype(np.float32)
    want = tserv.EnsembleServer([direct]).predict(images, kin)[1]
    server = tserv.EnsembleServer([direct, with_fe])
    for m in server.members:
        m.quantize_fe(images[:8])
    assert direct.qfe is None and with_fe.qfe is not None
    store = tcli._feature_store(server, images)
    assert store is images
    alone = tserv.EnsembleServer([direct])
    np.testing.assert_array_equal(alone.predict(store, kin)[1], want)
    codes = tcli._feature_store(tserv.EnsembleServer([with_fe]), images)
    assert codes.dtype == np.int8
    with pytest.raises(ValueError, match="int8 feature-store codes"):
        alone.predict(codes, kin)


def test_short_fold_skips_the_int8_fe_calibration():
    stats = {"image": {"mean": np.zeros(2048, np.float32), "std": np.ones(2048, np.float32)}}
    assert tcli.fe_calibration(np.ones((9, 2048), np.float32), stats, 10) is None
    calib = tcli.fe_calibration(np.ones((25, 2048), np.float32), stats, 10)
    assert calib.shape == (2, 10, 2048)


def test_refusals(tmp_path):
    """The twins compare pairs and cannot be ensemble members; a mesh is not
    a mesh (once refused naming A12) must hold the world's ranks, and one of
    one rank serves as no mesh does; CUDA is the default device and must be
    there."""
    fields = dict(model_name="Siamese_CNN", siamese=True)
    with pytest.raises(ValueError, match="pairs"):
        tserv.WindowModelBundle(ExperimentConfig(**fields), {}, device="cpu")
    _, member = _bundles(0, data_type="kinematics")
    rng = np.random.default_rng(1)
    images = rng.normal(size=(5, 10, 2048)).astype(np.float32)
    kin = rng.normal(size=(5, 10, 26)).astype(np.float32)
    plain = tserv.EnsembleServer([member]).predict(images, kin)
    meshed = tserv.EnsembleServer([member], mesh=make_mesh()).predict(images, kin)
    for a, b in zip(plain, meshed):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="needs 2 ranks, have 1"):
        tcli.main(["--mode", "soft_vote", "--run-a", "a", "--run-b", "b", "--serve",
                   "--data-root", str(tmp_path), "--mesh", "2,1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserv.WindowModelBundle(ExperimentConfig(model_name="SimpleCNN"),
                                    _jax_checkpoint(0, dict(model_name="SimpleCNN")))


# ------------------------------------------- runs of both packages' drivers
@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """Window folds on disk, a multimodal SimpleCNN (FE 2048 -> 8) run that
    med_tpu's driver wrote and a kinematics SimpleCNN run that the port's
    wrote, one fold, one epoch."""
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("ensemble_folds")
    _write_fold(str(root / "1Out"), rng, n_trials=3, T=300)
    runs = str(root / "runs")
    small = ["--data-root", str(root), "--runs-root", runs, "--video-dims", "8",
             "--batch-size", "32", "--n-epochs", "1", "--folds", "1Out"]
    jtw.main(small)
    jrun, = os.listdir(os.path.join(runs, "SimpleCNN_5Hz_multimodal"))
    _, trun = ttw.main([*small, "--device", "cpu", "--data-type", "kinematics"])
    return str(root), runs, jrun, trun.run_id


def test_load_ensemble_from_both_drivers_runs(driver_runs):
    """load_ensemble over med_tpu's run and the port's, in both packages, on
    the fold's test windows."""
    root, runs, jrun, trun = driver_runs
    cfg = run_config(os.path.join(runs, "SimpleCNN_5Hz_multimodal", jrun))
    _, test = tdata.build_window_fold(os.path.join(root, "1Out"), cfg)
    _, jtest = jdata.build_window_fold(os.path.join(root, "1Out"),
                                       JaxConfig(**{k: v for k, v in cfg.to_dict().items()
                                                    if k in JaxConfig.__dataclass_fields__}))
    np.testing.assert_array_equal(test.images, jtest.images)
    got = tserv.load_ensemble(runs, [jrun, trun], "LOSO", "1Out", device="cpu").predict(
        test.images, test.kinematics)
    want = jserv.load_ensemble(runs, [jrun, trun], "LOSO", "1Out").predict(
        test.images, test.kinematics)
    _close(got, want)


@pytest.mark.parametrize("extra", [(), ("--int8-fe",)], ids=["fp32", "int8_fe"])
def test_served_and_offline_cli_print_what_jax_prints(driver_runs, capsys, extra):
    root, runs, jrun, trun = driver_runs
    argv = ["--runs-root", runs, "--folds", "1Out", "--mode", "soft_vote", "--run-a", jrun,
            "--run-b", trun]
    for mode in (["--serve", "--data-root", root, *extra], []):
        jcli.main(argv + mode)
        want = capsys.readouterr().out
        tcli.main(argv + mode + (["--device", "cpu"] if mode else []))
        got = capsys.readouterr().out
        assert got == want
        assert "binary F1" in got and "nan" not in got


def _pixel_fold(root, rng, lengths, W=32):
    """A raw-frame fold in load_fold_trials' layout: uint8 frames under
    image_feats, one gesture so that windows are emitted."""
    os.makedirs(root)
    names = []
    for i, T in enumerate(lengths):
        name = f"Needle_Passing_B00{i + 1}"
        e = np.zeros((T, 5), np.int64)
        e[rng.random(T) < 0.4, 4] = 1
        np.savez(os.path.join(root, name + ".npz"),
                 image_feats=rng.integers(0, 256, (T, W, W, 3)).astype(np.uint8),
                 kinematics_feats=rng.normal(size=(T, 26)).astype(np.float32),
                 g_labels=np.ones(T, np.int64), e_labels=e)
        names.append(name + ".npz")
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("\n".join(names[:-1]))
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write(names[-1])


def test_pixel_serving_cli_with_int8_trunk_and_a_short_fold(driver_runs, tmp_path, capsys):
    """--serve --pixels-root: the full-geometry trunk from a fine-tune
    checkpoint (32x32 frames), fp32 and int8 (the int8 kernel's plain
    version); with --int8-fe on a train split of 8 frames, shorter than a
    window, the int8 FE is not calibrated (med_tpu crashes there)."""
    from med_tpu_torch.models.layers import init_weights
    from med_tpu_torch.models.resnet import ResNet50
    from med_tpu_torch.train.checkpoint import save_checkpoint
    from med_tpu_torch.utils.jax_params import export_jax_params

    _, runs, jrun, trun = driver_runs
    rng = np.random.default_rng(3)
    _pixel_fold(str(tmp_path / "raw" / "1Out"), rng, (8, 40))
    net = ResNet50()
    init_weights(net, torch.Generator().manual_seed(0))
    tree = export_jax_params(net)
    ckpt = str(tmp_path / "resnet50_{fold}.npz")
    save_checkpoint(ckpt.format(fold="1Out"), {"trunk": tree["params"]},
                    {"trunk": tree["batch_stats"]}, meta={"mean": [0.5] * 3, "std": [0.25] * 3})
    argv = ["--runs-root", runs, "--folds", "1Out", "--mode", "soft_vote", "--run-a", jrun,
            "--run-b", trun, "--serve", "--pixels-root", str(tmp_path / "raw"),
            "--resnet-ckpt", ckpt, "--serve-batch-size", "16", "--device", "cpu"]
    for extra, trunk in ((["--fp32-trunk"], "fp32"), (["--int8-trunk", "--int8-fe"], "int8")):
        tcli.main(argv + extra)
        out = capsys.readouterr().out
        assert f"trunk={trunk}" in out and "pixel-serve soft_vote binary F1" in out
        assert "nan" not in out


def test_window_predictions_from_pixels_equal_jax(rng):
    """Raw frames -> trunk -> windows -> ensemble in both packages: a trunk
    of stages (1, 1, 1, 1) at width 64 (2048-d features, what the
    FeatureExtractor takes) on 64x64 frames, fp32, fold statistics; a
    multimodal SimpleCNN and a kinematics one."""
    model = JaxResNet50((1, 1, 1, 1), 64, jnp.float32)
    v = jax.device_get(jax.jit(lambda: model.init(jax.random.key(0),
                                                  jnp.zeros((1, 64, 64, 3))))())
    T = 60
    frames = rng.integers(0, 256, size=(T, 64, 64, 3)).astype(np.uint8)
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    g = np.ones(T, np.int64)
    g[:7] = 0
    kw = dict(mean=np.full(3, 0.5, np.float32), std=np.full(3, 0.25, np.float32),
              stage_sizes=(1, 1, 1, 1), width=64, batch_size=16)
    jfe = jserv.PixelFrontEnd(v["params"], v["batch_stats"], dtype=jnp.float32, **kw)
    tfe = tserv.PixelFrontEnd(v["params"], v["batch_stats"], dtype=torch.float32,
                              device="cpu", **kw)
    feats = jfe.features(frames)
    stats = {"image": {"mean": feats.mean(0), "std": feats.std(0) + 1e-8},
             "kinematics": {"mean": kin.mean(0), "std": kin.std(0) + 1e-8}}
    (va, ta), (vb, tb) = _bundles(7), _bundles(8, data_type="kinematics")
    cfg = ExperimentConfig(model_name="SimpleCNN")
    starts, *got = tserv.predict_trial_from_pixels(tfe, tserv.EnsembleServer([ta, tb]),
                                                   frames, kin, g, cfg, stats)
    jstarts, *want = jserv.predict_trial_from_pixels(jfe, jserv.EnsembleServer([va, vb]),
                                                     frames, kin, g, JaxConfig(), stats)
    np.testing.assert_array_equal(starts, jstarts)
    assert len(starts) > 3
    _close(got, want)
