"""The window families' data and command lines in the port against the JAX
package's: the siamese pairs (numpy, the same draws of ``default_rng(seed)``),
window folds and batches from trial files, the three window CLIs on the CPU
at a small size (their runs read by ``med_tpu.cli.results``, the
sequential stage's gates against med_tpu's own ``_gate_fn`` on the port's
binary run), and the reference ``.pt`` importers of the window models.
Host-side numpy must agree exactly.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_torch_driver import _write_fold
from test_torch_port import ref_style_cnn, ref_style_feature_extractor, ref_style_lstm
from test_torch_window import leaves

from med_tpu.cli import results as jresults
from med_tpu.cli import train_window_es_sequential as jseq
from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data import datasets as jdata
from med_tpu.data import siamese as jsiamese
from med_tpu.train import loop as jloop
from med_tpu.utils import torch_port as jport
from med_tpu_torch.cli import train_window as twin
from med_tpu_torch.cli import train_window_es as tes
from med_tpu_torch.cli import train_window_es_sequential as tseq
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data import datasets as tdata
from med_tpu_torch.data import siamese as tsiamese
from med_tpu_torch.models import build_feature_extractor, build_model
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.utils import torch_port as tport
from med_tpu_torch.utils.jax_params import load_jax_params

SMALL = ("--device", "cpu", "--video-dims", "8", "--hidden-size", "16", "--batch-size", "32",
         "--n-epochs", "2", "--folds", "1Out")



def _windows(rng, n=60):
    """A split's gesture, error and subject columns: gesture runs within
    three subjects, errors on a third of the windows."""
    g = np.repeat(rng.integers(1, 6, n // 4 + 1), 4)[:n].reshape(-1, 1)
    err = (rng.random(n) < 0.35).astype(np.int64)
    subjects = np.asarray([f"Needle_Passing_{'BCD'[3 * i // n]}001" for i in range(n)],
                          dtype=object)
    return g, err, subjects


def test_train_pairs_equal_jax(rng):
    g, err, subjects = _windows(rng)
    got = tsiamese.create_train_pairs(g, err, subjects)
    want = jsiamese._train_pairs_numpy(g.reshape(-1).astype(np.int32), err.astype(np.int32),
                                       jsiamese._subject_ids(subjects))
    assert set(got) == set(want) and len(got["label"]) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    # med_tpu's entry point (its C++ scan where that builds) gives them too
    for k, v in jsiamese.create_train_pairs(g, err, subjects).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_test_pairs_sampling_and_materialization_equal_jax(rng, tmp_path):
    g, err, subjects = _windows(rng)
    g_te, err_te, subj_te = _windows(rng, 30)
    for n_comp, seed in ((5, 42), (3, 7)):
        got = tsiamese.create_test_pairs(g_te, err_te, subj_te, err, n_comp, seed)
        want = jsiamese.create_test_pairs(g_te, err_te, subj_te, err, n_comp, seed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pairs = tsiamese.create_train_pairs(g, err, subjects)
    got = tsiamese.sample_balanced_pairs(pairs, 50, seed=3)
    want = jsiamese.sample_balanced_pairs(pairs, 50, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    images = rng.normal(size=(60, 4, 6)).astype(np.float32)
    kin = rng.normal(size=(60, 4, 3)).astype(np.float32)
    for a, b in zip(tsiamese.materialize_pairs(got, images, kin),
                    jsiamese.materialize_pairs(want, images, kin)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # pair batches: the windows' protocol, as med_tpu's _siamese_batches
    data = tsiamese.materialize_pairs(got, images, kin)
    cfg = ExperimentConfig(batch_size=16)
    for b, jb in zip(tdata.array_batches(tloop._pair_arrays(data), 16, True, 42, 3),
                     jloop._siamese_batches(cfg, data, shuffle=True, epoch=3, seed=42),
                     strict=True):
        for k in jb:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    # the reference's CSV layout, written by one package and read by the other
    tsiamese.save_pairs_csv(str(tmp_path / "port.csv"), got, subjects, g)
    jsiamese.save_pairs_csv(str(tmp_path / "jax.csv"), want, subjects, g)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    back = tsiamese.load_pairs_csv(str(tmp_path / "jax.csv"))
    for k, v in jsiamese.load_pairs_csv(str(tmp_path / "port.csv")).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("window_folds")
    for i, out in enumerate(("1Out", "2Out")):
        _write_fold(str(root / out), rng, n_trials=3 + i, T=300, stats=i == 0)
    return str(root)


@pytest.mark.parametrize("delete_nd", [False, True])
def test_window_fold_and_batches_equal_jax(folds, delete_nd):
    """build_window_fold (load, window, powerset, Needle-Drop, standardize;
    fold 2Out has no statistics file) and window_batches (the seeded
    shuffle, the last batch padded with window 0, extras sliced along)."""
    for out in ("1Out", "2Out"):
        fields = dict(delete_ND=delete_nd, batch_size=16)
        got = tdata.build_window_fold(os.path.join(folds, out), ExperimentConfig(**fields))
        want = jdata.build_window_fold(os.path.join(folds, out), JaxConfig(**fields))
        for g, w in zip(got, want):
            assert len(g) == len(w) > 16
            for name in ("images", "kinematics", "g_labels", "e_powerset", "subjects", "e_raw"):
                a, b = getattr(g, name), getattr(w, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            assert g.binary_error_distribution == w.binary_error_distribution
            assert g.specific_error_distribution == w.specific_error_distribution
            for error_type in ("global", "all_errors", "Out_Of_View"):
                np.testing.assert_array_equal(g.labels_for(error_type), w.labels_for(error_type))
        gate = {"gate": np.arange(len(got[1]), dtype=np.float32)}
        cfg = ExperimentConfig(**fields)
        batches = list(tdata.window_batches(got[1], cfg, True, seed=5, epoch=2, extras=gate))
        jbatches = list(jdata.window_batches(want[1], JaxConfig(**fields), True, seed=5,
                                             epoch=2, extras=gate))
        assert len(batches) == len(jbatches) == tdata.n_window_batches(got[1], cfg)
        for b, jb in zip(batches, jbatches):
            assert set(b) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)


def _layout(tracker):
    files = sorted(os.path.relpath(os.path.join(d, f), tracker.dir)
                   for d, _, fs in os.walk(tracker.dir) for f in fs)
    want = ["artifacts/summary.json", "metrics.jsonl", "params.json"]
    for out in ("1Out",):
        want += [f"artifacts/best_model_LOSO_{out}.json",
                 f"checkpoints/best_model_LOSO_{out}.npz",
                 f"checkpoints/best_model_LOSO_{out}.npz.json",
                 f"checkpoints/last_state_LOSO_{out}.npz",
                 f"images/LOSO_fold_{out}_results.png"]
    params = json.load(open(os.path.join(tracker.dir, "params.json")))
    # med_tpu's plots: the best epoch's test matrix, named for a binary one
    binary = params["error_type"] == "global" or params["siamese"]
    want.append("images/LOSO_Test_Confusion_Matrix"
                + ("_global.png" if binary else ".png"))
    assert files == sorted(want)
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()
                        if k not in ("window_size", "stride", "in_features")})
    assert params == json.loads(json.dumps(jcfg.to_dict()))
    return params


def test_window_command_lines_write_the_run_layout_read_by_jax(folds, tmp_path, capsys):
    """python -m med_tpu_torch.cli.train_window (SimpleLSTM with pos_weight,
    then Siamese_CNN), train_window_es and train_window_es_sequential
    --run-id <the SimpleLSTM run> on the CPU at a small size: med_tpu's run
    layout and config keys, finite best rows, med_tpu's results table reads
    each run, and the sequential stage's gates equal med_tpu's _gate_fn on
    the same binary run."""
    runs = str(tmp_path / "runs")
    argv = ["--data-root", folds, "--runs-root", runs, *SMALL]
    # --fold-parallel (once refused naming A12) refuses --resume, as med_tpu's
    with pytest.raises(SystemExit, match="does not support --resume"):
        twin.main([*argv, "--fold-parallel", "--resume"])
    assert not os.path.exists(runs)
    results, binary = twin.main([*argv, "--model-name", "SimpleLSTM", "--pos-weight"])
    params = _layout(binary)
    assert (params["error_type"], params["out_features"], params["siamese"]) == ("global", 1,
                                                                                   False)
    ckpt = np.load(os.path.join(binary.dir, "checkpoints", "best_model_LOSO_1Out.npz"))
    assert "constants/class_counts" in ckpt.files
    assert any(k.startswith("batch_stats/model/head/bn0/") for k in ckpt.files)
    runs_made = {"lstm": (binary.run_id, 2)}

    results, siamese = twin.main([*argv, "--model-name", "Siamese_CNN", "--n-pairs", "64",
                                  "--n-comparisons", "3", "--data-type", "kinematics"])
    assert _layout(siamese)["siamese"] is True
    runs_made["siamese"] = (siamese.run_id, 2)
    for best in results.values():
        assert best["preds"].ndim == 1 and np.asarray(best["cm"]).shape == (2, 2)

    results, es = tes.main(argv)
    params = _layout(es)
    assert (params["model_name"], params["error_type"], params["out_features"],
            params["delete_ND"]) == ("SimpleLSTM", "all_errors", 6, True)
    runs_made["es"] = (es.run_id, 6)

    with pytest.raises(SystemExit, match="--run-id"):
        tseq.main(argv)
    results, seq = tseq.main([*argv, "--run-id", binary.run_id])
    params = _layout(seq)
    assert (params["error_type"], params["out_features"]) == ("sequential", 5)
    runs_made["seq"] = (seq.run_id, 6)
    for best in results.values():
        assert best["probs"].shape[1] == 5 and np.isfinite(best["test_loss"])
        assert np.asarray(best["cm"]).shape == (6, 6)

    cfg = ExperimentConfig(**{k: v for k, v in params.items()
                              if k not in ("window_size", "stride", "in_features")})
    train, test = tdata.build_window_fold(os.path.join(folds, "1Out"), cfg)
    ns = tseq.base_parser("").parse_args(argv + ["--run-id", binary.run_id])
    got = tseq._gate_fn(ns, cfg)("1Out", train, test)
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()
                        if k not in ("window_size", "stride", "in_features")})
    jtrain, jtest = jdata.build_window_fold(os.path.join(folds, "1Out"), jcfg)
    want = jseq._gate_fn(ns, jcfg)("1Out", jtrain, jtest)
    for split in ("train", "test"):
        np.testing.assert_array_equal(got[split]["gate"], want[split]["gate"], err_msg=split)
    assert got["test"]["gate"].shape == (len(test),)

    for label, (run_id, n_classes) in runs_made.items():
        jresults.main(["table", "--runs-root", runs, "--folds", "1Out",
                       "--run", f"{label}={run_id}", "--n-classes", str(n_classes),
                       "--average", "binary" if n_classes == 2 else "macro"])
        out = capsys.readouterr().out
        assert label in out and "F1" in out and "±" in out


def _reference_blob(path, model_name, rng):
    """A reference window model's ``best_model`` blob, the reference's key
    names, its BatchNorm statistics away from (0, 1). torch's modules draw
    their initial weights from a torch seed taken from ``rng``, not from
    the global generator, whose state depends on what ran before in the
    process."""
    with torch.random.fork_rng():
        torch.manual_seed(int(rng.integers(2 ** 31)))
        model = ref_style_cnn() if model_name.endswith("CNN") else ref_style_lstm()
        fe = ref_style_feature_extractor()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.copy_(torch.tensor(rng.normal(size=mod.running_mean.shape)))
                mod.running_var.copy_(torch.tensor(rng.random(mod.running_var.shape) + 0.5))
    torch.save({"feature_extractor": fe.state_dict(), "model": model.state_dict()}, path)
    return model.eval(), fe.eval()


@pytest.mark.parametrize("model_name", ["SimpleCNN", "SimpleLSTM", "Siamese_CNN",
                                        "Siamese_LSTM"])
def test_reference_window_checkpoints_import_as_jax_imports_them(tmp_path, rng, model_name):
    """A synthetic reference .pt through both importers: the same tree (a
    twin's under "branch", where the twin holds its branch; med_tpu's
    importer leaves it at the top); the port's model on it gives the torch
    oracle's logits (1e-5 of the largest)."""
    path = str(tmp_path / "best_model_LOSO_1Out.pt")
    oracle, fe_ref = _reference_blob(path, model_name, rng)
    got = tport.import_reference_checkpoint(path, model_name)
    want = jport.import_reference_checkpoint(path, model_name)
    if model_name.startswith("Siamese"):
        want["params"]["model"] = {"branch": want["params"]["model"]}
        want["batch_stats"]["model"] = {"branch": want["batch_stats"]["model"]}
    flat, wflat = leaves(got), leaves(want)
    assert set(flat) == set(wflat)
    for k, v in wflat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)

    cfg = ExperimentConfig(model_name=model_name)
    model, fe = build_model(cfg), build_feature_extractor(cfg)
    state, _ = load_jax_params({"params": got["params"]["model"],
                                "batch_stats": got["batch_stats"]["model"]}, model)
    model.load_state_dict(state)
    fe_state, _ = load_jax_params({"params": got["params"]["fe"]}, fe)
    fe.load_state_dict(fe_state)
    x_img = torch.tensor(rng.normal(size=(4, 10, 2048)), dtype=torch.float32)
    x_kin = torch.tensor(rng.normal(size=(4, 10, 26)), dtype=torch.float32)
    with torch.no_grad():
        x = torch.cat([fe(x_img), x_kin], dim=-1)
        ref = torch.cat([fe_ref.linear(x_img), x_kin], dim=-1)

        def ref_features(inp):
            if model_name.endswith("CNN"):
                return oracle.convolutional_layers(inp.permute(0, 2, 1))
            return torch.relu(oracle.lstm(inp)[0])[:, -1]

        if model_name.startswith("Siamese"):   # each window against the first
            got_logits = model(x, x[:1].expand_as(x))
            want_logits = oracle.linear_layers(
                torch.abs(ref_features(ref) - ref_features(ref[:1].expand_as(ref))))
        else:
            got_logits = model(x)
            want_logits = oracle.linear_layers(ref_features(ref))
    want_np = want_logits.numpy()
    np.testing.assert_allclose(got_logits.numpy(), want_np, rtol=1e-4,
                               atol=1e-5 * np.abs(want_np).max())

