"""The port's error-specific frame regime against the JAX package's: the
frame path's F1 average on a 6-class siamese config (fault C4), COG's
observed-gesture, skill-prompt and SRM variants, a named error type, the
sequential regime's loss and gates, the ES and sequential command lines,
and bf16 compute.

Inputs are made from a numpy seed; both packages take the port's weights
(``export_jax_params``) and, in training, the same numpy dropout masks: the
port through ``masks=``, med_tpu through ``flax.linen.intercept_methods``.
The JAX COG runs its plain XLA paths (``use_pallas=False``, as med_tpu's
own CPU tests run it; the port's kernels' plain versions are held against
the Pallas kernels in interpret mode by test_torch_attention_schedule.py
and test_torch_train_ops.py). Tolerances are stated per test.
"""

import argparse
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.cli import results as jresults
from med_tpu.cli import train_frame_es_sequential as jseq
from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data.datasets import FrameTrial as JaxTrial
from med_tpu.models.cog import COG as JaxCOG
from med_tpu.models.cog import COGStage as JaxCOGStage
from med_tpu.models.layers import ResidualStack as JaxResidualStack
from med_tpu.models.tcn import TeCNo as JaxTeCNo
from med_tpu.train import loop as jloop
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu.train.engine import _cog_sequential_loss, _loss_for_family
from med_tpu_torch.cli import train_frame as tcli
from med_tpu_torch.cli import train_frame_es as tes
from med_tpu_torch.cli import train_frame_es_sequential as tseq
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data import trials as ttrials
from med_tpu_torch.data.datasets import FrameTrial, build_frame_fold, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.models import build_model, build_tecno, init_weights
from med_tpu_torch.models.cog import COG
from med_tpu_torch.models.tcn import TeCNo
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.train.engine import Experiment, cog_loss, cog_sequential_loss
from med_tpu_torch.utils.jax_params import export_jax_params

COG_FIELDS = dict(model_name="COG", dataset_type="frame", data_type="kinematics",
                  num_layers_Basic=3, num_layers_R=2, num_R=2, mstcn_f_maps=16,
                  d_model=16, d_q=2, sequence_length=5, seed=0)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _trial(rng, T, name, n_classes=6):
    """A trial whose powerset class (runs of 8 frames) shifts 5 kinematic
    channels; the 7th column is error against none."""
    cls = np.repeat(rng.integers(0, n_classes, T // 8 + 1), 8)[:T]
    e = np.zeros((T, 7), np.int32)
    e[np.arange(T), cls] = 1
    e[:, -1] = cls > 0
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    kin[:, :5] += cls[:, None] * 0.7
    return dict(name=name, images=np.zeros((T, 2048), np.float32), kinematics=kin,
                g_labels=rng.integers(1, 9, T), e_powerset=e,
                skill=skill_one_hot(name, T), e_raw=rng.integers(0, 2, (T, 5)))


def _both(fields):
    return FrameTrial(**fields), JaxTrial(**fields)


def _masks(rng, cfg, T):
    """Numpy-seeded dropout masks of every COG stage, in COG.dropout_masks'
    layout (B = 1)."""
    C = cfg.mstcn_f_maps
    stages = {"TCN": (cfg.num_layers_Basic, T, True),
              "fast_stage1": (cfg.num_layers_Basic, T // 16, True)}
    for r in range(cfg.num_R):
        stages[f"R{r}"] = (cfg.num_layers_R, T, False)
        stages[f"fast_R{r}"] = (cfg.num_layers_R, T // 16, False)
    out = {}
    for name, (L, t, channel) in stages.items():
        out[name] = {"stack": rng.integers(0, 2, size=(L, 1, t, C)).astype(np.uint8)}
        if channel:
            out[name]["channel"] = rng.integers(0, 2, size=(1, 1, C)).astype(np.float32)
    return out


def _interceptor(masks):
    """med_tpu's dropout draws replaced by ``masks`` (stage name -> arrays)."""
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JaxResidualStack) and context.method_name == "dropout_mask":
            return jnp.asarray(masks[mod.path[-2]]["stack"])
        if (isinstance(mod, JaxCOGStage) and context.method_name == "pre"
                and mod.channel_dropout and args[1]):
            keep = jnp.asarray(masks[mod.path[-1]]["channel"])
            return next_fun(args[0], False) * keep.astype(args[0].dtype) * 2.0
        return next_fun(*args, **kwargs)
    return intercept


def _torch_masks(masks):
    return {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in masks.items()}


# ------------------------------------------------------------------- C4
def test_frame_metrics_take_the_frame_rule_on_a_six_class_siamese_config():
    """C4: med_tpu's frame loop averages F1 as binary for the global error
    type alone; a 6-class config with siamese=True is macro there, and so in
    the port. Same weights and dropout masks on both sides:
    evaluate_frame_fold's metrics, train_frame_fold's rows (losses at rtol
    1e-4, F1/accuracy/Jaccard from the same confusion matrices, exactly) and
    the best epoch."""
    fields = dict(COG_FIELDS, error_type="all_errors", out_features=6, siamese=True,
                  n_epochs=2, lr=3e-3, weight_decay=0.0, lr_scheduler=False)
    cfg, jcfg = ExperimentConfig(**fields), JaxConfig(**fields, use_pallas=False)
    assert tloop._average_for(cfg) == "binary"        # the window rule, kept for A7
    rng = np.random.default_rng(5)
    train = [_both(_trial(rng, T, f"Needle_Passing_{c}001")) for T, c in ((60, "B"), (50, "C"))]
    test = [_both(_trial(rng, T, f"Needle_Passing_{c}001")) for T, c in ((70, "D"), (40, "E"))]
    bucket = tloop._common_bucket(cfg, [t for t, _ in train + test])
    masks = _masks(rng, cfg, bucket)

    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed)
    tree = export_jax_params(exp.net)
    jexp = JaxExperiment(jcfg)
    plain_init = jexp.init_state

    def init_state(rng_key, sample, frozen=None, class_counts=None):
        state = plain_init(rng_key, sample, frozen=frozen)
        params = jax.tree.map(jnp.asarray, tree["params"])
        return state.replace(params=params, opt_state=jexp.tx.init(params),
                             constants={"model": jax.tree.map(jnp.asarray,
                                                              tree["constants"]["model"])})

    jexp.init_state = init_state
    state = init_state(jax.random.key(0), {k: v for k, v in frame_batch(
        train[0][0], cfg, bucket=bucket).items() if not k.startswith("_")})
    got = tloop.evaluate_frame_fold(cfg, exp, [t for t, _ in test], common_bucket=bucket)
    want = jloop.evaluate_frame_fold(jcfg, jexp, state, [j for _, j in test],
                                     common_bucket=bucket)
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    for k in ("f1", "f1_weighted", "acc", "jaccard"):
        assert got["metrics"][k] == want["metrics"][k], k
    np.testing.assert_array_equal(got["cm"], want["cm"])
    assert got["metrics"]["f1"] == got["metrics"]["f1_weighted"]     # macro: no weighted

    # the whole fold, both sides on the same masks every step
    exp.net.model.dropout_masks = lambda T, generator, B=1: _torch_masks(masks)
    res = tloop.train_frame_fold(cfg, [t for t, _ in train], [t for t, _ in test],
                                 exp=exp)
    with nn.intercept_methods(_interceptor(masks)):
        jres = jloop.train_frame_fold(jcfg, [j for _, j in train], [j for _, j in test],
                                      exp=jexp)
    assert len(res["history"]) == len(jres["history"]) == 2
    for row, jrow in zip(res["history"], jres["history"]):
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4, err_msg=k)
        for k in ("train_f1", "train_f1_weighted", "train_acc", "train_jaccard",
                  "test_f1", "test_f1_weighted", "test_acc", "test_jaccard"):
            assert row[k] == jrow[k], k
    assert res["best"]["epoch"] == jres["best"]["epoch"]
    np.testing.assert_array_equal(res["best"]["preds"], jres["best"]["preds"])


# ------------------------------------------------------------- variants
VARIANTS = {"observed": dict(use_all_gestures=False), "skill_prompt": dict(use_skill_prompt=True),
            "srm": dict(SRM=True)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cog_variant_forward_and_gradients_match_jax(variant):
    """Each variant's prompt table, every output track (rtol 1e-4, atol 1e-4)
    and one training forward's loss and gradients with the same dropout
    masks (rtol 1e-4, atol 1e-5 of each leaf's own max) against med_tpu's
    COG on its plain XLA paths."""
    fields = dict(COG_FIELDS, out_features=2, **VARIANTS[variant])
    cfg, jcfg = ExperimentConfig(**fields), JaxConfig(**fields)
    rng = np.random.default_rng(7)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    tree = export_jax_params(exp.net)
    M = {"observed": 8, "skill_prompt": 45, "srm": 15}[variant]
    assert tree["constants"]["model"]["gest_embed"].shape == (M, 512)
    assert ("skill_embed" in tree["constants"]["model"]) == (variant == "srm")
    assert ("cot_skill" in tree["params"]["model"]) == (variant == "srm")
    model = JaxCOG(num_layers_basic=jcfg.num_layers_Basic, num_layers_r=jcfg.num_layers_R,
                   num_r=jcfg.num_R, f_maps=jcfg.mstcn_f_maps, f_dim=jcfg.in_features(),
                   out_classes=2, d_model=jcfg.d_model, d_q=jcfg.d_q,
                   len_q=jcfg.sequence_length, use_all_gestures=jcfg.use_all_gestures,
                   use_skill_prompt=jcfg.use_skill_prompt, srm=jcfg.SRM,
                   use_pallas=False, fused=False)
    # med_tpu's own tables: the same surrogate rows
    jconsts = model.init(jax.random.key(0), jnp.zeros((1, 32, 26)))["constants"]
    for name, table in jconsts.items():
        np.testing.assert_array_equal(tree["constants"]["model"][name], np.asarray(table))

    batch = frame_batch(FrameTrial(**_trial(rng, 40, "Needle_Passing_C002", 2)), cfg, bucket=64)
    x = jnp.asarray(batch["kinematics"])
    variables = {"params": tree["params"]["model"], "constants": tree["constants"]["model"]}
    want_out, _ = model.apply(variables, x)
    with torch.no_grad():
        got_out, _ = exp.net.model(torch.from_numpy(batch["kinematics"]))
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)

    masks = _masks(rng, cfg, 64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("_")}

    def loss_fn(params):
        with nn.intercept_methods(_interceptor(masks)):
            out = model.apply({"params": params, "constants": variables["constants"]}, x,
                              train=True, rngs={"dropout": jax.random.key(0)})
        return _loss_for_family(jcfg, "cog", out, jbatch, {})

    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    loss, _ = exp.compute_gradients(batch, masks=_torch_masks(masks))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = _leaves(export_jax_params(exp.net, grads=True)["params"]["model"])
    want = _leaves(jax.device_get(want_grads))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=path)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("error_type", ["Out_Of_View", "Needle_Position"])
def test_cog_loss_for_a_named_error_type_matches_jax(rng, error_type):
    """A named error type goes through the all_errors branch with
    out_features classes and no binary cm: loss at rtol 1e-5, cm exactly."""
    Tpad, true_len = 64, 45
    tracks = [rng.normal(size=(1, t, 2)).astype(np.float32) for t in [Tpad] * 4 + [4] * 4]
    fields = _trial(rng, true_len, "Needle_Passing_B001")
    col = {"Out_Of_View": 1, "Needle_Position": 3}[error_type]
    fields["e_powerset"][:, col] = rng.integers(0, 2, true_len)
    labels = np.pad(FrameTrial(**fields).labels_for(error_type), (0, Tpad - true_len))
    assert set(np.unique(labels)) == {0, 1}
    mask = (np.arange(Tpad) < true_len).astype(np.float32)
    batch = {"labels": labels, "mask": mask, "true_len": np.asarray(true_len, np.int32)}
    fields = dict(model_name="COG", dataset_type="frame", error_type=error_type,
                  out_features=2)
    want_loss, want = _loss_for_family(JaxConfig(**fields), "cog",
                                       ([jnp.asarray(t) for t in tracks], None),
                                       {k: jnp.asarray(v) for k, v in batch.items()}, {})
    got_loss, got = cog_loss(ExperimentConfig(**fields), [torch.from_numpy(t) for t in tracks],
                             {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want) == {"cm", "preds", "probs"}
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=1e-5)


@pytest.mark.parametrize("true_len", [45, 64, 1])
def test_sequential_loss_matches_jax_with_random_gates(rng, true_len):
    """_cog_sequential_loss on 8 tracks of 5 classes, random gates: the
    loss (rtol 1e-5), the 6-class gated cm and the 5-class cm (exactly),
    predictions argmax + 1 and probabilities."""
    Tpad = 64
    tracks = [rng.normal(size=(1, t, 5)).astype(np.float32) for t in [Tpad] * 4 + [4] * 4]
    batch = {"labels": rng.integers(0, 6, Tpad),
             "mask": (np.arange(Tpad) < true_len).astype(np.float32),
             "true_len": np.asarray(true_len, np.int32),
             "gate": (rng.random(Tpad) < 0.6).astype(np.float32)}
    fields = dict(model_name="COG", dataset_type="frame", error_type="sequential",
                  out_features=5, smooth_lambda=0.15)
    want_loss, want = _cog_sequential_loss(JaxConfig(**fields), [jnp.asarray(t) for t in tracks],
                                           {k: jnp.asarray(v) for k, v in batch.items()}, 8)
    cfg = ExperimentConfig(**fields)
    got_loss, got = cog_sequential_loss(
        cfg, [torch.from_numpy(t) for t in tracks],
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want)
    for k in ("cm", "cm_specific", "preds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=1e-5)
    assert cog_loss(cfg, [torch.from_numpy(t) for t in tracks],
                    {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
                    )[0].item() == got_loss.item()
    with pytest.raises(ValueError, match="gate"):
        cog_sequential_loss(cfg, [torch.from_numpy(t) for t in tracks],
                            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
                             if k != "gate"})


# -------------------------------------------------------- command lines
def _write_fold(fold_dir, rng, n_trials, T=120):
    os.makedirs(fold_dir)
    names = [f"Needle_Passing_{'BCDEF'[i]}00{i + 1}" for i in range(n_trials)]
    for name in names:
        g = np.repeat(rng.integers(1, 6, T // 20 + 1), 20)[:T]
        e = np.zeros((T, 5), np.int64)
        err = rng.random(T) < 0.5
        e[err, 4] = 1
        e[np.flatnonzero(err), rng.integers(0, 4, int(err.sum()))] = 1
        kin = (rng.normal(size=(T, 26)) + e[:, 4:5] * 2.0).astype(np.float32)
        ttrials.save_trial_npz(os.path.join(fold_dir, name + ".npz"), ttrials.Trial(
            name, rng.normal(size=(T, 2048)).astype(np.float32), kin, g, e))
    for csv, listed in (("train.csv", names[:-1]), ("test.csv", names[-1:])):
        with open(os.path.join(fold_dir, csv), "w") as f:
            f.write("\n".join(n + ".npz" for n in listed))
    img, kin, _, _, _ = ttrials.load_fold(fold_dir, "train.csv")
    ttrials.save_fold_stats(fold_dir, ttrials.compute_fold_stats(img, kin))


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("es_folds")
    for i, out in enumerate(("1Out", "2Out")):
        _write_fold(str(root / out), rng, n_trials=3 + i)
    return str(root)


SMALL_FLAGS = ("--data-type", "kinematics", "--device", "cpu", "--num-layers-basic", "2",
               "--num-layers-r", "2", "--num-r", "1", "--d-model", "16", "--d-q", "2",
               "--sequence-length", "6", "--no-use-pallas", "--folds", "1Out,2Out",
               "--n-epochs", "2")


@pytest.fixture(scope="module")
def binary_run(folds, tmp_path_factory):
    runs = str(tmp_path_factory.mktemp("runs"))
    _, tracker = tcli.main(["--model-name", "COG", "--data-root", folds, "--runs-root", runs,
                            *SMALL_FLAGS])
    return runs, tracker.run_id


def test_sequential_gates_match_jax_on_the_same_checkpoint(folds, binary_run):
    """The sequential CLI's gates from the binary run's best checkpoints:
    the port's and med_tpu's _gates_fn give the same 0/1 gates, test trials
    trimmed to their frames, train trials their true-error frames."""
    runs, run_id = binary_run
    args = argparse.Namespace(runs_root=runs, run_id=run_id, setting="LOSO", device="cpu")
    fields = dict(model_name="COG", dataset_type="frame", data_type="kinematics",
                  error_type="sequential", out_features=5, delete_ND=True)
    port_fn = tseq._gates_fn(args, ExperimentConfig(**fields))
    jax_fn = jseq._gates_fn(args, JaxConfig(**fields))
    for out in ("1Out", "2Out"):
        fold = os.path.join(folds, out)
        cfg = ExperimentConfig(**fields)
        train = build_frame_fold(fold, cfg, "train.csv")
        test = build_frame_fold(fold, cfg, "test.csv")
        got, want = port_fn(out, train, test), jax_fn(out, train, test)
        for split in ("train", "test"):
            assert set(got[split]) == set(want[split])
            for name, gate in want[split].items():
                assert got[split][name].dtype == np.float32
                np.testing.assert_array_equal(got[split][name], np.asarray(gate), err_msg=name)
        assert {len(g) for g in got["test"].values()} == {t.n_frames for t in test}


@pytest.mark.parametrize("stage", ["es", "sequential"])
def test_es_command_lines_write_the_run_layout_read_by_jax(folds, binary_run, stage, capsys):
    """python -m med_tpu_torch.cli.train_frame_es / _sequential on the CPU at
    a small size: med_tpu's config keys and the stage's fixed fields, the
    run layout, 6-class windowed metrics, and med_tpu's results table reads
    the run."""
    runs, run_id = binary_run
    argv = ["--data-root", folds, "--runs-root", runs, *SMALL_FLAGS]
    if stage == "es":
        results, tracker = tes.main(argv)
        fixed = {"error_type": "all_errors", "out_features": 6, "smooth_lambda": 0.15}
    else:
        with pytest.raises(SystemExit, match="--run-id"):
            tseq.main(argv)
        results, tracker = tseq.main([*argv, "--run-id", run_id])
        fixed = {"error_type": "sequential", "out_features": 5, "smooth_lambda": 0.0}
    params = json.load(open(os.path.join(tracker.dir, "params.json")))
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()
                        if k not in ("window_size", "stride", "in_features")})
    assert params == json.loads(json.dumps(jcfg.to_dict()))
    assert {k: params[k] for k in fixed} == fixed
    assert (params["delete_ND"], params["mstcn_stages"], params["lr_scheduler"],
            params["weight_decay"], params["n_epochs"]) == (True, 8, False, 0.0, 2)
    files = sorted(os.path.relpath(os.path.join(d, f), tracker.dir)
                   for d, _, fs in os.walk(tracker.dir) for f in fs)
    want = ["artifacts/summary.json", "artifacts/windowed_metrics.json",
            "metrics.jsonl", "params.json"]
    for out in ("1Out", "2Out"):
        want += [f"artifacts/best_model_LOSO_{out}.json",
                 f"checkpoints/best_model_LOSO_{out}.npz",
                 f"checkpoints/best_model_LOSO_{out}.npz.json",
                 f"checkpoints/last_state_LOSO_{out}.npz",
                 f"images/LOSO_fold_{out}_results.png"]
    want.append("images/LOSO_Test_Confusion_Matrix.png")    # med_tpu's 6-class name
    assert files == sorted(want)
    windowed = json.load(open(os.path.join(tracker.dir, "artifacts", "windowed_metrics.json")))
    assert np.asarray(windowed["cm"]).shape == (6, 6)
    for best in results.values():
        assert best["probs"].shape[1] == fixed["out_features"]
        assert np.isfinite(best["test_loss"]) and np.asarray(best["cm"]).shape == (6, 6)
    jresults.main(["table", "--runs-root", runs, "--folds", "1Out,2Out",
                   "--run", f"{stage}={tracker.run_id}", "--n-classes", "6",
                   "--average", "macro"])
    out = capsys.readouterr().out
    assert stage in out and "F1" in out and "±" in out


# --------------------------------------------------------------- bfloat16
# port bf16 against med_tpu bf16, max |difference| over the largest |logit|:
# both run the same ops in the same order, but two libraries may round a
# bf16 sum the other way, one bf16 step (2**-8 of a value), which the
# layers after it carry to the logits
BF16_VS_JAX = 2e-2


@pytest.mark.parametrize("name", ["COG", "TeCNo"])
def test_bfloat16_forward_matches_jax_bfloat16_and_float32(name):
    """compute_dtype="bfloat16": float32 parameters, bf16 TCN paths, float32
    logits. Against med_tpu's bf16 forward on the same weights the logits
    agree within BF16_VS_JAX of their largest |value|; against the port's
    float32 forward within 0.1 of its largest, med_tpu's own bound
    (tests/test_models_shapes.py)."""
    rng = np.random.default_rng(9)
    T = 64
    x = rng.normal(size=(1, T, 26)).astype(np.float32)
    if name == "COG":
        kw = dict(num_layers_basic=3, num_layers_r=2, num_r=2, f_maps=16, f_dim=26,
                  d_model=16, d_q=2, len_q=5)
        nets = {dt: COG(**kw, dtype=dt) for dt in (None, torch.bfloat16)}
        jmod = JaxCOG(**kw, dtype=jnp.bfloat16, use_pallas=False, fused=False)
    else:
        kw = dict(num_stages=2, num_layers=4, f_maps=16, in_dim=26)
        nets = {dt: TeCNo(**kw, dtype=dt) for dt in (None, torch.bfloat16)}
        jmod = JaxTeCNo(**kw, dtype=jnp.bfloat16, fused=False)
    init_weights(nets[None], torch.Generator().manual_seed(4))
    nets[torch.bfloat16].load_state_dict(nets[None].state_dict())
    assert {p.dtype for p in nets[torch.bfloat16].parameters()} == {torch.float32}
    tree = export_jax_params(nets[None])
    variables = {"params": tree["params"]}
    if "constants" in tree:
        variables["constants"] = tree["constants"]
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = {dt: net(torch.from_numpy(x)) for dt, net in nets.items()}
    if name == "COG":
        want, got = list(want[0]), {dt: out for dt, (out, _) in got.items()}
    else:
        want, got = [want], {dt: [out] for dt, out in got.items()}
    for g16, g32, w in zip(got[torch.bfloat16], got[None], want):
        assert g16.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g16.numpy(), np.asarray(w), rtol=0,
                                   atol=BF16_VS_JAX * scale)
        np.testing.assert_allclose(g16.numpy(), g32.numpy(), rtol=0,
                                   atol=0.1 * float(g32.abs().max()))


def test_bfloat16_config_builds_the_bfloat16_models():
    for name in ("COG", "TeCNo"):
        net = build_model(ExperimentConfig(model_name=name, dataset_type="frame",
                                           compute_dtype="bfloat16", out_features=2))
        stacks = [m for m in net.modules() if hasattr(m, "w3")]
        assert stacks and {m.dtype for m in stacks} == {torch.bfloat16}
    # the frozen TeCNo under TransSVNet stays float32, as med_tpu builds it
    cfg = ExperimentConfig(model_name="TransSVNet", dataset_type="frame",
                           compute_dtype="bfloat16", out_features=2)
    exp = Experiment(cfg, device="cpu")
    exp.load_frozen({"tecno_params": export_jax_params(build_tecno(cfg))["params"]})
    assert {m.dtype for m in exp.frozen.modules() if hasattr(m, "w3")} == {None}



def test_reference_srm_checkpoint_imports_into_the_srm_variant(tmp_path):
    """A reference SRM COG state dict (the reference's key names: a second
    chain ``cot_skill`` and the ``all_skill_fea`` table; the stages' input
    convs over both chains' features) goes through both packages' `.pt`
    importers to the same tree, loads into the port's SRM COG, and gives
    med_tpu's SRM COG's logits (rtol 1e-4, atol 1e-4)."""
    from test_cog_full_parity import (D_MODEL, D_Q, F_DIM, F_MAPS, GEST_DIM, LEN_Q, N_CLS,
                                      NLB, NLR, NUM_R, POOL, RefCOG, T)

    from med_tpu.utils import torch_port as jport
    from med_tpu_torch.train.engine import FrameNet
    from med_tpu_torch.utils import torch_port as tport
    from med_tpu_torch.utils.jax_params import load_jax_params

    torch.manual_seed(1)
    sd = {k: v.clone() for k, v in RefCOG().state_dict().items()}
    for k in [k for k in sd if k.startswith("cot.")]:
        sd["cot_skill." + k[4:]] = sd[k] + 0.05 * torch.randn_like(sd[k])
    sd["all_skill_fea"] = torch.randn(15, GEST_DIM)
    for stage in ("TCN", "fast_stage1"):
        w = sd[f"{stage}.conv_1x1.weight"]
        sd[f"{stage}.conv_1x1.weight"] = torch.cat([w, 0.1 * torch.randn_like(w)], dim=1)
    path = str(tmp_path / "best_model_LOSO_1Out.pt")
    torch.save({"model": sd}, path)
    want, got = (jport.import_reference_checkpoint(path, "COG"),
                 tport.import_reference_checkpoint(path, "COG"))
    assert "cot_skill" in got["params"]["model"] and "skill_embed" in got["constants"]["model"]
    wl, gl = _leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    for p, w in wl.items():
        np.testing.assert_array_equal(gl[p], w, err_msg=p)

    kw = dict(num_layers_basic=NLB, num_layers_r=NLR, num_r=NUM_R, f_maps=F_MAPS, f_dim=F_DIM,
              out_classes=N_CLS, d_model=D_MODEL, d_q=D_Q, len_q=LEN_Q, gest_dim=GEST_DIM,
              fast_pool=POOL, srm=True)
    net = FrameNet(COG(**kw)).eval()
    state, constants = load_jax_params(got, net)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        for name, value in constants.items():
            net.get_buffer(name).copy_(value)
    x = np.random.default_rng(3).normal(size=(1, T, F_DIM)).astype(np.float32)
    jout, _ = JaxCOG(**kw, use_pallas=False).apply(
        {"params": want["params"]["model"], "constants": want["constants"]["model"]},
        jnp.asarray(x))
    with torch.no_grad():
        out, _ = net.model(torch.from_numpy(x))
    for k, (g, w) in enumerate(zip(out, jout, strict=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"track {k}")


@pytest.mark.parametrize("fields", [
    dict(error_type="all_errors", out_features=6),
    dict(error_type="Out_Of_View", out_features=2),
], ids=["six_classes", "named_type"])
def test_frame_server_serves_the_es_configurations_as_jax(fields):
    """FrameModelServer on the port's checkpoint against med_tpu's server on
    the same tree: every class's probability when the model is not binary,
    the class-1 probability otherwise (atol 1e-5), the same predictions."""
    from med_tpu.eval.serving import FrameModelServer as JaxServer
    from med_tpu_torch.eval.serving import FrameModelServer

    cfg = ExperimentConfig(**{**COG_FIELDS, **fields})
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(2)
    tree = export_jax_params(exp.net)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(70, 2048)).astype(np.float32)
    kin = rng.normal(size=(70, 26)).astype(np.float32)
    preds, probs = FrameModelServer(cfg, tree, device="cpu").predict_trial(images, kin)
    jpreds, jprobs = JaxServer(JaxConfig(**{**COG_FIELDS, **fields}, use_pallas=False),
                               tree).predict_trial(images, kin)
    want_shape = (70,) if fields["out_features"] == 2 else (70, 6)
    assert probs.shape == np.asarray(jprobs).shape == want_shape
    np.testing.assert_allclose(probs, np.asarray(jprobs), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(preds, np.asarray(jpreds))
