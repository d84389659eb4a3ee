"""Data and tensor parallelism in the port (med_tpu_torch/parallel/mesh.py
and the engine's steps), on spawned gloo ranks, against the port on one
rank and against med_tpu's sharded steps on its 8-device CPU mesh, with the
same weights, batch and injected dropout masks:

- the window step on meshes (2, 1), (1, 2) and (2, 2): loss, confusion
  matrix, predictions, every gradient (the FeatureExtractor's split leaves
  gathered), BatchNorm's running statistics (taken over the global padded
  batch), then the eval step (med_tpu's tests/test_parallel.py::
  test_dp_tp_sharded_step_matches_single_device);
- the FeatureExtractor's placement by path (::test_tp_placement_is_path_driven);
- the trial-parallel COG step, a short last group included (its zero-weight
  repeat on another rank: the loss is the global weighted mean, not a mean
  of the ranks' means; ::test_trial_parallel_sharded_over_mesh).

Gradients are held to 1e-5 of each leaf's largest |value| (med_tpu's read
from Adam's first moment, 0.1 g with no weight decay); losses to rtol 1e-5.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_groups import FIELDS as GROUP_FIELDS
from test_torch_groups import _fields as group_trial_fields
from test_torch_groups import _group, _group_masks, _jax_experiment, _mask_keys
from test_torch_window import config_fields, fold_fields, jax_experiment, leaves

from med_tpu.parallel import shard_batch as jax_shard_batch
from med_tpu.parallel import shard_state as jax_shard_state
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, WindowFold, frame_batch, window_batches
from med_tpu_torch.models import build_feature_extractor
from med_tpu_torch.parallel import launch
from med_tpu_torch.parallel.mesh import auto_shape, tp_placement
from med_tpu_torch.train.engine import Experiment, FrameNet
from med_tpu_torch.utils.jax_params import export_jax_params
from torch_rank_bodies import mesh_suite

B = 16


def _close(got, want, name, frac=1e-5, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


def _jax_mesh(shape):
    n = shape[0] * shape[1]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"))


# ----------------------------------------------------------------- window
@pytest.fixture(scope="module")
def window():
    rng = np.random.default_rng(5)
    fields = config_fields("SimpleCNN", batch_size=B, video_dims=8)
    cfg = ExperimentConfig(**fields)
    fold = WindowFold(**fold_fields(rng, B - 3, cfg.window_size))
    batch = next(window_batches(fold, cfg, shuffle=False))
    batch = {k: v for k, v in batch.items() if not k.startswith("_")}
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    tree = export_jax_params(exp.net)
    masks = [m.numpy() for m in exp.net.model.dropout_masks(B, torch.Generator().manual_seed(2))]
    one = exp.train_step(batch, masks=[torch.from_numpy(m) for m in masks])
    single = {"loss": float(one["loss"]), "cm": one["cm"].numpy(),
              "grads": {k: p.grad.numpy().copy() for k, p in exp.net.named_parameters()},
              "stats": {k: v.numpy().copy() for k, v in exp.net.state_dict().items()
                        if "running" in k}}
    ev = exp.eval_step(batch)
    single.update(eval_loss=float(ev["loss"]), eval_preds=ev["preds"].numpy())
    return fields, tree, batch, masks, single


SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


@pytest.fixture(scope="module")
def ranks(window, trial_dp, tmp_path_factory):
    """Each world size's group runs the window steps on its mesh shapes and
    the trial-DP steps on (n, 1): {n: (window results by shape, trial-DP
    results a rank)}."""
    fields, tree, batch, masks, _ = window
    tfields, ttree, groups, tmasks, _, _ = trial_dp
    out = {}
    for n, shapes in SHAPES.items():
        res = launch.spawn(mesh_suite, n, str(tmp_path_factory.mktemp(f"mesh{n}")),
                           args=((fields, tree, batch, masks, shapes),
                                 (tfields, ttree, groups, tmasks, (n, 1))), device="cpu")
        out[n] = ({shape: [r[0][k] for r in res] for k, shape in enumerate(shapes)},
                  [r[1] for r in res])
    return out


@pytest.fixture(scope="module")
def window_ranks(ranks):
    return {shape: v for n in ranks for shape, v in ranks[n][0].items()}


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_dp_tp_window_step_matches_one_rank(window, window_ranks, shape):
    *_, single = window
    for r in window_ranks[shape]:
        assert r["tp"] == ([] if shape[1] == 1 else
                           ["fe.dense0.bias", "fe.dense0.weight", "fe.dense1.weight"])
        _close(r["loss"], single["loss"], "loss")
        np.testing.assert_array_equal(r["cm"], single["cm"])
        for k, g in single["grads"].items():
            _close(r["grads"][k], g, k)
        for k, v in single["stats"].items():
            np.testing.assert_allclose(r["stats"][k], v, rtol=0, atol=1e-6, err_msg=k)
        _close(r["eval_loss"], single["eval_loss"], "eval loss")
        np.testing.assert_array_equal(r["eval_preds"], single["eval_preds"])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_dp_tp_window_step_matches_med_tpu_sharded_step(window, window_ranks, shape):
    fields, tree, batch, masks, _ = window
    jexp, intercept, state_for = jax_experiment(fields, tree, masks)
    mesh = _jax_mesh(shape)
    state = jax_shard_state(state_for(batch), mesh)
    with intercept():
        state, jm = jexp.train_step(state, jax_shard_batch(batch, mesh))
    r = window_ranks[shape][0]
    _close(r["loss"], jm["loss"], "loss")
    np.testing.assert_array_equal(r["cm"], np.asarray(jm["cm"]))
    np.testing.assert_array_equal(r["preds"], np.asarray(jm["preds"]))
    want = {k: v / 0.1 for k, v in leaves(jax.device_get(state.opt_state[1].mu)).items()}
    got = leaves(export_jax_params(_net_with_grads(fields, r["grads"]), grads=True)["params"])
    assert set(got) == set(want)
    for path, w in want.items():
        _close(got[path], w, path, frac=2e-5, rtol=1e-4)
    stats = leaves(jax.device_get(state.batch_stats))
    for path, w in leaves(export_jax_params(_net_with_stats(fields, tree, r["stats"]))
                          ["batch_stats"]).items():
        np.testing.assert_allclose(w, stats[path], rtol=0, atol=1e-6, err_msg=path)


def _net_with_grads(fields, grads):
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    for k, p in exp.net.named_parameters():
        p.grad = torch.from_numpy(grads[k])
    return exp.net


def _net_with_stats(fields, tree, stats):
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    with torch.no_grad():
        for k, v in stats.items():
            exp.net.get_buffer(k).copy_(torch.from_numpy(v))
    return exp.net


def test_tp_placement_is_path_driven():
    """The FeatureExtractor splits by parameter path at any width that
    divides the axis (a non-default video_dims too); a width that does not
    warns and stays replicated; no other parameter is ever split."""
    for video_dims in (8, 24):
        cfg = ExperimentConfig(model_name="SimpleCNN", video_dims=video_dims)
        net = FrameNet(torch.nn.Identity(), build_feature_extractor(cfg))
        assert tp_placement(net, 2) == {"fe.dense0.weight": 0, "fe.dense0.bias": 0,
                                        "fe.dense1.weight": 1}
        assert tp_placement(net, 1) == {}
    with pytest.warns(UserWarning, match="not divisible by model axis 3"):
        assert tp_placement(net, 3) == {}
    assert auto_shape(1) == (1, 1) and auto_shape(2) == (1, 2)
    assert auto_shape(8) == (4, 2) and auto_shape(3) == (3, 1)


# --------------------------------------------------------------- trial DP
@pytest.fixture(scope="module")
def trial_dp():
    """Two groups of four trials (the second short: two trials and two
    zero-weight repeats), their masks and the one-rank steps."""
    rng = np.random.default_rng(13)
    fields = {**GROUP_FIELDS, "trial_batch": 4, "num_R": 1, "num_layers_Basic": 2,
              "fused_epoch": False, "fused_run": False}
    cfg = ExperimentConfig(**fields)
    trials = [FrameTrial(**group_trial_fields(rng, T, f"Needle_Passing_{c}001"))
              for T, c in ((40, "B"), (55, "C"), (33, "D"), (60, "E"), (47, "F"))]
    batches = [frame_batch(t, cfg, bucket=64) for t in trials]
    groups = [_group(batches[:4], [1.0] * 4),
              _group([batches[4], batches[2], batches[4], batches[4]], [1.0, 1.0, 0.0, 0.0])]
    masks = [_group_masks(rng, cfg, 64, 4) for _ in groups]
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    tree = export_jax_params(exp.net)
    single = []
    for group, mk in zip(groups, masks):
        loss, m = exp.compute_gradients(group, masks={
            s: {k: torch.from_numpy(v) for k, v in d.items()} for s, d in mk.items()})
        single.append({"loss": float(loss), "cm": m["cm"].numpy(),
                       "grads": {k: p.grad.numpy().copy()
                                 for k, p in exp.net.named_parameters()}})
    return fields, tree, groups, masks, single, exp.eval_step(groups[0])


@pytest.mark.parametrize("n", [2, 4])
def test_trial_dp_cog_step_matches_one_rank(trial_dp, ranks, n):
    *_, single, ev = trial_dp
    for steps, evr in ranks[n][1]:
        for got, want in zip(steps, single):
            _close(got["loss"], want["loss"], "loss")
            np.testing.assert_array_equal(got["cm"], want["cm"])
            for k, g in want["grads"].items():
                _close(got["grads"][k], g, k)
        _close(evr["loss"], float(ev["loss"]), "eval loss")
        np.testing.assert_array_equal(evr["preds"], ev["preds"].numpy())
        np.testing.assert_array_equal(evr["cm"], ev["cm"].numpy())


def test_trial_dp_cog_step_matches_med_tpu_on_its_mesh(trial_dp, ranks):
    """med_tpu's trial-parallel step with the group over its 4-device data
    axis, from the same weights and masks: both groups (one compiled step)."""
    fields, tree, groups, masks, _, _ = trial_dp
    jfields = {k: v for k, v in fields.items() if k not in ("fused_epoch", "fused_run")}
    mesh = _jax_mesh((4, 1))
    jexp, intercept, state_for = _jax_experiment(tree, fields=jfields)
    for g, (group, mk) in enumerate(zip(groups, masks)):
        state = jax_shard_state(state_for({k: v[0] for k, v in group.items()
                                           if k != "trial_weight"}), mesh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jbatch = jax_shard_batch({**group, **_mask_keys(mk)}, mesh)
        with intercept():
            state, jm = jexp.train_step(state, jbatch)
        got = ranks[4][1][0][0][g]
        _close(got["loss"], jm["loss"], "loss")
        np.testing.assert_array_equal(got["cm"], np.asarray(jm["cm"]))
        want = leaves(jax.device_get(state.opt_state[1].mu))
        exp = Experiment(ExperimentConfig(**fields), device="cpu")
        for k, p in exp.net.named_parameters():
            p.grad = torch.from_numpy(got["grads"][k])
        mine = leaves(export_jax_params(exp.net, grads=True)["params"])
        for path, w in want.items():
            _close(mine[path], w / 0.1, path, rtol=1e-4)
