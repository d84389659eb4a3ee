"""Trial groups (``trial_batch`` = G > 1) in the port against the JAX
package's ``Experiment(trial_batch=G)``: one group train step (loss, the
summed confusion matrix, every gradient), the eval step, a short group's
zero-weight repeat, the group's single attention call with G x 8 heads, and
a whole fold whose train and test trials leave short groups.

Both sides take the port's weights and numpy-seeded dropout masks, each
trial its own: the port through ``masks=`` (the group on the masks' batch
axis), med_tpu through ``flax.linen.intercept_methods``, reading each
trial's masks from its slice of the vmapped batch. med_tpu runs its plain
XLA paths (``use_pallas=False``). Its gradients are read from Adam's first
moment after one step (0.1 g with no weight decay). Tolerance: rtol 1e-4,
atol 1e-5 of each tensor's largest |value|, unless a test says otherwise.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data.datasets import FrameTrial as JaxTrial
from med_tpu.models.cog import COGStage as JaxCOGStage
from med_tpu.models.layers import ResidualStack as JaxResidualStack
from med_tpu.train import loop as jloop
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.models import cog as tcog
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.utils.jax_params import export_jax_params

FIELDS = dict(model_name="COG", dataset_type="frame", data_type="kinematics",
              out_features=2, num_layers_Basic=3, num_layers_R=2, num_R=2,
              mstcn_f_maps=16, d_model=16, d_q=2, sequence_length=5, lr=1e-3,
              weight_decay=0.0, lr_scheduler=False, seed=0, trial_batch=2)
BUCKET = 64


def _close(got, want, name="", rtol=1e-4):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _fields(rng, T, name):
    lab = np.repeat(rng.integers(0, 2, T // 8 + 1), 8)[:T]
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = lab
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    kin[:, :5] += lab[:, None] * 2.0
    return dict(name=name, images=np.zeros((T, 2048), np.float32), kinematics=kin,
                g_labels=rng.integers(1, 9, T), e_powerset=e, skill=skill_one_hot(name, T))


def _stage_shapes(cfg, T):
    shapes = {"TCN": (cfg.num_layers_Basic, T, True),
              "fast_stage1": (cfg.num_layers_Basic, T // 16, True)}
    for r in range(cfg.num_R):
        shapes[f"R{r}"] = (cfg.num_layers_R, T, False)
        shapes[f"fast_R{r}"] = (cfg.num_layers_R, T // 16, False)
    return shapes


def _group_masks(rng, cfg, T, G):
    """Each trial's own masks, in the port's layout with the group on the
    batch axis: {"stack": (L, G, T, C), "channel": (G, 1, C)}."""
    C = cfg.mstcn_f_maps
    out = {}
    for name, (L, t, channel) in _stage_shapes(cfg, T).items():
        out[name] = {"stack": rng.integers(0, 2, size=(L, G, t, C)).astype(np.uint8)}
        if channel:
            out[name]["channel"] = rng.integers(0, 2, size=(G, 1, C)).astype(np.float32)
    return out


def _mask_keys(masks):
    """The same masks as batch keys with the group leading, so that med_tpu's
    vmap hands each trial its slice: per trial (L, 1, T, C) and (1, 1, C)."""
    keys = {}
    for name, d in masks.items():
        keys[f"drop/{name}/stack"] = np.moveaxis(d["stack"], 1, 0)[:, :, None]
        if "channel" in d:
            keys[f"drop/{name}/channel"] = d["channel"][:, None]
    return keys


def _jax_experiment(tree, constant_masks=None, fields=FIELDS):
    """med_tpu's Experiment(trial_batch=2) on the port's weights. Its dropout
    comes from the per-trial batch keys of :func:`_mask_keys`, or, given
    ``constant_masks`` (B = 1 layout), the same masks for every trial."""
    jexp = JaxExperiment(JaxConfig(**fields, use_pallas=False))
    plain_init = jexp.init_state
    seen = {}
    assemble = jexp._assemble

    def capture(params, batch, train=False, rng=None):
        seen["batch"] = batch
        return assemble(params, batch, train, rng)

    jexp._assemble = capture

    def mask_of(stage, kind):
        if constant_masks is not None:
            return jnp.asarray(constant_masks[stage][kind])
        return seen["batch"][f"drop/{stage}/{kind}"]

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JaxResidualStack) and context.method_name == "dropout_mask":
            return mask_of(mod.path[-2], "stack")
        if (isinstance(mod, JaxCOGStage) and context.method_name == "pre"
                and mod.channel_dropout and args[1]):
            return next_fun(args[0], False) * mask_of(mod.path[-1], "channel") * 2.0
        return next_fun(*args, **kwargs)

    def state_for(sample):
        state = plain_init(jax.random.key(0), sample)
        params = jax.tree.map(jnp.asarray, tree["params"])
        state = state.replace(params=params, opt_state=jexp.tx.init(params))
        if "constants" in tree:
            state = state.replace(constants={"model": jax.tree.map(
                jnp.asarray, tree["constants"]["model"])})
        return state

    return jexp, lambda: nn.intercept_methods(intercept), state_for


def _group(batches, weights):
    out = {k: np.stack([b[k] for b in batches]) for k in batches[0] if not k.startswith("_")}
    out["trial_weight"] = np.asarray(weights, np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(13)
    cfg = ExperimentConfig(**FIELDS)
    trials = [FrameTrial(**_fields(rng, T, f"Needle_Passing_{c}001"))
              for T, c in ((40, "B"), (55, "C"), (33, "D"))]
    batches = [frame_batch(t, cfg, bucket=BUCKET) for t in trials]
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    tree = export_jax_params(exp.net)
    return cfg, batches, tree, _group_masks(rng, cfg, BUCKET, 2)


@pytest.mark.parametrize("short", [False, True])
def test_group_train_step_matches_jax(setup, short):
    """One train step on a full group (two trials) or a short one (a trial
    and its zero-weight repeat): loss, weighted cm, predictions, every
    gradient; then the eval step's loss and cm on the stepped weights."""
    cfg, batches, tree, masks = setup
    members, weights = ([batches[0], batches[1]], [1.0, 1.0]) if not short else \
        ([batches[2], batches[2]], [1.0, 0.0])
    group = _group(members, weights)
    exp = Experiment(cfg, device="cpu")
    exp.load_params(tree)
    m = exp.train_step(group, masks={n: {k: torch.from_numpy(v) for k, v in d.items()}
                                     for n, d in masks.items()})

    jexp, intercept, state_for = _jax_experiment(tree)
    state = state_for({k: v[0] for k, v in group.items() if k != "trial_weight"})
    with intercept():
        state, jm = jexp.train_step(state, {**group, **_mask_keys(masks)})
    _close(m["loss"], jm["loss"], "loss", rtol=1e-5)
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(jm["cm"]))
    assert int(m["cm"].sum()) == sum(int(b["true_len"]) * w for b, w in zip(members, weights))
    np.testing.assert_array_equal(m["preds"].numpy(), np.asarray(jm["preds"]))
    _close(m["probs"], jm["probs"], "probs")
    got = _leaves(export_jax_params(exp.net, grads=True)["params"])
    want = _leaves(jax.device_get(state.opt_state[1].mu))
    assert set(got) == set(want) and len(want) > 40
    for path, w in want.items():
        _close(got[path], w / 0.1, path)

    with intercept():
        jev = jexp.eval_step(state, {**group, **_mask_keys(masks)})
    ev = exp.eval_step(group)
    _close(ev["loss"], jev["loss"], "eval loss")
    np.testing.assert_array_equal(ev["cm"].numpy(), np.asarray(jev["cm"]))


def test_a_short_group_is_its_one_trial(setup):
    """The zero-weight repeat adds nothing: a short group's loss, cm and
    gradients are its one trial's, run alone (trial_batch = 1) on the same
    masks (rtol 1e-5)."""
    cfg, batches, tree, masks = setup
    group = _group([batches[2], batches[2]], [1.0, 0.0])
    exp = Experiment(cfg, device="cpu")
    exp.load_params(tree)
    loss, m = exp.compute_gradients(group, masks={
        n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in masks.items()})
    grads = _leaves(export_jax_params(exp.net, grads=True)["params"])
    one = Experiment(cfg.replace(trial_batch=1), device="cpu")
    one.load_params(tree)
    loss1, m1 = one.compute_gradients(batches[2], masks={
        n: {k: torch.from_numpy(v[:, :1] if k == "stack" else v[:1]) for k, v in d.items()}
        for n, d in masks.items()})
    np.testing.assert_allclose(loss.item(), loss1.item(), rtol=1e-5)
    np.testing.assert_array_equal(m["cm"].numpy(), m1["cm"].numpy())
    for path, w in _leaves(export_jax_params(one.net, grads=True)["params"]).items():
        _close(grads[path], w, path, rtol=1e-5)


def test_a_group_runs_one_attention_call_with_its_trials_as_heads(setup, monkeypatch):
    """COG folds the group into the attention's head axis: one call a layer
    with G x 8 heads, as med_tpu's batching rule of the op does."""
    cfg, batches, tree, _ = setup
    calls = []
    plain = tcog.sliding_window_attention_packed

    def counted(q, k, v, window, m):
        calls.append((q.shape[0], k.shape[0], m))
        return plain(q, k, v, window, m)

    monkeypatch.setattr(tcog, "sliding_window_attention_packed", counted)
    exp = Experiment(cfg, device="cpu")
    exp.load_params(tree)
    exp.eval_step(_group(batches[:2], [1.0, 1.0]))
    assert calls == [(16, 16, 15), (16, 16, 15)]


def test_group_fold_matches_jax():
    """A whole fold with trial_batch = 2: 3 train trials (a short group each
    epoch) and 3 test trials (a short eval group), the same masks for every
    trial on both sides: every row's losses (rtol 1e-4) and F1, accuracy and
    Jaccard (exactly), the best epoch and its predictions."""
    rng = np.random.default_rng(17)
    fields = [_fields(rng, T, f"Needle_Passing_{c}001")
              for T, c in ((40, "B"), (50, "C"), (30, "D"), (45, "E"), (60, "F"), (35, "G"))]
    port = [FrameTrial(**f) for f in fields]
    jax_trials = [JaxTrial(**f) for f in fields]
    cfg = ExperimentConfig(**{**FIELDS, "n_epochs": 2, "lr": 3e-3})
    bucket = tloop._common_bucket(cfg, port)
    masks = _group_masks(rng, cfg, bucket, 1)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed)
    tree = export_jax_params(exp.net)
    exp.net.model.dropout_masks = lambda T, generator, B=1: {
        n: {k: torch.from_numpy(np.repeat(v, B, axis=1 if k == "stack" else 0))
            for k, v in d.items()} for n, d in masks.items()}
    res = tloop.train_frame_fold(cfg, port[:3], port[3:], exp=exp)

    jexp, intercept, state_for = _jax_experiment(tree, constant_masks=masks)
    jexp.init_state = lambda rng_key, sample, frozen=None, class_counts=None: state_for(sample)
    with intercept():
        jres = jloop.train_frame_fold(JaxConfig(**{**FIELDS, "n_epochs": 2, "lr": 3e-3,
                                                   "use_pallas": False}),
                                      jax_trials[:3], jax_trials[3:], exp=jexp)
    for row, jrow in zip(res["history"], jres["history"], strict=True):
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4, err_msg=k)
        for k in ("train_f1", "train_acc", "train_jaccard", "test_f1", "test_f1_weighted",
                  "test_acc", "test_jaccard"):
            assert row[k] == jrow[k], k
    assert res["best"]["epoch"] == jres["best"]["epoch"]
    np.testing.assert_array_equal(res["best"]["preds"], jres["best"]["preds"])
    np.testing.assert_allclose(res["best"]["probs"], jres["best"]["probs"], rtol=1e-4,
                               atol=1e-5)


def test_tecno_group_step_matches_jax(setup):
    """TeCNo in groups: each trial's stacks one kernel call (here the plain
    version) with its own masks; loss, cm and gradients as med_tpu's."""
    _, batches, _, _ = setup
    fields = dict(FIELDS, model_name="TeCNo", mstcn_stages=2, mstcn_layers=3)
    cfg = ExperimentConfig(**fields)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(5)
    tree = export_jax_params(exp.net)
    rng = np.random.default_rng(19)
    masks = {f"stage{s}": {"stack": rng.integers(0, 2, size=(3, 2, BUCKET, 16)).astype(np.uint8)}
             for s in range(2)}
    group = _group(batches[:2], [1.0, 1.0])
    m = exp.train_step(group, masks={n: {k: torch.from_numpy(v) for k, v in d.items()}
                                     for n, d in masks.items()})
    jexp, intercept, state_for = _jax_experiment(tree, fields=fields)
    state = state_for({k: v[0] for k, v in group.items() if k != "trial_weight"})
    with intercept():
        state, jm = jexp.train_step(state, {**group, **_mask_keys(masks)})
    _close(m["loss"], jm["loss"], "loss", rtol=1e-5)
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(jm["cm"]))
    got = _leaves(export_jax_params(exp.net, grads=True)["params"])
    for path, w in _leaves(jax.device_get(state.opt_state[1].mu)).items():
        _close(got[path], w / 0.1, path)
