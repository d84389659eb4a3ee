"""The port's COG training path (med_tpu_torch.train) against the JAX
package's: losses, metrics, the optimiser, one whole train step with the
same dropout masks on both sides, the epoch loop, and the device rules.

The JAX COG runs with fused=True (its TCN Pallas kernels in interpret
mode). Both sides take the same numpy-seeded dropout masks: the port
through ``masks=``, the JAX package through ``flax.linen.intercept_methods``
(nothing in med_tpu changes). Tolerance: rtol 1e-4 and atol 1e-5 *
max|want| per tensor, unless a test says otherwise.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.models.cog import COG as JaxCOG
from med_tpu.models.cog import COGStage as JaxCOGStage
from med_tpu.models.layers import ResidualStack as JaxResidualStack
from med_tpu.ops import metrics as jmetrics
from med_tpu.train import checkpoint as jckpt
from med_tpu.train import losses as jlosses
from med_tpu.train import optim as joptim
from med_tpu.train.engine import _loss_for_family
from med_tpu_torch import ops
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.eval.serving import FrameModelServer
from med_tpu_torch.ops import metrics as tmetrics
from med_tpu_torch.train import checkpoint as tckpt
from med_tpu_torch.train import losses as tlosses
from med_tpu_torch.train import optim as toptim
from med_tpu_torch.train.engine import Experiment, cog_loss
from med_tpu_torch.train.loop import train_frame_fold
from med_tpu_torch.utils.jax_params import export_jax_params

RTOL = 1e-4


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("true_len,t_track", [(40, 64), (37, 4), (64, 64), (1, 4), (250, 16)])
def test_cog_track_loss_matches_jax_on_ragged_lengths(rng, true_len, t_track):
    t_pad = 256 if true_len > 64 else 64
    logits = rng.normal(size=(1, t_track, 2)).astype(np.float32)
    labels = rng.integers(0, 2, t_pad)
    tl = np.asarray(true_len, np.int32)
    want = jlosses.cog_track_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(tl), 0.15)
    got = tlosses.cog_track_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(tl))
    for g, w in zip(got, want):
        _close(g, w)
    idx_want = jlosses.nearest_resample_dynamic(jnp.arange(t_pad), jnp.asarray(tl), t_track)
    idx_got = tlosses.nearest_resample_dynamic(torch.arange(t_pad), torch.from_numpy(tl),
                                               t_track)
    np.testing.assert_array_equal(idx_got.numpy(), np.asarray(idx_want))


def test_cross_entropy_and_smooth_loss_match_jax(rng):
    logits = rng.normal(size=(30, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 30)
    mask = (rng.random(30) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tlosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                    None if m is None else torch.from_numpy(m))
        _close(got, want)
    pair = mask[1:] * mask[:-1]
    for pm in (None, pair):
        _close(tlosses.smooth_loss(torch.from_numpy(logits),
                                   None if pm is None else torch.from_numpy(pm)),
               jlosses.smooth_loss(jnp.asarray(logits), None if pm is None else jnp.asarray(pm)))


@pytest.mark.parametrize("error_type,n_classes", [("global", 2), ("all_errors", 6)])
def test_cog_loss_matches_jax_loss_for_family(rng, error_type, n_classes):
    """The COG branch of _loss_for_family on the same 8 tracks: loss, cm and
    (all_errors) cm_binary."""
    Tpad, true_len = 64, 45
    tracks = [rng.normal(size=(1, t, n_classes)).astype(np.float32)
              for t in [Tpad] * 4 + [Tpad // 16] * 4]
    labels = rng.integers(0, n_classes, Tpad)
    mask = (np.arange(Tpad) < true_len).astype(np.float32)
    batch = {"labels": labels, "mask": mask, "true_len": np.asarray(true_len, np.int32)}
    fields = dict(model_name="COG", dataset_type="frame", error_type=error_type,
                  out_features=n_classes)
    want_loss, want = _loss_for_family(JaxConfig(**fields), "cog",
                                       ([jnp.asarray(t) for t in tracks], None),
                                       {k: jnp.asarray(v) for k, v in batch.items()}, {})
    got_loss, got = cog_loss(ExperimentConfig(**fields), [torch.from_numpy(t) for t in tracks],
                             {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    _close(got_loss, want_loss)
    keys = {"cm", "cm_binary"} & set(want)
    assert keys == ({"cm", "cm_binary"} if error_type == "all_errors" else {"cm"})
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _close(got["probs"], want["probs"])


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("n_classes,average", [(2, "binary"), (6, "macro"), (6, "weighted")])
def test_confusion_matrix_and_metrics_match_jax(rng, n_classes, average):
    labels = rng.integers(0, n_classes, 200)
    preds = rng.integers(0, n_classes, 200)
    mask = (rng.random(200) > 0.2).astype(np.float32)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds),
                                                n_classes, jnp.asarray(mask)))
    got = tmetrics.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds),
                                    n_classes, torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tmetrics.metrics_from_cm(want, average) == jmetrics.metrics_from_cm(want, average)
    assert tmetrics.f1_from_cm(want, average) == jmetrics.f1_from_cm(want, average)
    np.testing.assert_allclose(
        float(tmetrics.f1_from_cm_device(got, average)),
        float(jmetrics.f1_from_cm_device(jnp.asarray(want), average)), rtol=1e-6)


# --------------------------------------------------------------- optimiser
def test_adam_step_with_l2_and_cosine_lr_matches_optax(rng):
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    cfg = dict(lr=1e-3, weight_decay=5e-3, lr_scheduler=True, n_epochs=7)
    jcfg = JaxConfig(**cfg)
    tx = joptim.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = toptim.make_optimizer(ExperimentConfig(**cfg), tp)
    for epoch, g in enumerate(grads):
        lr = joptim.epoch_lr(jcfg, epoch + 2)
        assert toptim.epoch_lr(ExperimentConfig(**cfg), epoch + 2) == lr
        state = joptim.set_lr(state, lr)
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        toptim.set_lr(opt, lr)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# -------------------------------------------------------- one train step
SMALL = dict(model_name="COG", dataset_type="frame", data_type="multimodal",
             video_dims=2048, out_features=2, num_layers_Basic=3, num_layers_R=2,
             num_R=2, mstcn_f_maps=16, d_model=16, d_q=2, sequence_length=5,
             lr=1e-3, weight_decay=5e-3, lr_scheduler=False, seed=0)


def _trial(rng, T, name="Needle_Passing_C002", learnable=False):
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = np.repeat(rng.integers(0, 2, T // 8 + 1), 8)[:T]
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    if learnable:
        kin[:, :5] += e[:, -1:] * 2.0
    return FrameTrial(name=name, images=rng.normal(size=(T, 2048)).astype(np.float32),
                      kinematics=kin, g_labels=rng.integers(0, 15, T),
                      e_powerset=e, skill=skill_one_hot(name, T))


def _masks(rng, cfg, T):
    """Numpy-seeded dropout masks for every stage, in COG.dropout_masks'
    layout (as numpy arrays)."""
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


def _jax_train_step(jcfg, tree, batch, masks):
    """med_tpu's COG train step on the same params, batch and masks:
    value_and_grad of its loss, then its optax chain."""
    model = JaxCOG(num_layers_basic=jcfg.num_layers_Basic, num_layers_r=jcfg.num_layers_R,
                   num_r=jcfg.num_R, f_maps=jcfg.mstcn_f_maps, f_dim=jcfg.in_features(),
                   out_classes=jcfg.out_features, d_model=jcfg.d_model, d_q=jcfg.d_q,
                   len_q=jcfg.sequence_length, fused=True)

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JaxResidualStack) and context.method_name == "dropout_mask":
            return jnp.asarray(masks[mod.path[-2]]["stack"])
        if (isinstance(mod, JaxCOGStage) and context.method_name == "pre"
                and mod.channel_dropout and args[1]):
            keep = jnp.asarray(masks[mod.path[-1]]["channel"])
            return next_fun(args[0], False) * keep * 2.0
        return next_fun(*args, **kwargs)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("_")}
    x = jnp.concatenate([jbatch["images"], jbatch["kinematics"]], axis=-1)
    consts = tree["constants"]["model"]

    def loss_fn(params):
        with nn.intercept_methods(interceptor):
            out = model.apply({"params": params["model"], "constants": consts}, x,
                              train=True, rngs={"dropout": jax.random.key(0)})
        return _loss_for_family(jcfg, "cog", out, jbatch, {})

    params = jax.tree.map(jnp.asarray, tree["params"])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = joptim.make_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(params), params)
    return loss, metrics, grads, optax.apply_updates(params, updates)


def test_cog_train_step_matches_jax_with_injected_masks(rng):
    cfg = ExperimentConfig(**SMALL)
    jcfg = JaxConfig(**SMALL)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    tree = export_jax_params(exp.net)
    batch = frame_batch(_trial(rng, 40), cfg, bucket=64)
    masks = _masks(rng, cfg, 64)
    want_loss, want_m, want_grads, want_params = _jax_train_step(jcfg, tree, batch, masks)

    port_masks = {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in masks.items()}
    m = exp.train_step(batch, masks=port_masks)
    _close(m["loss"], want_loss, "loss")
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(want_m["cm"]))
    got_grads = _leaves(export_jax_params(exp.net, grads=True)["params"])
    want_g = _leaves(jax.device_get(want_grads))
    assert set(got_grads) == set(want_g) and len(want_g) > 40
    # atol is 1e-5 of the largest gradient of the whole tree, not of each
    # leaf: the FPN lateral bias's gradient (~6e-5) is a small difference of
    # large sums, and float32 moves it by ~1e-4 of its own size
    gmax = max(float(np.abs(w).max()) for w in want_g.values())
    for path, w in want_g.items():
        np.testing.assert_allclose(got_grads[path], w, rtol=RTOL, atol=1e-5 * gmax,
                                   err_msg=path)
    # the pad rows of the visual sequence are enc_norm's bias: its gradient
    # comes from them alone at the first frames, and it is not zero
    assert np.abs(got_grads["model/cot/enc_norm/bias"]).max() > 0
    # one Adam step moves a parameter by lr * g / (|g| + 1e-8): where |g| is
    # near 1e-8, a 1e-9 difference in g shifts that by ~1e-3 lr, so the
    # updated parameters are compared at 1e-2 of a step
    got_p = _leaves(export_jax_params(exp.net)["params"])
    for path, w in _leaves(jax.device_get(want_params)).items():
        np.testing.assert_allclose(got_p[path], w, rtol=0, atol=1e-2 * cfg.lr,
                                   err_msg=path)


def test_training_forward_draws_masks_from_the_generator(rng):
    cfg = ExperimentConfig(**SMALL)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    net = exp.net.model
    a = net.dropout_masks(64, torch.Generator().manual_seed(1))
    b = net.dropout_masks(64, torch.Generator().manual_seed(1))
    assert set(a) == {"TCN", "R0", "R1", "fast_stage1", "fast_R0", "fast_R1"}
    assert set(a["TCN"]) == {"channel", "stack"} and set(a["R0"]) == {"stack"}
    assert a["TCN"]["stack"].shape == (3, 1, 64, 16) and a["TCN"]["stack"].dtype == torch.uint8
    assert a["fast_R1"]["stack"].shape == (2, 1, 4, 16)
    assert a["TCN"]["channel"].shape == (1, 1, 16)
    for n in a:
        for k in a[n]:
            torch.testing.assert_close(a[n][k], b[n][k], rtol=0, atol=0)
    bits = torch.cat([a[n]["stack"].flatten() for n in a]).float()
    assert 0.4 < bits.mean().item() < 0.6
    batch = frame_batch(_trial(rng, 40), cfg, bucket=64)
    m1 = exp.train_step(batch)
    assert np.isfinite(m1["loss"].item())
    with pytest.raises(ValueError, match="masks or a generator"):
        net(torch.zeros(1, 64, cfg.in_features()), train=True)


def test_eval_step_returns_loss_and_cm_with_labels(rng):
    cfg = ExperimentConfig(**SMALL)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    batch = frame_batch(_trial(rng, 40), cfg, bucket=64)
    m = exp.eval_step(batch)
    assert set(m) == {"loss", "cm", "preds", "probs"}
    assert int(m["cm"].sum()) == 40 and np.isfinite(float(m["loss"]))
    served = exp.eval_step({k: batch[k] for k in ("images", "kinematics")})
    assert set(served) == {"preds", "probs"}
    torch.testing.assert_close(served["probs"], m["probs"], rtol=0, atol=0)


# ----------------------------------------------------------------- loop
def test_train_frame_fold_learns_and_checkpoints(rng, tmp_path):
    cfg = ExperimentConfig(**{**SMALL, "n_epochs": 2, "lr": 3e-3, "weight_decay": 0.0,
                              "d_model": 8, "d_q": 1, "sequence_length": 4})
    names = ["Needle_Passing_B001", "Needle_Passing_C002", "Needle_Passing_D003"]
    trials = [_trial(rng, T, n, learnable=True) for T, n in zip((60, 50, 70), names)]
    res = train_frame_fold(cfg, trials, trials[:1], device="cpu")
    hist = res["history"]
    assert [r["epoch"] for r in hist] == [0, 1]
    assert set(hist[0]) == {
        "epoch", "train_loss", "train_f1", "train_f1_weighted", "train_acc",
        "train_jaccard", "train_time", "test_loss", "test_f1", "test_f1_weighted",
        "test_acc", "test_jaccard", "test_inference_ms_per_frame"}
    assert all(np.isfinite(r["train_loss"]) for r in hist)
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    best = res["best"]
    want_epoch = 1 if hist[1]["test_f1_weighted"] > hist[0]["test_f1_weighted"] else 0
    assert best["epoch"] == want_epoch
    assert best["preds"].shape == best["labels"].shape == (60,)

    ckpt = res["checkpoint"]
    tckpt.save_checkpoint(str(tmp_path / "best_model_COG_1Out.npz"), ckpt["params"],
                          constants=ckpt["constants"])
    jtree = jckpt.load_best_checkpoint(str(tmp_path), "COG", "1Out")
    assert set(jtree) == {"params", "constants"}
    jleaves = _leaves(jtree["params"])
    assert set(jleaves) == set(_leaves(ckpt["params"]))
    server = FrameModelServer(cfg, tckpt.load_best_checkpoint(str(tmp_path), "COG", "1Out"),
                              device="cpu")
    preds, probs = server.predict_trial(trials[0].images, trials[0].kinematics)
    assert preds.shape == (60,) and np.isfinite(probs).all()


# ---------------------------------------------------------- device rules
def test_training_entry_points_need_cuda_unless_asked_for_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = ExperimentConfig(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        Experiment(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_frame_fold(cfg, [_trial(rng, 20)], [_trial(rng, 20)])


@pytest.mark.parametrize("option, roadmap", [({"trial_batch": 2}, "A6")])
def test_unported_training_options_raise(option, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        ExperimentConfig(**{**SMALL, **option})


def test_pos_weight_changes_nothing_on_the_frame_path_as_in_jax(rng):
    """med_tpu's frame driver never hands the loss its class counts, so with
    pos_weight=True it trains the unweighted loss; the port takes the flag
    and gives the same numbers: the JAX step with pos_weight=True, and its
    own step with pos_weight=False bit for bit."""
    cfg = ExperimentConfig(**{**SMALL, "pos_weight": True})
    jcfg = JaxConfig(**{**SMALL, "pos_weight": True})
    batch = frame_batch(_trial(rng, 40), cfg, bucket=64)
    masks = _masks(rng, cfg, 64)
    port_masks = {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in masks.items()}
    results = []
    for c in (cfg, cfg.replace(pos_weight=False)):
        exp = Experiment(c, device="cpu")
        exp.init_weights(3)
        tree = export_jax_params(exp.net)
        m = exp.train_step(batch, masks=port_masks)
        results.append((m["loss"], _leaves(export_jax_params(exp.net)["params"])))
    want_loss, want_m, _, want_params = _jax_train_step(jcfg, tree, batch, masks)
    (loss, params), (loss_off, params_off) = results
    _close(loss, want_loss, "loss")
    for path, w in _leaves(jax.device_get(want_params)).items():
        np.testing.assert_allclose(params[path], w, rtol=0, atol=1e-2 * cfg.lr, err_msg=path)
    assert loss.item() == loss_off.item()
    for path, w in params_off.items():
        np.testing.assert_array_equal(params[path], w, err_msg=path)


def test_cpu_training_launches_no_kernel(rng):
    ops.reset_launch_counts()
    exp = Experiment(ExperimentConfig(**SMALL), device="cpu")
    exp.init_weights(3)
    exp.train_step(frame_batch(_trial(rng, 40), exp.cfg, bucket=64))
    assert all(n == 0 for n in ops.launch_counts().values())


def test_port_config_takes_the_jax_training_defaults():
    jcfg = JaxConfig()
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(ExperimentConfig(), f.name) == getattr(jcfg, f.name), f.name
