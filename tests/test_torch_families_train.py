"""One train step of the port's TeCNo and TransSVNet families
(med_tpu_torch.train.engine) against med_tpu's ``Experiment``, and their
fold loop, on the CPU at a small size.

Both sides start from the same weights (med_tpu's ``init_state``, carried
into the port) and take the same batch; TeCNo's dropout masks are drawn with
numpy and injected into JAX through ``flax.linen.intercept_methods`` (nothing
in med_tpu changes). med_tpu's jitted ``train_step`` gives the loss and the
updated parameters; ``jax.grad`` of its loss gives the gradients. For
TransSVNet the gradients are taken in float64 (its LayerNorms over 2
features keep ~2 digits of a float32 gradient, see models/transsvnet.py,
and the port takes them in float64) and the updated parameters are
med_tpu's optimiser step on those. Tolerances: loss and gradients rtol 1e-4 and atol 1e-5 of each
leaf's largest |value| (TransSVNet: of the tree's largest, see the test);
the updated parameters 1e-2 of a step (lr), as in tests/test_torch_train.py
(Adam divides by |g| + 1e-8).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_families import _mask_interceptor, _port_cfg

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu.train.engine import _loss_for_family
from med_tpu_torch import ops
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.train.loop import train_frame_fold
from med_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

RTOL = 1e-4
FIELDS = dict(dataset_type="frame", data_type="video", video_dims=2048, out_features=2,
              mstcn_stages=2, mstcn_layers=3, mstcn_f_maps=8, sequence_length=30,
              lr=1e-3, weight_decay=5e-3, lr_scheduler=False, seed=0)
T_PAD = 64
# TransSVNet's LNs drive every encoded key to +-r(1, -1), r within ~1e-5 of
# 1, so the decoder's scores over a window are nearly equal and the
# gradients of its W_Q and W_K are ~1e-17 of the tree's largest (float64):
# what a run gives there is its rounding of the keys, float64's too
NULL_LEAVES = ("dec_attn/W_Q/kernel", "dec_attn/W_K/kernel")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _trial(rng, T, name="Needle_Passing_C002", learnable=False):
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = np.repeat(rng.integers(0, 2, T // 8 + 1), 8)[:T]
    images = rng.normal(size=(T, 2048)).astype(np.float32)
    if learnable:
        images[:, :8] += e[:, -1:] * 2.0
    return FrameTrial(name=name, images=images,
                      kinematics=rng.normal(size=(T, 26)).astype(np.float32),
                      g_labels=rng.integers(0, 15, T), e_powerset=e,
                      skill=skill_one_hot(name, T))


def _jax_start(jcfg, batch, frozen):
    """med_tpu's Experiment and its initial state on ``batch``."""
    jexp = JaxExperiment(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("_")}
    sample = {**jbatch, "tecno_logits": jnp.zeros((1, T_PAD, 2))}
    return jexp, jbatch, jexp.init_state(jax.random.key(4), sample, frozen=frozen)


def _frozen_tree(seed=7):
    from test_torch_families import _jax_tecno_like
    return {"tecno_params": _jax_tecno_like(JaxConfig(model_name="TeCNo", **FIELDS))}


@pytest.mark.parametrize("model_name", ["TeCNo", "TransSVNet"])
def test_train_step_matches_jax_experiment(rng, model_name):
    family = {"TeCNo": "tecno", "TransSVNet": "tsvn"}[model_name]
    jcfg = JaxConfig(model_name=model_name, **FIELDS)
    cfg = _port_cfg(jcfg)
    batch = frame_batch(_trial(rng, 45), cfg, bucket=T_PAD)
    frozen = _frozen_tree() if family == "tsvn" else None
    jexp, jbatch, state = _jax_start(jcfg, batch, frozen)
    params = jax.device_get(state.params)
    masks = {f"stage{s}": {"stack": rng.integers(0, 2, size=(3, 1, T_PAD, 8))
                           .astype(np.uint8)} for s in range(2)}
    interceptor = _mask_interceptor(masks)

    with nn.intercept_methods(interceptor):      # traced inside: the masks stick
        new_state, want_m = jexp.train_step(state, jbatch)
    want_params = _leaves(jax.device_get(new_state.params))

    def loss_fn(p, x64=False):
        dt = jnp.float64 if x64 else jnp.float32
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), p)
        x = jnp.asarray(batch["images"], dt)
        with nn.intercept_methods(interceptor):
            if family == "tsvn":
                tecno = jexp.frozen_tecno.apply(
                    {"params": jax.tree.map(lambda a: jnp.asarray(a, dt),
                                            frozen["tecno_params"])}, x)
                out = jexp.model.apply({"params": p["model"]}, tecno[-1].astype(dt), x)
            else:
                out = jexp.model.apply({"params": p["model"]}, x, train=True,
                                       rngs={"dropout": jax.random.key(0)})
        return _loss_for_family(jcfg, family, out, jbatch, {})[0]

    if family == "tsvn":
        with jax.enable_x64(True):
            grads = jax.device_get(jax.grad(lambda p: loss_fn(p, True))(params))
        # the updated parameters from med_tpu's optimiser on these gradients:
        # its float32 step carries its float32 gradients' ~1% noise, which
        # moves a parameter whose gradient sums terms of both signs to near
        # 0 by a large part of a step
        grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
        updates, _ = jexp.tx.update(grads, jexp.tx.init(params), params)
        want_params = _leaves(jax.device_get(optax.apply_updates(params, updates)))
    else:
        grads = jax.device_get(jax.grad(loss_fn)(params))
    want_g = _leaves(grads)

    exp = Experiment(cfg, device="cpu")
    st, _ = load_jax_params({"params": params}, exp.net)
    exp.net.load_state_dict(st, strict=True)
    if frozen is not None:
        exp.load_frozen(frozen)
    port_masks = {n: {"stack": torch.from_numpy(m["stack"])} for n, m in masks.items()}
    m = exp.train_step(batch, masks=port_masks)

    np.testing.assert_allclose(m["loss"].item(), float(want_m["loss"]), rtol=RTOL)
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(want_m["cm"]))
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(want_m["probs"]), rtol=0,
                               atol=1e-5)
    got_g = _leaves(export_jax_params(exp.net, grads=True)["params"])
    assert set(got_g) == set(want_g) and len(want_g) == (16 if family == "tecno" else 13)
    gmax = max(float(np.abs(w).max()) for w in want_g.values())
    for path, w in want_g.items():
        # each leaf to 1e-5 of its own largest |value|, but TransSVNet's
        # decoder W_Q and W_K (NULL_LEAVES) to 1e-5 of the tree's largest
        scale = gmax if path.endswith(NULL_LEAVES) else float(np.abs(w).max())
        np.testing.assert_allclose(got_g[path], w, rtol=RTOL, atol=1e-5 * max(scale, 1e-30),
                                   err_msg=path)
    got_p = _leaves(export_jax_params(exp.net)["params"])
    assert set(got_p) == set(want_params)
    for path, w in want_params.items():
        np.testing.assert_allclose(got_p[path], w, rtol=0, atol=1e-2 * cfg.lr, err_msg=path)
    # the frozen stage gets no gradient and does not move
    if exp.frozen is not None:
        assert all(p.grad is None for p in exp.frozen.parameters())
        frozen_now = _leaves(export_jax_params(exp.frozen)["params"])
        for path, w in _leaves(frozen["tecno_params"]).items():
            np.testing.assert_array_equal(frozen_now[path], w, err_msg=path)


@pytest.mark.parametrize("model_name", ["TeCNo", "TransSVNet"])
def test_eval_step_serves_the_final_output(rng, model_name):
    cfg = _port_cfg(JaxConfig(model_name=model_name, **FIELDS))
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    if model_name == "TransSVNet":
        exp.load_frozen(_frozen_tree())
    batch = frame_batch(_trial(rng, 40), cfg, bucket=T_PAD)
    m = exp.eval_step(batch)
    assert set(m) == {"loss", "cm", "preds", "probs"}
    assert int(m["cm"].sum()) == 40 and np.isfinite(float(m["loss"]))
    served = exp.eval_step({"images": batch["images"]})
    assert set(served) == {"preds", "probs"} and served["probs"].shape == (T_PAD,)
    torch.testing.assert_close(served["probs"], m["probs"], rtol=0, atol=0)


@pytest.mark.parametrize("model_name", ["TeCNo", "TransSVNet"])
def test_train_frame_fold_trains_each_family(rng, model_name):
    cfg = _port_cfg(JaxConfig(model_name=model_name, **{**FIELDS, "n_epochs": 2,
                                                         "lr": 3e-3}))
    names = ["Needle_Passing_B001", "Needle_Passing_C002", "Needle_Passing_D003"]
    trials = [_trial(rng, T, n, learnable=True) for T, n in zip((60, 50, 70), names)]
    frozen = _frozen_tree() if model_name == "TransSVNet" else None
    ops.reset_launch_counts()
    res = train_frame_fold(cfg, trials, trials[:1], device="cpu", frozen=frozen)
    assert all(n == 0 for n in ops.launch_counts().values())   # the CPU runs no kernel
    hist = res["history"]
    assert [r["epoch"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"]) for r in hist)
    if model_name == "TeCNo":
        assert hist[1]["train_loss"] < hist[0]["train_loss"]
    best = res["best"]
    assert best["preds"].shape == best["probs"].shape == (60,)
    assert set(res["checkpoint"]["params"]) == {"model"}
    if model_name == "TransSVNet":
        with pytest.raises(ValueError, match="frozen TeCNo"):
            train_frame_fold(cfg, trials, trials[:1], device="cpu")


def test_training_entry_points_need_cuda_unless_asked_for_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for name in ("TeCNo", "TransSVNet"):
        cfg = _port_cfg(JaxConfig(model_name=name, **FIELDS))
        with pytest.raises(RuntimeError, match="CUDA"):
            Experiment(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            train_frame_fold(cfg, [_trial(rng, 20)], [_trial(rng, 20)],
                             frozen=_frozen_tree() if name == "TransSVNet" else None)
