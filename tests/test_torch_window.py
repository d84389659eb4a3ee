"""The port's window models (med_tpu_torch.models.window_models) and their
train and eval steps against the JAX package's: logits in train and eval
mode, flax's BatchNorm, the LSTM's one bias a gate, the losses, and one
train step of each model and label regime (loss, confusion matrix,
predictions, every gradient, the updated running statistics), then an eval
step on the stepped weights.

Both sides take the same numpy-seeded dropout keep-masks: the port through
``masks=``, med_tpu through ``flax.linen.intercept_methods`` on its
``nn.Dropout`` calls, in the order the forward makes them (nothing in
med_tpu changes). Tolerances: logits and losses 1e-5 of the largest,
running statistics 1e-6, gradients 2e-5 of each leaf's largest (rtol
1e-4): held against float64 gradients of the same step, each package's
float32 gradients sit up to ~1e-5 of a leaf's largest away (7.5e-6 for
the port, 9.4e-6 for med_tpu, SimpleLSTM with class weights), so the two
can part by twice that; a twin's, 2e-5 of the tree's largest.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data.datasets import WindowFold as JaxWindowFold
from med_tpu.models import window_models as jwm
from med_tpu.train import losses as jlosses
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import WindowFold, window_batches
from med_tpu_torch.data.labels import powerset_error_labels
from med_tpu_torch.models import build_model
from med_tpu_torch.models.layers import BatchNorm, init_weights
from med_tpu_torch.models.window_models import LSTMLayer, window_model
from med_tpu_torch.train import losses as tlosses
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

B = 16



def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def close(got, want, name="", frac=1e-5, rtol=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def fold_fields(rng, n, W, error_rate=0.35, nd_rate=0.0, subjects=("B001", "C001")):
    """A synthetic window split's fields (both packages' WindowFold): a
    learnable error signal in the kinematics, one error kind a window (or
    Needle-Drop alone at ``nd_rate``)."""
    e = np.zeros((n, 5), np.int64)
    err = rng.random(n) < error_rate
    e[err, 4] = 1
    e[np.flatnonzero(err), rng.integers(0, 4, int(err.sum()))] = 1
    nd = (~err) & (rng.random(n) < nd_rate)
    e[nd, 1] = e[nd, 4] = 1
    pw, _ = powerset_error_labels(e, delete_ND=False)
    kin = rng.normal(size=(n, W, 26)).astype(np.float32)
    kin[:, :, :3] += 1.5 * e[:, 4, None, None]
    return dict(images=rng.normal(size=(n, W, 2048)).astype(np.float32), kinematics=kin,
                g_labels=rng.integers(1, 9, (n, 1)), e_powerset=pw,
                subjects=np.asarray([f"Needle_Passing_{subjects[i * len(subjects) // n]}"
                                     for i in range(n)], dtype=object),
                e_raw=e)


def config_fields(model_name, error_type="global", **kw):
    out_features = {"global": 1, "all_errors": 6, "sequential": 5}[error_type]
    fields = dict(model_name=model_name, error_type=error_type, out_features=out_features,
                  dataset_type="window", data_type="multimodal", video_dims=8,
                  batch_size=B, hidden_size=16, lr=3e-3, weight_decay=0.0,
                  siamese=model_name.startswith("Siamese"))
    fields.update(kw)
    return fields


def flat_masks(masks):
    """Keep-masks in the order the forward applies them: a siamese twin's
    (x1's, x2's) in turn."""
    if isinstance(masks, tuple):
        return [*masks[0], *masks[1]]
    return list(masks)


def dropout_interceptor(masks):
    """med_tpu's dropout made the injected keep-masks: each training
    ``nn.Dropout`` call takes the next mask (cyclically, so a traced step
    takes the same masks every time it is traced)."""
    masks = [np.asarray(m) for m in flat_masks(masks)]
    calls = [0]

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
            if not kwargs.get("deterministic", mod.deterministic):
                keep = masks[calls[0] % len(masks)]
                calls[0] += 1
                return jnp.where(jnp.asarray(keep), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    return lambda: nn.intercept_methods(intercept)


def jax_experiment(fields, tree, masks):
    """med_tpu's Experiment on the port's weights and running statistics
    (``init_state`` patched: its class counts still become its constants),
    its dropout the injected ``masks``."""
    jexp = JaxExperiment(JaxConfig(**fields))
    plain_init = jexp.init_state

    def state_for(sample, class_counts=None):
        state = plain_init(jax.random.key(0), sample, class_counts=class_counts)
        params = jax.tree.map(jnp.asarray, tree["params"])
        return state.replace(params=params, opt_state=jexp.tx.init(params),
                             batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]))

    jexp.init_state = (lambda rng_key, sample, frozen=None, class_counts=None:
                       state_for(sample, class_counts))
    return jexp, dropout_interceptor(masks), state_for


def seeded_experiment(cfg, seed=3, class_counts=None):
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(seed, class_counts)
    return exp


MODELS = [("SimpleCNN", 10), ("SimpleCNN", 30), ("SimpleLSTM", 10), ("Siamese_CNN", 10),
          ("Siamese_LSTM", 10)]


def _jax_model(name, W):
    return {"SimpleCNN": jwm.WindowCNN(window_size=W), "Siamese_CNN": jwm.SiameseCNN(),
            "SimpleLSTM": jwm.WindowLSTM(window_size=W, hidden_size=16),
            "Siamese_LSTM": jwm.SiameseLSTM()}[name]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name, W", MODELS)
def test_window_model_logits_match_jax(rng, name, W, train):
    """Logits from the same weights, running statistics and masks; in
    training the running statistics each side moved (the twins' branch
    twice, x1 then x2)."""
    model = window_model(name, 58, W, 1, hidden_size=16)
    init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():           # running statistics away from (0, 1)
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.running_mean.copy_(torch.tensor(rng.normal(size=mod.running_mean.shape)))
                mod.running_var.copy_(torch.tensor(rng.uniform(0.5, 2, mod.running_var.shape)))
    tree = export_jax_params(model)
    xs = [rng.normal(size=(B, W, 58)).astype(np.float32)
          for _ in range(2 if name.startswith("Siamese") else 1)]
    masks = model.dropout_masks(B, torch.Generator().manual_seed(2))
    got = model(*map(torch.from_numpy, xs), train=train, masks=masks)

    with dropout_interceptor(masks)():
        out = _jax_model(name, W).apply(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]}, *xs,
            train=train, mutable=["batch_stats"] if train else False)
    want, moved = out if train else (out, None)
    close(got, want, "logits")
    if train:
        now = leaves(export_jax_params(model)["batch_stats"])
        for path, w in leaves(jax.device_get(moved["batch_stats"])).items():
            np.testing.assert_allclose(now[path], w, rtol=0, atol=1e-6, err_msg=path)


def test_batchnorm_trains_as_flax_not_as_torch(rng):
    """flax's training BatchNorm: variance E[x²] − E[x]², running averages
    0.9 · old + 0.1 · batch with the biased variance; torch's BatchNorm1d
    keeps the unbiased one, so its running variance parts from flax's by
    n/(n − 1)."""
    x = (rng.normal(size=(6, 5, 4)) * 3 + 1).astype(np.float32)
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(rng.normal(1, 0.2, 5)))
        bn.bias.copy_(torch.tensor(rng.normal(0, 0.3, 5)))
    xt = torch.from_numpy(x)
    got = bn(xt, train=True)
    flax_bn = nn.BatchNorm(momentum=0.9)
    variables = {"params": {"scale": bn.weight.detach().numpy(),
                            "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                 "var": np.ones(5, np.float32)}}
    # flax normalises the last axis: hand it (B, L, C)
    want, moved = flax_bn.apply(variables, x.transpose(0, 2, 1), use_running_average=False,
                                mutable=["batch_stats"])
    close(got, np.asarray(want).transpose(0, 2, 1), "train output")
    np.testing.assert_allclose(bn.running_mean.numpy(), moved["batch_stats"]["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), moved["batch_stats"]["var"],
                               rtol=0, atol=1e-6)
    torch_bn = torch.nn.BatchNorm1d(5, momentum=0.1)
    torch_bn(xt)
    n = x.size // 5
    np.testing.assert_allclose(torch_bn.running_var.numpy() - 0.9,
                               (bn.running_var.numpy() - 0.9) * n / (n - 1), rtol=1e-4)
    variables["batch_stats"] = jax.device_get(moved["batch_stats"])
    want = flax_bn.apply(variables, x.transpose(0, 2, 1), use_running_average=True)
    close(bn(xt), np.asarray(want).transpose(0, 2, 1), "eval output")


def test_lstm_layer_has_one_bias_a_gate(rng):
    """One LSTM layer against flax's nn.RNN(OptimizedLSTMCell): outputs and
    every gradient, the bias's counted once; the same number of
    parameters."""
    layer = LSTMLayer(6, 5)
    init_weights(layer, torch.Generator().manual_seed(0))
    tree = export_jax_params(layer)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    g = rng.normal(size=(3, 7, 5)).astype(np.float32)
    out = layer(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    rnn = nn.RNN(nn.OptimizedLSTMCell(5))

    def f(params):
        return jnp.sum(rnn.apply({"params": params}, x) * g), rnn.apply({"params": params}, x)

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(tree["params"])
    close(out, want, "outputs")
    got = leaves(export_jax_params(layer, grads=True)["params"])
    want_g = leaves(jax.device_get(grads))
    assert set(got) == set(want_g) and len(got) == 12
    assert sum(p.numel() for p in layer.parameters()) == sum(w.size for w in want_g.values())
    for path, w in want_g.items():
        close(got[path], w, path)


def test_window_losses_match_jax(rng):
    logits = rng.normal(size=(12,)).astype(np.float32)
    labels = rng.integers(0, 2, 12)
    mask = (rng.random(12) > 0.2).astype(np.float32)
    for pw in (None, 2.5):
        close(tlosses.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                      torch.from_numpy(mask),
                                      None if pw is None else torch.tensor(pw)),
              jlosses.bce_with_logits(logits, labels, mask, pw), f"bce {pw}")
    logits6 = rng.normal(size=(12, 6)).astype(np.float32)
    labels6 = rng.integers(0, 6, 12)
    weights = rng.uniform(0.5, 3, 6).astype(np.float32)
    for w in (None, weights):
        close(tlosses.cross_entropy(torch.from_numpy(logits6), torch.from_numpy(labels6),
                                    torch.from_numpy(mask),
                                    None if w is None else torch.from_numpy(w)),
              jlosses.cross_entropy(logits6, labels6, mask, w), "ce")


STEPS = [("SimpleCNN", "global", True, 5), ("SimpleCNN", "global", False, 15),
         ("SimpleLSTM", "global", False, 5), ("Siamese_CNN", "global", True, 5),
         ("Siamese_LSTM", "global", False, 5), ("SimpleLSTM", "all_errors", True, 5),
         ("SimpleCNN", "all_errors", False, 5), ("SimpleLSTM", "sequential", False, 5),
         ("SimpleCNN", "sequential", True, 5)]


@pytest.mark.parametrize("name, error_type, pos_weight, frequency", STEPS)
def test_train_step_matches_jax(rng, name, error_type, pos_weight, frequency):
    """One train step from the same weights, masks and padded batch (its
    last rows repeat window 0, masked): loss, cm, predictions, every
    gradient (from med_tpu's first Adam moment), the running statistics;
    then the eval step's loss, cm and predictions on the stepped weights.
    ``pos_weight`` takes the class counts as med_tpu's loop makes them."""
    # on the kinematics: the FeatureExtractor's 82k relus a batch would put a
    # pre-activation within float32's noise of 0 about once in 30 steps,
    # flipping a row's term between the packages (its parity: the folds in
    # tests/test_torch_window_train.py, and the GPU test and smoke, pinned)
    fields = config_fields(name, error_type, pos_weight=pos_weight, frequency=frequency,
                           data_type="kinematics")
    cfg = ExperimentConfig(**fields)
    W = cfg.window_size
    split = fold_fields(rng, B - 3, W)
    if name.startswith("Siamese"):
        pair = fold_fields(rng, B - 3, W)
        split["images"] = np.stack([split["images"], pair["images"]], axis=1)
        split["kinematics"] = np.stack([split["kinematics"], pair["kinematics"]], axis=1)
    fold = WindowFold(**split)
    extras = None
    if error_type == "sequential":       # a gate that is not the true errors
        extras = {"gate": (rng.random(len(fold)) > 0.5).astype(np.float32)}
    batch = next(window_batches(fold, cfg, shuffle=False, extras=extras))
    from med_tpu.train.loop import _class_counts as jax_class_counts

    counts = jax_class_counts(JaxConfig(**fields), JaxWindowFold(**fold_fields(rng, 40, W)))
    exp = seeded_experiment(cfg, class_counts=counts)
    tree = export_jax_params(exp.net)
    masks = exp.net.model.dropout_masks(B, torch.Generator().manual_seed(5))
    m = exp.train_step(batch, masks=masks)

    jexp, intercept, state_for = jax_experiment(fields, tree, masks)
    jbatch = {k: v for k, v in batch.items() if not k.startswith("_")}
    state = state_for(jbatch, counts)
    with intercept():
        state, jm = jexp.train_step(state, jbatch)
    close(m["loss"], jm["loss"], "loss")
    for key in jm:
        if key.startswith("cm"):
            np.testing.assert_array_equal(m[key].numpy(), np.asarray(jm[key]), err_msg=key)
    np.testing.assert_array_equal(m["preds"].numpy(), np.asarray(jm["preds"]))
    close(m["probs"], jm["probs"], "probs")
    got = leaves(export_jax_params(exp.net, grads=True)["params"])
    want = {k: v / 0.1 for k, v in leaves(jax.device_get(state.opt_state[1].mu)).items()}
    assert set(got) == set(want)
    # a twin's gradients are differences of its two branches' nearly
    # cancelling terms: held to the tree's largest gradient, not each leaf's
    tree_max = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        if cfg.siamese:
            np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=2e-5 * tree_max,
                                       err_msg=path)
        else:
            close(got[path], w, path, frac=2e-5)
    stats = leaves(export_jax_params(exp.net)["batch_stats"])
    for path, w in leaves(jax.device_get(state.batch_stats)).items():
        np.testing.assert_allclose(stats[path], w, rtol=0, atol=1e-6, err_msg=path)

    # one Adam step moves a parameter by lr * g / (|g| + 1e-8): where |g| is
    # near 1e-8 (a few of the FE's 1M kernel entries), float32's difference
    # in g moves it by up to ~0.1 lr, so the eval step runs on med_tpu's
    # stepped weights (Adam itself: tests/test_torch_train.py)
    exp.load_params({"params": jax.device_get(state.params),
                     "batch_stats": jax.device_get(state.batch_stats),
                     "constants": jax.device_get(state.constants)})
    ev = exp.eval_step(batch)
    jev = jexp.eval_step(state, jbatch)
    close(ev["loss"], jev["loss"], "eval loss")
    np.testing.assert_array_equal(ev["cm"].numpy(), np.asarray(jev["cm"]))
    np.testing.assert_array_equal(ev["preds"].numpy(), np.asarray(jev["preds"]))


def test_factory_builds_every_window_model_and_ignores_compute_dtype():
    for name in ("SimpleCNN", "SimpleLSTM", "Siamese_CNN", "Siamese_LSTM"):
        for dtype in ("float32", "bfloat16"):
            model = build_model(ExperimentConfig(model_name=name, compute_dtype=dtype))
            assert all(p.dtype == torch.float32 for p in model.parameters())
    lstm = build_model(ExperimentConfig(model_name="SimpleLSTM", hidden_size=32, num_layers=2,
                                        out_features=6))
    assert lstm.num_layers == 2 and lstm.head.out.weight.shape == (6, 64)
    cnn30 = build_model(ExperimentConfig(model_name="SimpleCNN", frequency=15))
    assert cnn30.channels == (64, 128, 256) and cnn30.head.dense0.weight.shape == (256, 512)


def test_experiment_switches_tf32_off():
    """PyTorch leaves cuDNN's TF32 on by default; an Experiment, the
    training entry points' core, switches both flags off, as the serving
    constructors do."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    Experiment(ExperimentConfig(**config_fields("SimpleLSTM")), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_window_weights_round_trip_both_ways(rng):
    """A trained tree (running statistics moved) goes port -> med_tpu tree
    -> port bit for bit, for the CNN and the LSTM; and med_tpu's own
    initialised tree loads into the port and comes back unchanged."""
    for name in ("SimpleCNN", "Siamese_LSTM"):
        cfg = ExperimentConfig(**config_fields(name))
        exp = seeded_experiment(cfg)
        x = rng.normal(size=(B, 2, 10, 2048) if cfg.siamese else (B, 10, 2048))
        batch = {"images": x.astype(np.float32),
                 "kinematics": rng.normal(size=x.shape[:-1] + (26,)).astype(np.float32),
                 "labels": rng.integers(0, 2, B), "mask": np.ones(B, np.float32)}
        exp.train_step(batch)
        tree = exp.checkpoint()
        back = Experiment(cfg, device="cpu")
        back.load_params(tree)
        for (k, a), (_, b) in zip(exp.net.state_dict().items(), back.net.state_dict().items()):
            assert torch.equal(a, b), k
        jexp = JaxExperiment(JaxConfig(**config_fields(name)))
        jbatch = {k: v for k, v in batch.items()}
        state = jexp.init_state(jax.random.key(0), jbatch)
        jtree = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
        net = build_model(cfg)
        state_dict, _ = load_jax_params({"params": jtree["params"]["model"],
                                         "batch_stats": jtree["batch_stats"]["model"]}, net)
        net.load_state_dict(state_dict)
        again = export_jax_params(net)
        for path, w in leaves({"params": jtree["params"]["model"],
                               "batch_stats": jtree["batch_stats"]["model"]}).items():
            np.testing.assert_array_equal(leaves(again)[path], w, err_msg=path)
