"""The port's backbone fine-tuning against med_tpu's: train-mode and
ghost-batch BatchNorm, ``ResNetClassifier``, one fine-tune step (loss, every
gradient leaf, Adam's update, the running statistics), the batches, each
augmentation op with med_tpu's own draws, and the fine-tune CLI with its
checkpoint and exported folds read by med_tpu.

Weights are drawn by the port, exported in med_tpu's tree and loaded on both
sides. Tolerances, float32 on the CPU with sums taken in another order:
BatchNorm outputs and statistics 1e-6; forwards 1e-5; augmentation, 0-255
pixels within 1e-4 (float32 tan and sin of one angle may differ by an ulp
between XLA and PyTorch).

A step is the port's float32 step against med_tpu's step in float64
(``jax.enable_x64``, its modules at ``dtype=float64``; its pool and its
ghost statistics stay float32): loss 1e-5 relative; each gradient leaf
rtol 1e-4 plus 1e-5 of the leaf's largest |value| (chip_smoke.py's
TRAIN_TOL; float32 leaves land up to 2e-5 of their largest away); running
statistics 1e-5; after Adam's first step (an update of ~lr * sign(g))
each parameter within 1e-6 where |g| > 1e-4, within 2 lr elsewhere (a
gradient near Adam's eps 1e-8 takes a partial step that rounding moves).
The port's relu derivative pattern is pinned to its own float64 step's: a
pre-activation within rounding of 0 flips, moving one pixel's term of every
gradient upstream (the flips are counted). The trunks' blocks' last
BatchNorm scales are 0.2x (as chip_smoke.py's seeded trunk): with kaiming
weights and scale 1 a full-width trunk amplifies float32 rounding to
~1e-4 of the loss in either package (med_tpu's eager and jitted steps
differ by 1.7e-4 there). Frames are 64x64, so that the last stage's BN
takes 2 x 2 pixels an image.
"""

import functools
import glob
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from med_tpu.cli import resnet_finetune as jcli
from med_tpu.data import augment as jaug
from med_tpu.data.trials import load_fold as jax_load_fold
from med_tpu.eval.serving import PixelFrontEnd as JaxPixelFrontEnd
from med_tpu.models.resnet import ResNetClassifier as JaxClassifier
from med_tpu.models.resnet import SubsampledBatchNorm, load_pretrained_trunk
from med_tpu.train.losses import bce_with_logits as jax_bce
from med_tpu_torch.cli import resnet_finetune as tcli
from med_tpu_torch.data import augment as taug
from med_tpu_torch.data.trials import Trial, load_trial, save_trial_npz
from med_tpu_torch.eval.serving import PixelFrontEnd
from med_tpu_torch.models import init_weights, resnet
from med_tpu_torch.models.resnet import BatchNorm, ResNetClassifier
from med_tpu_torch.parallel import launch
from med_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint
from med_tpu_torch.utils.jax_params import export_jax_params, load_jax_params
from torch_rank_bodies import finetune_dp_suite

SMALL = dict(stage_sizes=(1, 1, 1, 1), width=8)
LR = 1e-3



def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _close_tree(got, want, rtol, atol, what):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


# ----------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("stride", [1, 4])
def test_train_mode_batchnorm_matches_flax(stride, rng):
    """Exact BN against flax's nn.BatchNorm, ghost BN (stride 4) against
    med_tpu's SubsampledBatchNorm: outputs and the moved running
    statistics, 1e-6; the statistics from the first B // 4 images only."""
    x = (rng.normal(size=(8, 6, 5, 4)) * 3 - 2).astype(np.float32)
    jbn = (fnn.BatchNorm(use_running_average=False, momentum=0.9) if stride == 1 else
           SubsampledBatchNorm(stat_stride=stride, use_running_average=False))
    variables = jbn.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray(rng.normal(size=4) + 1, jnp.float32),
                            "bias": jnp.asarray(rng.normal(size=4), jnp.float32)},
                 "batch_stats": variables["batch_stats"]}
    want, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(4, stat_stride=stride)
    state, _ = load_jax_params(jax.device_get(variables), bn)
    bn.load_state_dict(state)
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    _close_tree(export_jax_params(bn)["batch_stats"], mut["batch_stats"], 1e-6, 1e-6, "stats")
    if stride > 1:   # the rest of the batch moves nothing
        y = x.copy()
        y[2:] *= 5.0
        bn.load_state_dict(state)
        bn(torch.from_numpy(y).permute(0, 3, 1, 2), train=True)
        _close_tree(export_jax_params(bn)["batch_stats"], mut["batch_stats"], 1e-6, 1e-6,
                    "ghost stats")


# ------------------------------------------------------------ the classifier
def _seeded(seed, bn_stat_stride=1, residual_scale=1.0, **kw):
    """The port's classifier with weights drawn from ``seed``, BN scales and
    biases perturbed, each block's last BN scaled by ``residual_scale``;
    returns it and its tree in med_tpu's layout."""
    net = init_weights(ResNetClassifier(bn_stat_stride=bn_stat_stride, **kw),
                       torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, BatchNorm):
                m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=gen))
                if name.endswith(".bn3"):
                    m.weight.mul_(residual_scale)
                    m.bias.mul_(residual_scale)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return net, export_jax_params(net)


def test_classifier_tree_is_med_tpus():
    """The port's state maps onto exactly med_tpu's ResNetClassifier tree at
    full width (jax.eval_shape: no JAX compute), shapes equal."""
    net = ResNetClassifier()
    want = jax.eval_shape(functools.partial(JaxClassifier().init, train=False),
                          jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    got = export_jax_params(net)
    assert sorted(got) == ["batch_stats", "params"]
    for col in ("params", "batch_stats"):
        shapes = {k: v.shape for k, v in flatten_tree(got[col]).items()}
        assert shapes == {k: v.shape for k, v in flatten_tree(want[col]).items()}


@pytest.mark.parametrize("train", [False, True])
def test_classifier_forward_matches_med_tpu(train, rng):
    """Width 8, stages (1, 1, 1, 1), 32x32: logits and features in eval
    mode, logits and moved statistics in train mode, 1e-5."""
    net, tree = _seeded(0, **SMALL)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    model = JaxClassifier(**SMALL)
    variables = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        got = net(torch.from_numpy(x), train=train).numpy()
    if train:
        want, mut = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        _close_tree(export_jax_params(net)["batch_stats"], mut["batch_stats"], 1e-5, 1e-5,
                    "stats")
    else:
        want = model.apply(variables, jnp.asarray(x), train=False)
        feats = model.apply(variables, jnp.asarray(x), train=False, method="features")
        with torch.no_grad():
            np.testing.assert_allclose(net.features(torch.from_numpy(x)).numpy(),
                                       np.asarray(feats), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- one train step
def _jax_step(kw, tree, pix, labels, mask, freeze_bn):
    """med_tpu's fine-tune step (cli/resnet_finetune.py train_step, its
    --no-augment branch), written out so that the gradients can be read,
    on med_tpu's ResNetClassifier in float64 (``jax.enable_x64``): returns
    numpy (loss, grads, new params, new batch_stats)."""
    with jax.enable_x64(True):
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        model = JaxClassifier(**kw, dtype=jnp.float64)
        params = jax.tree.map(f64, tree["params"])
        batch_stats = jax.tree.map(f64, tree["batch_stats"])
        pix, labels, mask = f64(pix), jnp.asarray(labels), f64(mask)
        tx = optax.adam(LR)
        opt_state = tx.init(params)

        def loss_fn(p):
            if freeze_bn:
                logits = model.apply({"params": p, "batch_stats": batch_stats}, pix,
                                     train=False)
                return jax_bce(logits, labels, mask), batch_stats
            logits, mut = model.apply({"params": p, "batch_stats": batch_stats}, pix,
                                      train=True, mutable=["batch_stats"])
            return jax_bce(logits, labels, mask), mut["batch_stats"]

        @jax.jit
        def step(params, opt_state):
            (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, opt_state)
            return loss, grads, optax.apply_updates(params, updates), new_stats

        return jax.device_get(step(params, opt_state))


def _port_step(net, imgs, labels, mask, pixel_stats, freeze_bn):
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    loss = tcli.train_step(net, opt, imgs, labels, mask, pixel_stats, freeze_bn)
    return (float(loss), export_jax_params(net, grads=True)["params"],
            export_jax_params(net))


def _check_grads(grads, jgrads, rtol, atol_frac):
    g, jg = _leaves(grads), _leaves(jgrads)
    assert sorted(g) == sorted(jg)
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-30)
        np.testing.assert_allclose(g[k], jg[k], rtol=rtol, atol=atol_frac * scale, err_msg=k)
    return jg


def _check_step(port, jax_out, atol_frac=1e-5):
    loss, grads, after = port
    jloss, jgrads, jparams, jstats = jax_out
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jg = _check_grads(grads, jgrads, 1e-4, atol_frac)
    p, jp = _leaves(after["params"]), _leaves(jparams)
    for k in jp:
        sure = np.abs(jg[k]) > 1e-4
        np.testing.assert_allclose(p[k][sure], jp[k][sure], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(p[k], jp[k], rtol=0, atol=2 * LR, err_msg=k)
    _close_tree(after["batch_stats"], jstats, 1e-5, 1e-5, "stats")


def _padded_batch(rng, n=13, batch=8, hw=32):
    """The second batch of ``_batches`` over n images: n - batch rows, then
    image 0 repeated, masked 0."""
    images = rng.integers(0, 256, (n, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 2, n)
    imgs, labs, mask = list(tcli._batches(images, labels, batch, True, 3))[1]
    assert mask.sum() == n - batch and (imgs[mask == 0] == images[0]).all()
    mean = (images.reshape(-1, 3).mean(0) / 255.0).astype(np.float32)
    std = (images.reshape(-1, 3).std(0) / 255.0 + 1e-6).astype(np.float32)
    return imgs, labs, mask, mean, std


class _ReluPins:
    """The ResNet's relu (``models.resnet.relu``), recording a run's
    derivative pattern, then pinning the next runs' to it and counting the
    pre-activations whose sign differs (a value within rounding of 0 moves
    one pixel's term of the gradients upstream)."""

    def __init__(self):
        self.masks, self.pin, self.i, self.flips = [], False, 0, 0

    def __call__(self, x):
        if not self.pin:
            self.masks.append(x > 0)
            return torch.relu(x)
        m = self.masks[self.i]
        self.i += 1
        self.flips += int(((x > 0) != m).sum())
        return x * m.to(x.dtype)


def _step_case(seed, kw, stride, freeze, rng, n, batch, hw, monkeypatch, atol_frac=1e-5):
    """The port's float32 step, its relu pattern pinned to the port's own
    float64 step, against med_tpu's step in float64; the port's float64
    gradients against med_tpu's too (1e-6 of each leaf's largest, where
    med_tpu's ghost statistics, float32, are not in the way). Returns the
    port's step, the tree and the flips."""
    imgs, labels, mask, mean, std = _padded_batch(rng, n, batch, hw)
    net, tree = _seeded(seed, stride, residual_scale=0.2, **kw)
    jax_out = _jax_step(dict(kw, bn_stat_stride=stride), tree, (imgs / 255.0 - mean) / std,
                        labels, mask, freeze)
    pins = _ReluPins()
    monkeypatch.setattr(resnet, "relu", pins)
    net64 = ResNetClassifier(bn_stat_stride=stride, dtype=torch.float64, **kw)
    net64.load_state_dict(load_jax_params(tree, net64)[0])
    stats = (torch.from_numpy(mean), torch.from_numpy(std))
    port64 = _port_step(net64.double(), imgs, labels, mask, stats, freeze)
    if stride == 1:
        _check_grads(port64[1], jax_out[1], 0, 1e-6)
    pins.pin = True
    port = _port_step(net, imgs, labels, mask, stats, freeze)
    _check_step(port, jax_out, atol_frac)
    return port, tree, pins.flips


@pytest.mark.parametrize("case", ["exact", "freeze_bn", "stride4"])
def test_train_step_matches_med_tpu(case, rng, monkeypatch):
    """One --no-augment step on a padded batch of 8 at width 8: the padding rows
    count in train-mode BN statistics and not in the loss; with --freeze-bn
    BN runs on the running statistics while its scale and bias train; with
    bn_stat_stride 4 the ghost statistics."""
    port, tree, flips = _step_case(1, SMALL, 4 if case == "stride4" else 1,
                                   case == "freeze_bn", rng, 13, 8, 64, monkeypatch)
    assert flips <= 2
    if case == "freeze_bn":
        _close_tree(port[2]["batch_stats"], tree["batch_stats"], 0, 0, "frozen stats")


def test_full_width_train_step_matches_med_tpu(rng, monkeypatch):
    """The same step once at full width, (3, 4, 6, 3) x 64, B = 4 (one
    padded row), train-mode BN. The port's float64 gradients lie within
    1.7e-8 of med_tpu's (of each leaf's largest); its float32 ones, pinned,
    within 1.08e-5 beyond rtol 1e-4 (layer4_2's conv3 kernel): float32's
    own rounding over 53 convs, so these are held to 2e-5."""
    _, _, flips = _step_case(2, {}, 1, False, rng, 7, 4, 64, monkeypatch, atol_frac=2e-5)
    assert flips <= 8


def test_batches_equal_med_tpus(rng):
    """Shuffled by default_rng(seed), the last batch padded with image 0 of
    the whole array and masked; unshuffled for the eval pass."""
    images = rng.normal(size=(21, 2, 2, 3)).astype(np.float32)
    labels = rng.integers(0, 2, 21)
    for shuffle, seed in ((True, 7), (False, 0)):
        got = list(tcli._batches(images, labels, 8, shuffle, seed))
        want = list(jcli._batches(images, labels, 8, shuffle, seed))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------- augmentation
def _jax_draws(key, B, crop_pad=8, max_degrees=10.0, brightness=0.2, contrast=0.2):
    """med_tpu's augment_batch draws, in its split order (k1..k4; kb, kc in
    the jitter; kx, ky in the crop)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    kb, kc = jax.random.split(k1)
    b = jax.random.uniform(kb, (B, 1, 1, 1), minval=1 - brightness, maxval=1 + brightness)
    c = jax.random.uniform(kc, (B, 1, 1, 1), minval=1 - contrast, maxval=1 + contrast)
    angles = jax.random.uniform(k2, (B,), minval=-max_degrees,
                                maxval=max_degrees) * (jnp.pi / 180.0)
    kx, ky = jax.random.split(k3)
    off_y = jax.random.randint(ky, (B,), 0, 2 * crop_pad + 1)
    off_x = jax.random.randint(kx, (B,), 0, 2 * crop_pad + 1)
    flip = jax.random.bernoulli(k4, 0.5, (B, 1, 1, 1))

    def t(a):
        return torch.from_numpy(np.asarray(a).reshape(B).copy())

    return {"jitter": (t(b), t(c)), "angles": t(angles), "crop": (t(off_y).long(), t(off_x).long()),
            "flip": t(flip)}


@pytest.fixture
def frames(rng):
    return rng.integers(0, 256, size=(4, 32, 40, 3)).astype(np.float32)


@pytest.mark.parametrize("op", ["flip", "crop", "rotation", "jitter", "augment_batch"])
def test_augmentation_matches_med_tpu_with_its_draws(op, frames):
    key = jax.random.key(11)
    draws = _jax_draws(key, len(frames))
    x, jx = torch.from_numpy(frames), jnp.asarray(frames)
    if op == "flip":
        kf = jax.random.split(key, 4)[3]
        want = jaug.random_horizontal_flip(kf, jx)
        got = taug.random_horizontal_flip(x, draws["flip"])
    elif op == "crop":
        want = jaug.random_crop(jax.random.split(key, 4)[2], jx, pad=8)
        got = taug.random_crop(x, *draws["crop"], pad=8)
    elif op == "rotation":
        want = jaug.random_rotation(jax.random.split(key, 4)[1], jx, 10.0)
        got = taug.random_rotation(x, draws["angles"], 10.0)
    elif op == "jitter":
        want = jaug.color_jitter(jax.random.split(key, 4)[0], jx)
        got = taug.color_jitter(x, *draws["jitter"])
    else:
        mean = np.asarray([0.4, 0.5, 0.6], np.float32)
        std = np.asarray([0.2, 0.25, 0.3], np.float32)
        want = jaug.augment_batch(key, jx, normalize=(jnp.asarray(mean), jnp.asarray(std)))
        got = taug.augment_batch(x, draws, normalize=(torch.from_numpy(mean),
                                                      torch.from_numpy(std)))
        # back on the 0-255 scale for the tolerance
        want = (np.asarray(want) * std + mean) * 255.0
        got = (got.numpy() * std + mean) * 255.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-4)


def test_augment_draws_are_seeded_and_in_range():
    a = taug.draw_augment(64, torch.Generator().manual_seed(3))
    b = taug.draw_augment(64, torch.Generator().manual_seed(3))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    bright, contrast = a["jitter"]
    assert 0.8 <= float(bright.min()) and float(bright.max()) <= 1.2
    assert 0.8 <= float(contrast.min()) and float(contrast.max()) <= 1.2
    assert float(a["angles"].abs().max()) <= np.deg2rad(10.0) + 1e-7
    assert all(0 <= int(o.min()) and int(o.max()) <= 16 for o in a["crop"])
    assert 0 < int(a["flip"].sum()) < 64


# ------------------------------------------------------------------- the CLI
def _raw_fold(root, rng, n_trials=3, frames=16, hw=32):
    fold = root / "1Out"
    fold.mkdir(parents=True)
    names = []
    for i in range(n_trials):
        name = f"Needle_Passing_B00{i + 1}"
        names.append(name + ".npz")
        imgs = rng.integers(0, 256, size=(frames, hw, hw, 3)).astype(np.uint8)
        e = np.zeros((frames, 5), np.int64)
        e[: frames // 2, 4] = 1
        imgs[: frames // 2] //= 2
        save_trial_npz(str(fold / names[-1]),
                       Trial(name, imgs.astype(np.float32),
                             rng.normal(size=(frames, 26)).astype(np.float32),
                             np.ones(frames, np.int64), e))
    (fold / "train.csv").write_text("\n".join(names[:-1]))
    (fold / "test.csv").write_text(names[-1])
    return str(root)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The port's CLI on the CPU (3 trials of 16 frames, 32x32, batch 8, one
    epoch, augmentation on), then the same with --int8-trunk."""
    root = tmp_path_factory.mktemp("finetune")
    data = _raw_fold(root / "raw", np.random.default_rng(0))
    base = ["--data-root", data, "--folds", "1Out", "--batch-size", "8", "--n-epochs", "1",
            "--seed", "0", "--device", "cpu"]
    out = {}
    for name, extra in (("fp", []), ("int8", ["--int8-trunk"])):
        out[name] = str(root / name)
        tcli.main([*base, *extra, "--output-root", out[name],
                   "--runs-root", str(root / f"runs_{name}")])
    out["ckpt"] = glob.glob(str(root / "runs_fp" / "ResNet50_finetune" / "*" / "checkpoints"
                                / "resnet50_1Out.npz"))[0]
    out["data"] = data
    return out


def test_cli_checkpoint_is_med_tpus_tree_and_serves_in_both_packages(cli_runs):
    """resnet50_1Out.npz holds exactly the leaves of med_tpu's
    ResNetClassifier tree (jax.eval_shape) with its meta; both packages'
    PixelFrontEnd.from_checkpoint (fp32) serve it and give the exported
    test features (1e-4 relative L2: eval-mode convs in another order)."""
    ckpt = load_checkpoint(cli_runs["ckpt"])
    want = jax.eval_shape(functools.partial(JaxClassifier().init, train=False),
                          jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    shapes = {k: v.shape for k, v in flatten_tree(ckpt).items()}
    assert shapes == {k: v.shape for k, v in flatten_tree(dict(want)).items()}
    with open(cli_runs["ckpt"] + ".json") as f:
        meta = json.load(f)
    assert sorted(meta) == ["best_acc", "mean", "std"] and 0.0 <= meta["best_acc"] <= 1.0
    exported, *_ = jax_load_fold(os.path.join(cli_runs["fp"], "1Out"), "test.csv")
    test = load_trial(os.path.join(cli_runs["data"], "1Out", "Needle_Passing_B003.npz"))
    ours = PixelFrontEnd.from_checkpoint(cli_runs["ckpt"], dtype=torch.float32,
                                         device="cpu").features(test.image_feats)
    theirs = np.asarray(JaxPixelFrontEnd.from_checkpoint(
        cli_runs["ckpt"], dtype=jnp.float32).features(test.image_feats))
    for got in (ours, theirs):
        assert got.shape == exported.shape == (16, 2048)
        assert np.linalg.norm(got - exported) <= 1e-4 * np.linalg.norm(exported)


def test_cli_exported_folds_load_in_med_tpu(cli_runs):
    for split, n in (("train.csv", 32), ("test.csv", 16)):
        img, kin, g, e, subj = jax_load_fold(os.path.join(cli_runs["fp"], "1Out"), split)
        assert img.shape == (n, 2048) and kin.shape == (n, 26) and e.shape == (n, 5)
        assert np.isfinite(img).all() and np.abs(img).max() > 0


def test_cli_int8_trunk_export(cli_runs):
    """--int8-trunk exports through the int8 PTQ trunk: per-row cosine to the
    fp export > 0.98, and not equal to it."""
    fp, *_ = jax_load_fold(os.path.join(cli_runs["fp"], "1Out"), "test.csv")
    i8, *_ = jax_load_fold(os.path.join(cli_runs["int8"], "1Out"), "test.csv")
    cos = np.sum(fp * i8, -1) / (np.linalg.norm(fp, axis=-1) * np.linalg.norm(i8, axis=-1))
    assert cos.min() > 0.98, cos
    assert np.abs(fp - i8).max() > 1e-6


def _torchvision_sd(rng):
    """Random weights in torchvision's resnet50 state_dict layout (no
    torchvision here; the key and shape contract is what counts)."""
    sd = {}
    for key, value in ResNetClassifier().trunk.state_dict().items():
        parts = key.split(".")
        if parts[0].startswith("layer"):
            stage, block = parts[0].split("_")
            sub = {"down_conv": ["downsample", "0"], "down_bn": ["downsample", "1"]}
            parts = [stage, block, *sub.get(parts[1], [parts[1]]), *parts[2:]]
        draw = rng.normal(size=value.shape) * (0.05 if value.dim() == 4 else 1.0)
        if key.endswith("running_var"):
            draw = rng.random(value.shape) + 0.5
        sd[".".join(parts)] = draw.astype(np.float32)
    return sd


def test_cli_init_weights_and_freeze_bn(tmp_path, rng):
    """--init-weights starts the trunk from a torchvision-layout state dict;
    with --lr 0 and --freeze-bn the checkpoint's trunk is that state dict,
    parameters and running statistics alike."""
    sd = _torchvision_sd(rng)
    wpath = str(tmp_path / "imagenet.pth")
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, wpath)
    data = _raw_fold(tmp_path / "raw", rng, n_trials=2, frames=8)
    tcli.main(["--data-root", data, "--output-root", str(tmp_path / "out"), "--folds", "1Out",
               "--runs-root", str(tmp_path / "runs"), "--batch-size", "4", "--n-epochs", "1",
               "--no-augment", "--lr", "0", "--freeze-bn", "--init-weights", wpath,
               "--device", "cpu"])
    ckpt = load_checkpoint(glob.glob(str(tmp_path / "runs" / "**" / "resnet50_1Out.npz"),
                                     recursive=True)[0])
    params, stats = load_pretrained_trunk(wpath)
    _close_tree(ckpt["params"]["trunk"], params, 0, 0, "trunk params")
    _close_tree(ckpt["batch_stats"]["trunk"], stats, 0, 0, "trunk stats")


def test_cli_refuses_mesh_and_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    argv = ["--data-root", str(tmp_path), "--output-root", str(tmp_path / "o"),
            "--runs-root", str(tmp_path / "runs")]
    # --mesh (once refused naming A12): a mesh larger than the one-rank world
    with pytest.raises(SystemExit, match="needs 2 ranks, have 1"):
        tcli.main([*argv, "--mesh", "2,1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_step_takes_the_global_batch_statistics(n, rng, tmp_path):
    """``train_step`` on a (n, 1) mesh of spawned gloo ranks, each on its
    rows of a padded batch of 8, against one rank on the whole batch, in
    float64 (no relu can flip): BatchNorm's statistics over the global
    batch, and with bn_stat_stride 4 the ghost statistics over the global
    batch's first 2 images (held by rank 0 alone; the other ranks add
    nothing), as GSPMD takes them; the BCE's mean over the global mask, the
    gradients summed once. Loss, every gradient and every running
    statistic to 1e-10 of its largest."""
    imgs, labels, mask, mean, std = _padded_batch(rng, 13, 8, 32)
    net, _ = _seeded(2, **SMALL)
    state = net.double().state_dict()
    stats = (torch.from_numpy(mean), torch.from_numpy(std))
    strides = (1, 4)
    got = launch.spawn(finetune_dp_suite, n, str(tmp_path / "ranks"),
                       args=(state, SMALL, strides, imgs, labels, mask, stats), device="cpu")
    for stride in strides:
        one = ResNetClassifier(bn_stat_stride=stride, dtype=torch.float64, **SMALL)
        one.load_state_dict(state)
        one.double()
        opt = torch.optim.Adam(one.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
        loss = float(tcli.train_step(one, opt, imgs, labels, mask, stats, False))
        grads = {k: p.grad.numpy() for k, p in one.named_parameters()}
        bufs = {k: b.numpy() for k, b in one.named_buffers()}
        for r in got:
            r_loss, r_grads, r_bufs = r[stride]
            assert r_loss == pytest.approx(loss, rel=1e-10)
            for want, have in ((grads, r_grads), (bufs, r_bufs)):
                assert set(want) == set(have)
                for k, w in want.items():
                    np.testing.assert_allclose(have[k], w, rtol=0,
                                               atol=1e-10 * max(np.abs(w).max(), 1e-30),
                                               err_msg=f"stride {stride} {k}")
