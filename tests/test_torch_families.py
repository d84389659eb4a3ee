"""The port's TeCNo and TransSVNet (med_tpu_torch.models.tcn,
med_tpu_torch.models.transsvnet) and what serves and drives them, against
the JAX package's, on the CPU at small sizes with the same numpy-seeded
inputs and weights:

- K1 and K3's plain versions at TransSVNet's head width d=2, m=W=30, 8
  heads, against med_tpu's packed Pallas kernels in interpret mode (tile 32)
  and against ``jax.vjp`` of its XLA path: forward within 1e-6, gradients
  within 1e-5 (rtol, and atol of the tensor's largest |value|);
- TeCNo (2 stages x 3 layers, f_maps 8) against ``TeCNo(fused=True)`` (its
  TCN Pallas kernels in interpret mode), in eval and in training with the
  same dropout masks injected into JAX through
  ``flax.linen.intercept_methods``; TransSVNet (packed) against med_tpu's,
  outputs and parameter gradients, for T below and above len_q: rtol 1e-4,
  atol 1e-5 of the largest |value| (float32 summed in another order);
- the two losses and the binary metrics; the weight trees both ways; the
  reference ``.pt`` importers; ``FrameModelServer(frozen=)``; the command
  line at a small size (TeCNo, then TransSVNet on that run), read by
  ``med_tpu.cli.results`` and served by med_tpu (probabilities 1e-5).
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


# the reference-style torch modules with the reference's state_dict keys
from test_torch_driver import _write_fold
from test_torch_port import RefMultiStage, ref_style_transsvnet, torch_forward_transsvnet

from med_tpu.cli import results as jresults
from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data import trials as jtrials
from med_tpu.eval.serving import FrameModelServer as JaxServer
from med_tpu.models.layers import ResidualStack as JaxResidualStack
from med_tpu.models.tcn import TeCNo as JaxTeCNo
from med_tpu.models.transsvnet import TransSVNet as JaxTransSVNet
from med_tpu.ops import attention as jatt
from med_tpu.train import checkpoint as jckpt
from med_tpu.train import losses as jlosses
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu.train.engine import _loss_for_family
from med_tpu.utils import torch_port as jport
from med_tpu_torch.cli import train_frame as tcli
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.eval.serving import FrameModelServer
from med_tpu_torch.models import build_model
from med_tpu_torch.models.tcn import TeCNo
from med_tpu_torch.models.transsvnet import TransSVNet
from med_tpu_torch.ops import attention as tatt
from med_tpu_torch.train import checkpoint as tckpt
from med_tpu_torch.train import losses as tlosses
from med_tpu_torch.train.engine import FrameNet, binary_frame_loss
from med_tpu_torch.utils import torch_port as tport
from med_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

RTOL = 1e-4


def _close(got, want, name="", rtol=RTOL, atol_frac=1e-5):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _loaded(module, params):
    """``module`` with med_tpu's params tree loaded (every leaf consumed)."""
    state, _ = load_jax_params({"params": params}, module)
    module.load_state_dict(state, strict=True)
    return module


# ------------------------------------------------- K1, K3 at head width 2
H2, D2, M2, W2 = 8, 2, 30, 30       # TransSVNet's encoder: 8 heads, d = classes


@pytest.mark.parametrize("T", [9, 47])
def test_packed_attention_at_head_width_2_matches_pallas_and_xla(rng, T):
    N = T * M2
    q, k, v, g = (rng.normal(size=s).astype(np.float32)
                  for s in ((H2, D2, N), (H2, D2, T), (H2, D2, T), (H2, D2, N)))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    pal_out, pal_stats = jatt.sliding_window_attention_packed_fwd(
        jq, jk, jv, W2, M2, tile=32, interpret=True, return_stats=True)
    xla_out, vjp = jax.vjp(
        lambda a, b, c: jatt.sliding_window_attention_packed(a, b, c, W2, M2,
                                                             use_pallas=False), jq, jk, jv)
    pal_grads = jatt.sliding_window_attention_packed_bwd(
        jq, jk, jv, jg, pal_out, pal_stats, W2, M2, tile=32, interpret=True)
    xla_grads = vjp(jg)

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, stats = tatt.sliding_window_attention_packed_plain(tq, tk, tv, W2, M2)
    for name, want in (("vs Pallas", pal_out), ("vs XLA", xla_out)):
        _close(out, want, f"out {name}", rtol=1e-6, atol_frac=1e-6)
    _close(stats, pal_stats, "stats", rtol=1e-6, atol_frac=1e-6)
    grads = tatt.sliding_window_attention_packed_bwd_plain(tq, tk, tv, tg, out, stats,
                                                           W2, M2)
    # the Pallas backward returns dk, dv (H, T, d); the packed contract is (H, d, T)
    pal = (pal_grads[0], np.swapaxes(pal_grads[1], 1, 2), np.swapaxes(pal_grads[2], 1, 2))
    for name, got, p, x in zip(("dq", "dk", "dv"), grads, pal, xla_grads):
        _close(got, p, f"{name} vs Pallas", rtol=1e-5)
        _close(got, x, f"{name} vs jax.vjp", rtol=1e-5)

    # autograd through the op runs the same plain backward
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tatt.sliding_window_attention_packed(*leaves, W2, M2),
                               leaves, tg)
    for a, b in zip(auto, grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ TeCNo
S, L, FM, DIM, NC = 2, 3, 8, 12, 2


def _jax_tecno_params(seed=0, T=40):
    model = JaxTeCNo(num_stages=S, num_layers=L, f_maps=FM, in_dim=DIM, out_classes=NC,
                     fused=True)
    return model, model.init(jax.random.key(seed), jnp.zeros((1, T, DIM)))["params"]


def _mask_interceptor(masks):
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JaxResidualStack) and context.method_name == "dropout_mask":
            return jnp.asarray(masks[mod.path[-2]]["stack"])
        return next_fun(*args, **kwargs)
    return interceptor


def _tecno_masks(rng, T, B=1):
    return {f"stage{s}": {"stack": rng.integers(0, 2, size=(L, B, T, FM)).astype(np.uint8)}
            for s in range(S)}


def test_tecno_matches_jax_in_eval(rng):
    jmodel, params = _jax_tecno_params()
    x = rng.normal(size=(1, 40, DIM)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    net = _loaded(TeCNo(S, L, FM, DIM, NC), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (S, 1, 40, NC)
    _close(got, want)


def test_tecno_training_forward_and_gradients_match_jax_with_injected_masks(rng):
    T = 40
    jmodel, params = _jax_tecno_params(seed=1, T=T)
    x = rng.normal(size=(1, T, DIM)).astype(np.float32)
    gout = rng.normal(size=(S, 1, T, NC)).astype(np.float32)
    masks = _tecno_masks(rng, T)

    def f(p):
        with nn.intercept_methods(_mask_interceptor(masks)):
            out = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                               rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * gout), out

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(params)
    net = _loaded(TeCNo(S, L, FM, DIM, NC), params)
    tmasks = {n: {"stack": torch.from_numpy(m["stack"])} for n, m in masks.items()}
    got = net(torch.from_numpy(x), train=True, masks=tmasks)
    _close(got, want, "stage logits")
    (got * torch.from_numpy(gout)).sum().backward()
    got_g = _leaves(export_jax_params(net, grads=True)["params"])
    want_g = _leaves(jax.device_get(want_g))
    assert set(got_g) == set(want_g) and len(want_g) == S * 8
    for path, w in want_g.items():
        _close(got_g[path], w, path)


def test_tecno_dropout_masks_have_cogs_layout():
    net = TeCNo(S, L, FM, DIM, NC)
    a = net.dropout_masks(70, torch.Generator().manual_seed(3))
    b = net.dropout_masks(70, torch.Generator().manual_seed(3))
    assert set(a) == {"stage0", "stage1"} and set(a["stage0"]) == {"stack"}
    assert a["stage1"]["stack"].shape == (L, 1, 70, FM)
    assert a["stage1"]["stack"].dtype == torch.uint8
    for n in a:
        torch.testing.assert_close(a[n]["stack"], b[n]["stack"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="masks or a generator"):
        net(torch.zeros(1, 8, DIM), train=True)


# ------------------------------------------------------------- TransSVNet
TF, TIN, LEN_Q = 8, 12, 30


def _jax_tsvn(T, seed=0):
    model = JaxTransSVNet(f_maps=TF, out_classes=NC, len_q=LEN_Q, in_dim=TIN)
    params = model.init(jax.random.key(seed), jnp.zeros((1, T, NC)),
                        jnp.zeros((1, T, TIN)))["params"]
    return model, params


def _f64_grads(jmodel, params, inputs, gout):
    """jax.grad of sum(out * gout) in float64. TransSVNet's gradients pass
    through LayerNorms over 2 features, whose float32 backward keeps ~2
    digits (models/transsvnet.py); the port takes them in float64, so its
    float32 gradients are held to med_tpu's in float64."""
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        args = [jnp.asarray(a, jnp.float64) for a in inputs]
        return jax.device_get(jax.grad(
            lambda p: jnp.sum(jmodel.apply({"params": p}, *args) * gout))(p64))


@pytest.mark.parametrize("T", [20, 45])
def test_transsvnet_outputs_and_gradients_match_jax(rng, T):
    """T below and above len_q = 30: the first frames' windows are mostly
    zero pad; the packed encoder (K1's plain version) against med_tpu's
    packed encoder; gradients against its float64 ones (:func:`_f64_grads`)."""
    jmodel, params = _jax_tsvn(T, seed=T)
    logits = rng.normal(size=(1, T, NC)).astype(np.float32)
    feats = rng.normal(size=(1, T, TIN)).astype(np.float32)
    gout = rng.normal(size=(1, T, NC)).astype(np.float32)

    want = jmodel.apply({"params": params}, jnp.asarray(logits), jnp.asarray(feats))
    want_g = _f64_grads(jmodel, params, (logits, feats), gout)
    net = _loaded(TransSVNet(TF, NC, LEN_Q, TIN), params)
    got = net(torch.from_numpy(logits), torch.from_numpy(feats))
    _close(got, want, "output")
    (got * torch.from_numpy(gout)).sum().backward()
    got_g = _leaves(export_jax_params(net, grads=True)["params"])
    want_g = _leaves(jax.device_get(want_g))
    assert set(got_g) == set(want_g) and len(want_g) == 13
    for path, w in want_g.items():
        _close(got_g[path], w, path)

    # the windows' own attention (the plain method) gives the same numbers
    net.encode = net.encode_windows
    with torch.no_grad():
        _close(net(torch.from_numpy(logits), torch.from_numpy(feats)), want, "windows")


def test_transsvnet_keys_are_one_contiguous_tensor_per_head(rng, monkeypatch):
    """The packed encoder hands K1 contiguous (H, d, T) keys that repeat the
    sequence per head, queries (H, d, T*W) and the window arguments W, W."""
    seen = {}
    real = tatt.sliding_window_attention_packed

    def spy(q, k, v, window, m):
        seen.update(q=q, k=k, v=v, window=window, m=m)
        return real(q, k, v, window, m)

    from med_tpu_torch.models import transsvnet as tsv
    monkeypatch.setattr(tsv, "sliding_window_attention_packed", spy)
    net = TransSVNet(TF, NC, LEN_Q, TIN)
    x = torch.from_numpy(rng.normal(size=(33, NC)).astype(np.float32))
    net.enc_attn0.self_window_packed(x, LEN_Q)
    assert seen["window"] == seen["m"] == LEN_Q
    assert seen["q"].shape == (8, NC, 33 * LEN_Q) and seen["q"].is_contiguous()
    assert seen["k"].shape == seen["v"].shape == (8, NC, 33)
    assert seen["k"].is_contiguous() and seen["v"].is_contiguous()
    for h in range(8):
        torch.testing.assert_close(seen["k"][h], x.T, rtol=0, atol=0)


# ------------------------------------------------------------ losses
def test_soft_cross_entropy_and_tecno_stage_loss_match_jax(rng):
    stage_logits = rng.normal(size=(3, 1, 50, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 50)
    mask = (rng.random(50) > 0.3).astype(np.float32)
    targets = np.stack([1.0 - labels, labels], -1).astype(np.float32)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        _close(tlosses.soft_cross_entropy(torch.from_numpy(stage_logits[0]),
                                          torch.from_numpy(targets), tm),
               jlosses.soft_cross_entropy(jnp.asarray(stage_logits[0]),
                                          jnp.asarray(targets), jm))
        _close(tlosses.tecno_stage_loss(torch.from_numpy(stage_logits),
                                        torch.from_numpy(labels), tm),
               jlosses.tecno_stage_loss(jnp.asarray(stage_logits), jnp.asarray(labels), jm))


@pytest.mark.parametrize("family", ["tecno", "tsvn"])
def test_binary_frame_loss_matches_jax_loss_for_family(rng, family):
    Tpad, true_len = 64, 45
    shape = (2, 1, Tpad, 2) if family == "tecno" else (1, Tpad, 2)
    out = rng.normal(size=shape).astype(np.float32)
    batch = {"labels": rng.integers(0, 2, Tpad),
             "mask": (np.arange(Tpad) < true_len).astype(np.float32)}
    model_name = {"tecno": "TeCNo", "tsvn": "TransSVNet"}[family]
    want_loss, want = _loss_for_family(
        JaxConfig(model_name=model_name, dataset_type="frame", out_features=2), family,
        jnp.asarray(out), {k: jnp.asarray(v) for k, v in batch.items()}, {})
    got_loss, got = binary_frame_loss(family, torch.from_numpy(out),
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got_loss, want_loss, "loss")
    assert set(got) == set(want) == {"cm", "probs", "preds"}
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(want["preds"]))
    _close(got["probs"], want["probs"], "probs")


# -------------------------------------------------------- weight trees
@pytest.mark.parametrize("model_name, video_dims", [("TeCNo", 2048), ("TeCNo", 32),
                                                    ("TransSVNet", 2048)])
def test_weight_trees_round_trip_through_the_port(model_name, video_dims):
    """med_tpu's Experiment tree (model, and fe where the config has one)
    fills every port parameter and comes back leaf for leaf."""
    fields = dict(model_name=model_name, dataset_type="frame", data_type="video",
                  video_dims=video_dims, out_features=2, mstcn_layers=3, mstcn_f_maps=8,
                  sequence_length=LEN_Q)
    jcfg = JaxConfig(**fields)
    jexp = JaxExperiment(jcfg)
    batch = {"images": jnp.zeros((1, 64, 2048)), "labels": jnp.zeros(64, jnp.int32),
             "mask": jnp.ones(64), "tecno_logits": jnp.zeros((1, 64, 2))}
    frozen = None
    if model_name == "TransSVNet":
        frozen = {"tecno_params": _jax_tecno_like(jcfg)}
    tree = jax.device_get(jexp.init_state(jax.random.key(2), batch, frozen=frozen).params)
    cfg = ExperimentConfig(**fields)
    net = FrameNet(build_model(cfg), None)
    if cfg.uses_feature_extractor():
        from med_tpu_torch.models import build_feature_extractor
        net = FrameNet(build_model(cfg), build_feature_extractor(cfg))
    state, constants = load_jax_params({"params": tree}, net)
    net.load_state_dict(state, strict=True)
    assert constants == {}
    back = _leaves(export_jax_params(net)["params"])
    want = _leaves(tree)
    assert set(back) == set(want) and (("fe/out/kernel" in want) == (video_dims != 2048))
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=path)
    with pytest.raises(KeyError, match="no port parameter"):
        load_jax_params({"params": {**tree, "extra": {"kernel": np.zeros(2)}}}, net)


def _jax_tecno_like(jcfg):
    model = JaxTeCNo(num_stages=jcfg.mstcn_stages, num_layers=jcfg.mstcn_layers,
                     f_maps=jcfg.mstcn_f_maps, in_dim=jcfg.in_features(),
                     out_classes=jcfg.out_features)
    return jax.device_get(model.init(jax.random.key(5),
                                     jnp.zeros((1, 64, jcfg.in_features())))["params"])


# ------------------------------------------------- reference importers
def test_tecno_importer_matches_jax_and_the_reference(tmp_path, rng):
    torch.manual_seed(1)
    oracle = RefMultiStage(S, L, FM, DIM, 3).eval()
    x = rng.normal(size=(1, 40, DIM)).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.tensor(x).permute(0, 2, 1)).numpy().transpose(0, 1, 3, 2)
    path = str(tmp_path / "best_model_LOSO_1Out.pt")
    torch.save({"feature_extractor": None, "model": oracle.state_dict()}, path)
    want = jport.import_reference_checkpoint(path, "TeCNo")
    got = tport.import_reference_checkpoint(path, "TeCNo")
    assert set(_leaves(got)) == set(_leaves(want))
    for p, w in _leaves(want).items():
        np.testing.assert_array_equal(_leaves(got)[p], w, err_msg=p)
    net = _loaded(TeCNo(S, L, FM, DIM, 3), got["params"]["model"])
    with torch.no_grad():
        _close(net(torch.from_numpy(x)), ref, "vs the reference")
    via_ckpt = tckpt.load_best_checkpoint(str(tmp_path), "LOSO", "1Out", model_name="TeCNo")
    assert set(_leaves(via_ckpt)) == set(_leaves(want))


def test_transsvnet_importer_matches_jax_and_the_reference(tmp_path, rng):
    torch.manual_seed(2)
    C, T = 3, 41
    oracle = ref_style_transsvnet(TF, C, TIN).eval()
    logits = rng.normal(size=(1, T, C)).astype(np.float32)
    feats = rng.normal(size=(1, T, TIN)).astype(np.float32)
    ref = torch_forward_transsvnet(oracle, logits, feats, LEN_Q)
    path = str(tmp_path / "best_model_LOSO_1Out.pt")
    torch.save({"feature_extractor": None, "model": oracle.state_dict()}, path)
    want = jport.import_reference_checkpoint(path, "TransSVNet")
    got = tport.import_reference_checkpoint(path, "TransSVNet")
    assert set(_leaves(got)) == set(_leaves(want))
    for p, w in _leaves(want).items():
        np.testing.assert_array_equal(_leaves(got)[p], w, err_msg=p)
    net = _loaded(TransSVNet(TF, C, LEN_Q, TIN), got["params"]["model"])
    with torch.no_grad():
        _close(net(torch.from_numpy(logits), torch.from_numpy(feats)), ref,
               "vs the reference")


# ------------------------------------------------------------- serving
SERVE = dict(dataset_type="frame", data_type="video", out_features=2, mstcn_layers=3,
             mstcn_f_maps=8, sequence_length=LEN_Q)


def _port_cfg(jcfg):
    import dataclasses
    return ExperimentConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(ExperimentConfig)})


@pytest.mark.parametrize("model_name, video_dims", [("TeCNo", 32), ("TransSVNet", 2048)])
def test_frame_server_with_frozen_matches_jax(tmp_path, rng, model_name, video_dims):
    """One checkpoint file written by med_tpu (and, for TransSVNet, a frozen
    TeCNo tree), served by both packages: T=120, not a bucket multiple."""
    jcfg = JaxConfig(model_name=model_name, video_dims=video_dims, **SERVE)
    frozen = ({"tecno_params": _jax_tecno_like(jcfg)} if model_name == "TransSVNet"
              else None)
    batch = {"images": jnp.zeros((1, 256, 2048)), "labels": jnp.zeros(256, jnp.int32),
             "mask": jnp.ones(256), "tecno_logits": jnp.zeros((1, 256, 2))}
    state = jax.device_get(JaxExperiment(jcfg).init_state(jax.random.key(3), batch,
                                                          frozen=frozen))
    jckpt.save_checkpoint(str(tmp_path / "best_model_LOSO_1Out.npz"), state.params)
    stats = {"kinematics": {"mean": rng.normal(size=26).astype(np.float32),
                            "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}}
    T = 120
    images = rng.normal(size=(T, 2048)).astype(np.float32)
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    ckpt = jckpt.load_checkpoint(str(tmp_path / "best_model_LOSO_1Out.npz"))
    want_p, want_pr = JaxServer(jcfg, ckpt, stats=stats, frozen=frozen).predict_trial(
        images, kin)
    server = FrameModelServer(_port_cfg(jcfg),
                              tckpt.load_best_checkpoint(str(tmp_path), "LOSO", "1Out"),
                              stats=stats, frozen=frozen, device="cpu")
    got_p, got_pr = server.predict_trial(images, kin)
    assert got_p.shape == got_pr.shape == (T,)
    np.testing.assert_allclose(got_pr, np.asarray(want_pr), rtol=0, atol=1e-5)
    sure = np.abs(got_pr - 0.5) > 1e-5
    np.testing.assert_array_equal(got_p[sure], np.asarray(want_p)[sure])


def test_transsvnet_without_its_frozen_stage_raises(tmp_path):
    cfg = ExperimentConfig(model_name="TransSVNet", **SERVE, video_dims=2048)
    from med_tpu_torch.train.engine import Experiment
    exp = Experiment(cfg, device="cpu")
    tree = export_jax_params(exp.net)
    server = FrameModelServer(cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="frozen TeCNo"):
        server.predict_trial(np.zeros((10, 2048), np.float32), np.zeros((10, 26), np.float32))
    with pytest.raises(ValueError, match="TransSVNet"):
        Experiment(ExperimentConfig(model_name="TeCNo", **SERVE), device="cpu").load_frozen(
            {"tecno_params": {}})


# ---------------------------------------------------------------- CLI
FAMILY_FLAGS = ("--device", "cpu", "--mstcn-layers", "3", "--mstcn-f-maps", "8",
                "--n-epochs", "2", "--folds", "1Out,2Out")


@pytest.fixture(scope="module")
def family_folds(tmp_path_factory):
    rng = np.random.default_rng(13)
    root = tmp_path_factory.mktemp("family_folds")
    for i, out in enumerate(("1Out", "2Out")):
        _write_fold(str(root / out), rng, n_trials=3 + i)
    return str(root)


@pytest.fixture(scope="module")
def family_runs(family_folds, tmp_path_factory):
    """The defaults (TeCNo), then TransSVNet on that run."""
    runs = str(tmp_path_factory.mktemp("family_runs"))
    base = ["--data-root", family_folds, "--runs-root", runs, *FAMILY_FLAGS]
    tecno = tcli.main(base)
    tsvn = tcli.main([*base, "--model-name", "TransSVNet",
                      "--run-id", tecno[1].run_id])
    return tecno, tsvn, runs


def test_cli_defaults_run_tecno_then_transsvnet_on_its_run(family_runs, capsys):
    (t_res, t_tracker), (s_res, s_tracker), runs = family_runs
    assert t_tracker.dir == os.path.join(runs, "TeCNo_5Hz_video", t_tracker.run_id)
    assert s_tracker.dir == os.path.join(runs, "TransSVNet_5Hz_video", s_tracker.run_id)
    for tracker, results, name in ((t_tracker, t_res, "TeCNo"), (s_tracker, s_res,
                                                                  "TransSVNet")):
        assert set(results) == {"1Out", "2Out"}
        params = json.load(open(os.path.join(tracker.dir, "params.json")))
        assert (params["model_name"], params["data_type"], params["video_dims"],
                params["out_features"], params["mstcn_layers"]) == \
            (name, "video", 2048, 2, 3)
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
            assert np.isfinite(results[out]["train_loss"])
        want.append("images/LOSO_Test_Confusion_Matrix_global.png")
        assert files == sorted(want)
    assert json.load(open(os.path.join(s_tracker.dir, "params.json")))["run_id"] == \
        t_tracker.run_id
    jresults.main(["table", "--runs-root", runs, "--folds", "1Out,2Out",
                   "--run", f"tecno={t_tracker.run_id}", "--run", f"tsvn={s_tracker.run_id}"])
    out = capsys.readouterr().out
    assert "tecno" in out and "tsvn" in out and "±" in out


def test_cli_checkpoints_served_by_jax_give_the_ports_predictions(family_runs,
                                                                   family_folds):
    (_, t_tracker), (s_res, s_tracker), _ = family_runs
    params = json.load(open(os.path.join(s_tracker.dir, "params.json")))
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()
                        if k not in ("window_size", "stride", "in_features")})
    for out in ("1Out", "2Out"):
        fold = os.path.join(family_folds, out)
        tecno = jckpt.load_best_checkpoint(os.path.join(t_tracker.dir, "checkpoints"),
                                           "LOSO", out)
        tree = jckpt.load_best_checkpoint(os.path.join(s_tracker.dir, "checkpoints"),
                                          "LOSO", out)
        trial = jtrials.load_fold_trials(fold, "test.csv")[0]
        preds, probs = JaxServer(jcfg, tree, stats=jtrials.load_fold_stats(fold),
                                 frozen={"tecno_params": tecno["params"]["model"]}
                                 ).predict_trial(trial.image_feats, trial.kinematics)
        best = s_res[out]
        np.testing.assert_allclose(best["probs"], np.asarray(probs), rtol=0, atol=1e-5)
        sure = np.abs(best["probs"] - 0.5) > 1e-5
        np.testing.assert_array_equal(best["preds"][sure], np.asarray(preds)[sure])


def test_cli_transsvnet_with_an_unknown_run_id_writes_nothing(family_folds, tmp_path):
    with pytest.raises(FileNotFoundError, match="nope"):
        tcli.main(["--data-root", family_folds, "--runs-root", str(tmp_path),
                   *FAMILY_FLAGS, "--model-name", "TransSVNet", "--run-id", "nope"])
    assert os.listdir(tmp_path) == []
