"""Sequence parallelism in the port (med_tpu_torch/parallel/seqpar.py,
sp_cog.py, sp_tsvn.py): one trial's time axis split over 2 and 4 spawned
gloo ranks, against the port's single-rank model and against med_tpu's SP
functions under shard_map on its CPU mesh (tests/test_seqpar.py,
test_sp_cog.py, test_sp_tsvn.py), with the same weights and injected
dropout masks:

- TeCNo and COG (channel and stack dropout; COG's encoder runs the packed
  attention op on every rank, its halo the enc_norm bias at the global
  edge): the loss (rtol 1e-5), the final track's logits, every gradient
  leaf to 1e-5 of its largest |value|;
- TransSVNet over its frozen TeCNo, a masked tail: in float64 on both
  sides (its LayerNorms over two classes keep only float32's last digits);
- TeCNo's ``sp_tecno_loss`` with dropout at rate 0.3 on 2 ranks against
  med_tpu's ``sp_tecno_loss(..., dropout_rate=0.3)`` with the same global
  Bernoulli(0.7) masks; both packages' ``make_sp_tecno_train_step`` refuse
  that rate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import optax

from med_tpu.parallel.seqpar import make_sp_tecno_train_step as jax_make_sp_tecno_train_step
from med_tpu.parallel.seqpar import sp_tecno_loss as jax_sp_tecno_loss
from med_tpu.parallel.sp_cog import sp_cog_loss as jax_sp_cog_loss
from med_tpu.parallel.sp_tsvn import sp_tsvn_loss as jax_sp_tsvn_loss
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.parallel import launch
from med_tpu_torch.parallel.seqpar import make_sp_tecno_train_step, sp_tecno_forward
from med_tpu_torch.train import losses
from med_tpu_torch.train.engine import Experiment, cog_loss
from med_tpu_torch.utils.jax_params import export_jax_params
from torch_rank_bodies import seqpar_suite

T = 128
RATE = 0.3                  # TeCNo's SP dropout away from 0.5, on 2 ranks
FIELDS = {
    "tecno": dict(model_name="TeCNo", dataset_type="frame", data_type="kinematics",
                  out_features=2, mstcn_stages=3, mstcn_layers=5, mstcn_f_maps=8),
    "cog": dict(model_name="COG", dataset_type="frame", data_type="kinematics",
                out_features=2, num_layers_Basic=4, num_layers_R=3, num_R=2,
                mstcn_f_maps=8, d_model=16, d_q=2, sequence_length=6),
    "tsvn": dict(model_name="TransSVNet", dataset_type="frame", data_type="kinematics",
                 out_features=2, mstcn_stages=2, mstcn_layers=3, mstcn_f_maps=8,
                 sequence_length=6),
}


def _close(got, want, name, frac=1e-5, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _case(kind, rng):
    """(fields, tree, x, labels, mask, whole-trial masks, frozen)."""
    fields = FIELDS[kind]
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.init_weights(3)
    tree = export_jax_params(exp.net)
    x = rng.normal(size=(T, 26)).astype(np.float32)
    labels = rng.integers(0, 2, T)
    mask = np.ones(T, np.float32)
    gen = torch.Generator().manual_seed(4)
    frozen = masks = None
    if kind == "tecno":
        masks = {k: v["stack"][:, 0].numpy() for k, v in
                 exp.net.model.dropout_masks(T, gen, 1).items()}
    elif kind == "cog":
        masks = {k: {"stack": v["stack"][:, 0].numpy(),
                     **({"channel": v["channel"].reshape(-1).numpy()} if "channel" in v
                        else {})}
                 for k, v in exp.net.model.dropout_masks(T, gen, 1).items()}
    else:
        mask[T - 9:] = 0.0
        tecno = Experiment(ExperimentConfig(**{**fields, "model_name": "TeCNo"}),
                           device="cpu")
        tecno.init_weights(5)
        frozen = {"tecno_params": export_jax_params(tecno.net)["params"]["model"]}
    return fields, tree, x, labels, mask, masks, frozen


def _single_rank(kind, fields, tree, x, labels, mask, masks, frozen):
    """The port's one-rank forward and backward on the whole trial."""
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    model = exp.net.model
    xt, yt, mt = torch.from_numpy(x)[None], torch.from_numpy(labels), torch.from_numpy(mask)
    if kind == "tecno":
        out = model(xt, train=True, masks={k: {"stack": torch.from_numpy(v)[:, None]}
                                           for k, v in masks.items()})
        loss, final = losses.tecno_stage_loss(out, yt, mt), out[-1][0]
    elif kind == "cog":
        port = {k: {"stack": torch.from_numpy(v["stack"])[:, None],
                    **({"channel": torch.from_numpy(v["channel"]).reshape(1, 1, -1)}
                       if "channel" in v else {})} for k, v in masks.items()}
        out, _ = model(xt, train=True, masks=port)
        loss, _ = cog_loss(exp.cfg, out, {"labels": yt, "mask": mt,
                                          "true_len": torch.tensor(T)})
        final = out[0][0]
    else:
        # the frozen TeCNo's float64 logits as SP's own TeCNo path makes them
        # on one rank (the TCN kernels' plain versions take float32 alone)
        exp.load_frozen(frozen)
        model.double()
        exp.frozen.double()
        with torch.no_grad():
            tecno = sp_tecno_forward(exp.frozen, xt[0].double(), None)[-1]
        final = model(tecno[None], xt.double())[0]
        loss = losses.soft_cross_entropy(final, losses.binary_targets(yt, final.dtype), mt)
    loss.backward()
    return {"loss": float(loss.detach()), "final": final.detach().numpy(),
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(17)
    return {kind: _case(kind, rng) for kind in FIELDS}


@pytest.fixture(scope="module")
def rate_case(cases):
    """TeCNo's case with global Bernoulli(1 - RATE) masks."""
    fields, tree, x, labels, mask, _, frozen = cases["tecno"]
    cfg = ExperimentConfig(**fields)
    rng = np.random.default_rng(23)
    masks = {f"stage{s}": (rng.random((cfg.mstcn_layers, T, cfg.mstcn_f_maps)) < 1 - RATE)
             .astype(np.uint8) for s in range(cfg.mstcn_stages)}
    return fields, tree, x, labels, mask, masks, frozen


@pytest.fixture(scope="module")
def ranks(cases, rate_case, tmp_path_factory):
    out = {}
    for n in (2, 4):
        args = [(kind, *case) for kind, case in cases.items()]
        if n == 2:
            args.append(("tecno", *rate_case, RATE))
        res = launch.spawn(seqpar_suite, n, str(tmp_path_factory.mktemp(f"sp{n}")),
                           args=(args,), device="cpu")
        out[n] = {kind: [r[k] for r in res] for k, kind in enumerate(cases)}
        if n == 2:
            out[n]["tecno at RATE"] = [r[len(cases)] for r in res]
    return out


def _grad_tree(kind, fields, grads):
    """Port gradients (by parameter name) as med_tpu's params tree."""
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    for k, p in exp.net.model.named_parameters():
        p.grad = torch.from_numpy(grads[k]).to(p.dtype)
    return _leaves(export_jax_params(exp.net, grads=True)["params"]["model"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", list(FIELDS))
def test_sp_step_matches_one_rank(cases, ranks, kind, n):
    want = _single_rank(kind, *cases[kind])
    tree_max = max(float(np.abs(g).max()) for g in want["grads"].values())
    for r in ranks[n][kind]:
        _close(r["loss"], want["loss"], "loss")
        _close(r["final"], want["final"], "final logits")
        for k, g in want["grads"].items():
            if _qk_leaf(kind, k):
                np.testing.assert_allclose(r["grads"][k], g, rtol=0, atol=1e-5 * tree_max,
                                           err_msg=k)
            else:
                _close(r["grads"][k], g, k)


def _qk_leaf(kind, name):
    """TransSVNet's W_Q/W_K leaves: its scores over two-class LayerNorm
    outputs put their gradients near 1e-17 of the tree's (its known trap),
    so they are held to the tree's largest gradient."""
    return kind == "tsvn" and ("W_Q" in name or "W_K" in name)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_tecno_train_step_is_sgd_on_the_one_rank_gradient(cases, ranks, n):
    """make_sp_tecno_train_step: the loss of its step and the weights it
    leaves are the one-rank gradient's SGD step (lr 0.1)."""
    fields, tree, *_ = cases["tecno"]
    want = _single_rank("tecno", *cases["tecno"])
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    for r in ranks[n]["tecno"]:
        _close(r["step_loss"], want["loss"], "step loss")
        for k, p in exp.net.model.named_parameters():
            np.testing.assert_allclose(r["stepped"][k], p.detach().numpy() - 0.1 * want["grads"][k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_sp_tecno_matches_med_tpu_on_its_mesh(cases, ranks):
    _check_sp_tecno(cases["tecno"], ranks[4]["tecno"][0], 4, 0.5)


def test_sp_tecno_with_dropout_at_rate_0_3_matches_med_tpu_on_its_mesh(rate_case, ranks):
    _check_sp_tecno(rate_case, ranks[2]["tecno at RATE"][0], 2, RATE)


def _check_sp_tecno(case, r, n, rate):
    """Rank 0's SP TeCNo loss and gradients ``r`` against med_tpu's
    ``sp_tecno_loss`` at ``rate`` on an n-device mesh, the same masks."""
    fields, tree, x, labels, mask, masks, _ = case
    cfg = ExperimentConfig(**fields)
    mk = np.stack([masks[f"stage{s}"] for s in range(cfg.mstcn_stages)])
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    fn = functools.partial(jax_sp_tecno_loss, num_stages=cfg.mstcn_stages, axis_name="data",
                           dropout_rate=rate)
    loss, grads = jax.jit(jax.shard_map(
        lambda p, x, y, m, k: jax.value_and_grad(fn)(p, x, y, m, masks=k), mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P(None, None, "data")),
        out_specs=(P(), P())))(tree["params"]["model"], x, labels, mask, mk)
    _close(r["loss"], loss, "loss")
    got = _grad_tree("tecno", fields, r["grads"])
    for path, w in _leaves(jax.device_get(grads)).items():
        _close(got[path], w, path, rtol=1e-4)


def test_sp_tecno_train_step_refuses_the_rates_med_tpus_refuses(cases):
    fields, tree, *_ = cases["tecno"]
    cfg = ExperimentConfig(**fields)
    exp = Experiment(cfg, device="cpu")
    opt = torch.optim.SGD(exp.net.model.parameters(), lr=0.1)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    for rate in (0.0, 0.5):
        make_sp_tecno_train_step(exp.net.model, opt, None, dropout_rate=rate)
        jax_make_sp_tecno_train_step(mesh, optax.sgd(0.1), num_stages=cfg.mstcn_stages,
                                     num_layers=cfg.mstcn_layers,
                                     channels=cfg.mstcn_f_maps, dropout_rate=rate)
    with pytest.raises(NotImplementedError, match="0.3"):
        make_sp_tecno_train_step(exp.net.model, opt, None, dropout_rate=RATE)
    with pytest.raises(NotImplementedError, match="0.3"):
        jax_make_sp_tecno_train_step(mesh, optax.sgd(0.1), num_stages=cfg.mstcn_stages,
                                     num_layers=cfg.mstcn_layers, channels=cfg.mstcn_f_maps,
                                     dropout_rate=RATE)


def test_sp_cog_matches_med_tpu_on_its_mesh(cases, ranks):
    fields, tree, x, labels, _, masks, _ = cases["cog"]
    cfg = ExperimentConfig(**fields)
    dp = {"ch_TCN": masks["TCN"]["channel"], "ch_fast": masks["fast_stage1"]["channel"],
          **{k: v["stack"] for k, v in masks.items()}}
    specs = {k: P() if k.startswith("ch_") else P(None, "data") for k in dp}
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    fn = functools.partial(jax_sp_cog_loss, num_r=cfg.num_R, len_q=cfg.sequence_length,
                           smooth_lambda=cfg.smooth_lambda, axis_name="data")
    loss, grads = jax.jit(jax.shard_map(
        lambda p, c, x, y, d: jax.value_and_grad(fn)(p, c, x, y, dropout=d), mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), specs), out_specs=(P(), P())))(
        tree["params"]["model"], tree["constants"]["model"], x, labels, dp)
    r = ranks[4]["cog"][0]
    _close(r["loss"], loss, "loss")
    got = _grad_tree("cog", fields, r["grads"])
    for path, w in _leaves(jax.device_get(grads)).items():
        _close(got[path], w, path, rtol=1e-4)


def test_sp_tsvn_matches_med_tpu_on_its_mesh_in_float64(cases, ranks):
    fields, tree, x, labels, mask, _, frozen = cases["tsvn"]
    cfg = ExperimentConfig(**fields)
    with jax.enable_x64(True):
        to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
        fn = functools.partial(jax_sp_tsvn_loss, num_stages=cfg.mstcn_stages,
                               len_q=cfg.sequence_length, f_maps=cfg.mstcn_f_maps,
                               axis_name="data")
        loss, grads = jax.jit(jax.shard_map(
            lambda p, f, x, y, m: jax.value_and_grad(fn)(p, f, x, y, m), mesh=mesh,
            in_specs=(P(), P(), P("data"), P("data"), P("data")), out_specs=(P(), P())))(
            to64(tree["params"]["model"]), to64(frozen["tecno_params"]),
            jnp.asarray(x, jnp.float64), labels, jnp.asarray(mask, jnp.float64))
        grads = jax.device_get(grads)
    r = ranks[4]["tsvn"][0]
    _close(r["loss"], loss, "loss")
    # med_tpu's SP TeCNo rounds its logits to float32 even under x64, a
    # rounding the two-class LayerNorms lift to ~4e-7 of a gradient
    got = _grad_tree("tsvn", fields, r["grads"])
    tree_max = max(float(np.abs(w).max()) for w in _leaves(grads).values())
    for path, w in _leaves(grads).items():
        if _qk_leaf("tsvn", path):
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5 * tree_max, err_msg=path)
        else:
            _close(got[path], w, path)
