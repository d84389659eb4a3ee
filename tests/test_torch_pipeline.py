"""Pipeline parallelism in the port (med_tpu_torch/parallel/pipeline.py):
TeCNo's refinement stages one a rank over 2 and 4 spawned gloo ranks, M = 4
trials streaming through (med_tpu's tests/test_pipeline.py):

- the pipelined forward is the sequential stage chain's;
- two pipelined SGD steps (stage 0 on every rank, its gradient summed;
  each rank's stage by its own optimizer) equal two steps of the
  sequential chain: losses (rtol 1e-5) and every stage's weights, without
  dropout and with injected per-(stage, microbatch) masks;
- without dropout, med_tpu's ``make_pp_tecno_train_step`` on its mesh from
  the same weights gives the same losses and weights;
- with dropout at rates 0.5 and 0.3 on 2 ranks, so does med_tpu's step
  ``make_pp_tecno_train_step(mesh, tx, dropout_rate=r)``, its masks
  recomputed from its key (``_stage_dropout_mask``) and injected into the
  port: losses at rtol 1e-5, weights at rtol 1e-5, atol 1e-7 (med_tpu
  divides by 1 - r where the port multiplies by 1 / (1 - r): an ulp apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from med_tpu.parallel.pipeline import (_stage_dropout_mask, make_pp_tecno_train_step,
                                       shard_stage_params, stack_stage_params)
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.parallel import launch
from med_tpu_torch.train import losses
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.utils.jax_params import export_jax_params
from torch_rank_bodies import pipeline_cases

M, T, LR, STEPS = 4, 32, 0.05, 2
RATES = [0.5, 0.3]          # med_tpu's masks at each rate, on 2 ranks
KEY = 5


def _fields(n):
    return dict(model_name="TeCNo", dataset_type="frame", data_type="kinematics",
                out_features=2, mstcn_stages=n + 1, mstcn_layers=3, mstcn_f_maps=8)


def _jax_masks(n, rate):
    """med_tpu's pipeline masks of every (stage, microbatch) from its key,
    as uint8 (L, T, C)."""
    key = jax.random.key(KEY)
    return {(s, m): np.asarray(_stage_dropout_mask(key, s, m, 3, T, 8, rate), np.uint8)
            for s in range(n + 1) for m in range(M)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(M, T, 26)).astype(np.float32)
    labels = rng.integers(0, 2, (M, T))
    mask = (rng.random((M, T)) < 0.9).astype(np.float32)
    out = {}
    for n in (2, 4):
        exp = Experiment(ExperimentConfig(**_fields(n)), device="cpu")
        exp.init_weights(7)
        tree = export_jax_params(exp.net)
        masks = {(s, m): rng.integers(0, 2, (3, T, 8)).astype(np.uint8)
                 for s in range(n + 1) for m in range(M)}
        cases = [(_fields(n), tree, x, labels, mask, None, STEPS, LR),
                 (_fields(n), tree, x, labels, mask, masks, STEPS, LR)]
        if n == 2:
            cases += [(_fields(n), tree, x, labels, mask, _jax_masks(n, r), STEPS, LR, r)
                      for r in RATES]
        ranks = launch.spawn(pipeline_cases, n, str(tmp_path_factory.mktemp(f"pp{n}")),
                             args=(cases,), device="cpu")
        out[n] = (tree, masks, ranks)
    return x, labels, mask, out


def _sequential(n, tree, x, labels, mask, masks):
    """The whole chain on one rank: forward, then STEPS SGD steps."""
    exp = Experiment(ExperimentConfig(**_fields(n)), device="cpu")
    exp.load_params(tree)
    model = exp.net.model
    xt, yt, mt = map(torch.from_numpy, (x, labels, mask))
    with torch.no_grad():
        forward = model(xt).numpy()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    stage_masks = None if masks is None else {
        f"stage{s}": {"stack": torch.from_numpy(np.stack([masks[(s, m)] for m in range(M)], 1))}
        for s in range(n + 1)}
    out = []
    for _ in range(STEPS):
        opt.zero_grad()
        logits = model(xt, train=masks is not None, masks=stage_masks)
        loss = losses.tecno_stage_loss(logits, yt, mt)
        loss.backward()
        opt.step()
        out.append(float(loss.detach()))
    return forward, out, model


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_matches_the_sequential_chain(setup, n, dropout):
    x, labels, mask, out = setup
    tree, masks, ranks = out[n]
    forward, seq_losses, model = _sequential(n, tree, x, labels, mask,
                                             masks if dropout else None)
    for d, r in enumerate(ranks):
        got = r[int(dropout)]
        np.testing.assert_allclose(got["forward"], forward[d + 1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["losses"], seq_losses, rtol=1e-5)
        for name, want in (("stage0", model.stage0), ("stage", model.stages()[d + 1])):
            for k, v in want.state_dict().items():
                np.testing.assert_allclose(got[name][k], v.numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=f"{name}.{k}")


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_matches_med_tpu_on_its_mesh(setup, n):
    x, labels, mask, out = setup
    tree, _, ranks = out[n]
    params = jax.tree.map(jnp.asarray, tree["params"]["model"])
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    tx = optax.sgd(LR)
    stage0 = params["stage0"]
    stacked = shard_stage_params(stack_stage_params(params, n + 1), mesh)
    opt0, opt_r = tx.init(stage0), tx.init(stacked)
    step = make_pp_tecno_train_step(mesh, tx)
    jl = []
    for _ in range(STEPS):
        stage0, stacked, opt0, opt_r, loss = step(stage0, stacked, opt0, opt_r,
                                                  jnp.asarray(x), jnp.asarray(labels),
                                                  jnp.asarray(mask))
        jl.append(float(loss))
    for d, r in enumerate(ranks):
        np.testing.assert_allclose(r[0]["losses"], jl, rtol=1e-5)
        exp = Experiment(ExperimentConfig(**_fields(n)), device="cpu")
        stage = exp.net.model.stages()[d + 1]
        stage.load_state_dict({k: torch.from_numpy(v) for k, v in r[0]["stage"].items()})
        got = export_jax_params(exp.net)["params"]["model"][f"stage{d + 1}"]
        want = jax.device_get(jax.tree.map(functools.partial(lambda i, a: a[i], d), stacked))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("rate", RATES)
def test_pipeline_with_dropout_matches_med_tpu_on_its_mesh(setup, rate):
    x, labels, mask, out = setup
    n = 2
    tree, _, ranks = out[n]
    params = jax.tree.map(jnp.asarray, tree["params"]["model"])
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    tx = optax.sgd(LR)
    stage0 = params["stage0"]
    stacked = shard_stage_params(stack_stage_params(params, n + 1), mesh)
    opt0, opt_r = tx.init(stage0), tx.init(stacked)
    step = make_pp_tecno_train_step(mesh, tx, dropout_rate=rate)
    jl = []
    for _ in range(STEPS):
        stage0, stacked, opt0, opt_r, loss = step(stage0, stacked, opt0, opt_r,
                                                  jnp.asarray(x), jnp.asarray(labels),
                                                  jnp.asarray(mask), jax.random.key(KEY))
        jl.append(float(loss))
    for d, r in enumerate(ranks):
        got = r[2 + RATES.index(rate)]
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        exp = Experiment(ExperimentConfig(**_fields(n)), device="cpu")
        model = exp.net.model
        model.stage0.load_state_dict({k: torch.from_numpy(v) for k, v in got["stage0"].items()})
        model.stages()[d + 1].load_state_dict({k: torch.from_numpy(v)
                                               for k, v in got["stage"].items()})
        tree_got = export_jax_params(exp.net)["params"]["model"]
        want_stage = jax.device_get(jax.tree.map(functools.partial(lambda i, a: a[i], d),
                                                 stacked))
        for name, want in (("stage0", jax.device_get(stage0)), (f"stage{d + 1}", want_stage)):
            for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                                    jax.tree_util.tree_leaves(tree_got[name])):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                           err_msg=name + jax.tree_util.keystr(path))
