"""The port's COG (med_tpu_torch.models) against the JAX package's, on the
same weights carried over by med_tpu_torch.utils.jax_params.

The JAX COG runs twice: fused=True (its TCN Pallas kernels in interpret
mode) and use_pallas=False, fused=False (the plain XLA paths). Small
widths keep n_heads * d_q == d_model, as COG requires. Tolerance: rtol
1e-4, atol 1e-4 — float32 through ~15 layers summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.models.cog import COG as JaxCOG
from med_tpu.models.cog import ChainOfGestureTransformer as JaxCoT
from med_tpu_torch.models import init_weights
from med_tpu_torch.models.cog import COG, ChainOfGestureTransformer
from med_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

RTOL, ATOL = 1e-4, 1e-4
SMALL = dict(d_model=16, d_q=2, len_q=5)


def _load(net, variables):
    state, constants = load_jax_params(jax.device_get(dict(variables)), net)
    net.load_state_dict(state, strict=True)
    for name, value in constants.items():
        net.get_buffer(name).copy_(value)
    return net.eval()


def test_chain_of_gesture_matches_jax(rng):
    f_dim, gest_dim, T = 24, 32, 33
    gest = rng.normal(size=(15, gest_dim)).astype(np.float32)
    x = rng.normal(size=(T, f_dim)).astype(np.float32)
    jmod = JaxCoT(f_dim, gest_dim, n_heads=8, **SMALL)
    variables = jmod.init(jax.random.key(0), jnp.asarray(gest), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(gest), jnp.asarray(x))
    net = _load(ChainOfGestureTransformer(f_dim, gest_dim, n_heads=8, **SMALL), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(gest), torch.from_numpy(x))
    assert got.shape == (T, 15 * SMALL["d_model"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


COG_SMALL = dict(num_layers_basic=3, num_layers_r=2, num_r=2, f_maps=16,
                 f_dim=40, out_classes=2, **SMALL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("jax_kernels", [True, False])
def test_cog_matches_jax_all_tracks(rng, causal, jax_kernels):
    T = 80
    x = rng.normal(size=(1, T, COG_SMALL["f_dim"])).astype(np.float32)
    flags = (dict(fused=True) if jax_kernels
             else dict(use_pallas=False, fused=False))
    jmod = JaxCOG(causal=causal, **COG_SMALL, **flags)
    variables = jmod.init(jax.random.key(1), jnp.asarray(x))
    want_out, want_f = jmod.apply(variables, jnp.asarray(x))
    net = _load(COG(causal=causal, **COG_SMALL), variables)
    with torch.no_grad():
        got_out, got_f = net(torch.from_numpy(x))
    n_stages = 1 + COG_SMALL["num_r"]
    assert len(got_out) == len(want_out) == 2 * n_stages
    assert [t.shape[1] for t in got_out] == [T] * n_stages + [T // 16] * n_stages
    for g, w in zip(got_out + got_f, list(want_out) + list(want_f)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _cog_tree(rng):
    net = init_weights(COG(**COG_SMALL), torch.Generator().manual_seed(3))
    return net, export_jax_params(net)


def test_export_then_load_round_trips(rng):
    net, tree = _cog_tree(rng)
    state, constants = load_jax_params(tree, COG(**COG_SMALL))
    for key, value in net.state_dict().items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    torch.testing.assert_close(constants["gest_embed"], net.gest_embed, rtol=0, atol=0)


def test_exported_tree_matches_jax_param_tree(rng):
    """Same leaf paths and shapes as the JAX COG's own init."""
    _, tree = _cog_tree(rng)
    x = jnp.zeros((1, 32, COG_SMALL["f_dim"]))
    variables = jax.eval_shape(JaxCOG(**COG_SMALL).init, jax.random.key(0), x)
    flat = lambda t: {"/".join(str(k.key) for k in p): np.shape(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(tree) == flat(dict(variables))


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_load_jax_params_rejects_incomplete_trees(rng, fault):
    _, tree = _cog_tree(rng)
    params = tree["params"]
    if fault == "extra":
        params["cot"]["unused"] = {"kernel": np.zeros((2, 2), np.float32)}
    elif fault == "missing":
        del params["TCN"]["stack"]["w3"]
    else:
        params["latlayer1"]["Conv_0"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises((KeyError, ValueError)):
        load_jax_params(tree, COG(**COG_SMALL))


@pytest.mark.parametrize("padding", ["VALID", "SAME", [(4, 0)]])
def test_conv1d_tap_form_matches_jax(rng, padding):
    from med_tpu.models.layers import Conv1d as JaxConv1d
    from med_tpu_torch.models.layers import Conv1d

    x = rng.normal(size=(2, 19, 6)).astype(np.float32)
    jmod = JaxConv1d(5, kernel_size=3, dilation=2, padding=padding)
    variables = jmod.init(jax.random.key(2), jnp.asarray(x))
    net = _load(Conv1d(6, 5, kernel_size=3, dilation=2, padding=padding), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_single_stage_tcn_matches_jax_fused(rng):
    from med_tpu.models.layers import SingleStageTCN as JaxTCN
    from med_tpu_torch.models.layers import SingleStageTCN

    x = rng.normal(size=(1, 40, 12)).astype(np.float32)
    jmod = JaxTCN(4, 16, 3, fused=True)
    variables = jmod.init(jax.random.key(4), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    net = _load(SingleStageTCN(4, 12, 16, 3), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
