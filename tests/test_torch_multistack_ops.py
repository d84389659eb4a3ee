"""The port's public op entry points, ``dilated_residual_multistack`` (the
stacks' weights concatenated on the layer axis) and the head-major
``sliding_window_attention``, against the JAX package's.

The kernel modules run their plain PyTorch versions here (CPU tensors); the
JAX side runs its Pallas kernels in interpret mode, as its own tests do, or
differentiates with ``jax.grad`` / ``jax.vjp``. The Pallas attention kernels
run with tile=32: the merged backward reads its W-1 extension frames from the
next tile, so it needs tile >= W - 1. Tolerance: rtol 1e-4 and atol 1e-5 *
max|want| per tensor, float32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.ops import attention as jatt
from med_tpu.ops import tcn_fused as jtcn
from med_tpu_torch import ops
from med_tpu_torch.ops import attention as tatt
from med_tpu_torch.ops import tcn_fused as ttcn

RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


def _multistack_inputs(rng, T, C, L0, Lr, S):
    """x, the concatenated weights at the model's init scale
    (U(±1/sqrt(fan_in))), a keep-mask and stage-output cotangents."""
    Lt = L0 + Lr * (S - 1)

    def u(shape, fan_in):
        return (rng.uniform(-1, 1, size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return dict(x=rng.normal(size=(T, C)).astype(np.float32),
                w3=u((Lt, 3, C, C), 3 * C), b3=u((Lt, C), 3 * C),
                w1=u((Lt, C, C), C), b1=u((Lt, C), C),
                mask=rng.integers(0, 2, size=(Lt, T, C)).astype(np.uint8),
                g=rng.normal(size=(S, T, C)).astype(np.float32))


SHAPES = [(40, 8, 3, 2, 3), (37, 16, 4, 3, 2), (24, 8, 5, 1, 1)]
WEIGHTS = ("x", "w3", "b3", "w1", "b1")


@pytest.mark.parametrize("T,C,L0,Lr,S", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_multistack_forward_matches_pallas_interpret(rng, T, C, L0, Lr, S, causal,
                                                     use_mask):
    a = _multistack_inputs(rng, T, C, L0, Lr, S)
    mask = a["mask"] if use_mask else None
    want = jtcn.dilated_residual_multistack(
        *(jnp.asarray(a[k]) for k in WEIGHTS), L0, Lr, causal=causal,
        mask=None if mask is None else jnp.asarray(mask), interpret=True)
    args = [_t(a[k]) for k in WEIGHTS]
    tmask = None if mask is None else _t(mask)
    got = ttcn.dilated_residual_multistack(*args, L0, Lr, causal=causal, mask=tmask)
    _close(got, want, "stage outputs")
    plain = ttcn.dilated_residual_multistack_plain(*args, L0, Lr, causal=causal,
                                                   mask=tmask)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert ttcn.dilated_residual_multistack.launches == 0


@pytest.mark.parametrize("T,C,L0,Lr,S", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_multistack_backward_matches_pallas_interpret_and_jax_grad(rng, T, C, L0, Lr, S,
                                                                   causal, use_mask):
    a = _multistack_inputs(rng, T, C, L0, Lr, S)
    mask = a["mask"] if use_mask else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)
    jargs = [jnp.asarray(a[k]) for k in WEIGHTS]
    # the saved activations of the JAX saving forward feed both backwards
    _, h_saved, y_saved = jtcn._multi_fwd_call(*jargs, jmask, causal=causal, L0=L0,
                                               Lr=Lr, save=True, interpret=True)
    want = jtcn._multi_bwd_call(jnp.asarray(a["g"]), h_saved, y_saved, jargs[1],
                                jargs[3], jmask, causal=causal, L0=L0, Lr=Lr,
                                interpret=True)
    got = ttcn.dilated_residual_multistack_bwd(
        _t(a["g"]), _t(h_saved), _t(y_saved), _t(a["w3"]), _t(a["w1"]), L0, Lr,
        causal=causal, mask=tmask)
    names = ("dx", "dw3", "db3", "dw1", "db1")
    for name, gt, w in zip(names, got, want):
        _close(gt, w, name)
    # the port's saving forward gives the same residuals
    _, ph, py = ttcn.dilated_residual_multistack_plain(
        *(_t(a[k]) for k in WEIGHTS), L0, Lr, causal=causal, mask=tmask, save=True)
    _close(ph, h_saved, "h_saved")
    _close(py, y_saved, "y_saved")

    # autograd through the dispatcher against jax.grad through the custom VJP
    def loss(*args):
        out = jtcn.dilated_residual_multistack(*args, L0, Lr, causal=causal,
                                               mask=jmask, interpret=True)
        return jnp.sum(out * jnp.asarray(a["g"]))
    want_auto = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    leaves = [_t(a[k]).requires_grad_() for k in WEIGHTS]
    out = ttcn.dilated_residual_multistack(*leaves, L0, Lr, causal=causal, mask=tmask)
    auto = torch.autograd.grad(out, leaves, _t(a["g"]))
    for name, gt, w in zip(names, auto, want_auto):
        _close(gt, w, "autograd " + name)
    assert ttcn.dilated_residual_multistack_bwd.launches == 0


def test_multistack_rejects_layer_counts_that_make_no_stages(rng):
    a = _multistack_inputs(rng, 16, 8, 3, 2, 2)
    args = [_t(a[k]) for k in WEIGHTS]
    with pytest.raises(ValueError, match="not stacks"):
        ttcn.dilated_residual_multistack(*args, 3, 3)
    with pytest.raises(ValueError, match="not stacks"):
        ttcn.dilated_residual_multistack(*args, 6, 2)


def _attention_inputs(rng, H, T, M, d):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((H, T, M, d), (H, T, d), (H, T, d), (H, T, M, d))]


ATTENTION = [(2, 40, 3, 4, 5), (8, 48, 15, 8, 30), (1, 70, 1, 8, 30)]


@pytest.mark.parametrize("H,T,M,d,W", ATTENTION)
def test_head_major_attention_matches_pallas_interpret(rng, H, T, M, d, W):
    q, k, v, _ = _attention_inputs(rng, H, T, M, d)
    want = jatt.sliding_window_attention_pallas(*map(jnp.asarray, (q, k, v)), W,
                                                tile=32, interpret=True)
    got = tatt.sliding_window_attention_pallas(*map(_t, (q, k, v)), W)
    _close(got, want, "out")
    _close(tatt.sliding_window_attention(*map(_t, (q, k, v)), W, use_pallas=False),
           jatt.sliding_window_attention_xla(*map(jnp.asarray, (q, k, v)), W), "gather form")
    assert tatt.sliding_window_attention_pallas.launches == 0


@pytest.mark.parametrize("H,T,M,d,W", ATTENTION)
def test_head_major_attention_backward_matches_pallas_interpret_and_jax_vjp(
        rng, H, T, M, d, W):
    q, k, v, g = _attention_inputs(rng, H, T, M, d)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    want = jatt.sliding_window_attention_bwd_pallas(jq, jk, jv, jg, W, tile=32,
                                                    interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jatt.sliding_window_attention_xla(a, b, c, W),
                     jq, jk, jv)
    want_vjp = vjp(jg)
    got = tatt.sliding_window_attention_bwd_pallas(*map(_t, (q, k, v, g)), W)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(tatt.sliding_window_attention(*leaves, W), leaves, _t(g))
    for name, gt, au, w, wv in zip(("dq", "dk", "dv"), got, auto, want, want_vjp):
        _close(gt, w, name + " vs the Pallas backward")
        _close(gt, wv, name + " vs jax.vjp of the gather form")
        torch.testing.assert_close(au, gt, rtol=0, atol=0)
    assert tatt.sliding_window_attention_bwd_pallas.launches == 0


def test_new_wrappers_are_counted_with_the_others():
    names = set(ops.launch_counts())
    assert {"dilated_residual_multistack", "dilated_residual_multistack_bwd",
            "sliding_window_attention_pallas",
            "sliding_window_attention_bwd_pallas"} <= names
    tatt.sliding_window_attention_pallas.launches = 3
    ops.reset_launch_counts()
    assert tatt.sliding_window_attention_pallas.launches == 0
