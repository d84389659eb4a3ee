"""The port's backward operators against the JAX package's.

The kernel modules run their plain PyTorch backwards here (CPU tensors);
the JAX side runs its Pallas backward kernels in interpret mode, as its own
tests do, or differentiates them with ``jax.vjp``. Tolerance: rtol 1e-4
and atol 1e-5 * max|want| per tensor — float32 on both sides, with weight
gradients summed over T in another order.
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
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


def _attention_inputs(rng, H, d, m, T):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m))]


@pytest.mark.parametrize("H,d,m,W,T", [(2, 4, 3, 5, 40), (8, 8, 15, 30, 48)])
def test_swa_packed_bwd_matches_pallas_interpret(rng, H, d, m, W, T):
    q, k, v, g = _attention_inputs(rng, H, d, m, T)
    # the Pallas backward reads its W-1 extension frames from the next tile,
    # so it needs tile >= W - 1
    tile = 16 if W - 1 <= 16 else 32
    out, stats = jatt.sliding_window_attention_packed_fwd(
        *map(jnp.asarray, (q, k, v)), W, m, tile=tile, interpret=True,
        return_stats=True)
    want = jatt.sliding_window_attention_packed_bwd(
        *map(jnp.asarray, (q, k, v, g)), out, stats, W, m, tile=tile,
        interpret=True)
    got = tatt.sliding_window_attention_packed_bwd(
        *map(_t, (q, k, v, g, out, stats)), W, m)
    # the JAX kernel returns dk/dv (H, T, d); the packed contract is (H, d, T)
    for name, gt, w in zip(("dq", "dk", "dv"), got,
                           (want[0], np.swapaxes(want[1], 1, 2),
                            np.swapaxes(want[2], 1, 2))):
        assert gt.shape == w.shape
        _close(gt, w, name)
    assert tatt.sliding_window_attention_packed_bwd.launches == 0


def test_swa_packed_autograd_matches_autograd_of_plain_forward(rng):
    H, d, m, W, T = 2, 4, 3, 5, 17
    arrays = _attention_inputs(rng, H, d, m, T)
    g = _t(arrays[3])
    grads = []
    for fn in (lambda q, k, v: tatt.sliding_window_attention_packed(q, k, v, W, m),
               lambda q, k, v: tatt.sliding_window_attention_packed_plain(q, k, v, W, m)[0]):
        q, k, v = (_t(a).requires_grad_() for a in arrays[:3])
        fn(q, k, v).backward(g)
        grads.append([t.grad for t in (q, k, v)])
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        _close(got, want.numpy(), name)


def _stack_inputs(rng, L, T, C):
    """Weights at the model's init scale, U(±1/sqrt(fan_in))."""
    def u(shape, fan_in):
        return (rng.uniform(-1, 1, size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return (u((L, 3, C, C), 3 * C), u((L, C), 3 * C), u((L, C, C), C), u((L, C), C),
            rng.integers(0, 2, size=(L, T, C)).astype(np.uint8))


def _torch_grads(fn, x, weights, cotangent):
    """Gradients of <fn(x, weights), cotangent> through the port's autograd
    Function: (dx, [dw3, db3, dw1, db1] per stage)."""
    xt = _t(x).requires_grad_()
    wt = [[_t(a).requires_grad_() for a in w] for w in weights]
    fn(xt, wt).backward(_t(cotangent))
    return xt.grad, [[a.grad for a in w] for w in wt]


# T=20 < 2 * 2**(L-1) = 32: the widest taps fall wholly outside the sequence
@pytest.mark.parametrize("L,T", [(3, 48), (5, 20)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_dilated_residual_stack_bwd_matches_jax_vjp(rng, L, T, causal, use_mask):
    C = 8
    x = rng.normal(size=(T, C)).astype(np.float32)
    w3, b3, w1, b1, mask = _stack_inputs(rng, L, T, C)
    m = mask if use_mask else None
    g = rng.normal(size=(T, C)).astype(np.float32)

    def jfn(x, w3, b3, w1, b1):
        return jtcn.dilated_residual_stack(
            x, w3, b3, w1, b1, causal=causal,
            mask=None if m is None else jnp.asarray(m), interpret=True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, w3, b3, w1, b1)))
    want = vjp(jnp.asarray(g))
    dx, (dws,) = _torch_grads(
        lambda xt, wt: ttcn.dilated_residual_stack(
            xt, *wt[0], causal=causal, mask=None if m is None else _t(m)),
        x, [(w3, b3, w1, b1)], g)
    for name, got, w in zip(("dx", "dw3", "db3", "dw1", "db1"), [dx, *dws], want):
        _close(got, w, name)
    assert ttcn.dilated_residual_stack_bwd.launches == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_multistack_stages_bwd_matches_jax_vjp(rng, causal, use_mask):
    C, T, S, L0, Lr = 8, 48, 4, 3, 2
    x = rng.normal(size=(T, C)).astype(np.float32)
    stages = [_stack_inputs(rng, L0 if s == 0 else Lr, T, C) for s in range(S)]
    ws = [st[:4] for st in stages]
    masks = [st[4] for st in stages] if use_mask else None
    g = rng.normal(size=(S, T, C)).astype(np.float32)

    def jfn(x, jws):
        return jtcn.dilated_residual_multistack_stages(
            x, jws, L0, Lr, causal=causal,
            masks=None if masks is None else [jnp.asarray(mk) for mk in masks],
            interpret=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(x), [tuple(map(jnp.asarray, w)) for w in ws])
    want_dx, want_dws = vjp(jnp.asarray(g))
    dx, dws = _torch_grads(
        lambda xt, wt: ttcn.dilated_residual_multistack_stages(
            xt, wt, L0, Lr, causal=causal,
            masks=None if masks is None else [_t(mk) for mk in masks]),
        x, ws, g)
    _close(dx, want_dx, "dx")
    for s in range(S):
        for name, got, w in zip(("dw3", "db3", "dw1", "db1"), dws[s], want_dws[s]):
            _close(got, w, f"stage {s} {name}")
    assert ttcn.dilated_residual_multistack_stages_bwd.launches == 0


def test_multistack_bwd_from_jax_residuals_matches_pallas_interpret(rng):
    """The backward function alone, fed the JAX kernel's own saved h and y."""
    C, T, S, L0, Lr = 8, 40, 3, 3, 2
    x = rng.normal(size=(T, C)).astype(np.float32)
    stages = [_stack_inputs(rng, L0 if s == 0 else Lr, T, C) for s in range(S)]
    jws = tuple(tuple(map(jnp.asarray, st[:4])) for st in stages)
    jmasks = tuple(jnp.asarray(st[4]) for st in stages)
    _, h_saved, y_saved = jtcn._multi_fwd_call_s(
        jnp.asarray(x), jws, jmasks, causal=True, L0=L0, Lr=Lr, save=True,
        interpret=True)
    g = rng.normal(size=(S, T, C)).astype(np.float32)
    want_dx, want_dws = jtcn._multi_bwd_call_s(
        jnp.asarray(g), h_saved, y_saved, jws, jmasks, causal=True, L0=L0,
        Lr=Lr, interpret=True)
    dx, dws = ttcn.dilated_residual_multistack_stages_bwd(
        _t(g), _t(h_saved), _t(y_saved), [tuple(map(_t, st[:4])) for st in stages],
        L0, Lr, causal=True, masks=[_t(st[4]) for st in stages])
    _close(dx, want_dx, "dx")
    for s in range(S):
        for name, got, w in zip(("dw3", "db3", "dw1", "db1"), dws[s], want_dws[s]):
            _close(got, w, f"stage {s} {name}")


def test_saving_forward_matches_jax_residuals(rng):
    C, T, L = 8, 33, 4
    x = rng.normal(size=(T, C)).astype(np.float32)
    w3, b3, w1, b1, mask = _stack_inputs(rng, L, T, C)
    want = jtcn._fwd_call(*map(jnp.asarray, (x, w3, b3, w1, b1, mask)),
                          causal=False, save=True, interpret=True)
    got = ttcn._stages_fwd(_t(x), [tuple(map(_t, (w3, b3, w1, b1)))], [_t(mask)],
                           False, ttcn.dilated_residual_stack, save=True)
    for name, gt, w in zip(("out", "h_saved", "y_saved"), (got[0][0], got[1], got[2]),
                           want):
        _close(gt, w, name)


def test_no_grad_forward_saves_nothing_and_matches(rng):
    """Serving (no_grad) and training forwards agree; no_grad builds no graph."""
    C, T, L = 8, 24, 3
    x = _t(rng.normal(size=(T, C)).astype(np.float32))
    w = [_t(a).requires_grad_() for a in _stack_inputs(rng, L, T, C)[:4]]
    with torch.no_grad():
        served = ttcn.dilated_residual_stack(x, *w)
    trained = ttcn.dilated_residual_stack(x, *w)
    assert served.grad_fn is None and trained.grad_fn is not None
    torch.testing.assert_close(served, trained.detach(), rtol=0, atol=0)


def test_backward_wrappers_raise_on_devices_without_a_kernel():
    meta = torch.empty(2, 4, 12, device="meta")
    k = meta[:, :, :4]
    with pytest.raises(ValueError, match="device"):
        tatt.sliding_window_attention_packed_bwd(meta, k, k, meta, meta,
                                                 torch.empty(2, 2, 12, device="meta"), 2, 3)
    g = torch.empty(16, 8, device="meta")
    hs = torch.empty(2, 16, 8, device="meta")
    w3, w1 = torch.empty(2, 3, 8, 8, device="meta"), torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        ttcn.dilated_residual_stack_bwd(g, hs, hs, w3, w1)
    assert all(n == 0 for n in ops.launch_counts().values())
