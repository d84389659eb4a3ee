"""The port's operators (med_tpu_torch.ops) against the JAX package's.

The kernel modules run their plain PyTorch versions here (CPU tensors); the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerance: rtol 1e-4, atol 1e-5 — float32 on both sides, summed in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.ops import attention as jatt
from med_tpu.ops import interpolate as jinterp
from med_tpu.ops import tcn_fused as jtcn
from med_tpu_torch import ops
from med_tpu_torch.ops import attention as tatt
from med_tpu_torch.ops import interpolate as tinterp
from med_tpu_torch.ops import tcn_fused as ttcn

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("H,d,m,W,T", [(2, 4, 3, 5, 40), (8, 8, 15, 30, 48)])
def test_swa_packed_matches_pallas_interpret(rng, H, d, m, W, T):
    q = rng.normal(size=(H, d, T * m)).astype(np.float32)
    k = rng.normal(size=(H, d, T)).astype(np.float32)
    v = rng.normal(size=(H, d, T)).astype(np.float32)
    want_out, want_stats = jatt.sliding_window_attention_packed_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), W, m, tile=16,
        interpret=True, return_stats=True)
    got_out, got_stats = tatt.sliding_window_attention_packed(
        _t(q), _t(k), _t(v), W, m, return_stats=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_stats.numpy(), np.asarray(want_stats), rtol=RTOL, atol=ATOL)
    assert tatt.sliding_window_attention_packed.launches == 0


def test_swa_head_major_matches_jax(rng):
    H, T, M, d, W = 2, 23, 3, 4, 6
    q = rng.normal(size=(H, T, M, d)).astype(np.float32)
    k = rng.normal(size=(H, T, d)).astype(np.float32)
    v = rng.normal(size=(H, T, d)).astype(np.float32)
    want = jatt.sliding_window_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), W)
    got = tatt.sliding_window_attention_xla(_t(q), _t(k), _t(v), W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_layer_norm_and_attend_match_jax(rng):
    x = rng.normal(size=(5, 7, 16)).astype(np.float32)
    np.testing.assert_allclose(tatt.layer_norm(_t(x)).numpy(),
                               np.asarray(jatt.layer_norm(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    q, k, v = (rng.normal(size=(2, 3, n, 4)).astype(np.float32) for n in (5, 9, 9))
    np.testing.assert_allclose(
        tatt.attend(_t(q), _t(k), _t(v)).numpy(),
        np.asarray(jatt.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("in_size,out_size", [(7, 16), (16, 7), (64, 64)])
def test_interp1d_matches_jax(rng, in_size, out_size):
    x = rng.normal(size=(1, in_size, 3)).astype(np.float32)
    for name in ("interp1d_linear", "interp1d_nearest"):
        want = getattr(jinterp, name)(jnp.asarray(x), out_size, axis=1)
        got = getattr(tinterp, name)(_t(x), out_size, axis=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _stack_inputs(rng, L, T, C):
    return (rng.normal(size=(L, 3, C, C)).astype(np.float32) * 0.2,
            rng.normal(size=(L, C)).astype(np.float32) * 0.1,
            rng.normal(size=(L, C, C)).astype(np.float32) * 0.2,
            rng.normal(size=(L, C)).astype(np.float32) * 0.1,
            rng.integers(0, 2, size=(L, T, C)).astype(np.uint8))


# T=20 < 2 * 2**(L-1) = 32: the widest taps fall wholly outside the sequence
@pytest.mark.parametrize("L,T", [(3, 48), (5, 20)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_dilated_residual_stack_matches_pallas_interpret(rng, L, T, causal, use_mask):
    C = 8
    x = rng.normal(size=(T, C)).astype(np.float32)
    w3, b3, w1, b1, mask = _stack_inputs(rng, L, T, C)
    m = mask if use_mask else None
    want = jtcn.dilated_residual_stack(
        *map(jnp.asarray, (x, w3, b3, w1, b1)), causal=causal,
        mask=None if m is None else jnp.asarray(m), interpret=True)
    got = ttcn.dilated_residual_stack(
        *map(_t, (x, w3, b3, w1, b1)), causal=causal,
        mask=None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert ttcn.dilated_residual_stack.launches == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_multistack_stages_matches_pallas_interpret(rng, causal, use_mask):
    C, T, S, L0, Lr = 8, 48, 4, 3, 2
    x = rng.normal(size=(T, C)).astype(np.float32)
    stages = [_stack_inputs(rng, L0 if s == 0 else Lr, T, C) for s in range(S)]
    masks = [st[4] for st in stages] if use_mask else None
    want = jtcn.dilated_residual_multistack_stages(
        jnp.asarray(x), [tuple(map(jnp.asarray, st[:4])) for st in stages],
        L0, Lr, causal=causal,
        masks=None if masks is None else [jnp.asarray(mk) for mk in masks],
        interpret=True)
    got = ttcn.dilated_residual_multistack_stages(
        _t(x), [tuple(map(_t, st[:4])) for st in stages], L0, Lr, causal=causal,
        masks=None if masks is None else [_t(mk) for mk in masks])
    assert got.shape == (S, T, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert ttcn.dilated_residual_multistack_stages.launches == 0


def test_multistack_rejects_layer_counts_off_l0_lr(rng):
    C, T = 8, 16
    x = torch.zeros(T, C)
    stages = [tuple(map(_t, _stack_inputs(rng, n, T, C)[:4])) for n in (3, 2, 3)]
    with pytest.raises(ValueError, match="layer counts"):
        ttcn.dilated_residual_multistack_stages(x, stages, 3, 2)


def test_wrappers_raise_on_devices_without_a_kernel():
    """Neither a CUDA kernel nor the plain version: no quiet fallback."""
    meta = torch.empty(2, 4, 12, device="meta")
    with pytest.raises(ValueError, match="device"):
        tatt.sliding_window_attention_packed(meta, meta[:, :, :4], meta[:, :, :4], 2, 3)
    x = torch.empty(16, 8, device="meta")
    w = (torch.empty(2, 3, 8, 8, device="meta"), torch.empty(2, 8, device="meta"),
         torch.empty(2, 8, 8, device="meta"), torch.empty(2, 8, device="meta"))
    with pytest.raises(ValueError, match="device"):
        ttcn.dilated_residual_stack(x, *w)
    with pytest.raises(ValueError, match="device"):
        ttcn.dilated_residual_multistack_stages(x, [w], 2, 2)
    assert all(n == 0 for n in ops.launch_counts().values())

