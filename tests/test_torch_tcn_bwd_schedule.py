"""The schedule of the one-launch TCN backward (``csrc/tcn_stack_bwd.cu``),
emulated in plain PyTorch, against the port's plain backward and
``med_tpu``'s Pallas backward kernels in interpret mode.

The kernel runs one cooperative launch: steps k = Lt .. 0, each B(k) (the
dh update from layer k's da at the shifted rows, which other blocks wrote)
then A(k - 1) (row-local: the stage cotangent at a stage's last layer, dz,
da into layer k - 1's slots), a grid barrier after every step but the
last, then the weight gradients as independent (layer, product, chunk)
items whose partials are summed in chunk order. The emulation keeps that
structure: row tiles run in reversed or shuffled order, the da a step
writes becomes readable only at the barrier, and every buffer starts as
NaN, so a misplaced cotangent, a wrong tap sign, a read of a slot before
its barrier or a missing buffer shows here and not only on the card.

Tolerance: 1e-5 of each gradient's largest |value| (float32 summed in
another order: by chunk, and on the JAX side per layer at HIGHEST).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.ops import tcn_fused as jtcn
from med_tpu_torch.ops import tcn_fused as ttcn

NAN = float("nan")


def _rows(a, idx, T):
    """a[idx] with rows outside [0, T) zero."""
    out = torch.zeros((len(idx), a.shape[-1]), dtype=a.dtype)
    valid = (idx >= 0) & (idx < T)
    out[valid] = a[idx[valid]]
    return out


def _emulate(g, h_saved, y_saved, stage_weights, masks, causal, tile, chunk, order):
    """The kernel's schedule on the CPU -> (dx, per stage (dw3, db3, dw1,
    db1)). ``order`` maps the list of tile indices to the order a step runs
    them in."""
    S, T, C = g.shape
    Ls = [w[0].shape[0] for w in stage_weights]
    Lt = sum(Ls)
    where = [(s, i) for s, L in enumerate(Ls) for i in range(L)]
    center = 2 if causal else 1
    dh = torch.full((T, C), NAN)
    dz = torch.full((Lt, T, C), NAN)
    da = torch.full((Lt, T, C), NAN)       # what the last barrier published
    tiles = list(range(-(-T // tile)))
    for k in range(Lt, -1, -1):
        written = da.clone()                # this step's writes, seen after it
        for t in order(tiles):
            rows = torch.arange(t * tile, min(t * tile + tile, T))
            cur = dh[rows] if k < Lt else torch.zeros((len(rows), C))
            if k < Lt:                      # B(k)
                s, i = where[k]
                w3 = stage_weights[s][0][i]
                for j in range(3):
                    shift = (center - j) * 2 ** i
                    cur = cur + _rows(da[k], rows + shift, T) @ w3[j].T
            if k > 0:                       # A(k - 1)
                s, i = where[k - 1]
                if i == Ls[s] - 1:
                    cur = cur + g[s][rows]
                z = cur if masks is None else cur * (masks[s][i][rows].float() * 2.0)
                dz[k - 1][rows] = z
                written[k - 1][rows] = torch.where(
                    y_saved[k - 1][rows] > 0, z @ stage_weights[s][1][i].T,
                    torch.zeros_like(z))
            dh[rows] = cur
        da = written                        # the grid barrier
    P = -(-T // chunk)
    items = [(l, p, kind) for l in range(Lt) for p in range(P) for kind in range(4)]
    partial = {}
    for l, p, kind in order(items):
        rows = torch.arange(p * chunk, min(p * chunk + chunk, T))
        if kind == 0:
            partial[l, p, kind] = (y_saved[l][rows].T @ dz[l][rows], dz[l][rows].sum(0))
        else:
            s, i = where[l]
            shift = (center - (kind - 1)) * 2 ** i
            partial[l, p, kind] = (_rows(h_saved[l], rows - shift, T).T @ da[l][rows],
                                   da[l][rows].sum(0))
    total = {}
    for key in {(l, kind) for l, _, kind in items}:
        mat, col = partial[key[0], 0, key[1]]
        for p in range(1, P):               # chunk order
            mat, col = mat + partial[key[0], p, key[1]][0], col + partial[key[0], p, key[1]][1]
        total[key] = (mat, col)
    dws, l = [], 0
    for L in Ls:
        layer = range(l, l + L)
        dws.append((torch.stack([torch.stack([total[m, 1 + j][0] for j in range(3)])
                                 for m in layer]),
                    torch.stack([total[m, 1][1] for m in layer]),
                    torch.stack([total[m, 0][0] for m in layer]),
                    torch.stack([total[m, 0][1] for m in layer])))
        l += L
    return dh, dws


def _reversed(xs):
    return xs[::-1]


def _shuffled(xs):
    return [xs[i] for i in np.random.default_rng(len(xs)).permutation(len(xs))]


def _close(got, want, name):
    want = np.asarray(want)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol, err_msg=name)


def _inputs(rng, C, T, layers, use_mask):
    """Weights at the model's init scale, U(±1/sqrt(fan_in)), the input, a
    cotangent on every stage output, and uint8 keep-masks."""
    def u(shape, fan_in):
        return (rng.uniform(-1, 1, size=shape) / np.sqrt(fan_in)).astype(np.float32)
    ws = [(u((L, 3, C, C), 3 * C), u((L, C), 3 * C), u((L, C, C), C), u((L, C), C))
          for L in layers]
    masks = ([rng.integers(0, 2, size=(L, T, C)).astype(np.uint8) for L in layers]
             if use_mask else None)
    x = rng.normal(size=(T, C)).astype(np.float32)
    g = rng.normal(size=(len(layers), T, C)).astype(np.float32)
    return x, ws, masks, g


def _saved(x, ws, masks, causal):
    _, h_saved, y_saved = ttcn._stages_fwd(
        torch.from_numpy(x), [tuple(map(torch.from_numpy, w)) for w in ws],
        None if masks is None else [torch.from_numpy(m) for m in masks], causal,
        ttcn.dilated_residual_multistack_stages, save=True)
    return h_saved, y_saved


def _check(got, plain, jax_want, S):
    (dx, dws), (p_dx, p_dws), (j_dx, j_dws) = got, plain, jax_want
    _close(dx, p_dx, "dx vs plain")
    _close(dx, j_dx, "dx vs med_tpu")
    for s in range(S):
        for n, a, b, c in zip(("dw3", "db3", "dw1", "db1"), dws[s], p_dws[s], j_dws[s]):
            _close(a, b, f"stage {s} {n} vs plain")
            _close(a, c, f"stage {s} {n} vs med_tpu")


# K4: COG's slow path, four stages of 11, 10, 10 and 10 layers; T=40 is not
# a multiple of the 16-row tile or the 16-row chunk, and layers 6-10 of a
# stage reach wholly outside the sequence
@pytest.mark.parametrize("causal,use_mask", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("order", [_reversed, _shuffled])
def test_schedule_matches_multistage_backward(rng, causal, use_mask, order):
    C, T, layers = 8, 40, (11, 10, 10, 10)
    x, ws, masks, g = _inputs(rng, C, T, layers, use_mask)
    h_saved, y_saved = _saved(x, ws, masks, causal)
    tw = [(torch.from_numpy(w[0]), torch.from_numpy(w[2])) for w in ws]
    tm = None if masks is None else [torch.from_numpy(m) for m in masks]
    tg = torch.from_numpy(g)
    got = _emulate(tg, h_saved, y_saved, tw, tm, causal, tile=16, chunk=16, order=order)
    plain = ttcn._stages_bwd_plain(tg, h_saved, y_saved, tw, tm, causal)
    jax_want = jtcn._multi_bwd_call_s(
        jnp.asarray(g), jnp.asarray(h_saved.numpy()), jnp.asarray(y_saved.numpy()),
        tuple(tuple(map(jnp.asarray, w)) for w in ws),
        None if masks is None else tuple(map(jnp.asarray, masks)), causal=causal,
        L0=layers[0], Lr=layers[1], interpret=True)
    _check(got, plain, jax_want, len(layers))


# K5: one stack of the fast path; T=5 is shorter than one tile
@pytest.mark.parametrize("T,tile,chunk", [(40, 16, 16), (5, 16, 512), (33, 32, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("order", [_reversed, _shuffled])
def test_schedule_matches_single_stack_backward(rng, T, tile, chunk, causal, order):
    C, L = 8, 11
    x, ws, masks, g = _inputs(rng, C, T, (L,), True)
    h_saved, y_saved = _saved(x, ws, masks, causal)
    tw = [(torch.from_numpy(ws[0][0]), torch.from_numpy(ws[0][2]))]
    tm = [torch.from_numpy(masks[0])]
    tg = torch.from_numpy(g)
    got = _emulate(tg, h_saved, y_saved, tw, tm, causal, tile=tile, chunk=chunk,
                   order=order)
    plain = ttcn._stages_bwd_plain(tg, h_saved, y_saved, tw, tm, causal)
    j_dx, *j_dw = jtcn._bwd_call(
        jnp.asarray(g[0]), jnp.asarray(h_saved.numpy()), jnp.asarray(y_saved.numpy()),
        jnp.asarray(ws[0][0]), jnp.asarray(ws[0][2]), jnp.asarray(masks[0]),
        causal=causal, interpret=True)
    _check(got, plain, (j_dx, [j_dw]), 1)

