"""The schedules of the packed attention kernels (``csrc/swa_packed_fwd.cu``,
K1, and ``csrc/swa_packed_bwd.cu``, K3), emulated in plain PyTorch, against
the port's plain versions and ``med_tpu``'s Pallas kernels in interpret mode.

K1 makes one pass over each query's keys: the scores of a chunk of 16 keys
at once, an online max and sum across chunks, one exp a score. Its blocks
cover fpb frames (a slice of one frame's slots where m is large) and stage
the K/V rows of frames t0-W+1 .. t0+fpb+Wc-2, zero outside [0, T).

K3 computes each (query, key) pair once. A tile (head, F frames, MB slots)
stages its queries' q^, g and (lse, delta), delta formed from out and g,
and walks its window in chunks of WC positions (one chunk, WC = W, unless
W * D is large), staging each chunk's F+WC-1 key rows; phase 1 runs items
(frame, slot group, window position w) that write ds to a (query, w) band
and their key's dk/dv partial to P[frame][slot group][2D][w]; phase 2 adds
dq per query from the band and the key rows to what the chunk before wrote,
and sums each key row's partial over the tile's slot groups and frames into
the tile's scratch slot (adding to the F-1 rows the chunk before shares);
after the grid barrier each key sums its tiles' slots in tile order. The
tiling (F, MB, S, WC) is the one the kernel's ``plan()`` picks, mirrored in
``_bwd_plan``. The emulation keeps that structure: tiles run in reversed
or shuffled order, and the scratch, the band, P and every output start as
NaN, so a key row read from the wrong tile or chunk, a band entry never
written or a tile that misses a key shows here and not only on the card.

Tolerance: rtol 1e-4 and atol 1e-5 of each output's largest |value|
(float32 summed in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.ops import attention as jatt
from med_tpu_torch.ops import attention as tatt

NAN = float("nan")


def _reversed(xs):
    return xs[::-1]


def _shuffled(xs):
    return [xs[i] for i in np.random.default_rng(len(xs)).permutation(len(xs))]


def _rows(x, frames):
    """(D, T) -> (len(frames), D): the rows of the given frames, zero
    outside [0, T)."""
    T = x.shape[1]
    out = torch.zeros((len(frames), x.shape[0]), dtype=x.dtype)
    valid = (frames >= 0) & (frames < T)
    out[valid] = x[:, frames[valid]].T
    return out


def _fwd_launch(D, m, W):
    """The forward's launch shape, as the C entry picks it: (R, CH, fpb, spb,
    nsb)."""
    R = 4 if D <= 2 else 2 if D <= 8 else 1
    CH = 16
    slot_threads = -(-m // R)
    if slot_threads <= 128:
        return R, CH, 128 // slot_threads, m, 1
    return R, CH, 1, 128 * R, -(-m // (128 * R))


def _emulate_fwd(q, k, v, W, m, order):
    H, D, N = q.shape
    T = N // m
    R, CH, fpb, spb, nsb = _fwd_launch(D, m, W)
    wc = -(-W // CH) * CH
    scale = 1.0 / math.sqrt(D)
    out = torch.full_like(q, NAN)
    stats = torch.full((H, 2, N), NAN)
    blocks = [(h, b) for h in range(H) for b in range(-(-T // fpb) * nsb)]
    for h, b in order(blocks):
        t0, j0 = b // nsb * fpb, b % nsb * spb
        frames = torch.arange(t0 - (W - 1), t0 + fpb + wc - 1)
        ks, vs = _rows(k[h], frames), _rows(v[h], frames)
        for lt in range(min(fpb, T - t0)):
            n = (t0 + lt) * m + torch.arange(j0, min(m, j0 + spb))
            qr = q[h][:, n].T * scale                        # (slots, D)
            mx = torch.full((len(n),), -math.inf)
            total = torch.zeros(len(n))
            acc = torch.zeros((len(n), D))
            for c0 in range(0, W, CH):
                rows = lt + c0 + torch.arange(CH)
                s = qr @ ks[rows].T                          # (slots, CH)
                s[:, torch.arange(CH) + c0 >= W] = -math.inf
                nm = torch.maximum(mx, s.max(dim=1).values)
                if c0 > 0:
                    alpha = torch.exp(mx - nm)
                    total, acc = total * alpha, acc * alpha[:, None]
                mx = nm
                e = torch.exp(s - mx[:, None])
                total = total + e.sum(dim=1)
                acc = acc + e @ vs[rows]
            out[h][:, n] = (acc * (1.0 / total)[:, None]).T
            stats[h, 0, n] = mx + torch.log(total)
            stats[h, 1, n] = 1.0 / total
    return out, stats


def _window_chunks(W):
    """The chunk widths the plan tries after the whole window: W/2, W/4, .. 1."""
    WC = (W + 1) // 2
    while WC < W:
        yield WC
        if WC == 1:
            break
        WC = (WC + 1) // 2


def _bwd_plan(D, m, W):
    """(F, MB, S, WC) as ``plan()`` in ``csrc/swa_packed_bwd.cu`` picks them:
    the whole window first, F = 16, 8, .. 1 frames of all m slots, then one
    frame of m/2, m/4, .. slots, within a two-blocks-an-SM budget of shared
    memory and then a one-block one; where none fits, the same order with
    the largest window chunk that fits."""
    def smem_bytes(WC, F, MB, S):
        QT = F * MB
        dp = D + 4 if D % 8 == 0 else D
        wp = -(-WC // 4) * 4
        wp = wp + 4 if wp % 8 == 0 else wp
        return 4 * (4 * (F + WC - 1) * D + 2 * QT * dp + -(-2 * QT // 4) * 4 + QT * wp
                    + F * S * 2 * D * WC)

    for chunks in ((W,), _window_chunks(W)):
        chunks = list(chunks)
        for budget in (110 * 1024, 227 * 1024):
            F, nc = 16, 1
            while True:
                MB = -(-m // nc)
                for WC in chunks:
                    S = min(-(-256 // (F * WC)), MB)
                    if smem_bytes(WC, F, MB, S) <= budget:
                        return F, MB, S, WC
                if F > 1:
                    F //= 2
                elif MB > 1:
                    nc *= 2
                else:
                    break
    raise AssertionError("one frame, one slot and WC = 1 always fit")


def _emulate_bwd(q, k, v, g, out, stats, W, m, order):
    H, D, N = q.shape
    T = N // m
    F, MB, S, WC = _bwd_plan(D, m, W)
    scale = 1.0 / math.sqrt(D)
    nc, n_tiles, KR = -(-m // MB), -(-T // F), F + W - 1
    scratch = torch.full((H, n_tiles, nc, 2 * D, KR), NAN)
    dq = torch.full_like(q, NAN)
    tiles = [(h, i, c) for h in range(H) for i in range(n_tiles) for c in range(nc)]
    for h, i, c in order(tiles):
        f0, j0 = i * F, c * MB
        nf, mb = min(F, T - f0), min(MB, m - j0)
        n = (f0 + torch.arange(nf))[:, None] * m + j0 + torch.arange(mb)[None, :]
        qs = q[h][:, n].permute(1, 2, 0) * scale             # (nf, mb, D)
        gs = g[h][:, n].permute(1, 2, 0)
        lse = stats[h, 0][n]
        delta = (out[h][:, n] * g[h][:, n]).sum(dim=0)       # formed in the tile
        for w0 in range(0, W, WC):                           # window chunks
            wc = min(WC, W - w0)
            frames = torch.arange(f0 - (W - 1) + w0, f0 - (W - 1) + w0 + F + WC - 1)
            ks, vs = _rows(k[h], frames), _rows(v[h], frames)
            window = torch.arange(nf)[:, None] + torch.arange(wc)[None, :]
            keys, vals = ks[window], vs[window]              # (nf, wc, D)
            band = torch.full((nf, mb, wc), NAN)
            P = torch.full((F, S, 2 * D, WC), NAN)
            for sg in range(S):                              # phase 1
                js = torch.arange(sg, mb, S)
                a = torch.exp(torch.einsum("ljd,lwd->ljw", qs[:, js], keys) - lse[:, js, None])
                ds = a * (torch.einsum("ljd,lwd->ljw", gs[:, js], vals) - delta[:, js, None])
                band[:, js] = ds
                P[:nf, sg, :D, :wc] = torch.einsum("ljw,ljd->ldw", ds, qs[:, js])
                P[:nf, sg, D:, :wc] = torch.einsum("ljw,ljd->ldw", a, gs[:, js])
            part_dq = torch.einsum("ljw,lwd->dlj", band, keys) * scale    # phase 2
            dq[h][:, n] = part_dq if w0 == 0 else dq[h][:, n] + part_dq
            for r in range(F + wc - 1):
                part = torch.zeros(2 * D)
                for sg in range(S):
                    for lt in range(max(0, r - wc + 1), min(nf - 1, r) + 1):
                        part = part + P[lt, sg, :, r - lt]
                if w0 > 0 and r < F - 1:                     # shared with the chunk before
                    part = scratch[h, i, c, :, w0 + r] + part
                scratch[h, i, c, :, w0 + r] = part
    dk = torch.full_like(k, NAN)                             # after the barrier
    dv = torch.full_like(v, NAN)
    for f in range(T):
        part = torch.zeros((H, 2 * D))
        for i in range(f // F, min(n_tiles - 1, (f + W - 1) // F) + 1):
            for c in range(nc):
                part = part + scratch[:, i, c, :, f - i * F + W - 1]
        dk[:, :, f], dv[:, :, f] = part[:, :D], part[:, D:]
    return dq, dk, dv


def _close(got, want, name):
    want = np.asarray(want)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol, err_msg=name)


def _inputs(rng, H, d, m, T):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m))]


def _pallas_tile(W):
    """The Pallas backward reads W-1 extension frames from the next tile:
    the least power of two from 16 up that holds them."""
    tile = 16
    while tile < W - 1:
        tile *= 2
    return tile


# COG's (H, d, m, W) at T=48 (two chunks of 16 keys); W=40 takes three;
# m=1 and m=30; T shorter than a tile of 16 frames, and T=1; TransSVNet's
# d=2, m=W=30 (4 slots a thread)
FWD_CASES = [(8, 8, 15, 30, 48), (2, 8, 3, 40, 70), (2, 4, 1, 5, 40), (2, 16, 30, 7, 20),
             (2, 8, 15, 30, 5), (2, 8, 15, 30, 1), (8, 2, 30, 30, 47), (2, 2, 30, 30, 9),
             # COG's skill-prompt (45) and observed-gesture (8) tables; a trial
             # group of two on the head axis (16 heads)
             (2, 8, 45, 30, 21), (16, 8, 8, 30, 33)]


@pytest.mark.parametrize("H,d,m,W,T", FWD_CASES)
@pytest.mark.parametrize("order", [_reversed, _shuffled])
def test_forward_schedule_matches_plain_and_pallas(rng, H, d, m, W, T, order):
    q, k, v, _ = _inputs(rng, H, d, m, T)
    got = _emulate_fwd(*map(torch.from_numpy, (q, k, v)), W, m, order)
    plain = tatt.sliding_window_attention_packed_plain(*map(torch.from_numpy, (q, k, v)), W, m)
    want = jatt.sliding_window_attention_packed_fwd(
        *map(jnp.asarray, (q, k, v)), W, m, tile=_pallas_tile(W), interpret=True,
        return_stats=True)
    for name, a, b, c in zip(("out", "stats"), got, plain, want):
        _close(a, b, f"{name} vs plain")
        _close(a, c, f"{name} vs med_tpu")


# (H, d, m, W, T), each with the tiling the kernel's plan picks there:
# COG's (F=16, all 15 slots, one slot group) at T=48, T=F+1, T<F and T=1;
# W=40 (F=16, m=3); m=1; m=30 (F=8, 5 slot groups, T not a multiple of F);
# m=512 at d=32 (one frame, 64 slots a tile: 8 slot blocks); W=400 at d=32
# (F=16, window chunks of 13, the last of 10) and W=310 at m=2 over three
# tiles (F=16, chunks of 20, the last of 10); TransSVNet's d=2, m=W=30
# (F=16, all 30 slots, one slot group) over three tiles and within one
BWD_CASES = [(8, 8, 15, 30, 48), (2, 8, 15, 30, 17), (2, 8, 15, 30, 5), (2, 8, 15, 30, 1),
             (2, 8, 3, 40, 70), (2, 4, 1, 5, 40), (2, 16, 30, 7, 22), (1, 32, 512, 30, 3),
             (1, 32, 1, 400, 20), (1, 32, 2, 310, 40), (8, 2, 30, 30, 47), (2, 2, 30, 30, 9),
             (2, 8, 45, 30, 21), (16, 8, 8, 30, 33)]


def test_bwd_plan_mirrors_the_kernels_choices():
    """The tilings the cases above name, as the kernel's plan picks them."""
    assert _bwd_plan(8, 15, 30) == (16, 15, 1, 30)
    assert _bwd_plan(16, 30, 7) == (8, 30, 5, 7)
    assert _bwd_plan(32, 512, 30) == (1, 64, 9, 30)
    assert _bwd_plan(32, 1, 400) == (16, 1, 1, 13)
    assert _bwd_plan(32, 2, 310) == (16, 2, 1, 20)
    assert _bwd_plan(2, 30, 30) == (16, 30, 1, 30)
    assert _bwd_plan(8, 45, 30) == (4, 45, 3, 30)
    assert _bwd_plan(8, 8, 30) == (16, 8, 1, 30)


@pytest.mark.parametrize("H,d,m,W,T", BWD_CASES)
@pytest.mark.parametrize("order", [_reversed, _shuffled])
def test_backward_schedule_matches_plain_and_pallas(rng, H, d, m, W, T, order):
    q, k, v, g = _inputs(rng, H, d, m, T)
    tile = _pallas_tile(W)
    out, stats = jatt.sliding_window_attention_packed_fwd(
        *map(jnp.asarray, (q, k, v)), W, m, tile=tile, interpret=True, return_stats=True)
    want = jatt.sliding_window_attention_packed_bwd(
        *map(jnp.asarray, (q, k, v, g)), out, stats, W, m, tile=tile, interpret=True)
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, g, out, stats)]
    got = _emulate_bwd(*args, W, m, order)
    plain = tatt.sliding_window_attention_packed_bwd_plain(*args, W, m)
    # the JAX kernel returns dk/dv (H, T, d); the packed contract is (H, d, T)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain,
                             (want[0], np.swapaxes(want[1], 1, 2),
                              np.swapaxes(want[2], 1, 2))):
        _close(a, b, f"{name} vs plain")
        _close(a, c, f"{name} vs med_tpu")
