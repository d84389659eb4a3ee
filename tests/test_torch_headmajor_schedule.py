"""The schedules of the head-major attention kernels (``csrc/swa_headmajor_fwd.cu``,
K8, and ``csrc/swa_headmajor_bwd.cu``, K9), emulated in plain PyTorch,
against the port's plain versions, ``med_tpu``'s Pallas kernels in interpret
mode and ``jax.vjp`` of ``med_tpu``'s gather form.

K8 makes one pass over each query's keys, as the packed forward does: the
scores of a chunk of 16 keys at once, an online max and sum across chunks,
one exp a score. Its blocks cover fpb frames (a slice of one frame's slots
where m is large) and stage the K/V rows of frames t0-W+1 .. t0+fpb+Wc-2,
zero outside [0, T).

K9 is given q, k, v and g alone. A tile (head, F frames, MB slots) stages
its queries' q and g and its chunk's F+WC-1 K/V rows (WC = W unless W * D is
large). Phase 0 gives each query G lanes, lane h taking window positions h,
h+G, ..: where the whole window fits, pass 1 writes the scores and g.v to
two bands, pass 2 turns the scores into exp(s - max) (the lanes' max) and
sums them and their products with g.v, pass 3 writes a and ds and sums dq
(the lanes' sums combined by a butterfly, as the shuffles do). Where it
does not, a first walk over the chunks keeps an online (max, sum, sum p da)
a lane, merged over the lanes and then the chunks, and a second walk
computes each pair again from those statistics. Phase 1 runs items (frame,
slot group, window position w) that sum their key's dk/dv partial into
P[frame][slot group][2D][w]; phase 2 sums each key row's partial over the
tile's slot groups and frames into its scratch slot (adding to the F-1 rows
the chunk before shares); after the grid barrier each key sums its tiles'
slots in tile order. The tiling (F, MB, S, WC, G, WP) is the one the
kernel's ``plan()`` picks, mirrored in ``_bwd_plan``. Tiles and blocks run
in reversed or shuffled order, and the scratch, the bands, P and every
output start as NaN, so a key row read from the wrong tile or chunk, a band
entry never written or a tile that misses a key shows here and not only on
the card. The emulation counts its score evaluations: each (query, key) pair
once where the window fits a tile, twice where it goes in chunks.

Tolerance: the forward rtol 1e-4, atol 1e-5; the gradients rtol 1e-4 and
atol 1e-5 of each output's largest |value| (float32 summed in another
order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.ops import attention as jatt
from med_tpu_torch.ops import attention as tatt

NAN = float("nan")
THREADS_FWD, THREADS_BWD = 128, 256
CHUNK = 16
MAX_SMEM, TWO_BLOCKS, THREE_BLOCKS = 227 * 1024, 110 * 1024, 74 * 1024


def _reversed(xs):
    return xs[::-1]


def _shuffled(xs):
    return [xs[i] for i in np.random.default_rng(len(xs)).permutation(len(xs))]


def _rows(x, frames):
    """(T, D) -> (len(frames), D): the rows of the given frames, zero
    outside [0, T)."""
    T = x.shape[0]
    out = torch.zeros((len(frames), x.shape[1]), dtype=x.dtype)
    valid = (frames >= 0) & (frames < T)
    out[valid] = x[frames[valid]]
    return out


def _fwd_launch(D, m, W):
    """The forward's launch shape, as the C entry picks it: (R, fpb, spb,
    nsb); fpb halves while the staged rows exceed shared memory."""
    R = 2 if D <= 8 else 1
    slot_threads = -(-m // R)
    if slot_threads <= THREADS_FWD:
        fpb, spb, nsb = THREADS_FWD // slot_threads, m, 1
    else:
        fpb, spb, nsb = 1, THREADS_FWD * R, -(-m // (THREADS_FWD * R))
    wc = -(-W // CHUNK) * CHUNK
    while fpb > 1 and 2 * (fpb + wc - 1) * D * 4 > MAX_SMEM:
        fpb //= 2
    return R, fpb, spb, nsb


def _emulate_fwd(q, k, v, W, order):
    H, T, m, D = q.shape
    R, fpb, spb, nsb = _fwd_launch(D, m, W)
    wc = -(-W // CHUNK) * CHUNK
    scale = 1.0 / math.sqrt(D)
    out = torch.full_like(q, NAN)
    blocks = [(h, b) for h in range(H) for b in range(-(-T // fpb) * nsb)]
    for h, b in order(blocks):
        t0, j0 = b // nsb * fpb, b % nsb * spb
        frames = torch.arange(t0 - (W - 1), t0 + fpb + wc - 1)
        ks, vs = _rows(k[h], frames), _rows(v[h], frames)
        for lt in range(min(fpb, T - t0)):
            js = torch.arange(j0, min(m, j0 + spb))
            qr = q[h, t0 + lt, js] * scale                   # (slots, D)
            mx = torch.full((len(js),), -math.inf)
            total = torch.zeros(len(js))
            acc = torch.zeros((len(js), D))
            for c0 in range(0, W, CHUNK):
                rows = lt + c0 + torch.arange(CHUNK)
                s = qr @ ks[rows].T                          # (slots, CHUNK)
                s[:, torch.arange(CHUNK) + c0 >= W] = -math.inf
                nm = torch.maximum(mx, s.max(dim=1).values)
                if c0 > 0:
                    alpha = torch.exp(mx - nm)
                    total, acc = total * alpha, acc * alpha[:, None]
                mx = nm
                e = torch.exp(s - mx[:, None])
                total = total + e.sum(dim=1)
                acc = acc + e @ vs[rows]
            out[h, t0 + lt, js] = acc * (1.0 / total)[:, None]
    return out


def _window_chunks(W):
    """The chunk widths the plan tries after the whole window: W/2, W/4, .. 1."""
    WC = (W + 1) // 2
    while WC < W:
        yield WC
        if WC == 1:
            break
        WC = (WC + 1) // 2


def _lanes(QT, WC):
    G = 1
    while G < 32 and 2 * G * QT <= THREADS_BWD and 2 * G <= WC:
        G *= 2
    return G


def _band_stride(WC, G):
    n = -(-WC // G)
    return (n + 1 if n % 2 == 0 else n) * G


def _bwd_plan(D, m, W):
    """(F, MB, S, WC, G, WP) as ``plan()`` in ``csrc/swa_headmajor_bwd.cu``
    picks them: the whole window first, F = 16, 8, .. 1 frames of all m
    slots, then one frame of m/2, m/4, .. slots, within a three-blocks-an-SM
    budget of shared memory (D <= 8), then two, then one; where none fits,
    the same order with the largest window chunk that fits."""
    for chunks in ((W,), _window_chunks(W)):
        chunks = list(chunks)
        for budget in (THREE_BLOCKS if D <= 8 else TWO_BLOCKS, TWO_BLOCKS, MAX_SMEM):
            F, nc = 16, 1
            while True:
                MB = -(-m // nc)
                QT = F * MB
                for WC in chunks:
                    S = max(1, min(MB, THREADS_BWD // (F * WC)))
                    G = _lanes(QT, WC)
                    WP = _band_stride(WC, G)
                    floats = (4 * (F + WC - 1) * D + 4 * QT * D + 4 * QT + 2 * QT * WP
                              + F * S * 2 * D * WC)
                    if 4 * floats <= budget:
                        return F, MB, S, WC, G, WP
                if F > 1:
                    F //= 2
                elif MB > 1:
                    nc *= 2
                else:
                    break
    raise AssertionError("one frame, one slot and WC = 1 always fit")


def _butterfly(xs, op):
    """The lanes' values combined as the xor shuffles do: neighbours, then
    pairs of pairs."""
    while len(xs) > 1:
        xs = [op(xs[i], xs[i + 1]) for i in range(0, len(xs), 2)]
    return xs[0]


def _merge(a, b):
    """Online softmax statistics (max, sum, sum p da) of two sets of scores."""
    (m1, s1, p1), (m2, s2, p2) = a, b
    nm = torch.maximum(m1, m2)
    c1 = torch.where(m1 == -math.inf, 0.0, torch.exp(m1 - nm))
    c2 = torch.where(m2 == -math.inf, 0.0, torch.exp(m2 - nm))
    return nm, s1 * c1 + s2 * c2, p1 * c1 + p2 * c2


def _emulate_bwd(q, k, v, g, W, order, pairs=None):
    """K9's schedule -> (dq, dk, dv); ``pairs``, a one-element list, counts
    the (query, key) scores it computes."""
    H, T, m, D = q.shape
    F, MB, S, WC, G, WP = _bwd_plan(D, m, W)
    scale = 1.0 / math.sqrt(D)
    nc, n_tiles, KR = -(-m // MB), -(-T // F), F + W - 1
    chunk_starts = list(range(0, W, WC))
    chunked = len(chunk_starts) > 1
    scratch = torch.full((H, n_tiles, nc, 2 * D, KR), NAN)
    dq = torch.full_like(q, NAN)
    tiles = [(h, i, c) for h in range(H) for i in range(n_tiles) for c in range(nc)]
    for h, i, c in order(tiles):
        f0, j0 = i * F, c * MB
        nf, mb = min(F, T - f0), min(MB, m - j0)
        qs = q[h, f0:f0 + nf, j0:j0 + mb]                    # (nf, mb, D)
        gs = g[h, f0:f0 + nf, j0:j0 + mb]
        qh = qs * scale

        def keys(w0):
            frames = torch.arange(f0 - (W - 1) + w0, f0 - (W - 1) + w0 + F + WC - 1)
            return _rows(k[h], frames), _rows(v[h], frames)

        def pair(ks, vs, w):
            """Scores and g.v of the tile's queries with window position w
            of the chunk (key row lt + w for frame lt)."""
            if pairs is not None:
                pairs[0] += nf * mb
            kr, vr = ks[torch.arange(nf) + w], vs[torch.arange(nf) + w]   # (nf, D)
            return (torch.einsum("ljd,ld->lj", qh, kr), torch.einsum("ljd,ld->lj", gs, vr),
                    kr)

        if chunked:                                          # the statistics walk
            st = None
            for w0 in chunk_starts:
                wc = min(WC, W - w0)
                ks, vs = keys(w0)
                per_lane = []
                for lane in range(G):
                    mx = torch.full((nf, mb), -math.inf)
                    tot, pd = torch.zeros((nf, mb)), torch.zeros((nf, mb))
                    for w in range(lane, wc, G):
                        s, da, _ = pair(ks, vs, w)
                        mx, tot, pd = _merge((mx, tot, pd), (s, torch.ones_like(s), da))
                    per_lane.append((mx, tot, pd))
                merged = _butterfly(per_lane, _merge)
                st = merged if st is None else _merge(merged, st)
            mx_all, tot, pd = st
            rs_all, delta_all = 1.0 / tot, pd / tot
        for w0 in chunk_starts:                              # the gradient walk
            wc = min(WC, W - w0)
            ks, vs = keys(w0)
            b1 = torch.full((nf, mb, WP), NAN)
            b2 = torch.full((nf, mb, WP), NAN)
            if not chunked:
                lane_max = []
                for lane in range(G):                        # pass 1
                    mx = torch.full((nf, mb), -math.inf)
                    for w in range(lane, wc, G):
                        s, da, _ = pair(ks, vs, w)
                        b1[..., w], b2[..., w] = s, da
                        mx = torch.maximum(mx, s)
                    lane_max.append(mx)
                mx = _butterfly(lane_max, torch.maximum)
                sums, pds = [], []
                for lane in range(G):                        # pass 2
                    tot, pd = torch.zeros((nf, mb)), torch.zeros((nf, mb))
                    for w in range(lane, wc, G):
                        e = torch.exp(b1[..., w] - mx)
                        b1[..., w] = e
                        tot, pd = tot + e, pd + e * b2[..., w]
                    sums.append(tot)
                    pds.append(pd)
                rs = 1.0 / _butterfly(sums, torch.add)
                delta = _butterfly(pds, torch.add) * rs
            else:
                mx, rs, delta = mx_all, rs_all, delta_all
            accs = []
            for lane in range(G):                            # pass 3
                acc = torch.zeros((nf, mb, D))
                for w in range(lane, wc, G):
                    if chunked:
                        s, da, kr = pair(ks, vs, w)
                        e = torch.exp(s - mx)
                    else:
                        e, da, kr = b1[..., w], b2[..., w], ks[torch.arange(nf) + w]
                    a = e * rs
                    ds = a * (da - delta)
                    b1[..., w], b2[..., w] = a, ds
                    acc = acc + ds[..., None] * kr[:, None, :]
                accs.append(acc)
            part = _butterfly(accs, torch.add) * scale
            dq[h, f0:f0 + nf, j0:j0 + mb] = part if w0 == 0 else dq[h, f0:f0 + nf,
                                                                   j0:j0 + mb] + part
            P = torch.full((F, S, 2 * D, WC), NAN)           # phase 1
            for sg in range(S):
                js = torch.arange(sg, mb, S)
                a, ds = b1[:, js, :wc], b2[:, js, :wc]
                P[:nf, sg, :D, :wc] = torch.einsum("ljw,ljd->ldw", ds, qs[:, js]) * scale
                P[:nf, sg, D:, :wc] = torch.einsum("ljw,ljd->ldw", a, gs[:, js])
            for r in range(F + wc - 1):                      # phase 2
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
        dk[:, f], dv[:, f] = part[:, :D], part[:, D:]
    return dq, dk, dv


def _close(got, want, name, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def _close_grad(got, want, name):
    want = np.asarray(want)
    _close(got, want, name, atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def _inputs(rng, H, d, m, T):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d))]


def _pallas_tile(W):
    """The Pallas backward reads W-1 extension frames from the next tile:
    the least power of two from 16 up that holds them."""
    tile = 16
    while tile < W - 1:
        tile *= 2
    return tile


# COG's (H, d, m, W) at T=48 (two chunks of 16 keys); W=40 takes three;
# m=1 and m=30; m=300 at d=32 (slices of 128 slots); T shorter than a block,
# and T=1
FWD_CASES = [(8, 8, 15, 30, 48), (2, 8, 3, 40, 70), (2, 4, 1, 5, 40), (2, 16, 30, 7, 20),
             (1, 32, 300, 3, 4), (2, 8, 15, 30, 5), (2, 8, 15, 30, 1)]


@pytest.mark.parametrize("H,d,m,W,T", FWD_CASES)
@pytest.mark.parametrize("order", [_reversed, _shuffled])
def test_forward_schedule_matches_plain_and_pallas(rng, H, d, m, W, T, order):
    q, k, v, _ = _inputs(rng, H, d, m, T)
    got = _emulate_fwd(*map(torch.from_numpy, (q, k, v)), W, order)
    plain = tatt.sliding_window_attention_xla(*map(torch.from_numpy, (q, k, v)), W)
    want = jatt.sliding_window_attention_pallas(*map(jnp.asarray, (q, k, v)), W,
                                                tile=_pallas_tile(W), interpret=True)
    _close(got, plain, "out vs plain")
    _close(got, want, "out vs med_tpu")


# (H, d, m, W, T), each with the tiling the kernel's plan picks there:
# COG's (8 frames of all 15 slots, two lanes a query, within three blocks
# an SM) at T=48, T=F+1, T<F and T=1; W=40 (F=16, m=3, four lanes); m=1
# (four lanes: a fifth window position would idle the rest); m=30 at d=16
# (F=8, four slot groups); m=300 at d=32 (one frame, 38 slots a tile: 8
# slot blocks); windows no tile holds whole, within two blocks an SM:
# W=400 at d=32 (F=16, 31 chunks of 13, the last of 10) and W=310 at m=2
# over three tiles (31 chunks of 10)
BWD_CASES = [(8, 8, 15, 30, 48), (2, 8, 15, 30, 9), (2, 8, 15, 30, 5), (2, 8, 15, 30, 1),
             (2, 8, 3, 40, 70), (2, 4, 1, 5, 40), (2, 16, 30, 7, 22), (1, 32, 300, 30, 3),
             (1, 32, 1, 400, 20), (1, 32, 2, 310, 40)]


def test_bwd_plan_mirrors_the_kernels_choices():
    """The tilings the cases above name, as the kernel's plan picks them."""
    assert _bwd_plan(8, 15, 30) == (8, 15, 1, 30, 2, 30)
    assert _bwd_plan(8, 3, 40) == (16, 3, 1, 40, 4, 44)
    assert _bwd_plan(4, 1, 5) == (16, 1, 1, 5, 4, 12)
    assert _bwd_plan(16, 30, 7) == (8, 30, 4, 7, 1, 7)
    assert _bwd_plan(32, 300, 30) == (1, 38, 8, 30, 4, 36)
    assert _bwd_plan(32, 1, 400) == (16, 1, 1, 13, 8, 24)
    assert _bwd_plan(32, 2, 310) == (16, 2, 1, 10, 8, 24)


@pytest.mark.parametrize("H,d,m,W,T", BWD_CASES)
@pytest.mark.parametrize("order", [_reversed, _shuffled])
def test_backward_schedule_matches_plain_pallas_and_jax(rng, H, d, m, W, T, order):
    q, k, v, g = _inputs(rng, H, d, m, T)
    got = _emulate_bwd(*map(torch.from_numpy, (q, k, v, g)), W, order)
    plain = tatt.sliding_window_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, g)), W)
    pallas = jatt.sliding_window_attention_bwd_pallas(
        *map(jnp.asarray, (q, k, v, g)), W, tile=_pallas_tile(W), interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jatt.sliding_window_attention_xla(a, b, c, W),
                     *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(g))
    for name, a, b, c, e in zip(("dq", "dk", "dv"), got, plain, pallas, grads):
        _close_grad(a, b, f"{name} vs plain")
        _close_grad(a, c, f"{name} vs med_tpu's Pallas backward")
        _close_grad(a, e, f"{name} vs jax.vjp")


@pytest.mark.parametrize("H,d,m,W,T,evaluations", [(2, 8, 15, 30, 20, 1),
                                                   (1, 32, 1, 400, 20, 2)])
def test_backward_schedule_computes_each_pair_once_where_the_window_fits(
        rng, H, d, m, W, T, evaluations):
    """The score and g.v of each (query, key) pair once where the window
    fits a tile (COG's shapes), twice where it goes in chunks (W=400 at
    d=32), zero keys of the halo included."""
    q, k, v, g = _inputs(rng, H, d, m, T)
    pairs = [0]
    _emulate_bwd(*map(torch.from_numpy, (q, k, v, g)), W, _reversed, pairs)
    assert pairs[0] == evaluations * H * T * m * W
