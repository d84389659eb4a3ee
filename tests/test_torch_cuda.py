"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at awkward shapes (ragged tiles, dilations wider than the sequence,
acausal taps, dropout masks, images narrower than a tile; for the one-launch
TCN forward also T = 1 and 5, where every block but one has no rows, and
the 300-frame request's 18 and 300 rows; for the one-launch TCN backward
T = 1, 17 and 33 at every channel count, more than 16 stacks, and two runs
equal bit for bit; for the head-major attention the widest windows the
kernels before them took, m = 1 and 300, and two backward runs equal bit
for bit; operands in views 4 bytes past a 16-byte boundary, which the
head-major kernels read through their 4-byte instance and the TCN
wrappers refuse by name), the TCN stack and its backward at the keep
scale 1 / 0.7 of dropout rate 0.3 (and ``ResidualStack(dropout_rate=0.3)``
card against CPU), the small COG
served on the card against the CPU, and a small ResNet trunk and pixel
front end on the card against the CPU; K1 and K3 at the error-specific
regime's shapes (m = 45 and 8 queries a frame, a trial group's 16 heads),
the bf16 path launching no TCN kernel, and a trial group's step launching
the attention once a layer for both trials, its gradients equal to the
CPU's; one train step of each window model on the card against the CPU
(cuDNN's convs and LSTMs, with TF32 off once an Experiment is made). They
need an NVIDIA GPU and skip without one. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: rtol 1e-4, atol 1e-5 for the attention (values O(1)); atol 1e-4
for the TCN stacks, whose activations grow over the layers (the same for the
concatenated multistack and the head-major attention). The ResNet
stage kernel: relative L2 and max error over the largest value within 1e-5
in float32, and in bfloat16 within 2**-7 and 2**-5 (a sum taken in another
order may round a y1 or y2 value the other way, one bf16 step), at the
tensor-core tiles' tails and through both bf16 instances. Gradients:
rtol 1e-4, atol 1e-5 * max|want| per tensor (weight gradients are sums over
T, taken in another order).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from med_tpu_torch import ops
from med_tpu_torch.ops import attention as tatt
from med_tpu_torch.ops import resnet_fused as trf
from med_tpu_torch.ops import tcn_fused as ttcn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _dev(a, device):
    return torch.as_tensor(a, device=device)


# COG calls the packed attention and the per-stage multistack: the kernels of
# the public op entry points stay idle on its path
OP_API_IDLE = {"dilated_residual_multistack": 0, "dilated_residual_multistack_bwd": 0,
               "sliding_window_attention_pallas": 0,
               "sliding_window_attention_bwd_pallas": 0}


# the packed attention kernels at COG's shapes and beyond: W = 40 and 70 take
# three and five chunks of 16 keys in the forward; m = 30 and 512 (K3 splits
# 512 slots of d=32 over eight slot blocks); T = 1, 16 and 17 frames against
# K3's tiles of 16; and windows no tile of K3 holds whole, which it walks in
# chunks (W = 3000 at d=4, 3600 at d=8 and m=15, 800 at d=16, 400 at d=32:
# chunks of 94, 29, 25 and 13 positions), over three tiles; TransSVNet's head
# width d=2 (8 heads, m = W = 30, 4 slots a K1 thread), one frame, a ragged
# tile, m not a multiple of 4, and a window K3 walks in chunks
ATTENTION_SHAPES = [(8, 8, 15, 30, 100), (2, 4, 3, 5, 41), (3, 16, 1, 7, 300),
                    (1, 32, 300, 3, 5), (2, 8, 15, 40, 50), (2, 8, 15, 70, 90),
                    (2, 8, 30, 30, 40), (1, 8, 512, 30, 3), (1, 32, 512, 30, 3),
                    (8, 8, 15, 30, 1), (8, 8, 15, 30, 16), (8, 8, 15, 30, 17),
                    (1, 4, 1, 3000, 40), (1, 8, 15, 3600, 40), (1, 16, 1, 800, 40),
                    (1, 32, 1, 400, 40), (8, 2, 30, 30, 100), (8, 2, 30, 30, 1),
                    (2, 2, 30, 30, 17), (1, 2, 7, 5, 41), (1, 2, 30, 6000, 40),
                    # COG's skill-prompt (m = 45, 5 frames a K1 block, 4 a K3
                    # tile) and observed-gesture (m = 8) tables, and a trial
                    # group of two on the head axis (16 heads)
                    (8, 8, 45, 30, 100), (8, 8, 8, 30, 100), (16, 8, 15, 30, 100),
                    (16, 8, 45, 30, 33)]


@pytest.mark.parametrize("H,d,m,W,T", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain(cuda_device, rng, H, d, m, W, T):
    q, k, v = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
               for s in ((H, d, T * m), (H, d, T), (H, d, T)))
    before = tatt.sliding_window_attention_packed.launches
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    torch.cuda.synchronize()
    want_out, want_stats = tatt.sliding_window_attention_packed_plain(q, k, v, W, m)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-5)
    assert tatt.sliding_window_attention_packed.launches == before + 1


def _stack(rng, L, T, C, device):
    """Weights at the model's init scale, U(±1/sqrt(fan_in)): activations
    stay O(10) over 41 layers, where float32 sums agree to ~1e-5."""
    def u(shape, fan_in):
        return (rng.uniform(-1, 1, size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return [_dev(a, device) for a in (
        u((L, 3, C, C), 3 * C), u((L, C), 3 * C), u((L, C, C), C), u((L, C), C),
        rng.integers(0, 2, size=(L, T, C)).astype(np.uint8))]


# T = 1 and 5: every dilation but the first reaches past the sequence; 18
# and 300: a 300-frame request's fast and slow paths; 4097: a ragged last
# tile; 4096: the grid at its fullest
@pytest.mark.parametrize("C,L,T", [(64, 11, 1000), (64, 10, 20), (8, 5, 33),
                                   (16, 3, 64), (32, 4, 31), (64, 11, 1), (64, 11, 5),
                                   (64, 11, 18), (64, 10, 300), (64, 11, 4097),
                                   (8, 4, 1), (16, 6, 5), (32, 11, 4097)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_tcn_stack_kernel_matches_plain(cuda_device, rng, C, L, T, causal, use_mask):
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device)
    w3, b3, w1, b1, mask = _stack(rng, L, T, C, cuda_device)
    m = mask if use_mask else None
    before = ttcn.dilated_residual_stack.launches
    got = ttcn.dilated_residual_stack(x, w3, b3, w1, b1, causal=causal, mask=m)
    torch.cuda.synchronize()
    want = ttcn.dilated_stack_xla(x, w3, b3, w1, b1, causal=causal, mask=m)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert ttcn.dilated_residual_stack.launches == before + 1


@pytest.mark.parametrize("T", [257, 1, 5, 18, 300, 4096, 4097])
@pytest.mark.parametrize("use_mask", [False, True])
def test_tcn_multistack_kernel_matches_plain(cuda_device, rng, use_mask, T):
    """COG's 41 layers (11 + 3 x 10) at C=64 in one launch."""
    C, layers = 64, (11, 10, 10, 10)
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device)
    stages = [_stack(rng, L, T, C, cuda_device) for L in layers]
    masks = [s[4] for s in stages] if use_mask else None
    before = ttcn.dilated_residual_multistack_stages.launches
    got = ttcn.dilated_residual_multistack_stages(
        x, [s[:4] for s in stages], 11, 10, masks=masks)
    torch.cuda.synchronize()
    h, want = x, []
    for s, st in enumerate(stages):
        h = ttcn.dilated_stack_xla(h, *st[:4], mask=None if masks is None else masks[s])
        want.append(h)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-4, atol=1e-4)
    assert ttcn.dilated_residual_multistack_stages.launches == before + 1


@pytest.mark.parametrize("C,T,layers", [(64, 1, (11, 10)), (64, 5, (11, 10, 10, 10)),
                                        (64, 18, (11,)), (64, 300, (11, 10, 10, 10)),
                                        (64, 4097, (11, 10)), (8, 33, (3, 2, 2)),
                                        (16, 64, (4,)), (32, 300, (2, 5))])
@pytest.mark.parametrize("causal", [True, False])
def test_tcn_saving_forward_matches_plain_and_feeds_the_backward(cuda_device, rng, C, T,
                                                                 layers, causal):
    """The training forward's stage outputs and saved (Lt, T, C) h and y
    against the plain saving forward, then the backward kernels (K4) on them
    against the plain backward, on the same saved tensors."""
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device)
    stages = [_stack(rng, L, T, C, cuda_device) for L in layers]
    ws, masks = [s[:4] for s in stages], [s[4] for s in stages]
    before = ttcn.dilated_residual_multistack_stages.launches
    got = ttcn._stages_fwd(x, ws, masks, causal, ttcn.dilated_residual_multistack_stages,
                           save=True)
    torch.cuda.synchronize()
    assert ttcn.dilated_residual_multistack_stages.launches == before + 1
    want = ttcn._stages_fwd(x.cpu(), [[t.cpu() for t in w] for w in ws],
                            [mk.cpu() for mk in masks], causal,
                            ttcn.dilated_residual_multistack_stages, save=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    _, h_saved, y_saved = got
    g = _dev(rng.normal(size=(len(layers), T, C)).astype(np.float32), cuda_device)
    dx, dws = ttcn._stages_bwd(g, h_saved, y_saved, [(w[0], w[2]) for w in ws], masks,
                               causal, ttcn.dilated_residual_multistack_stages_bwd)
    want_dx, want_dws = ttcn._stages_bwd_plain(g, h_saved, y_saved,
                                               [(w[0], w[2]) for w in ws], masks, causal)
    _close_grad(dx, want_dx)
    for got_w, want_w in zip(dws, want_dws):
        for a, b in zip(got_w, want_w):
            _close_grad(a, b)


def test_tcn_forward_launch_fills_the_card_and_its_barrier_floor_runs(cuda_device, rng):
    """The one-launch forward's grid, as the launch reports it: at most one
    block a tile and no more than the card runs at once; the barrier-only
    launch on the same grid."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    grids = {}
    for T, C in ((1, 64), (18, 64), (300, 64), (1024, 64), (4096, 64), (4097, 8)):
        x = _dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device)
        ttcn.dilated_residual_stack(x, *_stack(rng, 2, T, C, cuda_device)[:4])
        blocks, rows = grids[T, C] = ttcn.dilated_residual_stack.last_launch
        assert 1 <= blocks <= -(-T // rows)
        assert blocks <= sms * (1 if C == 64 else 8)
    if sms == 132:          # an H100 SXM: one block an SM at C=64
        assert grids[4096, 64] == (128, 32)
        assert grids[1024, 64] == (64, 16)
    ttcn.forward_barriers(grids[4096, 64], 64, 40)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):        # no instance has 7-row tiles
        ttcn.forward_barriers((4, 7), 64, 1)


@pytest.mark.parametrize("S", [17, 33])
@pytest.mark.parametrize("T", [5, 300])
def test_tcn_forward_takes_more_than_16_stacks(cuda_device, rng, S, T):
    """More stacks than one launch carries: one launch for every 16, the
    stage outputs and saved h, y continuing across launches, per-stage and
    concatenated operands alike."""
    C, layers = 16, (2,) + (1,) * (S - 1)
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device)
    stages = [_stack(rng, L, T, C, cuda_device) for L in layers]
    ws, masks = [s[:4] for s in stages], [s[4] for s in stages]
    launches = -(-S // 16)
    before = ttcn.dilated_residual_multistack_stages.launches
    got = ttcn._stages_fwd(x, ws, masks, True, ttcn.dilated_residual_multistack_stages,
                           save=True)
    torch.cuda.synchronize()
    assert ttcn.dilated_residual_multistack_stages.launches == before + launches
    want = ttcn._stages_fwd(x.cpu(), [[t.cpu() for t in w] for w in ws],
                            [mk.cpu() for mk in masks], True,
                            ttcn.dilated_residual_multistack_stages, save=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    cat = [torch.cat(t) for t in zip(*ws)]
    before = ttcn.dilated_residual_multistack.launches
    got = ttcn._multistack_fwd(x, *cat, torch.cat(masks), 2, 1, True, save=True)
    torch.cuda.synchronize()
    assert ttcn.dilated_residual_multistack.launches == before + launches
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_kernels_reject_inputs_they_do_not_take(cuda_device):
    q = torch.zeros(2, 8, 30, device=cuda_device)
    k = torch.zeros(2, 8, 10, device=cuda_device)
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_packed(q, k, k, 5, 4)          # N != T*m
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_packed(q.double(), k.double(), k.double(), 5, 3)
    x = torch.zeros(16, 48, device=cuda_device)
    w = (torch.zeros(2, 3, 48, 48, device=cuda_device), torch.zeros(2, 48, device=cuda_device),
         torch.zeros(2, 48, 48, device=cuda_device), torch.zeros(2, 48, device=cuda_device))
    with pytest.raises(ValueError):
        ttcn.dilated_residual_stack(x, *w)                           # C=48
    x = torch.zeros(0, 8, device=cuda_device)
    w = [t[..., :8, :8] if t.dim() > 2 else t[:, :8] for t in w]
    w = [t.contiguous() for t in w]
    before = ttcn.dilated_residual_stack.launches
    with pytest.raises(ValueError, match="at least one row"):
        ttcn.dilated_residual_stack(x, *w)                           # T=0
    long = [torch.zeros((31, *t.shape[1:]), device=cuda_device) for t in w]
    with pytest.raises(ValueError, match="1 to 30 layers"):
        ttcn.dilated_residual_stack(torch.zeros(4, 8, device=cuda_device), *long)
    assert ttcn.dilated_residual_stack.launches == before


def test_small_cog_serves_the_same_on_card_and_cpu(cuda_device, rng):
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", out_features=2,
                           video_dims=32, num_layers_Basic=4, num_layers_R=3,
                           num_R=2, mstcn_f_maps=32, d_model=32, d_q=4,
                           sequence_length=5)
    exp = Experiment(cfg, device="cpu")
    tree = export_jax_params(init_weights(exp.net, torch.Generator().manual_seed(5)))
    images = rng.normal(size=(300, 2048)).astype(np.float32)
    kin = rng.normal(size=(300, 26)).astype(np.float32)
    ops.reset_launch_counts()
    got_p, got_pr = FrameModelServer(cfg, tree).predict_trial(images, kin)
    counts = ops.launch_counts()
    want_p, want_pr = FrameModelServer(cfg, tree, device="cpu").predict_trial(images, kin)
    np.testing.assert_allclose(got_pr, want_pr, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_p[np.abs(want_pr - 0.5) > 1e-5],
                                  want_p[np.abs(want_pr - 0.5) > 1e-5])
    assert counts == {**OP_API_IDLE,
                      "sliding_window_attention_packed": 2,
                      "dilated_residual_multistack_stages": 1,
                      "dilated_residual_stack": 1 + 2,
                      "sliding_window_attention_packed_bwd": 0,
                      "dilated_residual_multistack_stages_bwd": 0,
                      "dilated_residual_stack_bwd": 0,
                      "fused_bottleneck_stage": 0}


def _close_grad(got, want):
    atol = 1e-5 * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("H,d,m,W,T", ATTENTION_SHAPES)
def test_attention_bwd_kernel_matches_plain(cuda_device, rng, H, d, m, W, T):
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m)))
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    before = tatt.sliding_window_attention_packed_bwd.launches
    got = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)
    torch.cuda.synchronize()
    want = tatt.sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats, W, m)
    for a, b in zip(got, want):
        _close_grad(a, b)
    assert tatt.sliding_window_attention_packed_bwd.launches == before + 1


def _offset_view(a, device):
    """``a`` on the card in a contiguous view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(a.size + 1, dtype=torch.float32, device=device)
    buf[1:] = torch.as_tensor(a.ravel(), device=device)
    view = buf[1:].view(a.shape)
    assert view.data_ptr() % 16 == 4
    return view


def test_attention_kernels_take_views_off_16_byte_boundaries(cuda_device, rng):
    H, d, m, W, T = 8, 8, 15, 30, 40
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m))]
    q, k, v, g = (_offset_view(a, cuda_device) for a in arrays)
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    want_out, want_stats = tatt.sliding_window_attention_packed_plain(q, k, v, W, m)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-5)
    out = _offset_view(out.cpu().numpy(), cuda_device)
    got = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)
    want = tatt.sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats, W, m)
    for a, b in zip(got, want):
        _close_grad(a, b)


def test_head_width_2_attention_takes_views_off_16_byte_boundaries(cuda_device, rng):
    """TransSVNet's D=2 instances (8-byte rows) with every operand 4 bytes
    past a 16-byte boundary."""
    H, d, m, W, T = 8, 2, 30, 30, 45
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m))]
    q, k, v, g = (_offset_view(a, cuda_device) for a in arrays)
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    want_out, want_stats = tatt.sliding_window_attention_packed_plain(q, k, v, W, m)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-5)
    out = _offset_view(out.cpu().numpy(), cuda_device)
    stats = _offset_view(stats.cpu().numpy(), cuda_device)
    got = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)
    want = tatt.sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats, W, m)
    for a, b in zip(got, want):
        _close_grad(a, b)


@pytest.mark.parametrize("T,d,m", [(17, 8, 15), (4096, 8, 15), (4096, 2, 30)])
def test_attention_bwd_kernel_gives_the_same_bits_twice(cuda_device, rng, T, d, m):
    H, W = 8, 30
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m)))
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    first = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)
    second = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _device_kernels(fn, calls: int = 1):
    """Names of the kernels the card ran during ``calls`` calls of ``fn``,
    by ``chip_smoke.py``'s profiler helper (which takes a session that
    recorded no device event at all again)."""
    from chip_smoke import _device_events

    return [e.name for e in _device_events(fn, calls)]


def test_attention_kernels_launch_only_themselves(cuda_device, rng):
    """A K1 call runs one kernel and a K3 call one: no delta pass, no copy,
    no fill; each wrapper counts its one launch."""
    H, d, m, W, T = 8, 8, 15, 30, 64
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m)))
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    fwd = tatt.sliding_window_attention_packed
    bwd = tatt.sliding_window_attention_packed_bwd
    before = fwd.launches, bwd.launches
    names = _device_kernels(lambda: fwd(q, k, v, W, m, return_stats=True))
    assert len(names) == 1 and "swa_packed_fwd" in names[0], names
    names = _device_kernels(lambda: bwd(q, k, v, g, out, stats, W, m))
    assert len(names) == 1 and "swa_packed_bwd" in names[0], names
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)


def _grads(fn, x, weights, g):
    x = x.clone().requires_grad_()
    ws = [[t.clone().requires_grad_() for t in w] for w in weights]
    out = fn(x, ws)
    out.backward(g)
    return out.detach(), x.grad, [[t.grad for t in w] for w in ws]


@pytest.mark.parametrize("C,L,T", [(64, 11, 1000), (64, 10, 20), (8, 5, 33),
                                   (16, 3, 64), (32, 4, 300)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_tcn_stack_bwd_kernel_matches_plain(cuda_device, rng, C, L, T, causal, use_mask):
    """Card (saving forward K2 + backward K5) against the CPU's plain saving
    forward and plain backward, on the same inputs."""
    x = rng.normal(size=(T, C)).astype(np.float32)
    w3, b3, w1, b1, mask = _stack(rng, L, T, C, "cpu")
    g = rng.normal(size=(T, C)).astype(np.float32)
    m = mask if use_mask else None
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        fn = lambda xt, ws: ttcn.dilated_residual_stack(  # noqa: E731
            xt, *ws[0], causal=causal, mask=None if m is None else m.to(dev))
        before = ttcn.dilated_residual_stack_bwd.launches
        results.append(_grads(fn, _dev(x, dev), [[t.to(dev) for t in (w3, b3, w1, b1)]],
                              _dev(g, dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ttcn.dilated_residual_stack_bwd.launches == before + 1
    (o, dx, (dws,)), (wo, wdx, (wdws,)) = results
    torch.testing.assert_close(o.cpu(), wo, rtol=1e-4, atol=1e-4)
    for a, b in zip([dx, *dws], [wdx, *wdws]):
        _close_grad(a.cpu(), b)


@pytest.mark.parametrize("use_mask", [False, True])
def test_tcn_multistack_bwd_kernel_matches_plain(cuda_device, rng, use_mask):
    C, T, layers = 64, 257, (11, 10, 10, 10)
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device)
    stages = [_stack(rng, L, T, C, cuda_device) for L in layers]
    masks = [s[4] for s in stages] if use_mask else None
    g = _dev(rng.normal(size=(len(layers), T, C)).astype(np.float32), cuda_device)
    _, h_saved, y_saved = ttcn._stages_fwd(x, [s[:4] for s in stages], masks, True,
                                           ttcn.dilated_residual_multistack_stages,
                                           save=True)
    p_out, p_h, p_y = ttcn._stages_fwd(x.cpu(), [[t.cpu() for t in s[:4]] for s in stages],
                                       None if masks is None else [mk.cpu() for mk in masks],
                                       True, ttcn.dilated_residual_multistack_stages,
                                       save=True)
    torch.testing.assert_close(h_saved.cpu(), p_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y_saved.cpu(), p_y, rtol=1e-4, atol=1e-4)
    before = ttcn.dilated_residual_multistack_stages_bwd.launches
    dx, dws = ttcn.dilated_residual_multistack_stages_bwd(
        g, h_saved, y_saved, [s[:4] for s in stages], 11, 10, masks=masks)
    torch.cuda.synchronize()
    assert ttcn.dilated_residual_multistack_stages_bwd.launches == before + 1
    want_dx, want_dws = ttcn._stages_bwd_plain(g, h_saved, y_saved,
                                               [(s[0], s[2]) for s in stages], masks, True)
    _close_grad(dx, want_dx)
    for got, want in zip(dws, want_dws):
        for a, b in zip(got, want):
            _close_grad(a, b)


def _stages_bwd_case(rng, C, T, layers, causal, use_mask, device):
    """Saved h, y from the card's saving forward, a cotangent on every stage
    output, and each stage's (w3, w1) and mask, for a backward call."""
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), device)
    stages = [_stack(rng, L, T, C, device) for L in layers]
    masks = [s[4] for s in stages] if use_mask else None
    _, h_saved, y_saved = ttcn._stages_fwd(x, [s[:4] for s in stages], masks, causal,
                                           ttcn.dilated_residual_multistack_stages,
                                           save=True)
    g = _dev(rng.normal(size=(len(layers), T, C)).astype(np.float32), device)
    return g, h_saved, y_saved, [(s[0], s[2]) for s in stages], masks


# T = 1: one row, every tap but the centre outside; 17 and 33: one row past
# a 16- or 32-row tile
@pytest.mark.parametrize("C", [8, 16, 32, 64])
@pytest.mark.parametrize("T", [1, 17, 33])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_tcn_bwd_kernel_at_short_sequences(cuda_device, rng, C, T, causal, use_mask):
    """The one-launch backward at sequences shorter than, or one row past, a
    tile, for every channel count: three stages, so each stage's cotangent
    enters at its own layer."""
    g, h_saved, y_saved, ws, masks = _stages_bwd_case(rng, C, T, (3, 2, 2), causal,
                                                      use_mask, cuda_device)
    before = ttcn.dilated_residual_multistack_stages_bwd.launches
    dx, dws = ttcn._stages_bwd(g, h_saved, y_saved, ws, masks, causal,
                               ttcn.dilated_residual_multistack_stages_bwd)
    torch.cuda.synchronize()
    assert ttcn.dilated_residual_multistack_stages_bwd.launches == before + 1
    want_dx, want_dws = ttcn._stages_bwd_plain(g, h_saved, y_saved, ws, masks, causal)
    _close_grad(dx, want_dx)
    for got, want in zip(dws, want_dws):
        for a, b in zip(got, want):
            _close_grad(a, b)


@pytest.mark.parametrize("T", [300, 4097])
def test_tcn_bwd_kernel_gives_the_same_bits_twice(cuda_device, rng, T):
    """Two backward calls on the same inputs are equal bit for bit: no
    atomics, the weight-gradient partials summed in chunk order (at T=4097
    there are nine 512-row chunks)."""
    g, h_saved, y_saved, ws, masks = _stages_bwd_case(rng, 64, T, (11, 10, 10, 10), True,
                                                      True, cuda_device)
    runs = [ttcn._stages_bwd(g, h_saved, y_saved, ws, masks, True,
                             ttcn.dilated_residual_multistack_stages_bwd) for _ in range(2)]
    torch.cuda.synchronize()
    (dx0, dws0), (dx1, dws1) = runs
    assert torch.equal(dx0, dx1)
    for got, want in zip(dws0, dws1):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_tcn_bwd_launch_fills_the_card_and_its_barrier_floor_runs(cuda_device, rng):
    """The one-launch backward's grid, as the launch reports it: at most one
    block a tile and no more than the card runs at once; the barrier-only
    launch on the same grid."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    grids = {}
    for T, C in ((1, 64), (18, 64), (300, 64), (1024, 64), (4096, 64), (4097, 8)):
        g, h_saved, y_saved, ws, _ = _stages_bwd_case(rng, C, T, (2,), True, False,
                                                      cuda_device)
        ttcn.dilated_residual_stack_bwd(g[0], h_saved, y_saved, *ws[0])
        blocks, rows = grids[T, C] = ttcn.dilated_residual_stack_bwd.last_launch
        assert 1 <= blocks <= -(-T // rows)
        assert blocks <= sms * (1 if C == 64 else 8)
    if sms == 132:          # an H100 SXM: one block an SM at C=64
        assert grids[4096, 64] == (128, 32)
        assert grids[1024, 64] == (64, 16)
    ttcn.backward_barriers(grids[4096, 64], 64, ttcn.backward_barrier_count(41, 4096))
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):        # no instance has 7-row tiles
        ttcn.backward_barriers((4, 7), 64, 1)


@pytest.mark.parametrize("S", [17, 33])
@pytest.mark.parametrize("T", [5, 300])
def test_tcn_backward_takes_more_than_16_stacks(cuda_device, rng, S, T):
    """More stacks than one launch carries: one launch for every 16, the
    last group first, dh carried from launch to launch; per-stage and
    concatenated operands alike, against the plain backward."""
    C, layers = 16, (2,) + (1,) * (S - 1)
    g, h_saved, y_saved, ws, masks = _stages_bwd_case(rng, C, T, layers, True, True,
                                                      cuda_device)
    launches = -(-S // 16)
    before = ttcn.dilated_residual_multistack_stages_bwd.launches
    dx, dws = ttcn._stages_bwd(g, h_saved, y_saved, ws, masks, True,
                               ttcn.dilated_residual_multistack_stages_bwd)
    torch.cuda.synchronize()
    assert ttcn.dilated_residual_multistack_stages_bwd.launches == before + launches
    want_dx, want_dws = ttcn._stages_bwd_plain(g, h_saved, y_saved, ws, masks, True)
    _close_grad(dx, want_dx)
    for got, want in zip(dws, want_dws):
        for a, b in zip(got, want):
            _close_grad(a, b)
    w3, w1 = (torch.cat(t) for t in zip(*ws))
    bwd = ttcn.dilated_residual_multistack_bwd
    before = bwd.launches
    grads = bwd(g, h_saved, y_saved, w3, w1, 2, 1, mask=torch.cat(masks))
    torch.cuda.synchronize()
    assert bwd.launches == before + launches
    want = (want_dx, *(torch.cat(t) for t in zip(*want_dws)))
    for a, b in zip(grads, want):
        _close_grad(a, b)


def test_small_cog_train_step_same_on_card_and_cpu(cuda_device, rng):
    """One train step with the same weights and dropout masks on the card and
    on the CPU: equal loss and gradients, and the designed kernel launches on
    the card. Gradients, leaf by leaf: rtol 1e-4, atol 1e-5 of the leaf's
    own largest value; 5e-4 for the encoder FFN's leaves, where float32
    summed in another order flips a few relu derivatives, each of which
    moves one token's term of Dense_0's weight gradient."""
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.data.datasets import FrameTrial, frame_batch
    from med_tpu_torch.data.labels import skill_one_hot
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    cfg = ExperimentConfig(model_name="COG", dataset_type="frame", out_features=2,
                           video_dims=32, num_layers_Basic=4, num_layers_R=3,
                           num_R=2, mstcn_f_maps=32, d_model=32, d_q=4,
                           sequence_length=5, weight_decay=0.0, lr_scheduler=False)
    T, name = 300, "Needle_Passing_B001"
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = rng.integers(0, 2, T)
    trial = FrameTrial(name, rng.normal(size=(T, 2048)).astype(np.float32),
                       rng.normal(size=(T, 26)).astype(np.float32),
                       rng.integers(0, 15, T), e, skill_one_hot(name, T))
    batch = frame_batch(trial, cfg)
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        batch["images"].shape[1], torch.Generator().manual_seed(1))
    losses, grads = [], []
    for device in (cuda_device, torch.device("cpu")):
        exp = Experiment(cfg, device=device)
        exp.init_weights(5)
        ops.reset_launch_counts()
        loss, _ = exp.compute_gradients(
            batch, masks={n: {k: v.to(device) for k, v in d.items()} for n, d in masks.items()})
        counts = ops.launch_counts()
        losses.append(loss.item())
        grads.append(export_jax_params(exp.net, grads=True)["params"])
    assert counts == {k: 0 for k in counts}
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", v

    want = dict(leaves(grads[1]))
    for path, got in leaves(grads[0]):
        atol = (5e-4 if "/ffn/Dense_" in path else 1e-5) * np.abs(want[path]).max()
        np.testing.assert_allclose(got, want[path], rtol=1e-4, atol=atol, err_msg=path)
    exp = Experiment(cfg, device=cuda_device)
    exp.init_weights(5)
    ops.reset_launch_counts()
    exp.train_step(batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **OP_API_IDLE,
        "sliding_window_attention_packed": 2,
        "dilated_residual_multistack_stages": 1,
        "dilated_residual_stack": 1 + 2,
        "sliding_window_attention_packed_bwd": 2,
        "dilated_residual_multistack_stages_bwd": 1,
        "dilated_residual_stack_bwd": 3,
        "fused_bottleneck_stage": 0}


def _stage_blocks(rng, cin, f, n, proj, device):
    """Folded operands of n stride-1 blocks at f, the first with the
    projection when ``proj``; weights at He scale so activations stay O(1)."""
    blocks = []
    for b in range(n):
        c_in = cin if b == 0 else 4 * f
        blk = {"w1": rng.normal(size=(c_in, f)) * np.sqrt(2 / c_in),
               "c1": rng.normal(size=(1, f)) * 0.1,
               "w2": rng.normal(size=(9, f, f)) * np.sqrt(2 / (9 * f)),
               "c2": rng.normal(size=(1, f)) * 0.1,
               "w3": rng.normal(size=(f, 4 * f)) * np.sqrt(1 / f),
               "c3": rng.normal(size=(1, 4 * f)) * 0.1}
        if b == 0 and proj:
            blk["wd"] = rng.normal(size=(c_in, 4 * f)) * np.sqrt(1 / c_in)
            blk["cd"] = rng.normal(size=(1, 4 * f)) * 0.1
        blocks.append({k: _dev(v.astype(np.float32), device) for k, v in blk.items()})
    return blocks


def _stage_errors(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return ((torch.linalg.norm(got - want) / torch.linalg.norm(want)).item(),
            (err.max() / want.abs().max()).item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,f,n,proj", [
    (2, 16, 16, 8, 8, 2, True),        # stage 0 of a width-8 trunk
    (3, 8, 8, 64, 16, 2, False),       # identity blocks only
    (1, 7, 8, 24, 12, 1, True),        # f not a multiple of the k-step
    (2, 56, 56, 64, 64, 3, True),      # full-width stage 0 shapes
    (2, 28, 28, 512, 128, 1, False)])  # a full-width stage 1 block
def test_resnet_stage_kernel_matches_plain(cuda_device, rng, dtype, B, H, W, cin, f, n, proj):
    blocks = _stage_blocks(rng, cin, f, n, proj, cuda_device)
    x = _dev(np.maximum(rng.normal(size=(B, H * W, cin)), 0).astype(np.float32),
             cuda_device)
    before = trf.fused_bottleneck_stage.launches
    by_instance = dict(trf.fused_bottleneck_stage.instances)
    got = trf.fused_bottleneck_stage(x, blocks, Wr=W, dtype=dtype)
    torch.cuda.synchronize()
    assert trf.fused_bottleneck_stage.launches == before + 3 * n
    instance = ("fp32" if dtype == torch.float32 else
                "bf16 16-byte" if cin % 8 == 0 and f % 8 == 0 else "bf16 guarded")
    assert _launches_by_instance(by_instance) == {instance: 3 * n}
    want = trf.fused_bottleneck_stage_plain(x, blocks, Wr=W, dtype=dtype)
    assert got.dtype == dtype and got.shape == (B, H * W, 4 * f)
    rel, peak = _stage_errors(got, want)
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 2 ** -5)
    assert rel <= tol[0] and peak <= tol[1], (rel, peak)


def _launches_by_instance(before):
    now = trf.fused_bottleneck_stage.instances
    return {k: v - before.get(k, 0) for k, v in now.items() if v - before.get(k, 0)}


@pytest.mark.parametrize("B,H,W,cin,f,n,proj", [
    (1, 12, 20, 32, 16, 2, True),      # M = 240: a ragged 128-row tile; W not a multiple of 8
    (2, 8, 8, 64, 16, 1, True),        # Cin = 4f with the projection
    (1, 28, 28, 256, 128, 1, True)])   # a stage-1 block with the projection
def test_resnet_stage_bf16_tails_take_the_16_byte_instance(cuda_device, rng, B, H, W, cin, f,
                                                           n, proj):
    """The tensor-core instance at tile tails: ragged rows, image rows that
    cut 8-row fragments, the projection's K-steps after y2's."""
    blocks = _stage_blocks(rng, cin, f, n, proj, cuda_device)
    x = _dev(np.maximum(rng.normal(size=(B, H * W, cin)), 0).astype(np.float32),
             cuda_device)
    before = dict(trf.fused_bottleneck_stage.instances)
    got = trf.fused_bottleneck_stage(x, blocks, Wr=W, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _launches_by_instance(before) == {"bf16 16-byte": 3 * n}
    want = trf.fused_bottleneck_stage_plain(x, blocks, Wr=W, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H * W, 4 * f)
    rel, peak = _stage_errors(got, want)
    assert rel <= 2 ** -7 and peak <= 2 ** -5, (rel, peak)


def test_resnet_stage_bf16_unaligned_view_takes_the_guarded_instance(cuda_device, rng):
    """x a view one element into its storage (2 bytes off 16): the launches
    that read it (reduce, expand with the projection) take the guarded
    instance, the others the 16-byte one, and all match the plain version."""
    B, H, W, cin, f = 2, 8, 12, 24, 8
    blocks = _stage_blocks(rng, cin, f, 2, True, cuda_device)
    x = np.maximum(rng.normal(size=(B, H * W, cin)), 0).astype(np.float32)
    flat = torch.zeros(x.size + 1, dtype=torch.bfloat16, device=cuda_device)
    flat[1:] = _dev(x.reshape(-1), cuda_device).to(torch.bfloat16)
    xv = flat[1:].view(B, H * W, cin)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 2
    before = dict(trf.fused_bottleneck_stage.instances)
    got = trf.fused_bottleneck_stage(xv, blocks, Wr=W, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _launches_by_instance(before) == {"bf16 guarded": 2, "bf16 16-byte": 4}
    want = trf.fused_bottleneck_stage_plain(xv, blocks, Wr=W, dtype=torch.bfloat16)
    rel, peak = _stage_errors(got, want)
    assert rel <= 2 ** -7 and peak <= 2 ** -5, (rel, peak)


def test_resnet_stage_kernel_rejects_what_it_does_not_take(cuda_device, rng):
    blocks = _stage_blocks(rng, 8, 8, 1, True, cuda_device)
    x = torch.zeros(1, 64, 8, device=cuda_device)
    before = trf.fused_bottleneck_stage.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trf.fused_bottleneck_stage(x, blocks, Wr=8, dtype=torch.float16)
    cpu_blocks = [{k: v.cpu() for k, v in blk.items()} for blk in blocks]
    with pytest.raises(ValueError, match="contiguous"):
        trf.fused_bottleneck_stage(x, cpu_blocks, Wr=8, dtype=torch.float32)
    bad = [dict(blocks[0], w2=blocks[0]["w2"][:4])]
    with pytest.raises(ValueError, match="w2 has shape"):
        trf.fused_bottleneck_stage(x, bad, Wr=8, dtype=torch.float32)
    assert trf.fused_bottleneck_stage.launches == before


def test_small_trunk_and_pixel_front_end_same_on_card_and_cpu(cuda_device, rng):
    """A (2, 2, 1, 1) width-8 trunk with seeded weights and statistics: the
    fused apply on the card (three launches for each of stage 0's two
    blocks and stage 1's one stride-1 block) against the CPU's, the module
    trunk on the card against the CPU, and PixelFrontEnd (ImageNet path) on
    both. float32 with TF32 off: relative L2 within 1e-5."""
    from med_tpu_torch.eval.serving import PixelFrontEnd
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.models.resnet import ResNet50
    from med_tpu_torch.utils.jax_params import export_jax_params

    net = init_weights(ResNet50((2, 2, 1, 1), 8), torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(4)) * 0.1)
    tree = export_jax_params(net)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        v = trf.fold_trunk(tree, dtype=torch.float32, device=dev)
        before = trf.fused_bottleneck_stage.launches
        fused = trf.resnet50_fused_apply(v, _dev(x, dev), stage_sizes=(2, 2, 1, 1),
                                         dtype=torch.float32)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert trf.fused_bottleneck_stage.launches == before + 3 * (2 + 1)
        with torch.no_grad():
            module = net.to(dev)(_dev(x, dev))
        outs.append((fused.cpu(), module.cpu()))
    for got, want in zip(*outs):
        assert _stage_errors(got, want)[0] <= 1e-5
    frames = rng.integers(0, 256, size=(5, 480, 640, 3)).astype(np.uint8)
    feats = [PixelFrontEnd(tree["params"], tree["batch_stats"], dtype=torch.float32,
                           stage_sizes=(2, 2, 1, 1), width=8, batch_size=4,
                           device=dev).features(frames)
             for dev in (cuda_device, "cpu")]
    assert np.linalg.norm(feats[0] - feats[1]) <= 1e-5 * np.linalg.norm(feats[1])


# --- the concatenated multistack (K6, K7) and head-major attention (K8, K9) ---

def _multistack_inputs(rng, C, T, L0, Lr, S, device):
    Lt = L0 + Lr * (S - 1)
    x = _dev(rng.normal(size=(T, C)).astype(np.float32), device)
    return (x, *_stack(rng, Lt, T, C, device))


@pytest.mark.parametrize("C,T,L0,Lr,S", [(64, 257, 11, 10, 4), (8, 33, 3, 2, 3),
                                         (16, 64, 4, 4, 1), (32, 300, 2, 5, 2),
                                         (64, 1, 11, 10, 4), (64, 5, 11, 10, 2),
                                         (64, 4097, 11, 10, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_concatenated_multistack_kernels_match_plain(cuda_device, rng, C, T, L0, Lr,
                                                     S, causal, use_mask):
    """K6 (plain and saving) and K7 against their plain versions, and
    autograd through the dispatcher equal to the direct backward call."""
    x, w3, b3, w1, b1, mask = _multistack_inputs(rng, C, T, L0, Lr, S, cuda_device)
    Lt = w3.shape[0]
    m = mask if use_mask else None
    fwd, bwd = ttcn.dilated_residual_multistack, ttcn.dilated_residual_multistack_bwd
    before = fwd.launches
    got = fwd(x, w3, b3, w1, b1, L0, Lr, causal=causal, mask=m)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    want, want_h, want_y = ttcn.dilated_residual_multistack_plain(
        x, w3, b3, w1, b1, L0, Lr, causal=causal, mask=m, save=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    hs, h_saved, y_saved = ttcn._multistack_fwd(x, w3, b3, w1, b1, m, L0, Lr, causal,
                                                save=True)
    torch.testing.assert_close(hs, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_saved, want_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y_saved, want_y, rtol=1e-4, atol=1e-4)
    g = _dev(rng.normal(size=(S, T, C)).astype(np.float32), cuda_device)
    before = bwd.launches
    grads = bwd(g, h_saved, y_saved, w3, w1, L0, Lr, causal=causal, mask=m)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    want_grads = ttcn.dilated_residual_multistack_bwd_plain(
        g, h_saved, y_saved, w3, w1, L0, Lr, causal=causal, mask=m)
    for a, b in zip(grads, want_grads):
        _close_grad(a, b)
    leaves = [t.clone().requires_grad_() for t in (x, w3, b3, w1, b1)]
    auto = torch.autograd.grad(fwd(*leaves, L0, Lr, causal=causal, mask=m), leaves, g)
    for a, b in zip(auto, grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("H,d,m,W,T", [(8, 8, 15, 30, 100), (2, 4, 3, 5, 41),
                                       (3, 16, 1, 7, 300), (1, 32, 300, 3, 5),
                                       (8, 8, 15, 30, 1024)])
def test_head_major_attention_kernels_match_plain(cuda_device, rng, H, d, m, W, T):
    """K8 and K9 against their plain versions, and autograd through the
    dispatcher equal to the direct calls."""
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d)))
    fwd, bwd = tatt.sliding_window_attention_pallas, tatt.sliding_window_attention_bwd_pallas
    counts = fwd.launches, bwd.launches
    out = fwd(q, k, v, W)
    grads = bwd(q, k, v, g, W)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    torch.testing.assert_close(out, tatt.sliding_window_attention_xla(q, k, v, W),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(grads, tatt.sliding_window_attention_bwd_plain(q, k, v, g, W)):
        _close_grad(a, b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(tatt.sliding_window_attention(*leaves, W), leaves, g)
    for a, b in zip(auto, grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    plain = torch.autograd.grad(
        tatt.sliding_window_attention(*leaves, W, use_pallas=False), leaves, g)
    for a, b in zip(auto, plain):
        _close_grad(a, b)


# K8 and K9 at the widest windows the kernels before them ran at m=15
# (their shared memory held K8 to W = 7248, 3616, 1800, 892 and K9 to 3939,
# 1854, 796, 286 for d = 4, 8, 16, 32; K9 now walks a window no tile holds
# whole in chunks); m = 1 and 300; T = 37, a multiple of no tile or block
# (K8: 16 frames a block, K9: 8 or 16 a tile); H = 1
HEAD_MAJOR_WINDOWS = [(1, 4, 15, 7248, 40), (1, 8, 15, 3616, 40), (1, 16, 15, 1800, 40),
                      (1, 32, 15, 892, 40), (1, 4, 15, 3939, 40), (1, 8, 15, 1854, 40),
                      (1, 16, 15, 796, 40), (1, 32, 15, 286, 40), (2, 8, 1, 30, 37),
                      (1, 8, 300, 30, 37), (1, 32, 300, 30, 5), (3, 4, 15, 30, 37)]


@pytest.mark.parametrize("H,d,m,W,T", HEAD_MAJOR_WINDOWS)
def test_head_major_kernels_take_every_window_their_parents_took(cuda_device, rng, H, d, m,
                                                                 W, T):
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d)))
    out = tatt.sliding_window_attention_pallas(q, k, v, W)
    grads = tatt.sliding_window_attention_bwd_pallas(q, k, v, g, W)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tatt.sliding_window_attention_xla(q, k, v, W),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(grads, tatt.sliding_window_attention_bwd_plain(q, k, v, g, W)):
        _close_grad(a, b)


def _instances_since(fn, before):
    return {k: n - before.get(k, 0) for k, n in fn.instances.items() if n - before.get(k, 0)}


@pytest.mark.parametrize("operand", ["q", "k", "g"])
def test_head_major_kernels_take_views_off_16_byte_boundaries(cuda_device, rng, operand):
    """One operand a contiguous view 4 bytes past a 16-byte boundary: the C
    entries take their 4-byte instance (counted in ``.instances``) and match
    the plain versions; the aligned call takes the 16-byte one."""
    H, d, m, W, T = 8, 8, 15, 30, 40
    arrays = dict(zip("qkvg", (rng.normal(size=s).astype(np.float32)
                               for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d)))))
    aligned = {n: _dev(a, cuda_device) for n, a in arrays.items()}
    t = dict(aligned, **{operand: _offset_view(arrays[operand], cuda_device)})
    fwd, bwd = tatt.sliding_window_attention_pallas, tatt.sliding_window_attention_bwd_pallas
    before = dict(fwd.instances), dict(bwd.instances)
    out = fwd(t["q"], t["k"], t["v"], W)
    grads = bwd(t["q"], t["k"], t["v"], t["g"], W)
    torch.cuda.synchronize()
    # g is the backward's alone
    assert _instances_since(fwd, before[0]) == {"16-byte" if operand == "g" else "4-byte": 1}
    assert _instances_since(bwd, before[1]) == {"4-byte": 1}
    want = tatt.sliding_window_attention_xla(*(aligned[n] for n in "qkv"), W)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    want = tatt.sliding_window_attention_bwd_plain(*(aligned[n] for n in "qkvg"), W)
    for a, b in zip(grads, want):
        _close_grad(a, b)


TCN_ENTRIES = ("dilated_residual_stack", "dilated_residual_stack_bwd",
               "dilated_residual_multistack_stages", "dilated_residual_multistack_stages_bwd",
               "dilated_residual_multistack", "dilated_residual_multistack_bwd")


@pytest.mark.parametrize("entry", TCN_ENTRIES)
@pytest.mark.parametrize("operand", ["x", "w3"])
def test_tcn_wrappers_refuse_views_off_16_byte_boundaries(cuda_device, rng, entry, operand):
    """The TCN kernels copy their operands 16 bytes at a time: a contiguous
    view 4 bytes past a boundary (x of a forward, g of a backward, or the
    first stage's w3) raises ValueError naming it, and nothing launches."""
    C, T, L0, Lr = 8, 5, 2, 2

    def t(name, *shape):
        a = (rng.uniform(-1, 1, size=shape) / np.sqrt(3 * C)).astype(np.float32)
        return _offset_view(a, cuda_device) if name == operand else _dev(a, cuda_device)

    fn = getattr(ttcn, entry)
    bwd = entry.endswith("_bwd")
    if entry.startswith("dilated_residual_stack"):
        w3, b3, w1, b1 = t("w3", L0, 3, C, C), t("b3", L0, C), t("w1", L0, C, C), t("b1", L0, C)
        args = ((t("x", T, C), t("h", L0, T, C), t("y", L0, T, C), w3, w1) if bwd
                else (t("x", T, C), w3, b3, w1, b1))
    elif "stages" in entry:
        ws = [(t("w3" if s == 0 else "w3'", L, 3, C, C), t("b3", L, C), t("w1", L, C, C),
               t("b1", L, C)) for s, L in enumerate((L0, Lr))]
        args = ((t("x", 2, T, C), t("h", L0 + Lr, T, C), t("y", L0 + Lr, T, C), ws, L0, Lr)
                if bwd else (t("x", T, C), ws, L0, Lr))
    else:
        Lt = L0 + Lr
        w3, b3, w1, b1 = t("w3", Lt, 3, C, C), t("b3", Lt, C), t("w1", Lt, C, C), t("b1", Lt, C)
        args = ((t("x", 2, T, C), t("h", Lt, T, C), t("y", Lt, T, C), w3, w1, L0, Lr) if bwd
                else (t("x", T, C), w3, b3, w1, b1, L0, Lr))
    name = {"x": "g" if bwd else "x", "w3": "stage 0 w3" if "stages" in entry or
            entry.startswith("dilated_residual_stack") else "w3"}[operand]
    before = fn.launches
    with pytest.raises(ValueError, match=f"^{name} starts 4 bytes past a 16-byte boundary"):
        fn(*args)
    torch.cuda.synchronize()   # no CUDA error: nothing was launched
    assert fn.launches == before


@pytest.mark.parametrize("T", [17, 4096])
def test_head_major_bwd_kernel_gives_the_same_bits_twice(cuda_device, rng, T):
    H, d, m, W = 8, 8, 15, 30
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d)))
    first = tatt.sliding_window_attention_bwd_pallas(q, k, v, g, W)
    second = tatt.sliding_window_attention_bwd_pallas(q, k, v, g, W)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_head_major_kernels_launch_only_themselves(cuda_device, rng):
    """A K8 call runs one kernel and a K9 call one: no fill, no copy (K9's
    scratch is written before it is read); each wrapper counts its launch."""
    H, d, m, W, T = 8, 8, 15, 30, 64
    q, k, v, g = (_dev(rng.normal(size=s).astype(np.float32), cuda_device)
                  for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d)))
    fwd, bwd = tatt.sliding_window_attention_pallas, tatt.sliding_window_attention_bwd_pallas
    # five calls a session, and no kernel but the wrapper's own: the
    # profiler has dropped events of calls this short (~8 us) here, a whole
    # session of one call three times in a row (chip_smoke.py holds the
    # count exact at T = 1024 and 4096)
    names = _device_kernels(lambda: fwd(q, k, v, W), 5)
    assert 0 < len(names) <= 5 and all("swa_headmajor_fwd" in n for n in names), names
    names = _device_kernels(lambda: bwd(q, k, v, g, W), 5)
    assert 0 < len(names) <= 5 and all("swa_headmajor_bwd" in n for n in names), names
    # the profiler helper may take its session again: count one call alone
    before = fwd.launches, bwd.launches
    fwd(q, k, v, W)
    bwd(q, k, v, g, W)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)


def test_new_kernels_reject_inputs_they_do_not_take(cuda_device, rng):
    q = torch.zeros(2, 10, 3, 8, device=cuda_device)
    k = torch.zeros(2, 10, 8, device=cuda_device)
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_pallas(q, k[:, :9], k[:, :9], 5)      # T differs
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_pallas(q.double(), k.double(), k.double(), 5)
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_pallas(q, k.cpu(), k, 5)
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_pallas(q.transpose(1, 2), k, k, 5)   # not contiguous
    with pytest.raises(ValueError):
        tatt.sliding_window_attention_bwd_pallas(q, k, k, q[:, :, :2], 5)  # g's shape
    x, w3, b3, w1, b1, mask = _multistack_inputs(rng, 8, 16, 3, 2, 2, cuda_device)
    with pytest.raises(ValueError):
        ttcn.dilated_residual_multistack(x, w3, b3, w1, b1, 3, 3)          # 5 != 3 + 3n
    with pytest.raises(ValueError):
        ttcn.dilated_residual_multistack(x, w3, b3.cpu(), w1, b1, 3, 2)
    with pytest.raises(ValueError):
        ttcn.dilated_residual_multistack(x, w3, b3, w1, b1, 3, 2, mask=mask.float())
    with pytest.raises(ValueError):
        ttcn.dilated_residual_multistack(x, w3[:, :, :, :4], b3, w1, b1, 3, 2)


def test_small_cli_run_on_the_card_equals_its_cpu_run(cuda_device, rng, tmp_path):
    """The fold driver's command line at a small size, one epoch, on the card
    and with --device cpu: the same files, test probabilities within 1e-4
    (dropout masks are drawn on each device from its own generator, so only
    the untrained forward is compared: lr 0)."""
    from med_tpu_torch.cli import train_frame
    from med_tpu_torch.data.trials import (Trial, compute_fold_stats, load_fold,
                                           save_fold_stats, save_trial_npz)

    fold = tmp_path / "data" / "1Out"
    fold.mkdir(parents=True)
    names = [f"Needle_Passing_{'BCD'[i]}00{i + 1}" for i in range(3)]
    for name in names:
        T = 140
        e = np.zeros((T, 5), np.int64)
        e[:, 4] = np.repeat(rng.integers(0, 2, T // 10), 10)
        e[:, 2] = e[:, 4]
        save_trial_npz(str(fold / f"{name}.npz"), Trial(
            name, rng.normal(size=(T, 2048)).astype(np.float32),
            rng.normal(size=(T, 26)).astype(np.float32),
            np.repeat(rng.integers(1, 6, T // 20), 20), e))
    (fold / "train.csv").write_text("\n".join(n + ".npz" for n in names[:2]))
    (fold / "test.csv").write_text(names[2] + ".npz")
    img, kin, _, _, _ = load_fold(str(fold), "train.csv")
    save_fold_stats(str(fold), compute_fold_stats(img, kin))
    argv = ["--model-name", "COG", "--data-type", "multimodal",
            "--data-root", str(tmp_path / "data"), "--folds", "1Out",
            "--num-layers-basic", "2", "--num-layers-r", "2", "--num-r", "1",
            "--mstcn-f-maps", "32", "--d-model", "32", "--d-q", "4",
            "--sequence-length", "6", "--n-epochs", "1", "--lr", "0"]
    ops.reset_launch_counts()
    card, card_run = train_frame.main([*argv, "--runs-root", str(tmp_path / "card")])
    counts = ops.launch_counts()
    cpu, cpu_run = train_frame.main([*argv, "--runs-root", str(tmp_path / "cpu"),
                                     "--device", "cpu"])
    assert ops.launch_counts() == counts           # the CPU run launched nothing
    assert counts["sliding_window_attention_packed"] == 2 * 3
    assert counts["sliding_window_attention_packed_bwd"] == 2 * 2
    assert counts["dilated_residual_multistack_stages_bwd"] == 2 * 1
    np.testing.assert_allclose(card["1Out"]["probs"], cpu["1Out"]["probs"], rtol=0, atol=1e-4)
    listing = [sorted(str(f.relative_to(r.dir)) for f in Path(r.dir).rglob("*")
                      if f.is_file()) for r in (card_run, cpu_run)]
    assert listing[0] == listing[1] and len(listing[0]) == 8


# --------------------------------------------- TeCNo and TransSVNet
def test_tcn_kernels_at_tecnos_shape_over_the_whole_trial(cuda_device, rng):
    """One TeCNo stage at full width: conv_in (2048 -> 64) makes the stack's
    input, 8 layers at C=64 over a whole 4096-frame trial, one K2b launch
    forward (saving, with a dropout mask) and one K5 launch back."""
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.models.layers import SingleStageTCN

    stage = init_weights(SingleStageTCN(8, 2048, 64, 2),
                         torch.Generator().manual_seed(2)).to(cuda_device)
    T = 4096
    x = stage.conv_in(_dev(rng.normal(size=(1, T, 2048)).astype(np.float32),
                           cuda_device))[0].detach()
    assert x.is_contiguous() and x.data_ptr() % 16 == 0
    w = [t.detach() for t in stage.stack.weights()]
    mask = _dev(rng.integers(0, 2, size=(8, T, 64)).astype(np.uint8), cuda_device)
    g = _dev(rng.normal(size=(T, 64)).astype(np.float32), cuda_device)
    before = ttcn.dilated_residual_stack.launches, ttcn.dilated_residual_stack_bwd.launches
    got = ttcn._stages_fwd(x, [w], [mask], True, ttcn.dilated_residual_stack, save=True)
    dx, *dws = ttcn.dilated_residual_stack_bwd(g, got[1], got[2], w[0], w[2], mask=mask)
    torch.cuda.synchronize()
    assert (ttcn.dilated_residual_stack.launches,
            ttcn.dilated_residual_stack_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = ttcn._stages_fwd(x.cpu(), [[t.cpu() for t in w]], [mask.cpu()], True,
                            ttcn.dilated_residual_stack, save=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    # the plain backward on the kernel's own saved h, y: a relu within
    # rounding of 0 may take the other side in the CPU's forward
    p_dx, (p_dw,) = ttcn._stages_bwd_plain(g.cpu()[None], got[1].cpu(), got[2].cpu(),
                                           [(w[0].cpu(), w[2].cpu())], [mask.cpu()], True)
    for a, b in zip((dx, *dws), (p_dx, *p_dw)):
        _close_grad(a.cpu(), b)


@pytest.mark.parametrize("T,causal", [(300, True), (1000, False)])
def test_tcn_stack_and_its_backward_at_the_keep_scale_of_rate_0_3(cuda_device, rng, T, causal):
    """K2b and K5 at the keep scale 1 / 0.7 of dropout rate 0.3, a
    Bernoulli(0.7) keep-mask, against their plain versions at that scale;
    then ``ResidualStack(dropout_rate=0.3)``'s training forward and backward
    on the card, one launch each way a trial, against the same module's on
    the CPU."""
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.models.layers import ResidualStack, keep_scale

    L, C, rate = 5, 32, 0.3
    scale = keep_scale(rate)
    b = 1.0 / np.sqrt(3 * C)
    w = [_dev(rng.uniform(-b, b, size=s).astype(np.float32), cuda_device)
         for s in ((L, 3, C, C), (L, C), (L, C, C), (L, C))]
    x, g = (_dev(rng.normal(size=(T, C)).astype(np.float32), cuda_device) for _ in range(2))
    mask = _dev((rng.random((L, T, C)) < 1 - rate).astype(np.uint8), cuda_device)
    got = ttcn._stages_fwd(x, [w], [mask], causal, ttcn.dilated_residual_stack, save=True,
                           scale=scale)
    want = ttcn._stages_fwd(x.cpu(), [[t.cpu() for t in w]], [mask.cpu()], causal,
                            ttcn.dilated_residual_stack, save=True, scale=scale)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-4, atol=1e-4)
    out = ttcn.dilated_residual_stack(x, *w, causal=causal, mask=mask, scale=scale)
    torch.testing.assert_close(out.cpu(), want[0][0], rtol=1e-4, atol=1e-4)
    dx, *dws = ttcn.dilated_residual_stack_bwd(g, got[1], got[2], w[0], w[2], causal=causal,
                                               mask=mask, scale=scale)
    p_dx, (p_dw,) = ttcn._stages_bwd_plain(g.cpu()[None], got[1].cpu(), got[2].cpu(),
                                           [(w[0].cpu(), w[2].cpu())], [mask.cpu()], causal,
                                           scale)
    for a, b_ in zip((dx, *dws), (p_dx, *p_dw)):
        _close_grad(a.cpu(), b_)

    stack = init_weights(ResidualStack(L, C, causal=causal, dropout_rate=rate),
                         torch.Generator().manual_seed(3))
    xs = rng.normal(size=(2, T, C)).astype(np.float32)
    masks = stack.dropout_mask(2, T, torch.Generator().manual_seed(4))
    runs = []
    for device in ("cpu", cuda_device):
        net = stack.to(device)
        xt = _dev(xs, device).requires_grad_()
        before = ttcn.dilated_residual_stack.launches, ttcn.dilated_residual_stack_bwd.launches
        out = net(xt, masks.to(device))
        (out * _dev(xs, device)).sum().backward()
        launched = (ttcn.dilated_residual_stack.launches - before[0],
                    ttcn.dilated_residual_stack_bwd.launches - before[1])
        runs.append((out.detach().cpu(), xt.grad.cpu(),
                     [p.grad.cpu() for p in net.weights()], launched))
        net.zero_grad()
    (c_out, c_dx, c_dw, c_n), (g_out, g_dx, g_dw, g_n) = runs
    assert c_n == (0, 0) and g_n == (2, 2)
    torch.testing.assert_close(g_out, c_out, rtol=1e-4, atol=1e-4)
    for a, b_ in zip((g_dx, *g_dw), (c_dx, *c_dw)):
        _close_grad(a, b_)


FAMILY_SMALL = dict(dataset_type="frame", data_type="video", video_dims=2048,
                    out_features=2, mstcn_stages=2, mstcn_layers=4, mstcn_f_maps=32,
                    sequence_length=30, weight_decay=0.0, lr_scheduler=False)
# launches of a request and of a train step (ROADMAP.md's table for the slice)
FAMILY_LAUNCHES = {
    ("TeCNo", "request"): {"dilated_residual_stack": 2},
    ("TeCNo", "step"): {"dilated_residual_stack": 2, "dilated_residual_stack_bwd": 2},
    ("TransSVNet", "request"): {"dilated_residual_stack": 2,
                                "sliding_window_attention_packed": 1},
    ("TransSVNet", "step"): {"dilated_residual_stack": 2,
                             "sliding_window_attention_packed": 1,
                             "sliding_window_attention_packed_bwd": 1}}


@pytest.mark.parametrize("model_name", ["TeCNo", "TransSVNet"])
def test_small_tecno_and_transsvnet_same_on_card_and_cpu(cuda_device, rng, model_name):
    """Served and one train step on the card and on the CPU, same weights
    (and TeCNo's dropout masks): probabilities within 1e-5, the loss within
    1e-5, gradients rtol 1e-4 and atol 1e-5 of each leaf's largest value
    (TransSVNet: 2e-2 of it, and of the tree's largest for its decoder W_Q
    and W_K; float32 inputs fix its gradients only to ~1e-3, see
    TSVN_GRAD_ATOL and NULL_LEAVES in chip_smoke.py), and the designed
    launches."""
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.data.datasets import FrameTrial, frame_batch
    from med_tpu_torch.data.labels import skill_one_hot
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.models import build_tecno, init_weights
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    cfg = ExperimentConfig(model_name=model_name, **FAMILY_SMALL)
    tree = export_jax_params(init_weights(Experiment(cfg, device="cpu").net,
                                          torch.Generator().manual_seed(5)))
    frozen = None
    if model_name == "TransSVNet":
        tecno = init_weights(build_tecno(cfg), torch.Generator().manual_seed(6))
        frozen = {"tecno_params": export_jax_params(tecno)["params"]}
    T, name = 300, "Needle_Passing_B001"
    images = rng.normal(size=(T, 2048)).astype(np.float32)
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    idle = {k: 0 for k in ops.launch_counts()}
    ops.reset_launch_counts()
    got_p, got_pr = FrameModelServer(cfg, tree, frozen=frozen).predict_trial(images, kin)
    assert ops.launch_counts() == {**idle, **FAMILY_LAUNCHES[model_name, "request"]}
    want_p, want_pr = FrameModelServer(cfg, tree, frozen=frozen,
                                       device="cpu").predict_trial(images, kin)
    np.testing.assert_allclose(got_pr, want_pr, rtol=0, atol=1e-5)
    sure = np.abs(want_pr - 0.5) > 1e-5
    np.testing.assert_array_equal(got_p[sure], want_p[sure])

    e = np.zeros((T, 7), np.int32)
    e[:, -1] = rng.integers(0, 2, T)
    batch = frame_batch(FrameTrial(name, images, kin, rng.integers(0, 15, T), e,
                                   skill_one_hot(name, T)), cfg)
    masks = None
    if model_name == "TeCNo":
        masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
            batch["images"].shape[1], torch.Generator().manual_seed(1))
    losses, grads = [], []
    for device in (cuda_device, torch.device("cpu")):
        exp = Experiment(cfg, device=device)
        exp.init_weights(5)
        if frozen is not None:
            exp.load_frozen(frozen)
        ops.reset_launch_counts()
        dev_masks = None if masks is None else {
            n: {k: v.to(device) for k, v in d.items()} for n, d in masks.items()}
        loss, _ = exp.compute_gradients(batch, masks=dev_masks)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts() == {**idle, **FAMILY_LAUNCHES[model_name, "step"]}
        losses.append(loss.item())
        grads.append(export_jax_params(exp.net, grads=True)["params"])
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", v

    from chip_smoke import NULL_LEAVES, TSVN_GRAD_ATOL

    want = dict(leaves(grads[1]))
    gmax = max(np.abs(w).max() for w in want.values())
    atol = 1e-5 if model_name == "TeCNo" else TSVN_GRAD_ATOL
    for path, got in leaves(grads[0]):
        scale = gmax if path.endswith(NULL_LEAVES) else np.abs(want[path]).max()
        np.testing.assert_allclose(got, want[path], rtol=1e-4, atol=atol * scale,
                                   err_msg=path)


def _small_cog_config(**kw):
    from med_tpu_torch.config import ExperimentConfig

    fields = dict(model_name="COG", dataset_type="frame", out_features=2, video_dims=32,
                  num_layers_Basic=4, num_layers_R=3, num_R=2, mstcn_f_maps=32,
                  d_model=32, d_q=4, sequence_length=5, weight_decay=0.0,
                  lr_scheduler=False)
    return ExperimentConfig(**{**fields, **kw})


def _small_trial(rng, T, name):
    from med_tpu_torch.data.datasets import FrameTrial
    from med_tpu_torch.data.labels import skill_one_hot

    e = np.zeros((T, 7), np.int32)
    e[:, -1] = rng.integers(0, 2, T)
    return FrameTrial(name, rng.normal(size=(T, 2048)).astype(np.float32),
                      rng.normal(size=(T, 26)).astype(np.float32),
                      rng.integers(0, 15, T), e, skill_one_hot(name, T))


@pytest.mark.parametrize("model_name", ["COG", "TeCNo"])
def test_bfloat16_path_launches_no_tcn_kernel(cuda_device, rng, model_name):
    """compute_dtype="bfloat16": the TCN stacks run the model's own bf16
    layer loop, so a served trial and a train step launch no TCN kernel;
    COG's attention stays float32 through K1 and K3. The wrappers refuse
    bf16 operands on the card."""
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    cfg = _small_cog_config(model_name=model_name, compute_dtype="bfloat16")
    exp = Experiment(cfg, device=cuda_device)
    exp.init_weights(5)
    ops.reset_launch_counts()
    served = FrameModelServer(cfg, export_jax_params(exp.net)).predict_trial(
        rng.normal(size=(300, 2048)).astype(np.float32),
        rng.normal(size=(300, 26)).astype(np.float32))
    exp.train_step(frame_batch(_small_trial(rng, 300, "Needle_Passing_B001"), cfg))
    torch.cuda.synchronize()
    attention = 2 if model_name == "COG" else 0
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()} | {
        "sliding_window_attention_packed": 2 * attention,
        "sliding_window_attention_packed_bwd": attention}
    assert np.isfinite(served[1]).all()
    x = torch.zeros(64, 32, device=cuda_device, dtype=torch.bfloat16)
    w3, b3, w1, b1, _ = _stack(rng, 2, 64, 32, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ttcn.dilated_residual_stack(x, w3, b3, w1, b1)


def test_trial_group_step_launches_the_attention_once_a_group(cuda_device, rng):
    """trial_batch = 2: one train step on a group launches K1 and K3 once a
    encoder layer for both trials (16 heads), the TCN kernels once a trial;
    its loss and gradients equal the CPU's on the same masks (rtol 1e-4,
    atol 1e-5 of each leaf's largest value, 5e-4 for the encoder FFN)."""
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    cfg = _small_cog_config(trial_batch=2)
    batches = [frame_batch(_small_trial(rng, T, f"Needle_Passing_{c}001"), cfg, bucket=512)
               for T, c in ((300, "B"), (420, "C"))]
    group = {k: np.stack([b[k] for b in batches]) for k in batches[0] if not k.startswith("_")}
    group["trial_weight"] = np.ones(2, np.float32)
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        512, torch.Generator().manual_seed(1), B=2)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        exp = Experiment(cfg, device=device)
        exp.init_weights(5)
        ops.reset_launch_counts()
        m = exp.train_step(group, masks={n: {k: v.to(device) for k, v in d.items()}
                                         for n, d in masks.items()})
        counts = ops.launch_counts()
        results.append((m["loss"].item(), export_jax_params(exp.net, grads=True)["params"]))
        if device.type == "cuda":
            assert counts == {**OP_API_IDLE,
                              "sliding_window_attention_packed": 2,
                              "sliding_window_attention_packed_bwd": 2,
                              "dilated_residual_multistack_stages": 2,
                              "dilated_residual_multistack_stages_bwd": 2,
                              "dilated_residual_stack": 2 * 3,
                              "dilated_residual_stack_bwd": 2 * 3,
                              "fused_bottleneck_stage": 0}
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", v

    want = dict(leaves(results[1][1]))
    for path, got in leaves(results[0][1]):
        atol = (5e-4 if "/ffn/Dense_" in path else 1e-5) * np.abs(want[path]).max()
        np.testing.assert_allclose(got, want[path], rtol=1e-4, atol=atol, err_msg=path)


def _window_batch(rng, cfg, B=32):
    shape = (B, 2, cfg.window_size) if cfg.siamese else (B, cfg.window_size)
    return {"images": rng.normal(size=shape + (2048,)).astype(np.float32),
            "kinematics": rng.normal(size=shape + (26,)).astype(np.float32),
            "labels": rng.integers(0, 2, B), "mask": (np.arange(B) < B - 5).astype(np.float32)}


def _window_step(cfg, batch, masks, device, dtype):
    """Loss, gradients and running statistics (flat med_tpu paths, float64
    numpy) of one train step from seeded weights, in ``dtype``."""
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    exp = Experiment(cfg, device=device)
    exp.init_weights(3, np.asarray([0.7, 0.3], np.float32))
    exp.net.to(dtype)
    data = {k: torch.as_tensor(v, device=exp.device,
                               dtype=dtype if v.dtype == np.float32 else None)
            for k, v in batch.items()}
    exp._tensors = dict
    moved = (tuple([m.to(exp.device) for m in ms] for ms in masks) if cfg.siamese
             else [m.to(exp.device) for m in masks])
    loss, _ = exp.compute_gradients(data, masks=moved)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                       else {f"{prefix}/{k}": np.asarray(v, np.float64)})
        return out

    return (loss.item(), flat(export_jax_params(exp.net, grads=True)["params"]),
            flat(export_jax_params(exp.net)["batch_stats"]))


@pytest.mark.parametrize("model_name,frequency", [("SimpleCNN", 5), ("SimpleCNN", 15),
                                                  ("SimpleLSTM", 5), ("Siamese_CNN", 5),
                                                  ("Siamese_LSTM", 5)])
def test_window_train_step_same_on_card_and_cpu(cuda_device, rng, model_name, frequency):
    """An Experiment switches TF32 off (PyTorch leaves cuDNN's on); then one
    train step from the same weights, batch and masks on the card (float32)
    and on the CPU (float64), the card's relu, max-pool and |f1 - f2|
    choices pinned to the CPU's (chip_smoke.py's ``_window_pins``: a choice
    within float32's noise of a tie moves a whole row's gradient term): the
    loss (1e-5), the running statistics (1e-5 of each one's largest), every
    gradient leaf within 1e-5 of the tree's largest gradient. (Per leaf, a
    twin's gradients are differences of its two branches' terms; the smoke
    holds each leaf to its own largest at full width.)"""
    import sys

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import _window_pins
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.train.engine import Experiment

    cfg = ExperimentConfig(model_name=model_name, frequency=frequency, pos_weight=True,
                           siamese=model_name.startswith("Siamese"))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    Experiment(cfg)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    batch = _window_batch(rng, cfg)
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        32, torch.Generator().manual_seed(1))
    record = []
    with _window_pins(record=record):
        ref_loss, ref, ref_stats = _window_step(cfg, batch, masks, "cpu", torch.float64)
    with _window_pins(pin=record, flips=[]):
        loss, card, stats = _window_step(cfg, batch, masks, "cuda", torch.float32)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for path, w in ref_stats.items():
        assert np.abs(stats[path] - w).max() <= 1e-5 * np.abs(w).max(), path
    scale = max(np.abs(w).max() for w in ref.values())
    for path, w in ref.items():
        assert np.abs(card[path] - w).max() <= 1e-5 * scale, path


# ----------------------------------------------- the int8 convolution kernel
# (name, B, H, W, Cin, N, k, stride, pad): conv1's guarded Cin = 3 at 7x7/2,
# a 1x1, 3x3 /1 and /2, the downsample 1x1/2, the FE's dense layers as 1x1
# over rows (N = 32 fills half a tile), ragged rows and an odd N
INT8_SHAPES = [("conv1", 2, 32, 32, 3, 64, 7, 2, 3), ("1x1", 2, 14, 14, 64, 256, 1, 1, 0),
               ("3x3", 2, 14, 14, 64, 64, 3, 1, 1), ("3x3/2", 2, 15, 15, 128, 128, 3, 2, 1),
               ("down", 2, 14, 14, 256, 512, 1, 2, 0), ("fe0", 300, 1, 1, 2048, 512, 1, 1, 0),
               ("fe2", 300, 1, 1, 256, 32, 1, 1, 0), ("ragged", 3, 7, 5, 48, 40, 3, 1, 1),
               ("odd", 1, 9, 9, 16, 33, 3, 2, 1)]


def _int8_operands(rng, B, H, W, Cin, N, k, device):
    x = torch.tensor(rng.integers(-127, 128, (B, H, W, Cin)), dtype=torch.int8, device=device)
    w = torch.tensor(rng.integers(-127, 128, (N, k, k, Cin)), dtype=torch.int8, device=device)
    ws = torch.tensor(rng.uniform(1e-4, 1e-3, N), dtype=torch.float32, device=device)
    bias = torch.tensor(rng.normal(size=N), dtype=torch.float32, device=device)
    return x, w, ws, bias


@pytest.mark.parametrize("name,B,H,W,Cin,N,k,stride,pad", INT8_SHAPES)
def test_int8_conv_kernel_matches_plain(cuda_device, rng, name, B, H, W, Cin, N, k, stride,
                                        pad):
    """Each shape class: the int32 accumulators equal the plain version's
    (a float64 convolution, exact), the fp32 epilogue with an fp32 residual
    equal bit for bit (the same fp32 multiply and add, no FMA), and the int8
    requantization with an int8 residual and relu equal: every code."""
    from med_tpu_torch.ops import quant as tq

    x, w, ws, bias = _int8_operands(rng, B, H, W, Cin, N, k, cuda_device)
    Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    kw = dict(s_in=0.0123, stride=stride, pad=pad)
    before = dict(tq.int8_conv.instances)
    got = tq.int8_conv(x, w, ws, bias, accumulators=True, **kw)
    want = tq.int8_conv_plain(x, w, ws, bias, accumulators=True, **kw)
    assert got.dtype == torch.int32 and torch.equal(got, want), name
    res = torch.tensor(rng.normal(size=(B, Ho, Wo, N)), dtype=torch.float32,
                       device=cuda_device)
    got = tq.int8_conv(x, w, ws, bias, residual=res, **kw)
    assert torch.equal(got, tq.int8_conv_plain(x, w, ws, bias, residual=res, **kw)), name
    resq = torch.tensor(rng.integers(-127, 128, (B, Ho, Wo, N)), dtype=torch.int8,
                        device=cuda_device)
    qkw = dict(kw, residual=resq, res_scale=0.02, relu=True, out_scale=0.03)
    got = tq.int8_conv(x, w, ws, bias, **qkw)
    assert got.dtype == torch.int8
    assert torch.equal(got, tq.int8_conv_plain(x, w, ws, bias, **qkw)), name
    taken = {k: v - before.get(k, 0) for k, v in tq.int8_conv.instances.items()
             if v != before.get(k, 0)}
    aligned = Cin % 16 == 0 and N % 2 == 0
    assert taken == {"16-byte" if aligned else "guarded": 3}, (name, taken)


@pytest.mark.parametrize("operand", ["x", "w", "residual"])
def test_int8_conv_takes_views_off_16_byte_boundaries(cuda_device, rng, operand):
    """An operand in a view 1 byte (int8) or 4 bytes (fp32) past a 16-byte
    boundary: the guarded instance, the same results."""
    from med_tpu_torch.ops import quant as tq

    x, w, ws, bias = _int8_operands(rng, 2, 8, 8, 32, 64, 3, cuda_device)
    res = torch.tensor(rng.normal(size=(2, 8, 8, 64)), dtype=torch.float32, device=cuda_device)
    ops_ = {"x": x, "w": w, "residual": res}
    t = ops_[operand]
    shifted = torch.empty(t.numel() + 16, dtype=t.dtype, device=cuda_device)[1:1 + t.numel()]
    shifted = shifted.view(t.shape)
    shifted.copy_(t)
    assert shifted.data_ptr() % 16 != 0
    ops_[operand] = shifted
    kw = dict(s_in=0.01, pad=1, residual=ops_["residual"])
    before = tq.int8_conv.instances.get("guarded", 0)
    got = tq.int8_conv(ops_["x"], ops_["w"], ws, bias, **kw)
    assert tq.int8_conv.instances.get("guarded", 0) == before + 1
    assert torch.equal(got, tq.int8_conv_plain(x, w, ws, bias, s_in=0.01, pad=1, residual=res))


def test_int8_conv_refuses_what_it_does_not_take(cuda_device, rng):
    from med_tpu_torch.ops import quant as tq

    x, w, ws, bias = _int8_operands(rng, 1, 4, 4, 16, 16, 1, cuda_device)
    with pytest.raises(ValueError, match="int8"):
        tq.int8_conv(x.to(torch.float32), w, ws, bias, s_in=1.0)
    with pytest.raises(ValueError, match="float32"):
        tq.int8_conv(x, w, ws.double(), bias, s_in=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tq.int8_conv(x.transpose(1, 2), w, ws, bias, s_in=1.0)
    with pytest.raises(ValueError, match="res_scale"):
        tq.int8_conv(x, w, ws, bias, s_in=1.0, residual=x)


def _tiny_quant_trunk(rng, width):
    from med_tpu_torch.models.resnet import ResNet50
    from med_tpu_torch.models.layers import init_weights
    from med_tpu_torch.ops import quant as tq
    from med_tpu_torch.utils.jax_params import export_jax_params

    net = ResNet50((1, 1, 1, 1), width, torch.float32)
    init_weights(net, torch.Generator().manual_seed(4))
    tree = export_jax_params(net)
    x = rng.normal(size=(6, 64, 64, 3)).astype(np.float32)
    return tq.quantize_resnet50_trunk(tree, x[:4], (1, 1, 1, 1)), x


@pytest.mark.parametrize("width", [8, 16])
def test_int8_trunk_and_fe_same_on_card_and_cpu(cuda_device, rng, width):
    """A tiny int8 trunk (stages (1, 1, 1, 1); width 8 takes the guarded
    instance, 16 the 16-byte one) and an int8 FeatureExtractor: the card's
    features equal the CPU's bit for bit (exact products, the same fp32
    epilogue, an exact max pool and sum); 17 launches (conv1, three a block,
    one a downsample) and 3 for the FE."""
    from med_tpu_torch.ops import quant as tq

    qt, x = _tiny_quant_trunk(rng, width)
    want = tq.resnet50_int8_apply(qt, torch.from_numpy(x), (1, 1, 1, 1))
    before = tq.int8_conv.launches
    got = tq.resnet50_int8_apply(tq.tree_to(qt, cuda_device),
                                 torch.from_numpy(x).to(cuda_device), (1, 1, 1, 1))
    assert tq.int8_conv.launches - before == 1 + 4 * 3 + 4
    assert torch.equal(got.cpu(), want)
    fe = {"dense0": {"kernel": rng.normal(size=(2048, 512)).astype(np.float32) * 0.02,
                     "bias": rng.normal(size=512).astype(np.float32) * 0.1},
          "dense1": {"kernel": rng.normal(size=(512, 256)).astype(np.float32) * 0.05,
                     "bias": rng.normal(size=256).astype(np.float32) * 0.1},
          "out": {"kernel": rng.normal(size=(256, 32)).astype(np.float32) * 0.06,
                  "bias": rng.normal(size=32).astype(np.float32) * 0.1}}
    images = rng.normal(size=(24, 10, 2048)).astype(np.float32)
    qfe = tq.quantize_fe(fe, images[:8])
    want = tq.fe_int8_apply(qfe, torch.from_numpy(images))
    before = tq.int8_conv.launches
    got = tq.fe_int8_apply(tq.tree_to(qfe, cuda_device), torch.from_numpy(images).to(cuda_device))
    assert tq.int8_conv.launches - before == 3
    assert torch.equal(got.cpu(), want)


def test_ensemble_server_same_on_card_and_cpu(cuda_device, rng):
    """Soft vote over a multimodal SimpleCNN (FE 2048 -> 32, also on the int8
    path: three int8 launches a batch) and a kinematics one, and a cascade
    with a 6-class member, from seeded weights: the card's probabilities
    within 1e-5 of the CPU's, decisions equal away from the threshold; the
    int8 FE's exactly the CPU's plain version's arithmetic."""
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.eval.serving import EnsembleServer, WindowModelBundle
    from med_tpu_torch.ops import quant as tq
    from med_tpu_torch.train.engine import Experiment

    def tree(seed, **fields):
        cfg = ExperimentConfig(model_name="SimpleCNN", **fields)
        exp = Experiment(cfg, device="cpu")
        exp.init_weights(seed)
        return cfg, exp.checkpoint()

    members = [tree(0), tree(1, data_type="kinematics"),
               tree(2, error_type="all_errors", out_features=6)]
    images = rng.normal(size=(64, 10, 2048)).astype(np.float32)
    kin = rng.normal(size=(64, 10, 26)).astype(np.float32)
    for idx, mode in (((0, 1), "soft_vote"), ((0, 2), "cascade"), ((0, 1), "int8")):
        out = {}
        for dev in ("cpu", "cuda"):
            bundles = [WindowModelBundle(*members[i], device=dev) for i in idx]
            if mode == "int8":
                bundles[0].quantize_fe(images[:8])
            before = tq.int8_conv.launches
            out[dev] = EnsembleServer(bundles, mode="cascade" if mode == "cascade"
                                      else "soft_vote").predict(images, kin)
            if dev == "cuda":
                assert tq.int8_conv.launches - before == (3 if mode == "int8" else 0)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-5)
        clear = np.abs(out["cpu"][1] - 0.5) > 1e-5
        np.testing.assert_array_equal(out["cuda"][0][clear], out["cpu"][0][clear])


# ------------------------------------------------------- backbone fine-tuning
class _ReluPins:
    """``models.resnet.relu`` recording the CPU float64 step's derivative
    pattern, then pinning the card's to it (flips counted): a
    pre-activation within rounding of 0 moves one pixel's gradient term."""

    def __init__(self):
        self.masks, self.pin, self.i, self.flips = [], False, 0, 0

    def __call__(self, x):
        if not self.pin:
            self.masks.append((x > 0).cpu())
            return torch.relu(x)
        m = self.masks[self.i].to(x.device)
        self.i += 1
        self.flips += int(((x > 0) != m).sum())
        return x * m.to(x.dtype)


@pytest.mark.parametrize("case", ["exact", "freeze_bn", "stride4"])
def test_finetune_step_same_on_card_and_cpu(cuda_device, rng, monkeypatch, case):
    """One fine-tune step of a small ResNetClassifier ((1, 1, 1, 1) x 8,
    64x64 frames, a padded batch of 8, augmentation on with one set of
    draws) on the card in float32 against the CPU in float64, the relu
    pattern pinned: loss rtol 1e-5, each gradient leaf rtol 1e-4 + 1e-5 of
    its largest, running statistics 1e-5."""
    from med_tpu_torch.cli import resnet_finetune as cli
    from med_tpu_torch.data.augment import draw_augment
    from med_tpu_torch.models import init_weights, resnet
    from med_tpu_torch.utils.jax_params import export_jax_params

    stride, freeze = (4 if case == "stride4" else 1), case == "freeze_bn"
    images = rng.integers(0, 256, (13, 64, 64, 3)).astype(np.float32)
    imgs, labels, mask = list(cli._batches(images, rng.integers(0, 2, 13), 8, True, 1))[1]
    mean = images.reshape(-1, 3).mean(0) / 255.0
    std = images.reshape(-1, 3).std(0) / 255.0 + 1e-6
    draws = draw_augment(8, torch.Generator().manual_seed(5))
    net = init_weights(resnet.ResNetClassifier((1, 1, 1, 1), 8, bn_stat_stride=stride),
                       torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, m in net.named_modules():
            if name.endswith(".bn3"):
                m.weight.mul_(0.2)
    pins = _ReluPins()
    monkeypatch.setattr(resnet, "relu", pins)
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        model = resnet.ResNetClassifier((1, 1, 1, 1), 8, dtype=dt, bn_stat_stride=stride)
        model.load_state_dict(net.state_dict())
        model.to(dev, dt)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
        stats = (torch.tensor(mean, dtype=dt, device=dev), torch.tensor(std, dtype=dt, device=dev))
        loss = cli.train_step(model, opt, imgs, labels, mask, stats, freeze, draws)
        out[dev] = (float(loss), export_jax_params(model, grads=True)["params"],
                    export_jax_params(model)["batch_stats"])
        pins.pin = True
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v, np.float64)

    want = dict(leaves(out["cpu"][1]))
    for k, g in leaves(out["cuda"][1]):
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    want = dict(leaves(out["cpu"][2]))
    for k, s in leaves(out["cuda"][2]):
        np.testing.assert_allclose(s, want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert pins.flips <= 2


def test_augment_batch_same_on_card_and_cpu(cuda_device, rng):
    """augment_batch with one set of draws, on the card and on the CPU: the
    0-255 pixels within 1e-3 (float32 tan and sin of an angle may differ by
    an ulp between the two, which moves a shear's shift by ~1e-6 pixel at
    the frame's edge, |dx| <= 111.5, and a pixel between neighbours 255
    apart by up to ~6e-4 over the three passes; 2.4e-4 seen on an H100)."""
    from med_tpu_torch.data.augment import augment_batch, draw_augment

    frames = rng.integers(0, 256, (16, 224, 224, 3)).astype(np.float32)
    draws = draw_augment(16, torch.Generator().manual_seed(0))
    got = augment_batch(torch.from_numpy(frames).cuda(), draws).cpu().numpy()
    want = augment_batch(torch.from_numpy(frames), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------------ parallelism
def test_prefetch_copies_through_pinned_memory_on_a_side_stream(cuda_device, rng):
    """Each batch's arrays reach the card intact ('_' keys stay on the
    host), whatever the depth, and the consumer's stream owns them."""
    from med_tpu_torch.utils.prefetch import prefetch_to_device

    batches = [{"x": rng.normal(size=(64, 33)).astype(np.float32),
                "y": torch.arange(5) + i, "_name": f"t{i}"} for i in range(7)]
    for depth in (0, 1, 2, 5):
        out = list(prefetch_to_device(iter(batches), depth=depth, device=cuda_device))
        assert len(out) == 7
        for a, b in zip(out, batches):
            x = torch.as_tensor(a["x"]).to(cuda_device)
            np.testing.assert_array_equal(x.cpu().numpy(), b["x"])
            assert torch.equal(torch.as_tensor(a["y"]).cpu(), b["y"])
            assert a["_name"] == b["_name"]
            if depth:
                assert a["x"].is_cuda and a["y"].is_cuda


def _cuda_collectives():
    """On each gloo rank sharing the card: the shift, halo and gather of CUDA
    tensors (gloo takes them only through host memory) and an all-reduce."""
    from med_tpu_torch.parallel import comm, launch
    from med_tpu_torch.parallel.mesh import make_mesh

    g = make_mesh((launch.world_size(), 1)).group("data")
    i, S = launch.rank(), 8
    x = (torch.arange(2 * S * 3, dtype=torch.float32).reshape(2 * S, 3)[i * S:(i + 1) * S]
         .cuda().requires_grad_())
    y = comm.seq_shift_right(x, 3, g)
    h = comm.halo_left(x, 5, g, fill_row=torch.full((3,), -1.0, device="cuda"))
    z = comm.all_gather(x, g)
    s = comm.psum(x, g)
    (y.sum() + h.sum() + z.sum() + s.sum()).backward()
    return [t.detach().cpu().numpy() for t in (y, h, z, s, x.grad)] + [y.is_cuda and z.is_cuda]


def test_collectives_of_cuda_tensors_under_gloo(cuda_device, tmp_path):
    from med_tpu_torch.parallel import launch

    out = launch.spawn(_cuda_collectives, 2, str(tmp_path), backend="gloo", device="cuda")
    full = np.arange(48, dtype=np.float32).reshape(16, 3)
    shifted = np.concatenate([np.zeros((3, 3), np.float32), full[:13]])
    for i, (y, h, z, s, g, on_card) in enumerate(out):
        assert on_card
        np.testing.assert_array_equal(y, shifted[i * 8:(i + 1) * 8])
        rows = i * 8 - 5 + np.arange(5)
        np.testing.assert_array_equal(h, np.where((rows >= 0)[:, None], full[np.clip(rows, 0, None)],
                                                  -1.0))
        np.testing.assert_array_equal(z, full)
        np.testing.assert_array_equal(s, full[:8] + full[8:])
    # every row's cotangents: the gather's and the psum's (its backward the
    # identity), and wherever the shift or a halo read it
    grads = np.concatenate([g for *_, g, _ in out])
    want = np.full((16, 3), 2.0, np.float32)
    want[:13] += 1.0                              # read by the shift
    want[3:8] += 1.0                              # rank 1's halo: rows 3..7
    np.testing.assert_array_equal(grads, want)
