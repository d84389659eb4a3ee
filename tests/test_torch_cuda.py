"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at awkward shapes (ragged tiles, dilations wider than the sequence,
acausal taps, dropout masks, images narrower than a tile; for the one-launch
TCN forward also T = 1 and 5, where every block but one has no rows, and
the 300-frame request's 18 and 300 rows; for the one-launch TCN backward
T = 1, 17 and 33 at every channel count, more than 16 stacks, and two runs
equal bit for bit), the small COG
served on the card against the CPU, and a small ResNet trunk and pixel
front end on the card against the CPU. They need an NVIDIA GPU and skip without one. This file imports no
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


@pytest.mark.parametrize("H,d,m,W,T", [(8, 8, 15, 30, 100), (2, 4, 3, 5, 41),
                                       (3, 16, 1, 7, 300), (1, 32, 300, 3, 5)])
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


@pytest.mark.parametrize("H,d,m,W,T", [(8, 8, 15, 30, 100), (2, 4, 3, 5, 41),
                                       (3, 16, 1, 7, 300), (1, 32, 300, 3, 5)])
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
