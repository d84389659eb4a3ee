"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at awkward shapes (ragged tiles, dilations wider than the sequence,
acausal taps, dropout masks), and the small COG served on the card against
the CPU. They need an NVIDIA GPU and skip without one. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: rtol 1e-4, atol 1e-5 for the attention (values O(1)); atol 1e-4
for the TCN stacks, whose activations grow over the layers.
"""

import numpy as np
import pytest
import torch

from med_tpu_torch import ops
from med_tpu_torch.ops import attention as tatt
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


@pytest.mark.parametrize("C,L,T", [(64, 11, 1000), (64, 10, 20), (8, 5, 33),
                                   (16, 3, 64), (32, 4, 31)])
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
    assert ttcn.dilated_residual_stack.launches == before + L


@pytest.mark.parametrize("use_mask", [False, True])
def test_tcn_multistack_kernel_matches_plain(cuda_device, rng, use_mask):
    C, T, layers = 64, 257, (11, 10, 10, 10)
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
    assert ttcn.dilated_residual_multistack_stages.launches == before + sum(layers)


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
    assert counts == {"sliding_window_attention_packed": 2,
                      "dilated_residual_multistack_stages": 4 + 2 * 3,
                      "dilated_residual_stack": 4 + 2 * 3}
