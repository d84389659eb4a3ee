"""MiMo-V2-Flash's pieces on the card: the packed attention's sink instance
(``csrc/swa_sink_{fwd,bwd}.cu``) against its plain version at the model's
shapes (8 KV heads, q and k of width 192, v of 128, 8 query heads a KV
head, a 128-frame window) at T = 1,024 and 4,096 and at a ragged 1,000,
with and without sinks and the start mask, its backward's sink gradient
and two backward runs equal bit for bit; COG's K1/K3 giving the bits they
gave before the sink instance came (a digest of their outputs on seeded
inputs); a MiMo train step at the cut's widths (two layers, one of each
kind) on the card against the plain reference
(``benchmark/reference/mimo_v2_flash.py``); and one MoE layer at the
published widths giving the stacked expert gradients the per-slice path
gives (``test_torch_mimo.py::per_slice_moe``) bit for bit. They need an NVIDIA GPU and
skip without one; this file imports no JAX:

    python -m pytest tests/test_torch_mimo_cuda.py --noconftest -q

Tolerances: the attention's outputs rtol 1e-4, atol 1e-5 (values O(1));
gradients rtol 1e-4, atol 1e-5 of the tensor's largest value (sums over
the band, taken in another order). The train step: see its test.
"""

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from med_tpu_torch.ops import attention as tatt

pytestmark = pytest.mark.cuda

H, DK, DV, M, W = 8, 192, 128, 8, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(T, device, seed=5, sinks=True):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=device)
                  for s in ((H, DK, T * M), (H, DK, T), (H, DV, T), (H, DV, T * M)))
    b = (torch.as_tensor(rng.normal(size=(H, M)).astype(np.float32) * 2.0, device=device)
         if sinks else None)
    return q, k, v, g, b


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _close_grad(got, want):
    atol = 1e-5 * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


def _plain(*ts):
    """The operands on the CPU, where the op runs its plain version."""
    return [None if t is None else t.cpu() for t in ts]


@pytest.mark.parametrize("T,sinks,exclude", [(1024, True, True), (4096, True, True),
                                             (1000, True, True), (1024, False, True),
                                             (300, True, False)])
def test_sink_instance_matches_plain(cuda_device, T, sinks, exclude):
    q, k, v, g, b = _operands(T, cuda_device, sinks=sinks)
    before = (tatt.sliding_window_attention_sink.launches,
              tatt.sliding_window_attention_sink_bwd.launches)
    out, stats = tatt.sliding_window_attention_sink(q, k, v, b, W, M, exclude)
    grads = tatt.sliding_window_attention_sink_bwd(q, k, v, g, out, stats, b, W, M, exclude)
    torch.cuda.synchronize()
    assert (tatt.sliding_window_attention_sink.launches,
            tatt.sliding_window_attention_sink_bwd.launches) == (before[0] + 1, before[1] + 2)
    qc, kc, vc, gc, bc = _plain(q, k, v, g, b)
    want_out, want_stats = tatt.sliding_window_attention_sink(qc, kc, vc, bc, W, M, exclude)
    _close(out.cpu(), want_out)
    _close(stats.cpu(), want_stats)
    # the backward from the same forward, so that only the backward differs
    want = tatt.sliding_window_attention_sink_bwd(qc, kc, vc, gc, out.cpu(), stats.cpu(), bc,
                                                  W, M, exclude)
    for got, w in zip(grads, want):
        if w is None:
            assert got is None
        else:
            _close_grad(got.cpu(), w)
    again = tatt.sliding_window_attention_sink_bwd(q, k, v, g, out, stats, b, W, M, exclude)
    for a, c in zip(grads, again):
        assert a is None or torch.equal(a, c)


def test_sink_op_differentiates_through_the_kernels(cuda_device):
    """The public op with sinks and the start mask: autograd runs the sink
    instance both ways, and its gradients are the plain version's."""
    T = 700
    q, k, v, g, b = _operands(T, cuda_device, seed=9)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, b)]
    out = tatt.sliding_window_attention_packed(*leaves[:3], W, M, exclude_start=True,
                                               sinks=leaves[3])
    got = torch.autograd.grad(out, leaves, g)
    cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
    want_out = tatt.sliding_window_attention_packed(*cpu[:3], W, M, exclude_start=True,
                                                    sinks=cpu[3])
    want = torch.autograd.grad(want_out, cpu, g.cpu())
    _close(out.detach().cpu(), want_out.detach())
    for a, w in zip(got, want):
        _close_grad(a.cpu(), w)


def test_sink_kernels_refuse_other_shapes(cuda_device):
    q, k, v, g, b = _operands(64, cuda_device)
    with pytest.raises(ValueError, match="sink instance"):
        tatt.sliding_window_attention_sink(q, k, v, b, 64, M, True)
    with pytest.raises(ValueError, match="sinks"):
        tatt.sliding_window_attention_sink(q, k, v, b[:, :4].contiguous(), W, M, True)


# sha256 of K1's out and stats and K3's dq, dk, dv (float32 bytes, in that
# order) on _cog_operands(): read from the kernels before the sink instance
# was added, on an H100
COG_DIGEST = "4635ce9e7dd2045b8899adf54fd2fb7f1358b1d86cb53c5b51f3793299df830b"


def _cog_operands(device):
    rng = np.random.default_rng(2024)
    T, h, d, m = 1536, 8, 8, 15
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=device)
            for s in ((h, d, T * m), (h, d, T), (h, d, T), (h, d, T * m))]


def cog_kernel_digest(device) -> str:
    """K1 and K3 at COG's shapes (8 heads of width 8, 15 prompt tokens a
    frame, len_q 30, a 1,536-frame trial) through the public op."""
    q, k, v, g = _cog_operands(device)
    out, stats = tatt.sliding_window_attention_packed(q, k, v, 30, 15, return_stats=True)
    grads = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, 30, 15)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in (out, stats, *grads):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def test_cog_kernels_keep_their_bits(cuda_device):
    assert cog_kernel_digest(cuda_device) == COG_DIGEST


def _reference():
    path = Path(__file__).resolve().parent.parent / "benchmark" / "reference" / "mimo_v2_flash.py"
    spec = importlib.util.spec_from_file_location("mimo_reference_on_card", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_step_at_the_published_widths_matches_the_reference(cuda_device):
    """Layers 0 and 1 of the cut (full attention with the dense MLP, then
    windowed attention with the MoE of experts 0-7 of 256) at the published
    widths, one ``Experiment.train_step`` on a 700-frame trial padded to
    768, against the reference on the card in float32 following the
    program's picks where they are a top 8 of its own scores. Loss rtol
    1e-5; each leaf's first gradient (Adam's first moment) within 1e-3 of
    its largest value: sums of 768 frames and 4,096 features in another
    order, and the sink kernels' band sums against the gathered windows."""
    import json

    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.data.datasets import FrameTrial, frame_batch
    from med_tpu_torch.models.mimo import MiMoArch, MiMoMoE
    from med_tpu_torch.train.engine import Experiment

    ref = _reference()
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmark" / "configs" / "mimo_v2_flash.json").read_text())
    cfg["num_hidden_layers"] = 2
    g = torch.Generator(device=cuda_device).manual_seed(17)
    params = {}
    for name, shape, kind, a, _ in ref.param_spec(cfg):
        params[name] = (torch.full(shape, float(a), device=cuda_device) if kind == "fill" else
                        torch.rand(shape, generator=g, device=cuda_device) * (2 * a) - a)
    ecfg = ExperimentConfig(**{**cfg["experiment"], "seed": 0})
    exp = Experiment(ecfg, device=cuda_device, arch=MiMoArch.from_dict(ref.arch(cfg)))
    exp.net.load_state_dict(params, strict=True)
    moe = exp.net.model.layers[1].ffn
    assert isinstance(moe, MiMoMoE)
    picked = []
    select = moe.select
    moe.select = lambda s: picked.append(select(s)) or picked[-1]
    r = np.random.default_rng(6)
    T = 700
    labels = (np.arange(T) // 40) % 2
    tr = FrameTrial(name="Suturing_B001", images=r.normal(size=(T, 2048)).astype(np.float32),
                    kinematics=r.normal(size=(T, 26)).astype(np.float32),
                    g_labels=np.zeros(T, np.int64),
                    e_powerset=np.concatenate([np.zeros((T, 6), np.int32),
                                               labels[:, None].astype(np.int32)], 1),
                    skill=np.zeros((T, 3), np.float32))
    batch = frame_batch(tr, ecfg, bucket=768)
    m = exp.train_step(batch)
    got_grad = {n: exp.optimizer.state[p]["exp_avg"] / 0.1
                for n, p in exp.net.named_parameters() if p.requires_grad}

    x = torch.cat([torch.as_tensor(batch["images"][0]),
                   torch.as_tensor(batch["kinematics"][0])], 1).to(cuda_device)
    leaves = {k: v.clone().requires_grad_(not k.endswith(ref.FIXED)) for k, v in params.items()}
    want_logits, _ = ref.forward(leaves, cfg, x, [None, picked[0]])
    want_loss = ref.loss(want_logits, torch.as_tensor(batch["labels"], device=cuda_device), T)
    names = [k for k, v in leaves.items() if v.requires_grad]
    want = dict(zip(names, torch.autograd.grad(want_loss, [leaves[n] for n in names])))
    assert abs(float(m["loss"]) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert sorted(got_grad) == sorted(names)
    for n in names:
        scale = want[n].abs().max().item()
        assert (got_grad[n] - want[n]).abs().max().item() <= 1e-3 * max(scale, 1e-30), n
    with torch.no_grad():
        a = ref.arch(cfg)
        h = x @ leaves["model.W_in.weight"].T + leaves["model.W_in.bias"]
        h, _ = ref.layer(leaves, 0, h, a)
        h1 = ref.attention_part(leaves, 1, h, a)
        u = ref._rms(h1, leaves["model.layers.1.ffn_norm.weight"], a["eps"])
        assert ref.pick_gap(leaves, "model.layers.1.", u, a, picked[0]) <= 1e-5


@pytest.mark.parametrize("starved", [(), (3,)])
def test_held_experts_gradients_keep_the_per_slice_bits(cuda_device, starved):
    """One MoE layer at the published widths (hidden 4,096, experts 0-7 of
    256 of width 2,048, top 8) on 1,536 frames, ~48 an expert (one held
    expert biased out in the second case): the output and the three stacked
    gradients equal the per-slice path's bit for bit."""
    from med_tpu_torch.models.mimo import MiMoArch

    path = Path(__file__).resolve().parent / "test_torch_mimo.py"
    spec = importlib.util.spec_from_file_location("mimo_cpu_tests_on_card", path)
    cpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cpu)
    layer, u = cpu.moe_layer(torch.float32, starved=starved, frames=1536, arch=MiMoArch(),
                             device=cuda_device)
    out, got = cpu.moe_grads(layer, u, layer)
    want_out, want = cpu.moe_grads(layer, u, lambda v: cpu.per_slice_moe(layer, v))
    assert torch.equal(out, want_out)
    for name, a, b in zip(("w1", "w3", "w2"), got[2:], want[2:]):
        assert torch.equal(a, b), name
        assert all((torch.count_nonzero(a[e]) == 0) == (e in starved) for e in range(8)), name
