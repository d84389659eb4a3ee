"""COG's train step from CUDA graphs (``train/graphs.py``) on the card,
against an eager twin: the same experiment with the graphs switched off,
from the same weights, generator and trials. They need an NVIDIA GPU and
skip without one; this file imports no JAX:

    python -m pytest tests/test_torch_graphs_cuda.py --noconftest -q

Each graphed step starts from the twin's state (its parameters and Adam
moments copied in place, where the graphs read them), so every step is
compared alone. Tolerance, and why: the forward replays the eager step's
own operations on the same inputs, so the loss and the confusion matrix
are held to equality (rtol 1e-6 for the loss); the backward sums a
tensor's gradient from its consumers in another order where a consumer
lies across a segment's edge, so Adam's moments are held to rtol 1e-4,
atol 1e-5 of the leaf's largest value, as the card-against-CPU gradient
tests hold theirs; and a parameter to 1e-6 of its leaf's largest value,
except where Adam's step divides a gradient at its rounding noise by
itself, flipping the sign of an update of size lr: at most 2 lr, in at
most one element in a thousand.
"""

import numpy as np
import pytest
import torch

from med_tpu_torch import ops
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.train.engine import Experiment

pytestmark = pytest.mark.cuda

SMALL = dict(model_name="COG", dataset_type="frame", video_dims=2048, num_layers_Basic=4,
             num_layers_R=3, num_R=3, mstcn_f_maps=32, d_model=32, d_q=4,
             sequence_length=5, weight_decay=0.0, lr_scheduler=False)
LENGTHS = (300, 420, 350, 500, 310, 470)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


def _trial(rng, T, name="Needle_Passing_B001"):
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = rng.integers(0, 2, T)
    e[:, 0] = rng.integers(0, 2, T)
    return FrameTrial(name, rng.normal(size=(T, 2048)).astype(np.float32),
                      rng.normal(size=(T, 26)).astype(np.float32),
                      rng.integers(0, 15, T), e, skill_one_hot(name, T))


def _pair(device, error_type="global"):
    cfg = ExperimentConfig(**SMALL, error_type=error_type,
                           out_features=2 if error_type == "global" else 6)
    exps = []
    for _ in range(2):
        exp = Experiment(cfg, device=device)
        exp.init_weights(5)
        exps.append(exp)
    exps[1].graphs.engages = lambda: False
    assert exps[0].graphs.engages()
    return exps


def _sync(exp, twin):
    """The twin's parameters and Adam state into ``exp``, in place."""
    with torch.no_grad():
        for p, q in zip(exp.net.parameters(), twin.net.parameters()):
            p.copy_(q)
            for k, v in twin.optimizer.state.get(q, {}).items():
                state = exp.optimizer.state[p]
                if isinstance(v, torch.Tensor) and k in state:
                    state[k].copy_(v)
                else:
                    state[k] = v.clone() if isinstance(v, torch.Tensor) else v


def _compare(exp, twin, got, want, lr):
    assert got["loss"].item() == pytest.approx(want["loss"].item(), rel=1e-6)
    for k in want:
        if k.startswith("cm"):
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(exp.generator.get_state(), twin.generator.get_state())
    for (name, p), q in zip(exp.net.named_parameters(), twin.net.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            a, b = exp.optimizer.state[p][k], twin.optimizer.state[q][k]
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * max(b.abs().max().item(), 1e-30),
                                       msg=f"{name} {k}")
        diff = (p - q).abs()
        off = diff > 1e-6 * max(q.abs().max().item(), 1e-30)
        assert diff.max().item() <= 2 * lr * (1 + 1e-3), name
        assert off.sum().item() <= max(1, off.numel() // 1000), name


@pytest.mark.parametrize("error_type", ["global", "all_errors"])
def test_six_graphed_steps_follow_an_eager_twin(cuda_device, error_type):
    """Six steps on trials of six lengths padded to one 512-frame bucket,
    each drawing its own masks from the generator: one capture, then
    replays; every step against the twin's from the same state, and each
    step launches the kernels as the eager step does (K1 2, K3 2, K2a 1,
    K4 1, K2b 4, K5 4)."""
    exp, twin = _pair(cuda_device, error_type)
    rng = np.random.default_rng(7)
    diffs = []
    for i, T in enumerate(LENGTHS):
        batch = frame_batch(_trial(rng, T), exp.cfg, bucket=512)
        _sync(exp, twin)
        ops.reset_launch_counts()
        got = exp.train_step(batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = twin.train_step(batch)
        assert counts == {**{k: 0 for k in counts},
                          "sliding_window_attention_packed": 2,
                          "sliding_window_attention_packed_bwd": 2,
                          "dilated_residual_multistack_stages": 1,
                          "dilated_residual_multistack_stages_bwd": 1,
                          "dilated_residual_stack": 4, "dilated_residual_stack_bwd": 4}
        _compare(exp, twin, got, want, exp.cfg.lr)
        diffs.append(abs(got["loss"].item() - want["loss"].item()))
        assert len(exp.graphs.keys) == 1
    print(f"[graphs] {error_type}: loss differences {diffs}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def test_fresh_outputs_and_a_second_bucket_captures_again(cuda_device):
    """Each step's metrics are its own tensors, holding their values after
    later steps; a trial in another bucket captures a second set of graphs
    and the first set still replays."""
    exp, twin = _pair(cuda_device)
    rng = np.random.default_rng(8)
    kept = []
    for T, bucket in ((300, 512), (200, 256), (400, 512), (250, 256)):
        batch = frame_batch(_trial(rng, T), exp.cfg, bucket=bucket)
        _sync(exp, twin)
        got = exp.train_step(batch)
        want = twin.train_step(batch)
        _compare(exp, twin, got, want, exp.cfg.lr)
        kept.append((got, {k: v.clone() for k, v in got.items()}))
    assert len(exp.graphs.keys) == 2
    for got, copy in kept:
        for k, v in copy.items():
            assert torch.equal(got[k], v), k
    assert len({got["loss"].data_ptr() for got, _ in kept}) == len(kept)


def test_init_weights_drops_the_graphs(cuda_device):
    exp, twin = _pair(cuda_device)
    rng = np.random.default_rng(9)
    batch = frame_batch(_trial(rng, 300), exp.cfg, bucket=512)
    exp.train_step(batch)
    assert len(exp.graphs.keys) == 1
    for e in (exp, twin):
        e.init_weights(6)
    assert exp.graphs.keys == {}
    _compare(exp, twin, exp.train_step(batch), twin.train_step(batch), exp.cfg.lr)
    assert len(exp.graphs.keys) == 1
