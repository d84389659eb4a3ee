"""MiMo-V2-Flash's hybrid block (``models/mimo.py``) against its plain
reference (``benchmark/reference/mimo_v2_flash.py``, the file the benchmark
runs), at a small size on the CPU: hidden 64, 8 query heads over 2 KV heads
(windowed) and 1 (full), q and k of width 24 and v of 16, a window of 8,
16 experts of width 32 with 4 held and 4 picked, seeded weights, trials of
~40 frames. The model has no JAX counterpart.

- the model's logits, loss and every leaf's gradient (sinks and router
  included) against the reference in float64, and through
  ``Experiment.compute_gradients`` in float32 with the reference following
  the program's picks;
- the four shares of 4 experts each add up to the uncut layer of 16;
- the packed op's plain version with the start left out and sinks against
  the reference's gathered windows, forward and backward, and a reference
  that drops the sink or scores the zero-padded start failing the same
  comparison;
- COG's zero-padded plain path giving the bits it gave before;
- the frame CLI with ``--model-name MiMoV2Flash`` and
  ``FrameModelServer`` on its checkpoint (``MiMoArch``'s published cut
  swapped for the small size where ``build_model`` takes it);
- one MoE layer, a held expert given no frames, against the per-slice path
  it replaced (each expert's weights sliced from the stacks under
  autograd): the output and every gradient equal bit for bit in float32
  and float64, no ``SelectBackward0`` on a stack in the backward graph,
  and the gradient-slice counters covering every held expert.

Tolerances: float64 rtol 1e-9 (the two sides order their sums differently;
float64 rounding is ~1e-16 a step, so 1e-9 is far above it and far below any
mistake). float32: logits and loss rtol 1e-4, each gradient within 1e-4 of
its own largest value (sums over ~40 frames and 64 features in another
order, ~1e-6 relative; the softmax and the norms amplify a little)."""

import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.models.mimo import MiMoArch, MiMoMoE, MiMoV2Flash
from med_tpu_torch.ops import attention as tatt
from med_tpu_torch.train import losses
from med_tpu_torch.train.engine import Experiment

ROOT = Path(__file__).resolve().parent.parent


def _load_reference():
    path = ROOT / "benchmark" / "reference" / "mimo_v2_flash.py"
    spec = importlib.util.spec_from_file_location("mimo_reference_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load_reference()


def small_config(held=(4, 4), layers=4):
    """The benchmark's configuration file at a small size: every width cut,
    the layer pattern (F W W W ...) and the routing rule kept."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "mimo_v2_flash.json").read_text())
    cfg.update(hidden_size=64, swa_num_attention_heads=8, num_attention_heads=8,
               swa_num_key_value_heads=2, num_key_value_heads=1, head_dim=24, v_head_dim=16,
               sliding_window=8, intermediate_size=96, moe_intermediate_size=32,
               num_experts_per_tok=4, num_hidden_layers=layers, n_routed_experts=held[1])
    cfg["published"] = dict(cfg["published"], n_routed_experts=16)
    cfg["deployment"] = dict(cfg["deployment"], first_expert=held[0])
    return cfg


def seeded(cfg, seed=0, dtype=torch.float64):
    """A draw for every leaf of the reference's spec (uniform U(-a, a),
    fills), the program's names with the "model." prefix."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind, a, _ in ref.param_spec(cfg):
        if kind == "fill":
            out[name] = torch.full(shape, float(a), dtype=dtype)
        else:
            out[name] = (torch.rand(shape, generator=g, dtype=torch.float64) * 2 * a - a).to(dtype)
    return out


def model_of(cfg, params, dtype=torch.float64):
    model = MiMoV2Flash(MiMoArch.from_dict(ref.arch(cfg))).to(dtype)
    model.load_state_dict({k[len("model."):]: v for k, v in params.items()}, strict=True)
    return model


def trial(T=40, seed=1, dtype=torch.float64):
    r = np.random.default_rng(seed)
    x = torch.as_tensor(r.normal(size=(T, 2074)), dtype=dtype)
    labels = torch.as_tensor((np.arange(T) // 7) % 2)
    return x, labels


def _close(got, want, rtol):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= rtol * max(scale, 1e-30), \
        ((got - want).abs().max().item(), scale)


def test_model_matches_the_reference_in_float64():
    cfg = small_config()
    params = seeded(cfg)
    model = model_of(cfg, params)
    x, labels = trial()
    T = 34                                         # the last 6 frames are padding
    logits = model(x[None])[0]
    mask = (torch.arange(len(x)) < T).to(torch.float64)
    loss = losses.soft_cross_entropy(logits, losses.binary_targets(labels, logits.dtype), mask)
    named = dict(model.named_parameters())
    trainable = [n for n, p in named.items() if p.requires_grad]
    got = dict(zip(trainable, torch.autograd.grad(loss, [named[n] for n in trainable])))

    leaves = {k: v.clone().requires_grad_(not k.endswith(ref.FIXED)) for k, v in params.items()}
    want_logits, picks = ref.forward(leaves, cfg, x)
    want_loss = ref.loss(want_logits, labels, T)
    names = [k for k, v in leaves.items() if v.requires_grad]
    want = dict(zip(names, torch.autograd.grad(want_loss, [leaves[n] for n in names])))

    _close(logits, want_logits, 1e-9)
    assert abs(loss.item() - want_loss.item()) <= 1e-9 * abs(want_loss.item())
    assert sorted("model." + n for n in trainable) == sorted(names)
    for n in trainable:
        _close(got[n], want["model." + n], 1e-9)
    # the sinks, the router and the held experts take a gradient
    for part in ("attn.sinks.sinks", "ffn.gate.weight", "ffn.experts.w2"):
        assert any(part in n and want["model." + n].abs().max() > 0 for n in trainable), part
    assert any(p is not None for p in picks)


def test_train_step_matches_the_reference_in_float32():
    """``Experiment.compute_gradients`` (the train step's forward, loss and
    backward) against the reference in float32, the reference following the
    program's picks where they are a top k of its own scores."""
    cfg = small_config()
    params = seeded(cfg, seed=3, dtype=torch.float32)
    ecfg = ExperimentConfig(**{**cfg["experiment"], "seed": 0})
    exp = Experiment(ecfg, device="cpu", arch=MiMoArch.from_dict(ref.arch(cfg)))
    exp.net.load_state_dict(params, strict=True)
    moes = [(i, l.ffn) for i, l in enumerate(exp.net.model.layers) if isinstance(l.ffn, MiMoMoE)]
    picked = {}
    for i, moe in moes:
        moe.select = (lambda i, f: lambda s: picked.setdefault(i, f(s)))(i, moe.select)
    r = np.random.default_rng(5)
    T = 37
    labels = (np.arange(T) // 9) % 2
    tr = FrameTrial(name="Suturing_B001", images=r.normal(size=(T, 2048)).astype(np.float32),
                    kinematics=r.normal(size=(T, 26)).astype(np.float32),
                    g_labels=np.zeros(T, np.int64),
                    e_powerset=np.concatenate([np.zeros((T, 6), np.int32),
                                               labels[:, None].astype(np.int32)], 1),
                    skill=np.zeros((T, 3), np.float32))
    batch = frame_batch(tr, ecfg, bucket=48)
    loss, _ = exp.compute_gradients(batch)

    x = torch.cat([torch.as_tensor(batch["images"][0]), torch.as_tensor(batch["kinematics"][0])], 1)
    leaves = {k: v.clone().requires_grad_(not k.endswith(ref.FIXED)) for k, v in params.items()}
    pins = [picked.get(i) for i in range(len(exp.net.model.layers))]
    want_logits, _ = ref.forward(leaves, cfg, x, pins)
    want_loss = ref.loss(want_logits, torch.as_tensor(batch["labels"]), T)
    names = [k for k, v in leaves.items() if v.requires_grad]
    want = dict(zip(names, torch.autograd.grad(want_loss, [leaves[n] for n in names])))
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for n, p in exp.net.named_parameters():
        if p.requires_grad:
            _close(p.grad, want[n], 1e-4)
    # the program's picks are a top k of the reference's own scores
    h = x @ leaves["model.W_in.weight"].T + leaves["model.W_in.bias"]
    with torch.no_grad():
        a = ref.arch(cfg)
        for i in range(len(a["pattern"])):
            h1 = ref.attention_part(leaves, i, h, a)
            if pins[i] is not None:
                u = ref._rms(h1, leaves[f"model.layers.{i}.ffn_norm.weight"], a["eps"])
                assert ref.pick_gap(leaves, f"model.layers.{i}.", u, a, pins[i]) <= 1e-5
            h, _ = ref.ffn_part(leaves, i, h1, a, pins[i])


def test_expert_shares_add_up_to_the_whole_layer():
    """Four chips' shares of a 16-expert layer (4 each): their partial
    outputs sum to the reference layer that holds all 16."""
    whole = small_config(held=(0, 16), layers=2)
    a_whole = ref.arch(whole)
    params = seeded(whole, seed=7)
    lp = "model.layers.1."
    u = torch.as_tensor(np.random.default_rng(2).normal(size=(40, 64)))
    want, _ = ref.moe(params, lp, u, a_whole)
    total = torch.zeros_like(u)
    for first in (0, 4, 8, 12):
        arch = MiMoArch.from_dict({**a_whole, "held": [first, 4]})
        layer = MiMoMoE(arch).to(torch.float64)
        state = {"gate.weight": params[lp + "ffn.gate.weight"],
                 "gate.e_score_correction_bias": params[lp + "ffn.gate.e_score_correction_bias"]}
        for w in ("w1", "w3", "w2"):
            state[f"experts.{w}"] = params[f"{lp}ffn.experts.{w}"][first:first + 4]
        layer.load_state_dict(state, strict=True)
        with torch.no_grad():
            total += layer(u[None])[0]
    _close(total, want, 1e-12)
    assert want.abs().max() > 0


def _packed(q, k, v, H, m):
    """(T, H, d) queries and (T, G, d) keys and values -> the packed layout."""
    T, _, dk = q.shape
    G = k.shape[1]
    qp = q.reshape(T, G, m, dk).permute(1, 3, 0, 2).reshape(G, dk, T * m)
    return qp, k.permute(1, 2, 0).contiguous(), v.permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("sinks", [True, False])
def test_plain_sink_instance_matches_the_gathered_windows(sinks):
    T, H, G, dk, dv, W = 21, 8, 2, 6, 4, 5
    m = H // G
    r = np.random.default_rng(3)
    q, k, v = (torch.tensor(r.normal(size=s), requires_grad=True)
               for s in ((T, H, dk), (T, G, dk), (T, G, dv)))
    b = torch.tensor(r.normal(size=(G, m)) * 2, requires_grad=True) if sinks else None
    g = torch.as_tensor(r.normal(size=(T, H, dv)))
    leaves = [q, k, v] + ([b] if sinks else [])

    want = ref.window_attention(q, k, v, None if b is None else b.reshape(-1), W)
    qp, kp, vp = _packed(q, k, v, H, m)
    out = tatt.sliding_window_attention_packed(qp, kp, vp, W, m, exclude_start=True, sinks=b)
    got = out.reshape(G, dv, T, m).permute(2, 0, 3, 1).reshape(T, H, dv)
    _close(got, want, 1e-12)
    for a, w in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, leaves, g)):
        _close(a, w, 1e-12)
    # the comparison sees a reference that drops the sink or scores the
    # zero-padded start: each is off by far more than the tolerance
    zero_start = tatt.sliding_window_attention_packed(qp, kp, vp, W, m, sinks=b)
    assert (zero_start - out).abs().max() > 1e-3
    if sinks:
        no_sink = tatt.sliding_window_attention_packed(qp, kp, vp, W, m, exclude_start=True)
        assert (no_sink - out).abs().max() > 1e-3


def _cog_plain_before(q, k, v, window, m):
    """The zero-padded plain forward as it stood before the sink instance."""
    H, dk, N = q.shape
    T = N // m
    q4 = (q * (1.0 / math.sqrt(dk))).permute(0, 2, 1).reshape(H, T, m, dk)
    kwin = torch.stack([tatt.sliding_windows(x, window) for x in k.transpose(1, 2)])
    vwin = torch.stack([tatt.sliding_windows(x, window) for x in v.transpose(1, 2)])
    scores = torch.einsum("htmd,htwd->htmw", q4, kwin)
    smax = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - smax)
    psum = p.sum(dim=-1, keepdim=True)
    rsum = 1.0 / psum
    out = torch.einsum("htmw,htwd->htmd", p, vwin) * rsum
    lse = smax + torch.log(psum)
    stats = torch.cat([lse, rsum], dim=-1)
    return (out.reshape(H, N, -1).permute(0, 2, 1), stats.reshape(H, N, 2).permute(0, 2, 1))


def test_cog_zero_padded_plain_path_keeps_its_bits():
    r = np.random.default_rng(4)
    H, d, m, W, T = 8, 8, 15, 30, 70
    q, k, v, g = (torch.as_tensor(r.normal(size=s).astype(np.float32))
                  for s in ((H, d, T * m), (H, d, T), (H, d, T), (H, d, T * m)))
    out, stats = tatt.sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    before = _cog_plain_before(q, k, v, W, m)
    assert torch.equal(out, before[0]) and torch.equal(stats, before[1])
    grads = tatt.sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)
    assert len(grads) == 3
    # autograd through COG's op takes the three-gradient backward
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = tatt.sliding_window_attention_packed(*leaves, W, m)
    for a, b in zip(torch.autograd.grad(y, leaves, g), grads):
        assert torch.equal(a, b)


def _write_fold(fold_dir, rng, names, T):
    from med_tpu_torch.data import trials as ttrials

    os.makedirs(fold_dir)
    for name in names:
        e = np.zeros((T, 5), np.int64)
        e[(np.arange(T) // 10) % 2 == 1, 4] = 1
        kin = (rng.normal(size=(T, 26)) + e[:, 4:5] * 2.0).astype(np.float32)
        g = np.ones(T, np.int64)
        ttrials.save_trial_npz(os.path.join(fold_dir, name + ".npz"), ttrials.Trial(
            name, rng.normal(size=(T, 2048)).astype(np.float32), kin, g, e))
    with open(os.path.join(fold_dir, "train.csv"), "w") as f:
        f.write("\n".join(n + ".npz" for n in names[:-1]))
    with open(os.path.join(fold_dir, "test.csv"), "w") as f:
        f.write(names[-1] + ".npz")


def test_frame_cli_trains_and_the_server_serves_it(tmp_path, monkeypatch):
    import med_tpu_torch.models as models
    from med_tpu_torch.cli import train_frame
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.train.checkpoint import load_best_checkpoint

    # the published cut (~2.1 B parameters) is too large for a CPU test: the
    # CLI and the server build the small size where build_model takes its sizes
    small = MiMoArch.from_dict(ref.arch(small_config()))
    built = []
    monkeypatch.setattr(models, "MiMoArch", lambda: built.append(small) or small)
    rng = np.random.default_rng(8)
    _write_fold(str(tmp_path / "data" / "1Out"), rng,
                [f"Suturing_{c}001" for c in "BCD"], T=50)
    train_frame.main(["--model-name", "MiMoV2Flash", "--data-type", "multimodal",
                      "--video-dims", "2048", "--device", "cpu", "--data-root",
                      str(tmp_path / "data"), "--folds", "1Out", "--runs-root",
                      str(tmp_path / "runs"), "--n-epochs", "2", "--lr", "1e-4"])
    assert built
    (run_dir,) = [p for p in (tmp_path / "runs").glob("*/*") if p.is_dir()]
    ckpt = load_best_checkpoint(str(run_dir / "checkpoints"), "LOSO", "1Out",
                                model_name="MiMoV2Flash")
    cfg = ExperimentConfig(model_name="MiMoV2Flash", dataset_type="frame",
                           data_type="multimodal", video_dims=2048, out_features=2)
    server = FrameModelServer(cfg, ckpt, device="cpu")
    images = rng.normal(size=(45, 2048)).astype(np.float32)
    kin = rng.normal(size=(45, 26)).astype(np.float32)
    preds, probs = server.predict_trial(images, kin)
    assert preds.shape == probs.shape == (45,)
    assert np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()


def test_windowed_layers_hand_the_kernels_contiguous_operands(monkeypatch):
    """The sink kernels read their operands where they lie: the model hands
    them contiguous tensors (a permuted view of one trial stays strided)."""
    import med_tpu_torch.models.mimo as mimo

    seen = []
    op = mimo.sliding_window_attention_packed

    def check(q, k, v, *args, **kwargs):
        seen.append(all(t.is_contiguous() for t in (q, k, v, kwargs.get("sinks"))
                        if t is not None))
        return op(q, k, v, *args, **kwargs)

    monkeypatch.setattr(mimo, "sliding_window_attention_packed", check)
    cfg = small_config()
    model = model_of(cfg, seeded(cfg), torch.float32)
    model(trial(dtype=torch.float32)[0][None])
    assert seen and all(seen)


class _SliceSwiGLU(torch.autograd.Function):
    """One held expert's SwiGLU on its weights' slices, as the layer ran it
    before its held experts became one node: autograd makes each slice's
    gradient a zero-filled tensor the size of the stack and adds them up."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2):
        h1, h3 = x @ w1.T, x @ w3.T
        ctx.save_for_backward(x, w1, w3, w2, h1, h3)
        return (torch.nn.functional.silu(h1) * h3) @ w2.T

    @staticmethod
    def backward(ctx, g):
        x, w1, w3, w2, h1, h3 = ctx.saved_tensors
        g = g.contiguous()
        s = torch.sigmoid(h1)
        act = h1 * s
        da = g @ w2
        dw2 = g.T @ (act * h3)
        dh3 = da * act
        dh1 = da * h3 * (s * (1.0 + h1 * (1.0 - s)))
        return dh1 @ w1 + dh3 @ w3, dh1.T @ x, dh3.T @ x, dw2


def per_slice_moe(layer, u):
    """``MiMoMoE.forward`` with each held expert's weights sliced from the
    stacks under autograd (``e1[e]``), one node an expert."""
    x = u.reshape(-1, u.shape[-1])
    scores = torch.sigmoid(x @ layer.gate.weight.T)
    chosen = layer.select(scores.detach())
    picked = torch.gather(scores, 1, chosen)
    weights = picked / picked.sum(dim=-1, keepdim=True)
    n_held = layer.experts.w1.shape[0]
    ids = torch.arange(layer.first, layer.first + n_held, device=u.device)
    hit = chosen[:, :, None] == ids
    w_held = (weights[:, :, None] * hit).sum(dim=1)
    pairs = hit.any(dim=1).T.nonzero().cpu()
    counts = torch.bincount(pairs[:, 0], minlength=n_held).tolist()
    rows = pairs[:, 1].to(u.device)
    out = torch.zeros_like(x)
    e1, e3, e2 = layer.experts.w1, layer.experts.w3, layer.experts.w2
    at = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        idx = rows[at:at + n]
        at += n
        ye = _SliceSwiGLU.apply(x.index_select(0, idx), e1[e], e3[e], e2[e])
        out.index_add_(0, idx, ye * w_held.index_select(0, idx)[:, e:e + 1])
    return out.reshape(u.shape)


def moe_layer(dtype, starved=(1,), frames=40, seed=11, arch=None, device="cpu"):
    """One MoE layer (the small size's experts 4-7 of 16, top 4 unless
    ``arch`` is given) with seeded weights, the held experts ``starved``
    biased out of every top k, and (1, frames, hidden) inputs."""
    from med_tpu_torch.models.layers import _uniform_

    arch = arch or MiMoArch.from_dict(ref.arch(small_config()))
    layer = MiMoMoE(arch)
    g = torch.Generator().manual_seed(seed)
    layer.experts.reset_parameters(g)
    _uniform_(layer.gate.weight, arch.hidden, g)
    with torch.no_grad():
        for e in starved:
            layer.gate.e_score_correction_bias[layer.first + e] = -1e3
    u = torch.randn((1, frames, arch.hidden), generator=g, dtype=dtype)
    return layer.to(device=device, dtype=dtype), u.to(device)


def moe_grads(layer, u, forward):
    """The layer's output and the gradients of a seeded projection of it
    with respect to the input, the router and the three stacks."""
    u = u.detach().requires_grad_(True)
    out = forward(u)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2),
                       dtype=u.dtype).to(u.device)
    leaves = [u, layer.gate.weight, layer.experts.w1, layer.experts.w3, layer.experts.w2]
    return out, torch.autograd.grad(out, leaves, gout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_held_experts_keep_the_per_slice_paths_bits(dtype):
    """The layer against the per-slice path it replaced, one held expert
    given no frames: the output and the three stacked gradients equal, the
    starved expert's slices zero, the input's and the router's gradients
    equal bit for bit."""
    layer, u = moe_layer(dtype)
    out, got = moe_grads(layer, u, layer)
    want_out, want = moe_grads(layer, u, lambda v: per_slice_moe(layer, v))
    assert torch.equal(out, want_out)
    for name, a, b in zip(("input", "router", "w1", "w3", "w2"), got, want):
        assert torch.equal(a, b), name
    for d in got[2:]:
        assert torch.count_nonzero(d[1]) == 0
        assert all(torch.count_nonzero(d[e]) > 0 for e in (0, 2, 3))


def _selects_of_stacks(out, stacks):
    """The backward graph's ``SelectBackward0`` nodes that feed a stack."""
    found, seen, todo = [], set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nexts = [n for n, _ in node.next_functions]
        if type(node).__name__ == "SelectBackward0" and any(
                getattr(n, "variable", None) is s for n in nexts for s in stacks):
            found.append(node)
        todo += nexts
    return found


def test_backward_graph_slices_no_stacked_expert_weight():
    layer, u = moe_layer(torch.float64)
    u.requires_grad_(True)
    stacks = (layer.experts.w1, layer.experts.w3, layer.experts.w2)
    assert _selects_of_stacks(layer(u), stacks) == []
    # the walk finds the per-slice path's three a fed expert
    assert len(_selects_of_stacks(per_slice_moe(layer, u), stacks)) == 9


def test_gradient_slice_counters_cover_every_held_expert():
    from med_tpu_torch.utils import profiling

    layer, u = moe_layer(torch.float32)
    u.requires_grad_(True)
    calls = 3
    with torch.autograd.profiler.profile(use_kineto=False):
        profiling.reset()
        for _ in range(calls):
            layer(u).square().sum().backward()
        snap = profiling.snapshot()
    profiling.reset()
    slices, zeroed = snap["med.moe.grad_slices"]["calls"], snap["med.moe.grad_zeroed"]["calls"]
    assert slices + zeroed == layer.experts.w1.shape[0] * calls
    assert zeroed == calls                         # the starved expert, each backward


def test_a_layer_feeding_no_held_expert_runs_no_expert(monkeypatch):
    """Every held expert biased out: no expert runs, and the layer's zero
    output carries no gradient to the stacks."""
    import med_tpu_torch.models.mimo as mimo

    calls = []
    monkeypatch.setattr(mimo, "expert_swiglu", lambda *a: calls.append(a))
    layer, u = moe_layer(torch.float64, starved=(0, 1, 2, 3))
    out = layer(u.requires_grad_(True))
    assert calls == [] and torch.count_nonzero(out) == 0
    assert not out.requires_grad
