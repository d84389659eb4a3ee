"""COG's forward cut at its kernel calls (``models/cog.py``: ``COG.forward``
run through ``segments``), each stretch one node of autograd as a replayed
graph is, run eagerly on the CPU against the uncut ``COG.forward``: the
tracks, the loss, the metrics and every gradient equal bit for bit in
training (the masks given) and the tracks in eval, for the 'global' and
'all_errors' regimes; each segment holds exactly the parameters its
outputs reach. And the rule of the step graphs (``train/graphs.py``): on
the CPU, on a mesh and for other families a train step builds none, and
each step's loss is a tensor of its own. The graphs themselves run on the
card (``tests/test_torch_graphs_cuda.py``)."""

import numpy as np
import pytest
import torch

from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.models.cog import segments
from med_tpu_torch.parallel.mesh import make_mesh, shard_state, unshard_state
from med_tpu_torch.train.engine import Experiment, cog_loss
from med_tpu_torch.train.graphs import _Loss
from med_tpu_torch.utils import profiling

SMALL = dict(model_name="COG", dataset_type="frame", video_dims=2048, num_layers_Basic=4,
             num_layers_R=3, num_R=2, mstcn_f_maps=8, d_model=16, d_q=2,
             sequence_length=5, weight_decay=0.0, lr_scheduler=False)


def _trial(rng, T, name="Needle_Passing_B001"):
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = rng.integers(0, 2, T)
    e[:, 0] = rng.integers(0, 2, T)
    return FrameTrial(name, rng.normal(size=(T, 2048)).astype(np.float32),
                      rng.normal(size=(T, 26)).astype(np.float32),
                      rng.integers(0, 15, T), e, skill_one_hot(name, T))


def _cog(error_type):
    out_features = 2 if error_type == "global" else 6
    exp = Experiment(ExperimentConfig(**SMALL, error_type=error_type,
                                      out_features=out_features), device="cpu")
    exp.init_weights(5)
    return exp


def _grads(loss, params):
    return torch.autograd.grad(loss, params, allow_unused=True)


class _Cut(torch.autograd.Function):
    """A segment as one node of autograd, as ``train/graphs.py::_Replay``
    replays one: its forward on its inputs detached and re-attached, its
    backward by ``torch.autograd.grad`` into those inputs and the segment's
    parameters (which ride along as inputs of the node)."""

    @staticmethod
    def forward(ctx, segment, n, *args):
        inputs = [None if a is None else a.detach().requires_grad_(a.requires_grad)
                  for a in args[:n]]
        with torch.enable_grad():
            outs = segment(*inputs)
        ctx.cut = (inputs, args[n:], outs)
        ctx.set_materialize_grads(False)
        got = [o.detach() for o in outs]
        ctx.mark_non_differentiable(*[g for g, o in zip(got, outs) if not o.requires_grad])
        return tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        inputs, params, outs = ctx.cut
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad and g is not None]
        wrt = [a for a in inputs if a is not None and a.requires_grad] + list(params)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs else [None] * len(wrt))
        into = [next(got) if a is not None and a.requires_grad else None for a in inputs]
        return (None, None, *into, *got)


def _cut_run(segs):
    def run(name, *xs):
        params = [p for p in segs[name].parameters() if p.requires_grad]
        return _Cut.apply(segs[name], len(xs), *xs, *params)
    return run


@pytest.mark.parametrize("error_type", ["global", "all_errors"])
@pytest.mark.parametrize("train", [True, False])
def test_segmented_cog_equals_cog_forward_bit_for_bit(error_type, train):
    exp = _cog(error_type)
    model, cfg = exp.net.model, exp.cfg
    data = exp._tensors(frame_batch(_trial(np.random.default_rng(3), 300), cfg))
    x = exp._assemble(data)
    masks = model.dropout_masks(x.shape[1], torch.Generator().manual_seed(1)) if train else None
    params = list(exp.net.parameters())
    with torch.set_grad_enabled(train):
        want, want_f = model(x, train=train, masks=masks)
        got, got_f = model(x, train=train, masks=masks, run=_cut_run(segments(model)))
    assert len(got) == len(want) == 2 * (cfg.num_R + 1)
    assert len(got_f) == len(want_f) == 2 * (cfg.num_R + 1)
    for g, w in zip(got + got_f, want + want_f):
        assert torch.equal(g, w)
    if not train:
        return
    loss_w, metrics_w = cog_loss(cfg, want, data)
    keys = sorted(k for k in data if k not in ("images", "kinematics"))
    loss_g, *values = _Cut.apply(_Loss(exp._loss, len(got), keys), len(got) + len(keys),
                                 *got, *(data[k] for k in keys))
    assert torch.equal(loss_g, loss_w)
    assert list(metrics_w) == (["cm", "preds", "probs"]
                               + (["cm_binary"] if error_type == "all_errors" else []))
    for v, w in zip(values, metrics_w.values()):
        assert torch.equal(v, w)
    for name, g, w in zip([n for n, _ in exp.net.named_parameters()],
                          _grads(loss_g, params), _grads(loss_w, params)):
        assert (g is None) == (w is None), name
        assert g is None or torch.equal(g, w), name


def test_each_segment_holds_the_parameters_its_outputs_reach():
    """A segment's parameters are what its graph differentiates: every one
    that its outputs reach, and no other. The stacks' weights go to the
    kernels, and the slow stages' class convs are dead (as in COG.forward);
    every other parameter belongs to one segment."""
    exp = _cog("global")
    model = exp.net.model
    x = exp._assemble(exp._tensors(frame_batch(_trial(np.random.default_rng(4), 64), exp.cfg)))
    masks = model.dropout_masks(x.shape[1], torch.Generator().manual_seed(2))
    segs = segments(model)
    names = {p: n for n, p in model.named_parameters()}
    reached = {}

    def run(name, *xs):
        # cut from the segments before: a gradient reaches this one's alone
        outs = segs[name](*[x.detach().requires_grad_(x.requires_grad) for x in xs])
        diff = [o for o in outs if o.requires_grad]
        grads = torch.autograd.grad(diff, list(model.parameters()),
                                    [torch.ones_like(o) for o in diff], allow_unused=True)
        reached[name] = {names[p] for p, g in zip(model.parameters(), grads) if g is not None}
        return outs

    model(x, True, masks, run=run)
    held = {name: {names[p] for p in s.parameters()} for name, s in segs.items()}
    assert list(reached) == list(segs)
    assert reached == held
    owned = [n for s in held.values() for n in s]
    assert len(owned) == len(set(owned))
    rest = set(names.values()) - set(owned)
    stages = model.slow_names + model.fast_names
    assert rest == ({f"{s}.stack.{w}" for s in stages for w in ("w3", "b3", "w1", "b1")}
                    | {f"{s}.conv_out.{w}" for s in model.slow_names
                       for w in ("weight", "bias")})


def _window_batch(rng, cfg):
    B, W = 16, cfg.window_size
    return {"kinematics": rng.normal(size=(B, W, 26)).astype(np.float32),
            "labels": rng.integers(0, 2, B).astype(np.float32),
            "mask": np.ones(B, np.float32)}


@pytest.mark.parametrize("case", ["cog", "cog_mesh", "tecno", "window"])
def test_a_cpu_train_step_builds_no_graph_and_keeps_its_own_loss(case):
    """The CPU, a (1 x 1) mesh, TeCNo and a window model take the eager
    step: no graph, no graph count. Three steps' losses are three tensors,
    each keeping its value after the steps that follow."""
    rng = np.random.default_rng(5)
    if case == "tecno":
        cfg = ExperimentConfig(model_name="TeCNo", dataset_type="frame", data_type="video",
                               video_dims=2048, out_features=2, mstcn_stages=2,
                               mstcn_layers=3, mstcn_f_maps=8, lr_scheduler=False)
    elif case == "window":
        cfg = ExperimentConfig(model_name="SimpleCNN", dataset_type="window",
                               data_type="kinematics", out_features=1, batch_size=16,
                               hidden_size=16, lr_scheduler=False)
    else:
        cfg = ExperimentConfig(**SMALL, out_features=2)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(7)
    if case == "cog_mesh":
        shard_state(exp, make_mesh())
    assert not exp.graphs.engages()
    steps = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        for i in range(3):
            batch = (_window_batch(rng, cfg) if case == "window" else
                     frame_batch(_trial(rng, 40 + 20 * i), cfg, bucket=128))
            loss = exp.train_step(batch)["loss"]
            steps.append((loss, float(loss)))
        snap = profiling.snapshot()
    assert exp.graphs.keys == {}
    assert snap["med.train.step"]["calls"] == 3
    assert "med.train.graph_step" not in snap and "med.train.graph_capture" not in snap
    assert len({id(loss) for loss, _ in steps}) == 3
    assert len({loss.data_ptr() for loss, _ in steps}) == 3
    for loss, value in steps:
        assert float(loss) == value
    assert len({value for _, value in steps}) == 3


def test_the_counter_records_only_while_a_profiler_records():
    profiling.reset()
    profiling.count("med.train.graph_step")
    assert profiling.snapshot() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        for _ in range(3):
            profiling.count("med.train.graph_step")
        profiling.count("med.train.graph_capture")
        snap = profiling.snapshot()
    assert snap == {"med.train.graph_step": {"calls": 3, "total_ms": 0.0, "self_ms": 0.0},
                    "med.train.graph_capture": {"calls": 1, "total_ms": 0.0, "self_ms": 0.0}}


@pytest.mark.parametrize("how", ["init_weights", "load_params", "shard_state", "unshard_state"])
def test_what_moves_the_state_drops_the_graphs(how):
    exp = _cog("global")
    tree = exp.checkpoint()
    exp.graphs.keys["a key"] = object()
    exp.graphs._params = [1, 2]
    {"init_weights": lambda: exp.init_weights(5),
     "load_params": lambda: exp.load_params(tree),
     "shard_state": lambda: shard_state(exp, make_mesh()),
     "unshard_state": lambda: unshard_state(exp)}[how]()
    assert exp.graphs.keys == {} and exp.graphs._params is None
