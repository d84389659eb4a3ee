"""COG's train step from CUDA graphs, cut at the hand-written kernels.

A COG train step runs ~1,400 device operations, all but 14 of them small
PyTorch ops that the host launches one by one: the forward, the 8 tracks'
loss and autograd's backward. Here the step runs ``COG.forward`` itself,
whose stretches between two kernel calls (``models/cog.py::segments``) and
the loss run from CUDA graphs. The first call of a stretch at a batch's
shapes warms it up on a side stream and captures its forward and its
backward (``torch.autograd.grad`` into every input and parameter that
needs a gradient, as ``torch.cuda.make_graphed_callables`` does) into a
memory pool of its own; every call then copies its inputs into the graph's
own (an input that is another graph's output is read where it lies) and
replays. A replay is one node of autograd (:class:`_Replay`), so
``loss.backward()`` replays the backward graphs in reverse; they add the
parameters' gradients into their ``.grad`` themselves, as autograd would.

The kernels (K1, K2a, K2b forward; K3, K4, K5 backward) keep their
ordinary launches between the replays: every call of their wrappers and
every ``.launches`` count holds, and their cooperative launches stay out of
stream capture. The dropout masks are drawn eagerly, once a step, from the
experiment's generator, as the eager step draws them; zeroing the
gradients and Adam stay eager. A capture changes no parameter, Adam state
or generator.

:meth:`StepGraphs.engages` says where a step takes this path: COG in
float32 without SRM or a feature extractor, one trial a step, the 'global'
or 'all_errors' regime, on a CUDA device, with no mesh or a mesh whose
every axis has one rank. Anything else, eval steps and serving stay eager.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import torch

from ..models.cog import segments
from ..utils.profiling import count, span

# warm-up runs of a stretch (forward and backward) on a side stream before
# its capture: cuBLAS and autograd set themselves up there, not in a graph
WARMUP = 2


def _where(t: torch.Tensor):
    return t.data_ptr(), tuple(t.shape), t.stride()


class _Graphed:
    """One stretch's forward and backward graphs at one set of input
    shapes. ``shared`` holds where the outputs of the graphs captured
    before it lie: an input that is one of them is read in place.

    The backward graph adds the parameters' gradients into their ``.grad``
    itself (a parameter without one gets zeros first, as autograd would
    give it the gradient), so autograd sees only the stretch's inputs: a
    stretch with no input that needs a gradient takes one parameter as an
    anchor, to which its backward returns nothing. The backward graph may
    reuse the memory of what the forward saved once it has read it, so each
    backward replay follows one forward replay, as a step replays them."""

    def __init__(self, segment: torch.nn.Module, args, shared: Set[tuple]):
        self.params = [p for p in segment.parameters() if p.requires_grad]
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.inputs = [a.detach() if _where(a) in shared else a.detach().clone()
                       for a in args]
        for s, a in zip(self.inputs, args):
            s.requires_grad_(a.requires_grad)
        needs = [s for s in self.inputs if s.requires_grad]
        self.anchor = [] if needs else self.params[:1]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                outs = [o for o in segment(*self.inputs) if o.requires_grad]
                torch.autograd.grad(outs, needs + self.params,
                                    [torch.zeros_like(o) for o in outs], allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, stream=side, capture_error_mode="thread_local"):
            outputs = segment(*self.inputs)
        self.differentiable = [o.requires_grad for o in outputs]
        diff = [o for o in outputs if o.requires_grad]
        self.grad_outputs = [torch.empty_like(o) for o in diff]
        self.bwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool(), stream=side,
                              capture_error_mode="thread_local"):
            grads = torch.autograd.grad(diff, needs + self.params, self.grad_outputs,
                                        allow_unused=True)
            into = [(p.grad, g) for p, g in zip(self.params, grads[len(needs):])
                    if g is not None]
            if into:
                torch._foreach_add_([a for a, _ in into], [g for _, g in into])
        # the gradients of the inputs that the backward graph writes (None
        # where none flows); held here, so that autograd never takes one of
        # them as its own or adds into it in place
        grads = iter(grads)
        self.grads = [next(grads) if s.requires_grad else None for s in self.inputs]
        self.outputs = [o.detach() for o in outputs]
        shared.update(_where(o) for o in self.outputs)


def _copy(pairs) -> None:
    """Each (graph's buffer, tensor) pair's tensor into the buffer, in one
    launch for all."""
    if pairs:
        torch._foreach_copy_([b for b, _ in pairs], [t for _, t in pairs])


class _Replay(torch.autograd.Function):
    """A stretch's forward graph replayed as one autograd node whose
    backward replays the stretch's backward graph."""

    @staticmethod
    def forward(ctx, graphed: _Graphed, *args):
        _copy([(s, a) for s, a in zip(graphed.inputs, args) if s.data_ptr() != a.data_ptr()])
        graphed.fwd.replay()
        ctx.graphed = graphed
        ctx.set_materialize_grads(False)
        outs = [o.detach() for o in graphed.outputs]
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, graphed.differentiable)
                                      if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        graphed = ctx.graphed
        diff = [g for g, d in zip(grads, graphed.differentiable) if d]
        for buf, g in zip(graphed.grad_outputs, diff):
            if g is None:
                buf.zero_()
        _copy([(buf, g) for buf, g in zip(graphed.grad_outputs, diff) if g is not None])
        graphed.bwd.replay()
        return (None, *graphed.grads, *[None] * len(graphed.anchor))


class _Loss(torch.nn.Module):
    """COG's loss over its tracks as a stretch: (tracks..., batch tensors
    by ``keys``) -> (loss, the metrics' tensors in ``names`` order)."""

    def __init__(self, loss_fn, n_tracks: int, keys: List[str]):
        super().__init__()
        self.loss_fn, self.n_tracks, self.keys = loss_fn, n_tracks, keys
        self.names: List[str] = []

    def forward(self, *xs):
        loss, metrics = self.loss_fn(list(xs[:self.n_tracks]),
                                     dict(zip(self.keys, xs[self.n_tracks:])))
        self.names = list(metrics)
        return (loss, *metrics.values())


class _KeyGraphs:
    """The graphs of one set of batch shapes: a stretch's are captured the
    first time the step reaches it."""

    def __init__(self, segs: Dict[str, torch.nn.Module]):
        self.segs = segs
        self.graphed: Dict[str, _Graphed] = {}
        self.shared: Set[tuple] = set()

    def run(self, name: str, *args):
        graphed = self.graphed.get(name)
        if graphed is None:
            graphed = self.graphed[name] = _Graphed(self.segs[name], args, self.shared)
        return _Replay.apply(graphed, *args, *graphed.anchor)


class StepGraphs:
    """An experiment's COG train steps from graphs, one set of graphs a
    key: each batch tensor's shape and dtype. A new key captures; the
    graphs hold the addresses of the parameters and their gradients, so a
    step that finds one moved (or a gradient set to None) drops them all
    and captures again, and :meth:`clear` drops them (``init_weights``,
    ``load_params``, ``shard_state``, ``unshard_state``)."""

    def __init__(self, exp):
        self.exp = exp
        self.keys: Dict[tuple, _KeyGraphs] = {}
        self._params: Optional[List[int]] = None

    def clear(self) -> None:
        self.keys.clear()
        self._params = None

    def engages(self) -> bool:
        exp = self.exp
        cfg, model = exp.cfg, exp.net.model
        return (exp.family == "cog" and exp.device.type == "cuda"
                and (exp.mesh is None or all(n == 1 for n in exp.mesh.shape.values()))
                and cfg.trial_batch <= 1 and cfg.error_type in ("global", "all_errors")
                and not cfg.uses_feature_extractor()
                and model.dtype is None and model.cot_skill is None)

    def _addresses(self) -> List[int]:
        """Where the parameters and their gradients lie: the graphs read
        and write them there."""
        return [0 if t is None else t.data_ptr()
                for p in self.exp.net.parameters() for t in (p, p.grad)]

    def _graphs(self, data: Dict[str, torch.Tensor]) -> _KeyGraphs:
        if self._addresses() != self._params:
            self.clear()
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(data.items()))
        graphs = self.keys.get(key)
        if graphs is None:
            count("med.train.graph_capture")
            model = self.exp.net.model
            keys = sorted(k for k in data if k not in ("images", "kinematics"))
            n_tracks = len(model.slow_names) + len(model.fast_names)
            segs = {**segments(model), "loss": _Loss(self.exp._loss, n_tracks, keys)}
            graphs = self.keys[key] = _KeyGraphs(segs)
        return graphs

    def loss(self, data: Dict[str, torch.Tensor], masks=None):
        """The step's forward and loss from the graphs: (loss, metrics), the
        loss ready for ``backward()``, the metrics fresh tensors. ``masks``
        as ``COG.dropout_masks`` draws them, or None: ``COG.forward`` draws
        them from the experiment's generator."""
        exp = self.exp
        graphs = self._graphs(data)
        count("med.train.graph_step")
        with span("med.train.forward"):
            out_list, _ = exp.net.model(exp._assemble(data), True, masks, exp.generator,
                                        run=graphs.run)
        with span("med.train.loss"):
            loss_seg = graphs.segs["loss"]
            loss, *values = graphs.run("loss", *out_list, *(data[k] for k in loss_seg.keys))
            metrics = {k: v.clone() for k, v in zip(loss_seg.names, values)}
        self._params = self._addresses()
        return loss, metrics
