"""Meshes and placement (port of ``med_tpu.parallel.mesh``).

Axes, as in ``med_tpu``:

- ``data``: the batch (windows or trials) splits over it; each rank steps
  its rows, the reductions that GSPMD makes global are made global (the
  masked means, BatchNorm's statistics, the group loss, the confusion
  matrices) and the parameter gradients are summed over it once a step;
- ``model``: tensor parallelism of the FeatureExtractor, Megatron-style by
  the parameter's path: ``fe.dense0`` by output columns (its weight's rows
  and its bias), ``fe.dense1`` by input rows (its weight's columns), one
  all-reduce over ``model`` after ``dense1``'s product, before its bias.
  A width that does not divide the axis warns and stays replicated. Adam's
  moments follow their parameters.

A :class:`Mesh` is a ``torch.distributed`` device mesh over the ranks of
the world, row-major (rank = data · n_model + model). A world of one rank
needs no process group: its mesh is (1, 1) and holds no groups.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import comm

# the FeatureExtractor's tensor-parallel placement: parameter -> split axis
# of the torch weight (dense0's output columns are its weight's rows)
_TP_DIMS = {"fe.dense0.weight": 0, "fe.dense0.bias": 0, "fe.dense1.weight": 1}


class Mesh:
    """The ranks of the world as a (data, model) grid, with a process group
    along each axis (None for an axis of one rank)."""

    def __init__(self, shape: Tuple[int, int], device_mesh=None):
        self.shape = {"data": int(shape[0]), "model": int(shape[1])}
        self.device_mesh = device_mesh
        r = dist.get_rank() if device_mesh is not None else 0
        self._coord = {"data": r // self.shape["model"], "model": r % self.shape["model"]}

    def group(self, axis: str):
        if self.device_mesh is None or self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coord[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def auto_shape(world: int) -> Tuple[int, int]:
    """med_tpu's 'auto' layout: model = 2 when the count is even and > 1."""
    model = 2 if world % 2 == 0 and world > 1 else 1
    return world // model, model


def make_mesh(shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The world's ranks as a (data, model) mesh: ``shape`` (data,) or
    (data, model), or :func:`auto_shape` of the world size. The shape must
    hold every rank of the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = auto_shape(world) if shape is None else tuple(int(s) for s in shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if shape[0] * shape[1] != world:
        raise ValueError(f"a {shape[0]}x{shape[1]} mesh needs {shape[0] * shape[1]} "
                         f"ranks; the world has {world}")
    if world == 1:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, init_device_mesh(device_type, shape, mesh_dim_names=("data", "model")))


def split_rows(n: int, mesh: Optional[Mesh], name: str = "batch") -> Optional[slice]:
    """This rank's rows of a leading axis of ``n`` over ``data``, or None
    when the axis stays whole: one data rank, or ``n`` not a multiple of
    the axis (which warns: data parallelism then quietly becoming
    replication is easy to miss)."""
    if mesh is None or mesh.shape["data"] == 1:
        return None
    k = mesh.shape["data"]
    if n % k:
        warnings.warn(f"{name} leading dim {n} not divisible by data axis {k}; "
                      "replicating (DP disabled for this array)", stacklevel=3)
        return None
    per = n // k
    i = mesh.coord("data")
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of every batch array along its leading axis; keys
    starting with '_' and scalars pass whole. A leading axis that does not
    divide ``data`` warns and replicates."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_") or getattr(v, "ndim", 0) == 0:
            out[k] = v
            continue
        rows = split_rows(v.shape[0], mesh, f"batch['{k}']")
        out[k] = v if rows is None else v[rows]
    return out


def tp_placement(net: torch.nn.Module, n_model: int) -> Dict[str, int]:
    """The FeatureExtractor's split axes by parameter name, when both of its
    first two layers divide the ``model`` axis (else a warning and {})."""
    if n_model == 1 or getattr(net, "fe", None) is None or not hasattr(net.fe, "dense1"):
        return {}
    params = dict(net.named_parameters())
    for name, dim in _TP_DIMS.items():
        width = params[name].shape[dim]
        if width % n_model:
            warnings.warn(f"{name} width {width} not divisible by model axis "
                          f"{n_model}; replicating", stacklevel=3)
            return {}
    return dict(_TP_DIMS)


def _narrow(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    return t.detach().chunk(n, dim=dim)[i].clone()


def shard_params(net: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Keep this rank's slice of each tensor-parallel parameter (in place)
    and tell the FeatureExtractor its ``model`` group. Returns the
    placement (parameter -> split axis)."""
    placement = tp_placement(net, mesh.shape["model"])
    params = dict(net.named_parameters())
    n, i = mesh.shape["model"], mesh.coord("model")
    for name, dim in placement.items():
        p = params[name]
        p.data = _narrow(p.data, dim, n, i)
        p.grad = None if p.grad is None else torch.zeros_like(p.data)
    if placement:
        net.fe.tp_group = mesh.group("model")
    return placement


def set_stats_group(net: torch.nn.Module, group) -> None:
    """Tell every BatchNorm of ``net`` the group whose ranks hold a training
    batch's rows between them (None: each rank holds whole batches)."""
    from ..models.layers import BatchNorm

    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = group


def shard_state(exp, mesh: Mesh) -> None:
    """Place an :class:`~med_tpu_torch.train.engine.Experiment` on ``mesh``:
    tensor-parallel FeatureExtractor parameters and their Adam moments
    (:func:`shard_params`); everything else replicated. Its steps then take
    this rank's rows of every batch over ``data``, and its BatchNorms take
    their statistics over the ``data`` group (:func:`set_stats_group`).
    The experiment's step graphs are dropped."""
    exp.graphs.clear()
    placement = shard_params(exp.net, mesh)
    set_stats_group(exp.net, mesh.group("data"))
    params = dict(exp.net.named_parameters())
    n, i = mesh.shape["model"], mesh.coord("model")
    for name, dim in placement.items():
        state = exp.optimizer.state.get(params[name], {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in state:
                state[key] = _narrow(state[key], dim, n, i)
    exp.mesh, exp.tp = mesh, placement


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    moved = t.detach().movedim(dim, 0).contiguous()
    return comm.all_gather(moved, group).movedim(0, dim).contiguous()


@contextlib.contextmanager
def full_view(exp):
    """Inside, a tensor-parallel Experiment holds its whole parameters and
    Adam moments (gathered over ``model``; every rank of the axis must
    enter), so its checkpoint and snapshot are a single rank's; on exit
    each rank takes its slices back. A collective only where it is
    sharded."""
    placement = getattr(exp, "tp", {})
    if not placement:
        yield exp
        return
    group = exp.mesh.group("model")
    params = dict(exp.net.named_parameters())
    saved = {}
    for name, dim in placement.items():
        p = params[name]
        state = exp.optimizer.state.get(p, {})
        saved[name] = (p.data, {k: state[k] for k in ("exp_avg", "exp_avg_sq") if k in state})
        p.data = _gather(p.data, dim, group)
        for k, v in saved[name][1].items():
            state[k] = _gather(v, dim, group)
    try:
        yield exp
    finally:
        for name, (data, moments) in saved.items():
            p = params[name]
            p.data = data
            exp.optimizer.state.get(p, {}).update(moments)


def unshard_state(exp) -> None:
    """Undo :func:`shard_state`'s tensor-parallel split for good (a gather
    over ``model``): the experiment holds its whole parameters and moments
    again; its mesh stays for the data axis. The experiment's step graphs
    are dropped."""
    exp.graphs.clear()
    if not getattr(exp, "tp", None):
        return
    group = exp.mesh.group("model")
    params = dict(exp.net.named_parameters())
    for name, dim in exp.tp.items():
        p = params[name]
        p.data = _gather(p.data, dim, group)
        p.grad = None if p.grad is None else torch.zeros_like(p.data)
        state = exp.optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in state:
                state[key] = _gather(state[key], dim, group)
    exp.net.fe.tp_group = None
    exp.tp = {}
