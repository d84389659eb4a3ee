"""Weight carry-over between the JAX package and the port.

A ``med_tpu`` checkpoint tree (the nested dict of numpy arrays, or the flat
``{"params/model/cot/layer0/W_Q/kernel": array, ...}`` of its ``.npz``)
maps leaf by leaf onto a port module's ``state_dict``. Each parameterised
port module names its flax layout (``flax_layout``, see
:mod:`med_tpu_torch.models.layers`):

    dense      weight (out, in)        <-> kernel (in, out)
    conv       weight (O, I, K)        <-> Conv_0/kernel (K, I, O);  bias <-> Conv_0/bias
    conv2d     weight (O, I, kh, kw)   <-> kernel (kh, kw, I, O)
    norm       weight                  <-> scale
    batchnorm  weight, bias            <-> scale, bias;
               running_mean, running_var (buffers) <-> batch_stats mean, var
    stack      w3, b3, w1, b1          <-> the same, stacked per stage

Module paths are the same on both sides ("model.cot.layer0.W_Q" is
"params/model/cot/layer0/W_Q", "layer1_0.bn1.running_mean" is
"batch_stats/layer1_0/bn1/mean"); frozen tables such as ``gest_embed`` are
buffers on the port side and ``constants`` on the JAX side. Each rule has
a transform into the port's layout and one back.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..train.checkpoint import flatten_tree, unflatten_tree

_Transform = Callable[[np.ndarray], np.ndarray]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _conv1d(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 1, 0)          # its own inverse


# (collection, flax path suffix, flax -> port transform, port -> flax transform)
_Rule = Tuple[str, Tuple[str, ...], _Transform, _Transform]
_BATCHNORM = {"weight": ("params", ("scale",)), "bias": ("params", ("bias",)),
              "running_mean": ("batch_stats", ("mean",)),
              "running_var": ("batch_stats", ("var",))}


def _leaf_rule(layout: str, pname: str) -> _Rule:
    """How parameter (or buffer) ``pname`` of a module maps to flax."""
    if layout == "dense":
        return (("params", ("kernel",), np.transpose, np.transpose) if pname == "weight"
                else ("params", ("bias",), _same, _same))
    if layout == "conv":
        return (("params", ("Conv_0", "kernel"), _conv1d, _conv1d) if pname == "weight"
                else ("params", ("Conv_0", "bias"), _same, _same))
    if layout == "conv2d":
        return ("params", ("kernel",), lambda a: a.transpose(3, 2, 0, 1),
                lambda a: a.transpose(2, 3, 1, 0))
    if layout == "norm":
        return ("params", ("scale",) if pname == "weight" else ("bias",), _same, _same)
    if layout == "batchnorm":
        return (*_BATCHNORM[pname], _same, _same)
    if layout == "stack":
        return "params", (pname,), _same, _same
    raise ValueError(f"unknown flax layout {layout!r}")


def param_table(net: nn.Module) -> Dict[str, Tuple[str, _Transform, _Transform]]:
    """port state_dict key -> (flax '/'-path, flax -> port transform, port ->
    flax transform), for every entry of ``net.state_dict()``; raises if an
    entry has no flax counterpart."""
    table = {}
    for mod_name, module in net.named_modules():
        layout = getattr(module, "flax_layout", None)
        if layout is None:
            continue
        prefix = mod_name.split(".") if mod_name else []
        entries = list(module.named_parameters(recurse=False))
        if layout == "batchnorm":
            entries += list(module.named_buffers(recurse=False))
        for pname, _ in entries:
            collection, suffix, to_port, to_flax = _leaf_rule(layout, pname)
            key = ".".join((*prefix, pname))
            table[key] = ("/".join((collection, *prefix, *suffix)), to_port, to_flax)
    unmapped = set(net.state_dict()) - set(table)
    if unmapped:
        raise ValueError(f"port parameters with no flax layout: {sorted(unmapped)}")
    return table


def _constant_table(net: nn.Module) -> Dict[str, str]:
    """port buffer name -> flax 'constants/...' path, for the frozen tables."""
    return {name: "/".join(("constants", *name.split(".")))
            for name, _ in net.named_buffers() if name.endswith("gest_embed")}


def load_jax_params(tree: Dict, net: nn.Module):
    """``med_tpu`` checkpoint tree -> (state_dict for ``net``, constants).

    ``constants`` maps port buffer names (e.g. "model.gest_embed") to the
    checkpoint's frozen tables; it is empty when the checkpoint has none.
    Raises unless every checkpoint leaf is consumed and every port
    parameter is filled with the right shape."""
    flat = flatten_tree(tree)
    by_flax = {path: (key, to_port) for key, (path, to_port, _) in param_table(net).items()}
    consts = {path: name for name, path in _constant_table(net).items()}
    state, constants, unknown = {}, {}, []
    for path, value in flat.items():
        arr = np.asarray(value, np.float32)
        if path in by_flax:
            key, fn = by_flax[path]
            state[key] = torch.tensor(fn(arr))
        elif path in consts:
            constants[consts[path]] = torch.tensor(arr)
        else:
            unknown.append(path)
    if unknown:
        raise KeyError(f"checkpoint leaves with no port parameter: {sorted(unknown)}")
    expected = net.state_dict()
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port parameters missing from the checkpoint: {missing}")
    for key, value in {**state, **constants}.items():
        want = expected[key].shape if key in expected else net.get_buffer(key).shape
        if value.shape != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                             f"port shape {tuple(want)}")
    return state, constants


def export_jax_params(net: nn.Module, grads: bool = False) -> Dict:
    """The inverse: ``net``'s parameters, running statistics and frozen
    tables as a ``med_tpu`` checkpoint tree {"params": ..., "batch_stats":
    ..., "constants": ...} of numpy arrays (each present when ``net`` has
    such entries). With
    ``grads``, the parameters' gradients instead, as {"params": ...} in the
    same layout (zeros where a parameter has none), to compare leaf by leaf
    with ``jax.grad``."""
    flat = {}
    state = net.state_dict()
    params = dict(net.named_parameters())
    for key, (path, _, to_flax) in param_table(net).items():
        value = state[key]
        if grads:
            if key not in params:       # running statistics get no gradient
                continue
            p = params[key]
            value = p.grad if p.grad is not None else torch.zeros_like(p)
        # a copy: on the CPU .numpy() shares the parameter's memory, which the
        # optimiser's next step overwrites in place
        flat[path] = np.array(to_flax(value.detach().cpu().numpy()), order="C")
    if not grads:
        for name, path in _constant_table(net).items():
            flat[path] = net.get_buffer(name).detach().cpu().numpy().copy()
    return unflatten_tree(flat)
