"""Weight carry-over between the JAX package and the port.

A ``med_tpu`` checkpoint tree (the nested dict of numpy arrays, or the flat
``{"params/model/cot/layer0/W_Q/kernel": array, ...}`` of its ``.npz``)
maps leaf by leaf onto a port module's ``state_dict``. Each parameterised
port module names its flax layout (``flax_layout``, see
:mod:`med_tpu_torch.models.layers`):

    dense  weight (out, in)    <-> kernel (in, out)
    conv   weight (O, I, K)    <-> Conv_0/kernel (K, I, O);  bias <-> Conv_0/bias
    norm   weight              <-> scale
    stack  w3, b3, w1, b1      <-> the same, stacked per stage

Module paths are the same on both sides ("model.cot.layer0.W_Q" is
"params/model/cot/layer0/W_Q"); frozen tables such as ``gest_embed`` are
buffers on the port side and ``constants`` on the JAX side. Each transform
is its own inverse, so one table serves both directions.
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


def _leaf_rule(layout: str, pname: str) -> Tuple[Tuple[str, ...], _Transform]:
    """(flax path suffix, transform) of parameter ``pname`` of a module."""
    if layout == "dense":
        return ((("kernel",), np.transpose) if pname == "weight"
                else (("bias",), _same))
    if layout == "conv":
        return ((("Conv_0", "kernel"), lambda a: a.transpose(2, 1, 0))
                if pname == "weight" else (("Conv_0", "bias"), _same))
    if layout == "norm":
        return (("scale",), _same) if pname == "weight" else (("bias",), _same)
    if layout == "stack":
        return (pname,), _same
    raise ValueError(f"unknown flax layout {layout!r}")


def param_table(net: nn.Module) -> Dict[str, Tuple[str, _Transform]]:
    """port state_dict key -> (flax '/'-path, transform), for every entry of
    ``net.state_dict()``; raises if a parameter has no flax counterpart."""
    table = {}
    for mod_name, module in net.named_modules():
        layout = getattr(module, "flax_layout", None)
        if layout is None:
            continue
        prefix = mod_name.split(".") if mod_name else []
        for pname, _ in module.named_parameters(recurse=False):
            suffix, fn = _leaf_rule(layout, pname)
            key = ".".join((*prefix, pname))
            table[key] = ("/".join(("params", *prefix, *suffix)), fn)
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
    by_flax = {path: (key, fn) for key, (path, fn) in param_table(net).items()}
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


def export_jax_params(net: nn.Module) -> Dict:
    """The inverse: ``net``'s parameters and frozen tables as a ``med_tpu``
    checkpoint tree {"params": ..., "constants": ...} of numpy arrays."""
    flat = {}
    state = net.state_dict()
    for key, (path, fn) in param_table(net).items():
        flat[path] = np.ascontiguousarray(fn(state[key].detach().cpu().numpy()))
    for name, path in _constant_table(net).items():
        flat[path] = net.get_buffer(name).detach().cpu().numpy()
    return unflatten_tree(flat)
