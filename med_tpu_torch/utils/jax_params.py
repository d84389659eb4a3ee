"""Weight carry-over between the JAX package and the port.

A ``med_tpu`` checkpoint tree (the nested dict of numpy arrays, or the flat
``{"params/model/cot/layer0/W_Q/kernel": array, ...}`` of its ``.npz``)
maps leaf by leaf onto a port module's ``state_dict``. Each parameterised
port module names its flax layout (``flax_layout``, see
:mod:`med_tpu_torch.models.layers`):

    dense      weight (out, in)        <-> kernel (in, out)
    conv       weight (O, I, K)        <-> Conv_0/kernel (K, I, O);  bias <-> Conv_0/bias
    conv1d     weight (O, I, K)        <-> kernel (K, I, O);  bias <-> bias
    conv2d     weight (O, I, kh, kw)   <-> kernel (kh, kw, I, O)
    norm       weight                  <-> scale
    batchnorm  weight, bias            <-> scale, bias;
               running_mean, running_var (buffers) <-> batch_stats mean, var
    stack      w3, b3, w1, b1          <-> the same, stacked per stage
    lstm       w_ih (4H, I), w_hh (4H, H), b (4H), gates i, f, g, o
               <-> cell/{ii,if,ig,io}/kernel (I, H), cell/{hi,hf,hg,ho}/kernel
               (H, H) and cell/{hi,hf,hg,ho}/bias (flax's OptimizedLSTMCell:
               one bias a gate, on the recurrent side)

Module paths are the same on both sides ("model.cot.layer0.W_Q" is
"params/model/cot/layer0/W_Q", "layer1_0.bn1.running_mean" is
"batch_stats/layer1_0/bn1/mean"); frozen tables (COG's ``gest_embed`` and
SRM's ``skill_embed``) are buffers on the port side and ``constants`` on
the JAX side. Each rule has a transform into the port's layout and one
back; an LSTM rule joins four flax leaves into one port parameter.
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
_GATES = "ifgo"
_LSTM = {"w_ih": ("i", "kernel"), "w_hh": ("h", "kernel"), "b": ("h", "bias")}


def _leaf_rule(layout: str, pname: str) -> _Rule:
    """How parameter (or buffer) ``pname`` of a module maps to flax."""
    if layout == "dense":
        return (("params", ("kernel",), np.transpose, np.transpose) if pname == "weight"
                else ("params", ("bias",), _same, _same))
    if layout == "conv":
        return (("params", ("Conv_0", "kernel"), _conv1d, _conv1d) if pname == "weight"
                else ("params", ("Conv_0", "bias"), _same, _same))
    if layout == "conv1d":
        return (("params", ("kernel",), _conv1d, _conv1d) if pname == "weight"
                else ("params", ("bias",), _same, _same))
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


def _lstm_rules(prefix, pname: str):
    """The four (flax path, to port, to flax) leaves of LSTM parameter
    ``pname``: one a gate, each transposed for a kernel; the port's block
    of gate k is rows k*H:(k+1)*H."""
    side, leaf = _LSTM[pname]
    fn = np.transpose if leaf == "kernel" else _same
    return [("/".join(("params", *prefix, "cell", side + g, leaf)), fn, fn)
            for g in _GATES]


def param_table(net: nn.Module) -> Dict[str, list]:
    """port state_dict key -> its flax leaves, each (flax '/'-path, flax ->
    port transform, port -> flax transform), for every entry of
    ``net.state_dict()``: one leaf, or an LSTM parameter's four gates
    (stacked on axis 0 in the port); raises if an entry has no flax
    counterpart."""
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
            key = ".".join((*prefix, pname))
            if layout == "lstm":
                table[key] = _lstm_rules(prefix, pname)
                continue
            collection, suffix, to_port, to_flax = _leaf_rule(layout, pname)
            table[key] = [("/".join((collection, *prefix, *suffix)), to_port, to_flax)]
    unmapped = set(net.state_dict()) - set(table)
    if unmapped:
        raise ValueError(f"port parameters with no flax layout: {sorted(unmapped)}")
    return table


def _constant_table(net: nn.Module) -> Dict[str, str]:
    """port buffer name -> flax 'constants/...' path, for the frozen tables."""
    return {name: "/".join(("constants", *name.split(".")))
            for name, _ in net.named_buffers()
            if name.endswith(("gest_embed", "skill_embed"))}


def load_jax_params(tree: Dict, net: nn.Module):
    """``med_tpu`` checkpoint tree -> (state_dict for ``net``, constants).

    ``constants`` maps port buffer names (e.g. "model.gest_embed") to the
    checkpoint's frozen tables; it is empty when the checkpoint has none.
    Raises unless every checkpoint leaf is consumed and every port
    parameter is filled with the right shape."""
    flat = flatten_tree(tree)
    table = param_table(net)
    by_flax = {path: key for key, leaves in table.items() for path, _, _ in leaves}
    consts = {path: name for name, path in _constant_table(net).items()}
    parts, constants, unknown = {}, {}, []
    for path, value in flat.items():
        arr = np.asarray(value, np.float32)
        if path in by_flax:
            parts[path] = arr
        elif path in consts:
            constants[consts[path]] = torch.tensor(arr)
        else:
            unknown.append(path)
    if unknown:
        raise KeyError(f"checkpoint leaves with no port parameter: {sorted(unknown)}")
    expected = net.state_dict()
    missing = sorted(key for key, leaves in table.items()
                     if any(path not in parts for path, _, _ in leaves))
    if missing:
        raise KeyError(f"port parameters missing from the checkpoint: {missing}")
    state = {}
    for key, leaves in table.items():
        arrays = [fn(parts[path]) for path, fn, _ in leaves]
        state[key] = torch.tensor(arrays[0] if len(arrays) == 1
                                  else np.concatenate(arrays, axis=0))
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
    for key, leaves in param_table(net).items():
        value = state[key]
        if grads:
            if key not in params:       # running statistics get no gradient
                continue
            p = params[key]
            value = p.grad if p.grad is not None else torch.zeros_like(p)
        value = value.detach().cpu().numpy()
        blocks = np.split(value, len(leaves), axis=0) if len(leaves) > 1 else [value]
        for (path, _, to_flax), block in zip(leaves, blocks):
            # a copy: on the CPU .numpy() shares the parameter's memory, which
            # the optimiser's next step overwrites in place
            flat[path] = np.array(to_flax(block), order="C")
    if not grads:
        for name, path in _constant_table(net).items():
            flat[path] = net.get_buffer(name).detach().cpu().numpy().copy()
    return unflatten_tree(flat)


# ---------------------------------------------------- int8 quantized trees
_QCONV = ("wq", "wscale", "bias")
_QFE_LAYER = ("wq", "wscale", "bias", "in_scale")


def _quant_leaf(path: str, value) -> torch.Tensor:
    """One leaf of a ``med_tpu`` quantized tree in the port's layout: an int8
    weight with its input and output axes turned so that each output
    channel's K values are contiguous (HWIO -> OHWI, (I, O) -> (O, I)),
    float32 scales and biases, and each activation scale a 0-d tensor."""
    a = np.asarray(value)
    if path.endswith("/wq"):
        if a.dtype != np.int8:
            raise ValueError(f"{path}: int8 weights expected, got {a.dtype}")
        a = np.transpose(a, (3, 0, 1, 2)) if a.ndim == 4 else a.T
    else:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _take(flat: Dict[str, np.ndarray], path: str):
    if path not in flat:
        raise KeyError(f"quantized tree has no leaf {path}")
    return _quant_leaf(path, flat.pop(path))


def _leftover(flat: Dict[str, np.ndarray]) -> None:
    if flat:
        raise KeyError(f"quantized tree leaves with no port counterpart: {sorted(flat)}")


def load_jax_quant_trunk(tree: Dict, stage_sizes=(3, 4, 6, 3)) -> Dict:
    """``med_tpu.ops.quant.quantize_resnet50_trunk``'s tree (numpy leaves) ->
    the port's quantized trunk (tensors on the CPU) for
    ``ops.quant.resnet50_int8_apply``; raises unless every leaf is consumed
    and every leaf of the ``stage_sizes`` geometry is there."""
    from ..ops.quant import block_geometry

    flat = flatten_tree(tree)
    out = {"in_scale": _take(flat, "in_scale"),
           "conv1": {k: _take(flat, f"conv1/{k}") for k in (*_QCONV, "out_scale")}}
    for name, _, has_down in block_geometry(stage_sizes):
        convs = ("c1", "c2", "c3", "down") if has_down else ("c1", "c2", "c3")
        blk = {c: {k: _take(flat, f"{name}/{c}/{k}") for k in _QCONV} for c in convs}
        blk.update({k: _take(flat, f"{name}/{k}") for k in ("a1", "a2", "out")})
        out[name] = blk
    _leftover(flat)
    return out


def load_jax_quant_fe(tree: Dict) -> Dict:
    """``med_tpu.ops.quant.quantize_fe``'s {"layers": [...]} (numpy leaves) ->
    the port's quantized FeatureExtractor for ``ops.quant.fe_int8_apply``;
    raises unless each layer has exactly its four leaves."""
    if set(tree) != {"layers"}:
        raise KeyError(f"a quantized FE tree holds 'layers' alone; got {sorted(tree)}")
    layers = []
    for i, layer in enumerate(tree["layers"]):
        flat = {f"layers/{i}/{k}": v for k, v in layer.items()}
        layers.append({k: _take(flat, f"layers/{i}/{k}") for k in _QFE_LAYER})
        _leftover(flat)
    return {"layers": layers}
