"""Dilated residual TCN stacks (PyTorch port of ``med_tpu.ops.tcn_fused``).

A TCN stage is ``num_layers`` dilated residual layers at C channels,

    h_{i+1} = h_i + mask_i * scale * (W1 · relu(dconv3_{2^i}(h_i) + b3) + b1)

with the mask only in training; ``scale`` is the dropout's keep scale
1 / (1 - rate), 2.0 (rate 0.5) unless a caller passes another. Shapes:  x (T, C);  w3 (L, 3, C, C)
[tap, in, out];  b3 (L, C);  w1 (L, C, C) [in, out];  b1 (L, C);  mask
(L, T, C) uint8 or None. Layer i of a stage uses dilation 2**i.

On a CUDA tensor every layer of a call's stacks runs in one persistent
launch of the hand-written kernel ``csrc/tcn_stack_fwd.cu`` (a grid barrier
between layers; one launch for every 16 stacks); on a CPU tensor the plain
version :func:`dilated_stack_xla` runs. Where autograd needs a gradient, the
forward also saves every layer's input h and post-relu y (the TPU kernels'
``save=True`` residuals) and the backward walks the layers in reverse: on
the card in one persistent launch of ``csrc/tcn_stack_bwd.cu`` (one grid
barrier a layer, the weight gradients after the last layer in the same
launch; one launch for every 16 stacks), on the CPU the plain loop
:func:`_layer_bwd_plain`.

:func:`dilated_residual_multistack` is the same sequence of stacks with the
weights of all stacks concatenated on the layer axis (w3 (Lt, 3, C, C), ...,
mask (Lt, T, C)): on the card the same two kernels find each stage's slices
by offset, so nothing is split or joined on the host.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import cuda_build

StageWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _shifts(d: int, causal: bool):
    """Per-tap input delays: out[t] = sum_j x[t - s_j] @ W_j (causal: left
    pad 2d; acausal: symmetric pad d)."""
    return (2 * d, d, 0) if causal else (d, 0, -d)


def _shift_rows(h: torch.Tensor, s: int) -> torch.Tensor:
    """Row t of the result is h[t - s], zero outside [0, T)."""
    T = h.shape[0]
    out = torch.zeros_like(h)
    if abs(s) < T:
        if s >= 0:
            out[s:] = h[:T - s]
        else:
            out[:T + s] = h[-s:]
    return out


def dilated_stack_xla(x, w3, b3, w1, b1, *, causal: bool = True, mask=None,
                      saved: Optional[List] = None, scale: float = 2.0):
    """Plain PyTorch version of a stack, one layer at a time (named after the
    JAX oracle it ports). ``saved``, when given, collects each layer's
    (input h, post-relu y); ``scale`` multiplies a kept element."""
    h = x.to(torch.float32)
    for i in range(w3.shape[0]):
        acc = b3[i][None, :]
        for j, s in enumerate(_shifts(2 ** i, causal)):
            acc = acc + _shift_rows(h, s) @ w3[i, j]
        y = torch.relu(acc)
        if saved is not None:
            saved.append((h, y))
        z = y @ w1[i] + b1[i][None, :]
        if mask is not None:
            z = z * (mask[i].to(torch.float32) * scale)
        h = h + z
    return h


def _layer_bwd_plain(dh, h, y, w3, w1, mask, d: int, causal: bool, scale: float = 2.0):
    """One layer's backward, the TPU kernel's arithmetic (tcn_fused.py
    _bwd_kernel): returns (dh at the layer input, dw3, db3, dw1, db1)."""
    dz = dh * (mask.to(torch.float32) * scale) if mask is not None else dh
    dw1 = y.T @ dz
    db1 = dz.sum(0)
    da = torch.where(y > 0.0, dz @ w1.T, torch.zeros_like(dz))
    db3 = da.sum(0)
    shifts = _shifts(d, causal)
    dw3 = torch.stack([_shift_rows(h, s).T @ da for s in shifts])
    for j, s in enumerate(shifts):
        dh = dh + _shift_rows(da, -s) @ w3[j].T
    return dh, dw3, db3, dw1, db1


def _stages_bwd_plain(g, h_saved, y_saved, stage_weights, masks, causal: bool,
                      scale: float = 2.0):
    """Plain backward of stages run back to back: g (S, T, C) cotangents of
    the stage outputs, entering at each stage's last layer; stage_weights
    per stage (w3, w1)."""
    dh = torch.zeros_like(g[0])
    l = h_saved.shape[0]
    dws = [None] * len(stage_weights)
    for s in reversed(range(len(stage_weights))):
        w3, w1 = stage_weights[s]
        dh = dh + g[s]
        per_layer = []
        for i in reversed(range(w3.shape[0])):
            l -= 1
            dh, *dw = _layer_bwd_plain(dh, h_saved[l], y_saved[l], w3[i], w1[i],
                                       None if masks is None else masks[s][i],
                                       2 ** i, causal, scale)
            per_layer.append(dw)
        dws[s] = tuple(torch.stack(t[::-1]) for t in zip(*per_layer))
    return dh, dws


MAX_LAYERS = 30      # layers of a stack: the widest tap, 2 * 2**29, is an int


def _check_operand(name: str, t, dev, dtype) -> None:
    """check_operand, and the alignment the kernels' accesses need: 16 bytes
    for float operands (cp.async and float4), 4 for a uint8 mask (read 4
    bytes at a time), an element for the rest."""
    cuda_build.check_operand(name, t, dev, dtype)
    nbytes = {torch.float32: 16, torch.uint8: 4}.get(dtype, t.element_size())
    cuda_build.check_alignment(name, t, nbytes)


def _check_stages(x_shape, stage_weights, masks, dev,
                  names=("w3", "b3", "w1", "b1")) -> None:
    """Raise unless each stage's tensors (named ``names``) and mask have the
    kernels' types and shapes."""
    T, C = x_shape
    if C not in (8, 16, 32, 64):
        raise ValueError(f"the CUDA kernel takes 8, 16, 32 or 64 channels; got {C}")
    for s, w in enumerate(stage_weights):
        L = w[0].shape[0]
        shapes = {"w3": (L, 3, C, C), "b3": (L, C), "w1": (L, C, C), "b1": (L, C)}
        for name, t in zip(names, w):
            shape = shapes[name]
            _check_operand(f"stage {s} {name}", t, dev, torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"stage {s} {name} has shape {tuple(t.shape)}, "
                                 f"expected {shape}")
        if masks is not None:
            _check_operand(f"stage {s} mask", masks[s], dev, torch.uint8)
            if tuple(masks[s].shape) != (L, T, C):
                raise ValueError(f"stage {s} mask has shape "
                                 f"{tuple(masks[s].shape)}, expected {(L, T, C)}")


def _check_fwd_counts(T: int, layers: Sequence[int]) -> None:
    """Raise unless the forward kernel takes T rows and stacks of these
    layer counts."""
    if T < 1:
        raise ValueError(f"the CUDA kernel takes at least one row; got T={T}")
    if not all(1 <= n <= MAX_LAYERS for n in layers):
        raise ValueError(f"the CUDA kernel takes stacks of 1 to {MAX_LAYERS} layers; "
                         f"got {list(layers)}")


def _fwd_buffers(T: int, C: int, S: int, Lt: int, dev, save: bool):
    """The forward's outputs (S, T, C), its (2, T, C) ping-pong scratch
    (a layer never writes the buffer it reads: neighbouring blocks read its
    rows) and, with ``save``, the (Lt, T, C) saved h and y."""
    f32 = dict(dtype=torch.float32, device=dev)
    saved = [torch.empty((Lt, T, C), **f32) for _ in range(2)] if save else [None, None]
    return torch.empty((S, T, C), **f32), torch.empty((2, T, C), **f32), *saved


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


_FWD, _BWD = "tcn_stack_fwd", "tcn_stack_bwd"
_STAGES_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.POINTER(ctypes.c_int)] * 3 \
    + [ctypes.c_void_p]


def _launch(lib: str, entry: str, argtypes, counter, *args) -> None:
    """Call the C entry ``entry`` of kernel library ``lib`` with ``args``
    and then its launch count, grid and tile-height out-parameters and the
    current stream; raise ``counter.launches`` by the launches the runtime
    accepted and set ``counter.last_launch`` to the (blocks, rows a tile)
    they ran with."""
    launched, blocks, rows = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    fn = cuda_build.kernel_function(lib, entry, argtypes)
    code = fn(*args, ctypes.byref(launched), ctypes.byref(blocks), ctypes.byref(rows),
              torch.cuda.current_stream().cuda_stream)
    counter.launches += launched.value
    cuda_build.check_launch(lib, lib, code)
    counter.last_launch = (blocks.value, rows.value)


def _stages_cuda(x, stage_weights: Sequence[StageWeights], masks, causal: bool,
                 counter, save: bool = False, scale: float = 2.0):
    """Run the stages back to back, one launch for every 16; returns the (S, T, C) stage
    outputs, and with ``save`` also the (Lt, T, C) layer inputs h and
    post-relu activations y. ``counter`` is the public wrapper whose launch
    count the launch raises; ``scale`` multiplies a kept element."""
    T, C = x.shape
    dev = x.device
    _check_operand("x", x, dev, torch.float32)
    _check_stages(x.shape, stage_weights, masks, dev)
    Ls = [w[0].shape[0] for w in stage_weights]
    _check_fwd_counts(T, Ls)
    S = len(Ls)
    hs, scratch, h_saved, y_saved = _fwd_buffers(T, C, S, sum(Ls), dev, save)
    w3s, b3s, w1s, b1s = (_pointers([w[k] for w in stage_weights]) for k in range(4))
    mks = None if masks is None else _pointers(masks)
    layers = (ctypes.c_int * S)(*Ls)
    with torch.cuda.device(dev):
        _launch(_FWD, "tcn_stages_fwd", _STAGES_ARGTYPES, counter, x.data_ptr(),
                ctypes.addressof(w3s), ctypes.addressof(b3s), ctypes.addressof(w1s),
                ctypes.addressof(b1s), None if mks is None else ctypes.addressof(mks),
                ctypes.addressof(layers), S, hs.data_ptr(), _ptr(h_saved),
                _ptr(y_saved), scratch.data_ptr(), T, C, int(causal), scale)
    return (hs, h_saved, y_saved) if save else hs


def _barriers(lib: str, symbol: str, launch: Tuple[int, int], C: int, n: int,
              device) -> None:
    fn = cuda_build.kernel_function(lib, symbol, [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(device):
        code = fn(*launch, C, n, torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, lib, code)


def forward_barriers(launch: Tuple[int, int], C: int, n: int, device=None) -> None:
    """Launch the grid of a forward launch, ``launch`` = (blocks, rows a
    tile) as a wrapper's ``last_launch`` gives it, at C channels, running
    ``n`` grid barriers and nothing else: the floor of the one-launch
    design, for measurement. Counts no launch."""
    _barriers(_FWD, "tcn_stack_barriers", launch, C, n, device)


def backward_barriers(launch: Tuple[int, int], C: int, n: int, device=None) -> None:
    """:func:`forward_barriers` for a backward launch's grid (the backward's
    instances have their own shared memory, so their own occupancy)."""
    _barriers(_BWD, "tcn_stack_bwd_barriers", launch, C, n, device)


def _wgrad_chunks(T: int) -> int:
    """The backward's weight-gradient chunks over T rows, as the kernel
    counts them: P > 1 needs the (Lt, P, 4C^2 + 2C) partial buffer."""
    return cuda_build.kernel_function(_BWD, "tcn_stack_bwd_chunks", [ctypes.c_int])(T)


def backward_barrier_count(layers: int, T: int) -> int:
    """Grid barriers one backward launch over ``layers`` layers and T rows
    makes: one after each layer's dz and da are written, and one before the
    weight-gradient partials are summed when there is more than one chunk."""
    return layers + (1 if _wgrad_chunks(T) > 1 else 0)


_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 9 \
    + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.POINTER(ctypes.c_int)] * 3 \
    + [ctypes.c_void_p]


def _pointers(tensors):
    """A ctypes array of the tensors' device addresses (kept alive by the
    caller for the duration of the call)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _bwd_buffers(T: int, C: int, Lt: int, dev):
    """The backward's dx (T, C); its per-layer dz and da slots (Lt, T, C);
    the weight-gradient partials (Lt, P, 4C^2 + 2C), or None when T fits
    one chunk; and the gradients dw3, db3, dw1, db1."""
    f32 = dict(dtype=torch.float32, device=dev)
    P = _wgrad_chunks(T)
    partial = torch.empty((Lt, P, 4 * C * C + 2 * C), **f32) if P > 1 else None
    return (torch.empty((T, C), **f32), torch.empty((Lt, T, C), **f32),
            torch.empty((Lt, T, C), **f32), partial, torch.empty((Lt, 3, C, C), **f32),
            torch.empty((Lt, C), **f32), torch.empty((Lt, C, C), **f32),
            torch.empty((Lt, C), **f32))


def _stages_bwd_cuda(g, h_saved, y_saved, stage_weights, masks, causal: bool,
                     counter, marks=None, scale: float = 2.0):
    """Backward of :func:`_stages_cuda` on the card: every layer and the
    weight gradients in one launch of ``tcn_stack_bwd.cu`` for every 16
    stages. ``stage_weights`` holds each stage's (w3, w1). ``marks``, for
    measurement, is None or a (4,) int64 tensor on the card that receives
    the device clock (ns) at the launch's start, the chain's end, the
    weight-gradient items' end and the launch's end, as block 0 sees them.
    Returns (dx, per stage (dw3, db3, dw1, db1))."""
    S, T, C = g.shape
    dev = g.device
    Ls = [w[0].shape[0] for w in stage_weights]
    Lt = sum(Ls)
    for name, t, shape in (("g", g, (len(stage_weights), T, C)),
                           ("h_saved", h_saved, (Lt, T, C)),
                           ("y_saved", y_saved, (Lt, T, C))):
        _check_operand(name, t, dev, torch.float32)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _check_stages((T, C), stage_weights, masks, dev, names=("w3", "w1"))
    _check_fwd_counts(T, Ls)
    if marks is not None:
        _check_operand("marks", marks, dev, torch.int64)
        if marks.numel() != 4:
            raise ValueError(f"marks holds {marks.numel()} words, expected 4")
    dx, dz, da, partial, dw3, db3, dw1, db1 = _bwd_buffers(T, C, Lt, dev)
    w3s = _pointers([w[0] for w in stage_weights])
    w1s = _pointers([w[1] for w in stage_weights])
    mks = None if masks is None else _pointers(masks)
    layers = (ctypes.c_int * S)(*Ls)
    with torch.cuda.device(dev):
        _launch(_BWD, "tcn_stages_bwd", _BWD_ARGTYPES, counter, g.data_ptr(),
                h_saved.data_ptr(), y_saved.data_ptr(), ctypes.addressof(w3s),
                ctypes.addressof(w1s), None if mks is None else ctypes.addressof(mks),
                ctypes.addressof(layers), S, dx.data_ptr(), dz.data_ptr(), da.data_ptr(),
                _ptr(partial), dw3.data_ptr(), db3.data_ptr(), dw1.data_ptr(),
                db1.data_ptr(), _ptr(marks), T, C, int(causal), scale)
    dws, a = [], 0
    for L in Ls:
        dws.append((dw3[a:a + L], db3[a:a + L], dw1[a:a + L], db1[a:a + L]))
        a += L
    return dx, dws


def _stages_fwd(x, stage_weights, masks, causal: bool, counter, save: bool,
                scale: float = 2.0):
    """(S, T, C) stage outputs, and with ``save`` the (Lt, T, C) saved h, y."""
    if x.is_cuda:
        return _stages_cuda(x, stage_weights, masks, causal, counter, save, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no TCN stack for device {x.device}")
    outs, saved, h = [], [] if save else None, x
    for s, (w3, b3, w1, b1) in enumerate(stage_weights):
        h = dilated_stack_xla(h, w3, b3, w1, b1, causal=causal,
                              mask=None if masks is None else masks[s],
                              saved=saved, scale=scale)
        outs.append(h)
    if save:
        return (torch.stack(outs), torch.stack([p[0] for p in saved]),
                torch.stack([p[1] for p in saved]))
    return torch.stack(outs)


def _stages_bwd(g, h_saved, y_saved, stage_weights, masks, causal: bool, counter,
                scale: float = 2.0):
    if g.is_cuda:
        return _stages_bwd_cuda(g, h_saved, y_saved, stage_weights, masks,
                                causal, counter, scale=scale)
    if g.device.type != "cpu":
        raise ValueError(f"no TCN stack backward for device {g.device}")
    return _stages_bwd_plain(g, h_saved, y_saved, stage_weights, masks, causal, scale)


class _Stages(torch.autograd.Function):
    """Stages back to back with a saving forward and the layer-reverse
    backward (med_tpu's _fused_multis_train / _fused_train custom VJPs).
    ``tensors`` holds the 4 weights of each stage, then one mask per stage
    when there are masks; the masks get no gradient."""

    @staticmethod
    def forward(ctx, x, spec, *tensors):
        n_stages, causal, fwd_counter, bwd_counter, scale = spec
        ws = [tuple(tensors[4 * s:4 * s + 4]) for s in range(n_stages)]
        masks = list(tensors[4 * n_stages:]) or None
        hs, h_saved, y_saved = _stages_fwd(x, ws, masks, causal, fwd_counter,
                                           save=True, scale=scale)
        ctx.spec = spec
        ctx.save_for_backward(h_saved, y_saved, *tensors)
        return hs

    @staticmethod
    def backward(ctx, g):
        n_stages, causal, _, bwd_counter, scale = ctx.spec
        h_saved, y_saved, *tensors = ctx.saved_tensors
        ws = [(tensors[4 * s], tensors[4 * s + 2]) for s in range(n_stages)]
        masks = list(tensors[4 * n_stages:]) or None
        dx, dws = _stages_bwd(g.contiguous(), h_saved, y_saved, ws, masks,
                              causal, bwd_counter, scale)
        n_masks = len(tensors) - 4 * n_stages
        return (dx, None, *[d for dw in dws for d in dw], *([None] * n_masks))


def _run_stages(x, stage_weights, masks, causal: bool, fwd_counter, bwd_counter,
                scale: float):
    """The saving autograd path when a gradient is needed, else the plain
    forward (serving saves nothing)."""
    flat = [t for w in stage_weights for t in w]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, *flat]):
        spec = (len(stage_weights), causal, fwd_counter, bwd_counter, scale)
        return _Stages.apply(x, spec, *flat, *(masks or []))
    return _stages_fwd(x, stage_weights, masks, causal, fwd_counter, save=False,
                       scale=scale)


def dilated_residual_stack(x, w3, b3, w1, b1, *, causal: bool = True,
                           mask=None, scale: float = 2.0) -> torch.Tensor:
    """One stack, (T, C) -> (T, C); ``scale`` multiplies an element that
    ``mask`` keeps (1 / (1 - dropout rate)). A CUDA tensor runs the CUDA
    kernel, one launch, whose (blocks, rows a tile) ``.last_launch`` keeps
    (replacing med_tpu/ops/tcn_fused.py::_fwd_kernel); a CPU tensor the
    plain version; any other device raises. Differentiable through
    :func:`dilated_residual_stack_bwd`."""
    return _run_stages(x, [(w3, b3, w1, b1)], None if mask is None else [mask],
                       causal, dilated_residual_stack, dilated_residual_stack_bwd,
                       scale)[0]


dilated_residual_stack.launches = 0
dilated_residual_stack.last_launch = None


def dilated_residual_stack_bwd(g, h_saved, y_saved, w3, w1, *, causal: bool = True,
                               mask=None, scale: float = 2.0):
    """Backward of one stack from its saved layer inputs and post-relu
    activations (L, T, C) and the output cotangent g (T, C) -> (dx, dw3,
    db3, dw1, db1), as med_tpu's ``_bwd_call``. A CUDA tensor runs the CUDA
    kernel, one launch, whose (blocks, rows a tile) ``.last_launch`` keeps
    (replacing med_tpu/ops/tcn_fused.py::_bwd_kernel); a CPU tensor the
    plain loop."""
    dx, dws = _stages_bwd(g[None].contiguous(), h_saved, y_saved, [(w3, w1)],
                          None if mask is None else [mask], causal,
                          dilated_residual_stack_bwd, scale)
    return (dx, *dws[0])


dilated_residual_stack_bwd.launches = 0
dilated_residual_stack_bwd.last_launch = None


def _check_layer_counts(stage_weights, L0: int, Lr: int) -> None:
    layers = [w[0].shape[0] for w in stage_weights]
    if layers[0] != L0 or any(n != Lr for n in layers[1:]):
        raise ValueError(f"stage layer counts {layers} do not match "
                         f"L0={L0}, Lr={Lr}")


def dilated_residual_multistack_stages(x, stage_weights: Sequence[StageWeights],
                                       L0: int, Lr: int, *, causal: bool = True,
                                       masks: Optional[Sequence] = None,
                                       scale: float = 2.0) -> torch.Tensor:
    """Stacks of L0, Lr, Lr, ... layers back to back, (T, C) -> the (S, T, C)
    stage outputs. ``stage_weights`` is a sequence of per-stage
    (w3, b3, w1, b1); ``masks`` a matching sequence of (L_s, T, C) uint8
    keep-masks, or None; ``scale`` multiplies a kept element. A CUDA tensor
    runs the CUDA kernel, one launch for every 16 stacks, whose (blocks,
    rows a tile) ``.last_launch`` keeps (replacing
    med_tpu/ops/tcn_fused.py::_multi_fwd_kernel_s); a CPU
    tensor the plain version; any other device raises. Differentiable
    through :func:`dilated_residual_multistack_stages_bwd`."""
    _check_layer_counts(stage_weights, L0, Lr)
    return _run_stages(x, stage_weights, masks, causal,
                       dilated_residual_multistack_stages,
                       dilated_residual_multistack_stages_bwd, scale)


dilated_residual_multistack_stages.launches = 0
dilated_residual_multistack_stages.last_launch = None


def dilated_residual_multistack_stages_bwd(g, h_saved, y_saved, stage_weights,
                                           L0: int, Lr: int, *,
                                           causal: bool = True, masks=None,
                                           scale: float = 2.0):
    """Backward of :func:`dilated_residual_multistack_stages` from the saved
    (Lt, T, C) layer inputs and post-relu activations and the (S, T, C)
    stage-output cotangents, g[s] entering at stage s's last layer -> (dx,
    per stage (dw3, db3, dw1, db1)), as med_tpu's ``_multi_bwd_call_s``. A
    CUDA tensor runs the CUDA kernel, one launch for every 16 stacks, whose
    (blocks, rows a tile) ``.last_launch`` keeps (replacing
    med_tpu/ops/tcn_fused.py::_multi_bwd_kernel_s); a CPU tensor the plain
    loop."""
    _check_layer_counts(stage_weights, L0, Lr)
    return _stages_bwd(g.contiguous(), h_saved, y_saved,
                       [(w[0], w[2]) for w in stage_weights], masks, causal,
                       dilated_residual_multistack_stages_bwd, scale)


dilated_residual_multistack_stages_bwd.launches = 0
dilated_residual_multistack_stages_bwd.last_launch = None


# --- operands concatenated on the layer axis -----------------------------

def _stage_lengths(Lt: int, L0: int, Lr: int) -> List[int]:
    """Layer counts (L0, Lr, Lr, ...) of the stages that Lt layers make."""
    if Lt == L0:
        return [L0]
    if L0 < 1 or Lr < 1 or Lt < L0 or (Lt - L0) % Lr:
        raise ValueError(f"{Lt} layers are not stacks of L0={L0}, Lr={Lr}, "
                         f"Lr, ... layers")
    return [L0] + [Lr] * ((Lt - L0) // Lr)


def _split(t, lengths):
    return None if t is None else torch.split(t, lengths)


def dilated_residual_multistack_plain(x, w3, b3, w1, b1, L0: int, Lr: int, *,
                                      causal: bool = True, mask=None,
                                      save: bool = False, scale: float = 2.0):
    """Plain PyTorch version of :func:`dilated_residual_multistack`, stage by
    stage through :func:`dilated_stack_xla` -> the (S, T, C) stage outputs,
    and with ``save`` also the (Lt, T, C) layer inputs h and post-relu y."""
    lengths = _stage_lengths(w3.shape[0], L0, Lr)
    masks = _split(mask, lengths)
    ws = list(zip(*(_split(t, lengths) for t in (w3, b3, w1, b1))))
    outs, saved, h = [], [] if save else None, x
    for s, (sw3, sb3, sw1, sb1) in enumerate(ws):
        h = dilated_stack_xla(h, sw3, sb3, sw1, sb1, causal=causal,
                              mask=None if masks is None else masks[s],
                              saved=saved, scale=scale)
        outs.append(h)
    if save:
        return (torch.stack(outs), torch.stack([p[0] for p in saved]),
                torch.stack([p[1] for p in saved]))
    return torch.stack(outs)


def dilated_residual_multistack_bwd_plain(g, h_saved, y_saved, w3, w1, L0: int,
                                          Lr: int, *, causal: bool = True,
                                          mask=None, scale: float = 2.0):
    """Plain PyTorch version of :func:`dilated_residual_multistack_bwd`,
    layer by layer through :func:`_layer_bwd_plain`."""
    lengths = _stage_lengths(w3.shape[0], L0, Lr)
    dx, dws = _stages_bwd_plain(g, h_saved, y_saved,
                                list(zip(_split(w3, lengths), _split(w1, lengths))),
                                _split(mask, lengths), causal, scale)
    return (dx, *(torch.cat(t) for t in zip(*dws)))


def _check_multistack(T: int, C: int, dev, named, mask) -> int:
    """Raise unless the concatenated operands (name -> tensor) and the mask
    have the kernels' types and shapes; returns Lt."""
    if C not in (8, 16, 32, 64):
        raise ValueError(f"the CUDA kernel takes 8, 16, 32 or 64 channels; got {C}")
    Lt = named["w3"].shape[0]
    shapes = {"x": (T, C), "w3": (Lt, 3, C, C), "b3": (Lt, C), "w1": (Lt, C, C),
              "b1": (Lt, C), "h_saved": (Lt, T, C), "y_saved": (Lt, T, C)}
    for name, t in named.items():
        _check_operand(name, t, dev, torch.float32)
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if mask is not None:
        _check_operand("mask", mask, dev, torch.uint8)
        if tuple(mask.shape) != (Lt, T, C):
            raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                             f"{(Lt, T, C)}")
    return Lt


_MULTI_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p]
_MULTI_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p]


def _multistack_fwd_cuda(x, w3, b3, w1, b1, mask, L0: int, Lr: int, causal: bool,
                         save: bool, scale: float):
    T, C = x.shape
    dev = x.device
    Lt = _check_multistack(T, C, dev, dict(x=x, w3=w3, b3=b3, w1=w1, b1=b1), mask)
    lengths = _stage_lengths(Lt, L0, Lr)
    _check_fwd_counts(T, lengths)
    hs, scratch, h_saved, y_saved = _fwd_buffers(T, C, len(lengths), Lt, dev, save)
    with torch.cuda.device(dev):
        _launch(_FWD, "tcn_multistack_fwd", _MULTI_ARGTYPES, dilated_residual_multistack,
                x.data_ptr(), w3.data_ptr(), b3.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), _ptr(mask), hs.data_ptr(), _ptr(h_saved),
                _ptr(y_saved), scratch.data_ptr(), T, C, Lt, L0, max(Lr, 1),
                int(causal), scale)
    return (hs, h_saved, y_saved) if save else hs


def _multistack_fwd(x, w3, b3, w1, b1, mask, L0, Lr, causal, save, scale: float = 2.0):
    if x.is_cuda:
        return _multistack_fwd_cuda(x, w3, b3, w1, b1, mask, L0, Lr, causal, save, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no TCN multistack for device {x.device}")
    return dilated_residual_multistack_plain(x, w3, b3, w1, b1, L0, Lr, causal=causal,
                                             mask=mask, save=save, scale=scale)


def dilated_residual_multistack_bwd(g, h_saved, y_saved, w3, w1, L0: int,
                                    Lr: int, *, causal: bool = True, mask=None,
                                    scale: float = 2.0):
    """Backward of :func:`dilated_residual_multistack` from the saved
    (Lt, T, C) layer inputs and post-relu activations and the (S, T, C)
    stage-output cotangents, g[s] entering at stage s's last layer -> (dx,
    dw3, db3, dw1, db1) in the concatenated layout, as med_tpu's
    ``_multi_bwd_call``. A CUDA tensor runs the CUDA kernel, one launch for
    every 16 stacks, whose (blocks, rows a tile) ``.last_launch`` keeps
    (replacing med_tpu/ops/tcn_fused.py::_multi_bwd_kernel); a CPU tensor
    the plain version; any other device raises."""
    if g.device.type == "cpu":
        return dilated_residual_multistack_bwd_plain(
            g, h_saved, y_saved, w3, w1, L0, Lr, causal=causal, mask=mask, scale=scale)
    if not g.is_cuda:
        raise ValueError(f"no TCN multistack backward for device {g.device}")
    S, T, C = g.shape
    dev = g.device
    Lt = _check_multistack(T, C, dev, dict(g=g, h_saved=h_saved, y_saved=y_saved,
                                           w3=w3, w1=w1), mask)
    if S != len(_stage_lengths(Lt, L0, Lr)):
        raise ValueError(f"g holds {S} stage cotangents; {Lt} layers of "
                         f"L0={L0}, Lr={Lr} make {len(_stage_lengths(Lt, L0, Lr))}")
    _check_fwd_counts(T, _stage_lengths(Lt, L0, Lr))
    dx, dz, da, partial, dw3, db3, dw1, db1 = _bwd_buffers(T, C, Lt, dev)
    with torch.cuda.device(dev):
        _launch(_BWD, "tcn_multistack_bwd", _MULTI_BWD_ARGTYPES,
                dilated_residual_multistack_bwd, g.data_ptr(), h_saved.data_ptr(),
                y_saved.data_ptr(), w3.data_ptr(), w1.data_ptr(), _ptr(mask),
                dx.data_ptr(), dz.data_ptr(), da.data_ptr(), _ptr(partial),
                dw3.data_ptr(), db3.data_ptr(), dw1.data_ptr(), db1.data_ptr(), None, T,
                C, Lt, L0, max(Lr, 1), int(causal), scale)
    return dx, dw3, db3, dw1, db1


dilated_residual_multistack_bwd.launches = 0
dilated_residual_multistack_bwd.last_launch = None


class _Multistack(torch.autograd.Function):
    """Saving forward and layer-reverse backward over the concatenated
    operands (med_tpu's _fused_multi_train / _fused_multi_eval custom VJPs);
    the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, w3, b3, w1, b1, mask, L0, Lr, causal, scale):
        hs, h_saved, y_saved = _multistack_fwd(x, w3, b3, w1, b1, mask, L0, Lr,
                                               causal, save=True, scale=scale)
        ctx.spec = (L0, Lr, causal, scale)
        ctx.save_for_backward(h_saved, y_saved, w3, w1, mask)
        return hs

    @staticmethod
    def backward(ctx, g):
        L0, Lr, causal, scale = ctx.spec
        h_saved, y_saved, w3, w1, mask = ctx.saved_tensors
        grads = dilated_residual_multistack_bwd(g.contiguous(), h_saved, y_saved,
                                                w3, w1, L0, Lr, causal=causal,
                                                mask=mask, scale=scale)
        return (*grads, None, None, None, None, None)


def dilated_residual_multistack(x, w3, b3, w1, b1, L0: int, Lr: int, *,
                                causal: bool = True, mask=None,
                                scale: float = 2.0) -> torch.Tensor:
    """Stacks of L0, Lr, Lr, ... layers back to back, (T, C) -> the (S, T, C)
    stage outputs, with the stacks' weights concatenated on the layer axis:
    w3 (Lt, 3, C, C), b3 (Lt, C), w1 (Lt, C, C), b1 (Lt, C), ``mask`` the
    (Lt, T, C) uint8 keep-mask or None, ``scale`` the factor of a kept
    element; layer l uses dilation 2**(its index within its stage). A CUDA tensor runs the CUDA kernel, one launch for
    every 16 stacks, whose (blocks, rows a tile) ``.last_launch`` keeps
    (replacing med_tpu/ops/tcn_fused.py::_multi_fwd_kernel); a
    CPU tensor the plain version; any other device raises. Differentiable
    through :func:`dilated_residual_multistack_bwd`."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w3, b3, w1, b1)):
        return _Multistack.apply(x, w3, b3, w1, b1, mask, L0, Lr, causal, scale)
    return _multistack_fwd(x, w3, b3, w1, b1, mask, L0, Lr, causal, save=False, scale=scale)


dilated_residual_multistack.launches = 0
dilated_residual_multistack.last_launch = None
