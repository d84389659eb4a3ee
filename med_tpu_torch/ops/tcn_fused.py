"""Dilated residual TCN stacks (PyTorch port of ``med_tpu.ops.tcn_fused``).

A TCN stage is ``num_layers`` dilated residual layers at C channels,

    h_{i+1} = h_i + mask_i * 2 * (W1 · relu(dconv3_{2^i}(h_i) + b3) + b1)

with the mask only in training. Shapes:  x (T, C);  w3 (L, 3, C, C)
[tap, in, out];  b3 (L, C);  w1 (L, C, C) [in, out];  b1 (L, C);  mask
(L, T, C) uint8 or None. Layer i of a stage uses dilation 2**i.

On a CUDA tensor each layer is one launch of the hand-written kernel
``csrc/tcn_layer.cu``, ping-ponging two activation buffers; on a CPU tensor
the plain version :func:`dilated_stack_xla` runs. Forward only: the
backward kernels belong to the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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


def dilated_stack_xla(x, w3, b3, w1, b1, *, causal: bool = True, mask=None):
    """Plain PyTorch version of a stack, one layer at a time (named after the
    JAX oracle it ports)."""
    h = x.to(torch.float32)
    for i in range(w3.shape[0]):
        acc = b3[i][None, :]
        for j, s in enumerate(_shifts(2 ** i, causal)):
            acc = acc + _shift_rows(h, s) @ w3[i, j]
        z = torch.relu(acc) @ w1[i] + b1[i][None, :]
        if mask is not None:
            z = z * (mask[i].to(torch.float32) * 2.0)
        h = h + z
    return h


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _stages_cuda(x, stage_weights: Sequence[StageWeights], masks, causal: bool,
                 counter) -> torch.Tensor:
    """Run the stages back to back, one kernel launch per layer; returns the
    (S, T, C) stage outputs. ``counter`` is the public wrapper whose launch
    count each launch raises."""
    T, C = x.shape
    if C not in (8, 16, 32, 64):
        raise ValueError(f"the CUDA kernel takes 8, 16, 32 or 64 channels; got {C}")
    dev = x.device
    cuda_build.check_operand("x", x, dev, torch.float32)
    for s, w in enumerate(stage_weights):
        L = w[0].shape[0]
        shapes = ((L, 3, C, C), (L, C), (L, C, C), (L, C))
        for name, t, shape in zip(("w3", "b3", "w1", "b1"), w, shapes):
            cuda_build.check_operand(f"stage {s} {name}", t, dev, torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"stage {s} {name} has shape {tuple(t.shape)}, "
                                 f"expected {shape}")
        if masks is not None:
            cuda_build.check_operand(f"stage {s} mask", masks[s], dev, torch.uint8)
            if tuple(masks[s].shape) != (L, T, C):
                raise ValueError(f"stage {s} mask has shape "
                                 f"{tuple(masks[s].shape)}, expected {(L, T, C)}")
    fn = cuda_build.kernel_function("tcn_layer", "tcn_layer_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hs = torch.empty((len(stage_weights), T, C), dtype=torch.float32, device=dev)
    # an in-place layer would race with neighbouring blocks' tap reads, so
    # each layer writes a buffer other than its input
    scratch = (torch.empty_like(x), torch.empty_like(x))
    src = x
    for s, (w3, b3, w1, b1) in enumerate(stage_weights):
        L = w3.shape[0]
        for i in range(L):
            if i == L - 1:
                dst = hs[s]
            else:
                dst = scratch[1] if src is scratch[0] else scratch[0]
            mask_ptr = masks[s][i].data_ptr() if masks is not None else None
            code = fn(src.data_ptr(), w3[i].data_ptr(), b3[i].data_ptr(),
                      w1[i].data_ptr(), b1[i].data_ptr(), mask_ptr,
                      dst.data_ptr(), T, C, 2 ** i, int(causal), stream)
            cuda_build.check_launch("tcn_layer", "tcn_layer_fwd", code)
            counter.launches += 1
            src = dst
    return hs


def dilated_residual_stack(x, w3, b3, w1, b1, *, causal: bool = True,
                           mask=None) -> torch.Tensor:
    """One stack, (T, C) -> (T, C). A CUDA tensor runs the CUDA kernel, one
    launch per layer (replacing med_tpu/ops/tcn_fused.py::_fwd_kernel); a
    CPU tensor the plain version; any other device raises."""
    if x.is_cuda:
        masks = None if mask is None else [mask]
        return _stages_cuda(x, [(w3, b3, w1, b1)], masks, causal,
                            dilated_residual_stack)[0]
    if x.device.type == "cpu":
        return dilated_stack_xla(x, w3, b3, w1, b1, causal=causal, mask=mask)
    raise ValueError(f"no TCN stack for device {x.device}")


dilated_residual_stack.launches = 0


def dilated_residual_multistack_stages(x, stage_weights: Sequence[StageWeights],
                                       L0: int, Lr: int, *, causal: bool = True,
                                       masks: Optional[Sequence] = None
                                       ) -> torch.Tensor:
    """Stacks of L0, Lr, Lr, ... layers back to back, (T, C) -> the (S, T, C)
    stage outputs. ``stage_weights`` is a sequence of per-stage
    (w3, b3, w1, b1); ``masks`` a matching sequence of (L_s, T, C) uint8
    keep-masks, or None. A CUDA tensor runs the CUDA kernel, one launch per
    layer (replacing med_tpu/ops/tcn_fused.py::_multi_fwd_kernel_s); a CPU
    tensor the plain version; any other device raises."""
    layers = [w[0].shape[0] for w in stage_weights]
    if layers[0] != L0 or any(n != Lr for n in layers[1:]):
        raise ValueError(f"stage layer counts {layers} do not match "
                         f"L0={L0}, Lr={Lr}")
    if x.is_cuda:
        return _stages_cuda(x, stage_weights, masks, causal,
                            dilated_residual_multistack_stages)
    if x.device.type != "cpu":
        raise ValueError(f"no TCN stack for device {x.device}")
    outs = []
    h = x
    for s, (w3, b3, w1, b1) in enumerate(stage_weights):
        h = dilated_stack_xla(h, w3, b3, w1, b1, causal=causal,
                              mask=None if masks is None else masks[s])
        outs.append(h)
    return torch.stack(outs)


dilated_residual_multistack_stages.launches = 0
