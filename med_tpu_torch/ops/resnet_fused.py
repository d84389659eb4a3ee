"""Fused ResNet-50 bottleneck stages at inference (PyTorch port of
``med_tpu.ops.resnet_fused``).

Inference BatchNorm is an affine, so each conv + BN folds into (W', c):
W' = W * scale / sqrt(var + eps), c = bias - mean * scale / sqrt(var + eps),
folded in fp32 and cast to the working dtype where it is used. Trees and
kernels keep the JAX package's layout: a variables tree {"params",
"batch_stats"} as ``med_tpu`` writes it, conv kernels (kh, kw, I, O),
activations NHWC, a stage's activation as (B, H*W, C) rows.

:func:`fused_bottleneck_stage` runs a stage's stride-1 blocks. On a CUDA
tensor it launches the hand-written kernel ``csrc/resnet_stage.cu`` three
times a block (1x1 reduce, 3x3, 1x1 expand with the residual); on a CPU
tensor it runs the plain version :func:`fused_bottleneck_stage_plain`, which
rounds at the same points. :func:`resnet50_fused_apply` stitches the stem,
the max-pool and the stride-2 blocks (``F.conv2d``; XLA convs in the JAX
package) with the fused stages into the trunk's forward; it takes the tree
or the tree folded once by :func:`fold_trunk`.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

BN_EPS = 1e-5  # flax.linen.BatchNorm's default, as torchvision's


def _tensor(a, device=None) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device) if device is not None else a
    return torch.tensor(np.asarray(a), device=device)


def fold_conv_bn(kernel, bn_params, bn_stats, eps: float = BN_EPS):
    """(conv kernel (kh, kw, I, O), inference BN) -> (folded kernel, bias),
    both fp32."""
    scale, bias, mean, var = (_tensor(t).to(torch.float32) for t in (
        bn_params["scale"], bn_params["bias"], bn_stats["mean"], bn_stats["var"]))
    a = scale / torch.sqrt(var + eps)
    c = bias - mean * a
    return _tensor(kernel).to(torch.float32) * a, c


_BLOCK_CONVS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
                ("down_conv", "down_bn"))


def _fold_block(block_params, block_stats):
    """A Bottleneck block's convs, each folded with its BN: {conv name:
    (kernel (kh, kw, I, O), bias)}, both fp32."""
    return {conv: fold_conv_bn(block_params[conv]["kernel"], block_params[bn],
                               block_stats[bn])
            for conv, bn in _BLOCK_CONVS if conv in block_params}


def _stage_operands(blk) -> Dict[str, torch.Tensor]:
    """A folded block (see :func:`_fold_block`) as the kernel's operands,
    views of the same tensors."""
    (w1, c1), (w2, c2), (w3, c3) = blk["conv1"], blk["conv2"], blk["conv3"]
    f = w1.shape[-1]
    out = {"w1": w1[0, 0], "c1": c1.reshape(1, f),
           "w2": w2.reshape(9, f, f), "c2": c2.reshape(1, f),
           "w3": w3[0, 0], "c3": c3.reshape(1, 4 * f)}
    if "down_conv" in blk:
        wd, cd = blk["down_conv"]
        out["wd"] = wd[0, 0]
        out["cd"] = cd.reshape(1, 4 * f)
    return out


def fold_bottleneck_params(block_params, block_stats) -> Dict[str, torch.Tensor]:
    """One Bottleneck block's (params, batch_stats) -> the kernel's operands:
    w1 (Cin, f), w2 (9, f, f), w3 (f, 4f) folded kernels and (1, ·) biases;
    wd, cd for the stride-1 projection when the block has one."""
    return _stage_operands(_fold_block(block_params, block_stats))


def _mm(a, w):
    """fp32 product of working-dtype operands (bf16 products are exact in
    fp32): the kernels' preferred_element_type=float32."""
    return a.to(torch.float32) @ w.to(torch.float32)


def fused_bottleneck_stage_plain(x, blocks: Sequence[Dict[str, Any]], *, Wr: int,
                                 dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_bottleneck_stage`: the TPU
    kernel's arithmetic, rounding y1, y2 and each block's output to
    ``dtype``, biases and the residual added in fp32."""
    B, HW, _ = x.shape
    H = HW // Wr
    x = x.to(dtype)
    for blk in blocks:
        f = blk["w1"].shape[-1]
        w = {k: (v if k.startswith("c") else v.to(dtype)) for k, v in blk.items()}
        y1 = torch.relu(_mm(x, w["w1"]) + w["c1"]).to(dtype)
        img = F.pad(y1.view(B, H, Wr, f), (0, 0, 1, 1, 1, 1))
        acc = w["c2"].expand(B * HW, f).to(torch.float32)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                tap = img[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + Wr].reshape(B * HW, f)
                acc = acc + _mm(tap, w["w2"][3 * (dy + 1) + (dx + 1)])
        y2 = torch.relu(acc).to(dtype).view(B, HW, f)
        z = _mm(y2, w["w3"]) + w["c3"]
        res = _mm(x, w["wd"]) + w["cd"] if "wd" in w else x.to(torch.float32)
        x = torch.relu(z + res).to(dtype)
    return x


_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_MAX_ROWS = 65535 * 128   # the kernel's grid covers 128 rows a block in y
_REDUCE, _CONV3, _EXPAND = 0, 1, 2


def _stage_cuda(x, blocks, Wr: int, dtype, counter) -> torch.Tensor:
    """The stage on the card: three launches of ``resnet_stage_gemm`` a
    block, y1 and y2 in device memory."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16; got {dtype}")
    B, HW, _ = x.shape
    M, H, dev = B * HW, HW // Wr, x.device
    if M > _MAX_ROWS:
        raise ValueError(f"{M} rows exceed the kernel's grid ({_MAX_ROWS})")
    x = x.to(dtype).contiguous()
    fn = cuda_build.kernel_function("resnet_stage", "resnet_stage_gemm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = int(dtype == torch.bfloat16)

    def gemm(mode, a0, a1, b0, b1, c0, c1, res, out, K0, K1):
        for name, t, want in (("a0", a0, dtype), ("a1", a1, dtype), ("b0", b0, dtype),
                              ("b1", b1, dtype), ("c0", c0, torch.float32),
                              ("c1", c1, torch.float32), ("res", res, dtype)):
            if t is not None:
                cuda_build.check_operand(name, t, dev, want)
        N = out.shape[-1]
        code = fn(mode, is_bf16, a0.data_ptr(), None if a1 is None else a1.data_ptr(),
                  b0.data_ptr(), None if b1 is None else b1.data_ptr(), c0.data_ptr(),
                  None if c1 is None else c1.data_ptr(),
                  None if res is None else res.data_ptr(), out.data_ptr(),
                  M, N, K0, K1, H, Wr, stream)
        cuda_build.check_launch("resnet_stage", "resnet_stage_gemm", code)
        counter.launches += 1

    for blk in blocks:
        cin, f = blk["w1"].shape
        shapes = {"w1": (cin, f), "c1": (1, f), "w2": (9, f, f), "c2": (1, f),
                  "w3": (f, 4 * f), "c3": (1, 4 * f), "wd": (cin, 4 * f), "cd": (1, 4 * f)}
        if x.shape[-1] != cin:
            raise ValueError(f"block takes {cin} channels, the activation has {x.shape[-1]}")
        w = {}
        for k, v in blk.items():
            if tuple(v.shape) != shapes[k]:
                raise ValueError(f"{k} has shape {tuple(v.shape)}, expected {shapes[k]}")
            w[k] = v.to(torch.float32 if k.startswith("c") else dtype).contiguous()
        proj = "wd" in w
        if not proj and cin != 4 * f:
            raise ValueError(f"an identity block needs Cin = 4f; got {cin}, f={f}")
        y1 = torch.empty((B, HW, f), dtype=dtype, device=dev)
        y2 = torch.empty_like(y1)
        out = torch.empty((B, HW, 4 * f), dtype=dtype, device=dev)
        gemm(_REDUCE, x, None, w["w1"], None, w["c1"], None, None, y1, cin, 0)
        gemm(_CONV3, y1, None, w["w2"], None, w["c2"], None, None, y2, f, 0)
        gemm(_EXPAND, y2, x if proj else None, w["w3"], w.get("wd"), w["c3"],
             w.get("cd"), None if proj else x, out, f, cin if proj else 0)
        x = out
    return x


def fused_bottleneck_stage(x, blocks: Sequence[Dict[str, Any]], *, Wr: int,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Stride-1 bottleneck blocks, (B, H*W, Cin) -> (B, H*W, 4f) in ``dtype``.

    ``x`` rows are the image's pixels row-major with row length ``Wr``;
    ``blocks`` are folded operand dicts from :func:`fold_bottleneck_params`
    (a 'wd' key adds the stride-1 projection of a stage's first block). A
    CUDA tensor launches ``csrc/resnet_stage.cu`` three times a block
    (replacing med_tpu/ops/resnet_fused.py::_stage_kernel); a CPU tensor
    runs :func:`fused_bottleneck_stage_plain`; any other device raises."""
    B, HW, _ = x.shape
    if HW % 8:
        raise ValueError(f"H*W={HW} must be 8-aligned for the row-flat form")
    if HW % Wr:
        raise ValueError(f"H*W={HW} is not a multiple of the row length {Wr}")
    if x.is_cuda:
        return _stage_cuda(x, blocks, Wr, dtype, fused_bottleneck_stage)
    if x.device.type != "cpu":
        raise ValueError(f"no fused bottleneck stage for device {x.device}")
    return fused_bottleneck_stage_plain(x, blocks, Wr=Wr, dtype=dtype)


fused_bottleneck_stage.launches = 0


def _conv_bn(x, kernel, c, stride: int, dtype):
    """NHWC conv with a folded kernel (kh, kw, I, O), the folded bias added
    in the working dtype after the conv (as the JAX package does)."""
    pad = (kernel.shape[0] - 1) // 2
    w = kernel.to(dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1) + c.to(dtype)


def _block_conv(x, blk, stride: int, dtype):
    """One Bottleneck block on the library conv path, from its folded convs
    (see :func:`_fold_block`)."""
    y = torch.relu(_conv_bn(x, *blk["conv1"], 1, dtype))
    y = torch.relu(_conv_bn(y, *blk["conv2"], stride, dtype))
    y = _conv_bn(y, *blk["conv3"], 1, dtype)
    res = _conv_bn(x, *blk["down_conv"], stride, dtype) if "down_conv" in blk else x
    return torch.relu(y + res)


def fold_trunk(variables, *, dtype=torch.bfloat16, device=None) -> Dict:
    """Every conv + BN of a ``med_tpu`` trunk tree {"params",
    "batch_stats"} (numpy or tensors), folded once: {"conv1": (kernel,
    bias), "layer<s>_<b>": {conv name: (kernel, bias)}, ...}, kernels
    (kh, kw, I, O) folded in fp32 and cast to ``dtype``, biases fp32, all on
    ``device``. :func:`resnet50_fused_apply` takes it in place of the tree,
    so a caller that runs many batches folds and casts once."""
    p, s = variables["params"], variables["batch_stats"]

    def put(w, c):
        return w.to(device, dtype).contiguous(), c.to(device).contiguous()

    out = {"conv1": put(*fold_conv_bn(p["conv1"]["kernel"], p["bn1"], s["bn1"]))}
    for name in p:
        if name.startswith("layer"):
            out[name] = {conv: put(w, c) for conv, (w, c) in _fold_block(p[name], s[name]).items()}
    return out


def resnet50_fused_apply(variables, x, *, stage_sizes=(3, 4, 6, 3),
                         dtype=torch.bfloat16, fused_stages=(0, 1)) -> torch.Tensor:
    """ResNet-50 trunk inference with the fused stride-1 stages:
    (B, H, W, 3) preprocessed pixels -> (B, 2048) pooled fp32 features, the
    same math as ``ResNet50`` at inference (folded BN; rounding differs at
    the working dtype's level only). ``variables`` is the ``med_tpu`` tree
    {"params", "batch_stats"}, folded on every call, or its
    :func:`fold_trunk` at ``dtype`` on ``x``'s device, which gives the same
    result. ``fused_stages`` indexes the stages (0-based) whose stride-1
    blocks run through :func:`fused_bottleneck_stage`; a stage stays on the
    conv path when its H*W is not 8-aligned."""
    dev = x.device
    folded = (fold_trunk(variables, dtype=dtype, device=dev) if "params" in variables
              else variables)
    w0, c0 = folded["conv1"]
    if w0.dtype != dtype or w0.device != dev:
        raise ValueError(f"the folded trunk is {w0.dtype} on {w0.device}; "
                         f"the call needs {dtype} on {dev}")
    x = x.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1), stride=2, padding=3)
    y = torch.relu(y + c0.to(dtype)[:, None, None])
    y = F.max_pool2d(y, 3, stride=2, padding=1).permute(0, 2, 3, 1)

    for stage, n_blocks in enumerate(stage_sizes):
        first_fused = 0 if stage == 0 else 1   # block 0 strides 2 on the conv path
        if stage > 0:
            y = _block_conv(y, folded[f"layer{stage + 1}_0"], 2, dtype)
        B, H, W, C = y.shape
        rest = [folded[f"layer{stage + 1}_{b}"] for b in range(first_fused, n_blocks)]
        if stage in fused_stages and (H * W) % 8 == 0 and rest:
            blocks = [_stage_operands(blk) for blk in rest]
            flat = fused_bottleneck_stage(y.reshape(B, H * W, C), blocks, Wr=W, dtype=dtype)
            y = flat.reshape(B, H, W, flat.shape[-1])
        else:
            for blk in rest:
                y = _block_conv(y, blk, 1, dtype)
    return y.to(torch.float32).mean(dim=(1, 2))
