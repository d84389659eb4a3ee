"""Post-training int8 quantization of the serving trunk and the
FeatureExtractor (port of ``med_tpu.ops.quant``).

The scheme is ``med_tpu``'s, a serving-only extra (the reference has no
quantized path):

- BatchNorm folded into the preceding conv: ``y = a * conv(x) + b`` with
  ``a = gamma / sqrt(var + eps)`` per output channel, ``b = beta - mean * a``;
- weights symmetric per output channel, ``wscale[o] = max|k'[..., o]| / 127``;
- activations symmetric per tensor with static scales from one calibration
  batch (max-abs over the folded fp32 forward, on the CPU, so the scales do
  not depend on the device);
- int32 accumulation; the dequantization ``acc * (s_in * wscale) + bias``,
  the residual, relu and the requantization ``clip(rint(y / s_out), ±127)``
  as the product's epilogue.

Every int8 product goes through :func:`int8_conv`. On a CUDA tensor it
launches the hand-written kernel ``csrc/int8_conv.cu`` (mma.sync s8 on the
tensor cores, the epilogue fused), which replaces XLA's int8 conv and dot
in ``med_tpu`` (``_conv_i8``, ``_dense_i8``); on a CPU tensor it runs the
plain version :func:`int8_conv_plain` (exact int32 accumulators through a
float64 convolution, the epilogue in PyTorch ops); any other device raises.
A trunk forward is 53 launches (conv1, three a block, one a downsample), a
FeatureExtractor forward 3. The input quantization, the int8 max pool and
the final mean are PyTorch ops, as XLA computes them outside any product.

The port's quantized trees hold ``med_tpu``'s leaves with each int8 weight
as (O, kh, kw, I) (a dense layer's as (O, I)): every output channel's K
values contiguous, the kernel's layout. Activation scales are 0-d float32
CPU tensors, read on the host without a device sync.
:func:`med_tpu_torch.utils.jax_params.load_jax_quant_trunk` and
``load_jax_quant_fe`` carry ``med_tpu``'s trees across.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

BN_EPS = 1e-5  # flax nn.BatchNorm's default, as models/resnet.py

INSTANCES = ("16-byte", "guarded")
_OUT_I32, _OUT_F32, _OUT_I8 = 0, 1, 2
_RES_NONE, _RES_F32, _RES_I8 = 0, 1, 2
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def _f32(scale) -> float:
    """A scale as a Python float holding its float32 value."""
    return float(np.float32(scale.item() if torch.is_tensor(scale) else scale))


def _inverse(scale) -> float:
    """1 / scale in float32, as ``x * (1.0 / scale)`` forms it in med_tpu."""
    return float(np.float32(1.0) / np.float32(_f32(scale)))


# --------------------------------------------------------------- primitives
def quantize_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """fp32 -> int8 with a symmetric scale: clip(round(x * (1 / scale)), ±127),
    rounding half to even (``torch.round``, as ``jnp.round``)."""
    q = torch.round(x.to(torch.float32) * _inverse(scale))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def quantize_weights_per_channel(kernel) -> Tuple[np.ndarray, np.ndarray]:
    """Folded fp kernel (Kh, Kw, I, O) -> (int8 kernel, per-O fp32 scale)."""
    k = np.asarray(kernel, np.float32)
    amax = np.max(np.abs(k), axis=(0, 1, 2))
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def fold_conv_bn(conv_p, bn_p, bn_s, eps: float = BN_EPS):
    """Fold inference BN into the conv: returns (folded kernel, bias)."""
    a = np.asarray(bn_p["scale"], np.float32) / np.sqrt(
        np.asarray(bn_s["var"], np.float32) + eps)
    k = np.asarray(conv_p["kernel"], np.float32) * a  # broadcast on O axis
    b = np.asarray(bn_p["bias"], np.float32) - np.asarray(bn_s["mean"], np.float32) * a
    return k, b


def block_geometry(stage_sizes: Sequence[int]):
    """Yield (name, stride, has_down) in ``ResNet50``'s block order."""
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            yield f"layer{stage + 1}_{block}", 2 if (stage > 0 and block == 0) else 1, block == 0


# -------------------------------------------------------- the int8 product
def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, wscale: torch.Tensor,
                    bias: torch.Tensor, *, s_in, stride: int = 1, pad: int = 0,
                    residual: Optional[torch.Tensor] = None, res_scale=None,
                    relu: bool = False, out_scale=None,
                    accumulators: bool = False) -> torch.Tensor:
    """The plain version of :func:`int8_conv`, in PyTorch ops on any device:
    the int32 accumulators exactly (a float64 convolution of the int8
    values: |acc| <= K * 127² < 2^31 is an integer float64 holds), then
    ``med_tpu``'s epilogue op by op."""
    xd = x.permute(0, 3, 1, 2).to(torch.float64)
    wd = w.permute(0, 3, 1, 2).to(torch.float64)
    acc = F.conv2d(xd, wd, stride=stride, padding=pad).permute(0, 2, 3, 1)
    acc = acc.to(torch.int32).contiguous()
    if accumulators:
        return acc
    s = torch.tensor(_f32(s_in), dtype=torch.float32, device=x.device)
    y = acc.to(torch.float32) * (s * wscale) + bias
    if residual is not None:
        if residual.dtype == torch.int8:
            r = torch.tensor(_f32(res_scale), dtype=torch.float32, device=x.device)
            y = y + residual.to(torch.float32) * r
        else:
            y = y + residual
    if relu:
        y = torch.relu(y)
    return y if out_scale is None else quantize_tensor(y, out_scale)


def _int8_conv_cuda(x, w, wscale, bias, s_in, stride, pad, residual, res_scale, relu,
                    out_scale, accumulators, counter) -> torch.Tensor:
    dev = x.device
    B, H, W, cin = x.shape
    N, kh, kw, wcin = w.shape
    if wcin != cin:
        raise ValueError(f"the weights take {wcin} channels, the activation has {cin}")
    for name, t, want in (("x", x, torch.int8), ("w", w, torch.int8),
                          ("wscale", wscale, torch.float32), ("bias", bias, torch.float32)):
        cuda_build.check_operand(name, t, dev, want)
    if tuple(wscale.shape) != (N,) or tuple(bias.shape) != (N,):
        raise ValueError(f"wscale and bias must be ({N},); got {tuple(wscale.shape)}, "
                         f"{tuple(bias.shape)}")
    Ho, Wo = (H + 2 * pad - kh) // stride + 1, (W + 2 * pad - kw) // stride + 1
    res_kind, rs = _RES_NONE, 0.0
    if residual is not None:
        if tuple(residual.shape) != (B, Ho, Wo, N):
            raise ValueError(f"residual {tuple(residual.shape)}, output {(B, Ho, Wo, N)}")
        cuda_build.check_operand("residual", residual, dev, residual.dtype)
        int8_res = residual.dtype == torch.int8
        res_kind, rs = (_RES_I8, _f32(res_scale)) if int8_res else (_RES_F32, 0.0)
    if accumulators:
        out_kind, dtype = _OUT_I32, torch.int32
    elif out_scale is None:
        out_kind, dtype = _OUT_F32, torch.float32
    else:
        out_kind, dtype = _OUT_I8, torch.int8
    out = torch.empty((B, Ho, Wo, N), dtype=dtype, device=dev)
    fn = cuda_build.kernel_function("int8_conv", "int8_conv", _ARGTYPES)
    taken = ctypes.c_int(-1)
    code = fn(x.data_ptr(), w.data_ptr(), wscale.data_ptr(), bias.data_ptr(), _f32(s_in),
              None if residual is None else residual.data_ptr(), res_kind, rs,
              out.data_ptr(), out_kind, 0.0 if out_scale is None else _inverse(out_scale),
              int(relu), B, H, W, cin, N, kh, kw, stride, pad, ctypes.byref(taken),
              torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("int8_conv", "int8_conv", code)
    counter.launches += 1
    instance = INSTANCES[taken.value]
    counter.instances[instance] = counter.instances.get(instance, 0) + 1
    return out


def int8_conv(x: torch.Tensor, w: torch.Tensor, wscale: torch.Tensor, bias: torch.Tensor,
              *, s_in, stride: int = 1, pad: int = 0,
              residual: Optional[torch.Tensor] = None, res_scale=None, relu: bool = False,
              out_scale=None, accumulators: bool = False) -> torch.Tensor:
    """One int8 convolution with its epilogue: NHWC int8 ``x`` (B, H, W, Cin)
    and int8 weights ``w`` (O, kh, kw, Cin) to (B, Ho, Wo, O).

    y = acc * (s_in * wscale) + bias, plus ``residual`` (fp32, or int8 times
    ``res_scale``), relu if asked; returned as fp32, or requantized to int8
    by ``out_scale``; with ``accumulators`` the int32 sums themselves. A CUDA
    tensor launches ``csrc/int8_conv.cu`` once (replacing
    med_tpu/ops/quant.py::_conv_i8 and its epilogue); a CPU tensor runs
    :func:`int8_conv_plain`; any other device raises. Operands must be int8
    and the scales fp32."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 operands; got {x.dtype} and {w.dtype}")
    if wscale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"wscale and bias must be float32; got {wscale.dtype}, {bias.dtype}")
    if residual is not None and residual.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"the residual is int8 or float32; got {residual.dtype}")
    if residual is not None and residual.dtype == torch.int8 and res_scale is None:
        raise ValueError("an int8 residual needs its res_scale")
    kw = dict(s_in=s_in, stride=stride, pad=pad, residual=residual, res_scale=res_scale,
              relu=relu, out_scale=out_scale, accumulators=accumulators)
    if x.is_cuda:
        return _int8_conv_cuda(x, w, wscale, bias, counter=_COUNTER, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"no int8 convolution for device {x.device}")
    return int8_conv_plain(x, w, wscale, bias, **kw)


int8_conv.launches = 0
int8_conv.instances = {}   # launches by INSTANCES name; read as a difference
# where launches are counted, bound once: a check may wrap the module's
# int8_conv while a forward runs (chip_smoke.py's _Int8Check)
_COUNTER = int8_conv


def int8_dense(x: torch.Tensor, w: torch.Tensor, wscale: torch.Tensor, bias: torch.Tensor,
               *, s_in, relu: bool = False, out_scale=None,
               accumulators: bool = False) -> torch.Tensor:
    """int8 (..., I) @ int8 (O, I)^T with the epilogue: :func:`int8_conv`'s
    1x1 case over the rows (replacing med_tpu/ops/quant.py::_dense_i8)."""
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, 1, 1, k)
    y = int8_conv(rows, w.reshape(w.shape[0], 1, 1, k), wscale, bias, s_in=s_in,
                  relu=relu, out_scale=out_scale, accumulators=accumulators)
    return y.reshape(*lead, w.shape[0])


# ------------------------------------------------------------- calibration
def fold_trunk(variables, stage_sizes: Sequence[int]) -> Dict[str, Any]:
    """Fold every conv+BN of a ResNet50 variables tree into (kernel, bias)."""
    params, stats = variables["params"], variables["batch_stats"]
    folded: Dict[str, Any] = {
        "conv1": fold_conv_bn(params["conv1"], params["bn1"], stats["bn1"])}
    for name, _, has_down in block_geometry(stage_sizes):
        p, s = params[name], stats[name]
        blk = {f"c{i}": fold_conv_bn(p[f"conv{i}"], p[f"bn{i}"], s[f"bn{i}"])
               for i in (1, 2, 3)}
        if has_down:
            blk["down"] = fold_conv_bn(p["down_conv"], p["down_bn"], s["down_bn"])
        folded[name] = blk
    return folded


def _conv_f(x, kb, stride: int, pad: int):
    """Folded fp32 conv on NCHW, (kh, kw, I, O) kernel, then the bias."""
    k, b = kb
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    return F.conv2d(x, w, stride=stride, padding=pad) + torch.from_numpy(b)[:, None, None]


def _amax(x) -> float:
    return float(x.abs().max())


@torch.no_grad()
def _calib_forward(folded, x, stage_sizes: Sequence[int]) -> Dict[str, float]:
    """Folded fp32 forward on the CPU recording max|.| at every requant
    point: the trunk input, post-relu conv1, and each block's two inner
    activations and its output (the int8 graph's structure)."""
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).permute(0, 3, 1, 2)
    rec = {"in": _amax(x)}
    y = torch.relu(_conv_f(x, folded["conv1"], 2, 3))
    rec["conv1"] = _amax(y)
    y = F.max_pool2d(y, 3, 2, 1)
    for name, stride, has_down in block_geometry(stage_sizes):
        blk = folded[name]
        t = torch.relu(_conv_f(y, blk["c1"], 1, 0))
        rec[f"{name}/a1"] = _amax(t)
        t = torch.relu(_conv_f(t, blk["c2"], stride, 1))
        rec[f"{name}/a2"] = _amax(t)
        t = _conv_f(t, blk["c3"], 1, 0)
        res = _conv_f(y, blk["down"], stride, 0) if has_down else y
        y = torch.relu(t + res)
        rec[f"{name}/out"] = _amax(y)
    return rec


def _act_scale(amax: float) -> torch.Tensor:
    return torch.tensor(np.float32(max(amax, 1e-6) / 127.0))


def _qconv(kb) -> Dict[str, torch.Tensor]:
    wq, ws = quantize_weights_per_channel(kb[0])
    return {"wq": torch.from_numpy(np.ascontiguousarray(np.transpose(wq, (3, 0, 1, 2)))),
            "wscale": torch.from_numpy(ws), "bias": torch.tensor(np.asarray(kb[1]))}


def quantize_resnet50_trunk(variables, calib_x,
                            stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> Dict[str, Any]:
    """The int8 serving trunk of a ResNet50 variables tree ({"params",
    "batch_stats"}, numpy, as ``med_tpu`` holds it), calibrated on one
    preprocessed fp32 batch ``calib_x`` (B, H, W, 3) on the CPU. Returns the
    port's quantized tree on the CPU (:func:`tree_to` moves it)."""
    folded = fold_trunk(variables, stage_sizes)
    rec = _calib_forward(folded, calib_x, stage_sizes)
    qt: Dict[str, Any] = {"in_scale": _act_scale(rec["in"]),
                          "conv1": dict(_qconv(folded["conv1"]),
                                        out_scale=_act_scale(rec["conv1"]))}
    for name, _, has_down in block_geometry(stage_sizes):
        blk = folded[name]
        q = {"c1": _qconv(blk["c1"]), "c2": _qconv(blk["c2"]), "c3": _qconv(blk["c3"]),
             "a1": _act_scale(rec[f"{name}/a1"]), "a2": _act_scale(rec[f"{name}/a2"]),
             "out": _act_scale(rec[f"{name}/out"])}
        if has_down:
            q["down"] = _qconv(blk["down"])
        qt[name] = q
    return qt


def tree_to(tree, device):
    """A quantized tree with its weights on ``device``; the activation
    scales (0-d tensors) stay on the CPU, read without a device sync."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree if tree.dim() == 0 else tree.to(device)


def _fe_layer_names(fe_params) -> list:
    """The FE's layers in the order they apply: dense0, dense1, ..., by
    number (a string sort puts dense10 before dense2), then out."""
    dense = [n for n in fe_params if n.startswith("dense")]
    return sorted(dense, key=lambda n: int(n[len("dense"):])) + ["out"]


@torch.no_grad()
def quantize_fe(fe_params, calib_images) -> Dict[str, list]:
    """The int8 FeatureExtractor (2048 -> 512 -> 256 -> 32, relu between)
    of its flax params tree (numpy: ``dense<i>`` and ``out``, each {kernel
    (I, O), bias}), calibrated on one representative (B, W, 2048) feature
    batch in fp32 on the CPU: per-output-channel int8 weights and static
    per-tensor input scales. Returns {"layers": [{"wq" (O, I), "wscale",
    "bias", "in_scale"}, ...]} on the CPU."""
    names = _fe_layer_names(fe_params)
    x = torch.tensor(np.asarray(calib_images, np.float32))
    rec = [_amax(x)]
    for i, name in enumerate(names):
        p = fe_params[name]
        x = torch.matmul(x, torch.tensor(np.asarray(p["kernel"], np.float32))) \
            + torch.tensor(np.asarray(p["bias"], np.float32))
        if i + 1 < len(names):
            x = torch.relu(x)
            rec.append(_amax(x))
    layers = []
    for i, name in enumerate(names):
        k = np.asarray(fe_params[name]["kernel"], np.float32)
        ws = np.maximum(np.max(np.abs(k), axis=0), 1e-12) / 127.0
        wq = np.clip(np.round(k / ws), -127, 127).astype(np.int8)
        layers.append({"wq": torch.from_numpy(np.ascontiguousarray(wq.T)),
                       "wscale": torch.from_numpy(ws.astype(np.float32)),
                       "bias": torch.tensor(np.asarray(fe_params[name]["bias"], np.float32)),
                       "in_scale": _act_scale(rec[i])})
    return {"layers": layers}


# ------------------------------------------------------------- int8 forward
def quantize_fe_input(qfe, images: torch.Tensor) -> torch.Tensor:
    """fp32 feature windows -> the int8 feature store that
    :func:`fe_int8_apply` takes (the layer-0 activation scale)."""
    return quantize_tensor(images, qfe["layers"][0]["in_scale"])


def fe_int8_apply(qfe, images: torch.Tensor) -> torch.Tensor:
    """int8 FeatureExtractor forward: (B, W, 2048) fp32, or the int8 feature
    store of :func:`quantize_fe_input`, to (B, W, 32) fp32; bit-identical
    either way. Each hidden layer's epilogue applies relu and requantizes
    to the next layer's input scale; the last returns fp32. Three launches
    of :func:`int8_conv` on the card."""
    layers = qfe["layers"]
    x = images if images.dtype == torch.int8 else quantize_fe_input(qfe, images)
    for i, qd in enumerate(layers):
        last = i + 1 == len(layers)
        x = int8_dense(x, qd["wq"], qd["wscale"], qd["bias"], s_in=qd["in_scale"],
                       relu=not last, out_scale=None if last else layers[i + 1]["in_scale"])
    return x


def _max_pool_i8(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool of NHWC int8, exact through an fp32 view
    (a max of int8 values is one of them; the padding never wins)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2).to(torch.float32), 3, 2, 1)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _block_i8(xq, s_in, q, stride: int, has_down: bool):
    def conv(x, c, s, **kw):
        return int8_conv(x, c["wq"], c["wscale"], c["bias"], s_in=s, **kw)

    t = conv(xq, q["c1"], s_in, relu=True, out_scale=q["a1"])
    t = conv(t, q["c2"], q["a1"], stride=stride, pad=1, relu=True, out_scale=q["a2"])
    if has_down:
        res = conv(xq, q["down"], s_in, stride=stride)
        y = conv(t, q["c3"], q["a2"], residual=res, relu=True, out_scale=q["out"])
    else:
        y = conv(t, q["c3"], q["a2"], residual=xq, res_scale=s_in, relu=True,
                 out_scale=q["out"])
    return y, q["out"]


def resnet50_int8_apply(qt, x: torch.Tensor,
                        stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> torch.Tensor:
    """int8 trunk forward: preprocessed pixels (B, H, W, 3) fp32 -> (B, F)
    pooled fp32 features, on ``x``'s device (the tree's weights must be
    there: :func:`tree_to`); the contract of ``ResNet50``'s forward."""
    xq = quantize_tensor(x, qt["in_scale"])
    c1 = qt["conv1"]
    yq = int8_conv(xq, c1["wq"], c1["wscale"], c1["bias"], s_in=qt["in_scale"], stride=2,
                   pad=3, relu=True, out_scale=c1["out_scale"])
    yq = _max_pool_i8(yq)
    s = c1["out_scale"]
    for name, stride, has_down in block_geometry(stage_sizes):
        yq, s = _block_i8(yq, s, qt[name], stride, has_down)
    return pooled_features(yq, s)


def pooled_features(yq: torch.Tensor, s) -> torch.Tensor:
    """The last block's NHWC int8 codes -> (B, C) pooled fp32 features: the
    final dequantization folds into the mean, s * mean(int8). An exact sum
    of integers, then a division, as jnp.mean; the divisor is a tensor on
    the device, since PyTorch's CUDA division by a scalar multiplies by its
    reciprocal, which can land an ulp from the quotient."""
    n = torch.tensor(float(yq.shape[1] * yq.shape[2]), device=yq.device)
    return yq.to(torch.float32).sum(dim=(1, 2)) / n * _f32(s)
