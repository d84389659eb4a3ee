"""Plain ResNet-50 (torchvision's v1.5, He et al., arXiv:1512.03385) and the
reference's fine-tuning head, as functions of a flat parameter dict whose
names are the checkpoint layout's ("conv1.weight", "layer1_0.bn1.weight",
"layer2_0.down_conv.weight", ...; the classifier's under "trunk." with
"fc1.*", "fc2.*").

BatchNorm is flax's (the JAX package's, which the served checkpoints come
from): training normalises by the batch's mean and its variance
E[x²] - E[x]² clipped at 0, as (x - mean) * (rsqrt(var + eps) * scale) +
bias, and moves the running statistics to 0.9 * old + 0.1 * batch (the
biased variance); inference uses the running statistics. In bfloat16 the
rounding is flax's: a conv rounds its output, BatchNorm normalises in
float32 and rounds once, the residual sum and relu run in bfloat16, the
pool in float32."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.9


def blocks(stage_sizes: Sequence[int]) -> List[Tuple[str, int, int, bool]]:
    """(name, features, stride, downsample) of every bottleneck block."""
    out = []
    for stage, n in enumerate(stage_sizes):
        for block in range(n):
            out.append((f"layer{stage + 1}_{block}", 2 ** stage,
                        2 if (stage > 0 and block == 0) else 1, block == 0))
    return out


def param_spec(stage_sizes=(3, 4, 6, 3), width: int = 64, residual_scale: float = 0.2,
               perturb: float = 0.1, prefix: str = "", head: Optional[Tuple[int, int]] = None):
    """The trunk's (and with ``head`` = (hidden, classes) the classifier's)
    weight spec for :mod:`core.weights`: convs Kaiming normal over fan-out;
    BatchNorm scales N(1, perturb²) and biases N(0, perturb²), both times
    ``residual_scale`` in each block's last BatchNorm (a trained ResNet's are
    small); running statistics 0 and 1; the head U(±1/sqrt(fan_in))."""
    spec = []

    def conv(name, cin, cout, k):
        spec.append((f"{prefix}{name}.weight", (cout, cin, k, k), "normal", 0.0,
                     math.sqrt(2.0 / (cout * k * k))))

    def bn(name, c, scale=1.0):
        spec.append((f"{prefix}{name}.weight", (c,), "normal", scale, perturb * scale))
        spec.append((f"{prefix}{name}.bias", (c,), "normal", 0.0, perturb * scale))
        spec.append((f"{prefix}{name}.running_mean", (c,), "fill", 0.0, 0.0))
        spec.append((f"{prefix}{name}.running_var", (c,), "fill", 1.0, 0.0))

    conv("conv1", 3, width, 7)
    bn("bn1", width)
    cin = width
    for name, mult, _, down in blocks(stage_sizes):
        f = width * mult
        conv(f"{name}.conv1", cin, f, 1)
        bn(f"{name}.bn1", f)
        conv(f"{name}.conv2", f, f, 3)
        bn(f"{name}.bn2", f)
        conv(f"{name}.conv3", f, 4 * f, 1)
        bn(f"{name}.bn3", 4 * f, residual_scale)
        if down:
            conv(f"{name}.down_conv", cin, 4 * f, 1)
            bn(f"{name}.down_bn", 4 * f)
        cin = 4 * f
    if head is not None:
        hidden, classes = head
        for name, fan_in, fan_out in (("fc1", cin, hidden), ("fc2", hidden, classes)):
            bound = 1.0 / math.sqrt(fan_in)
            spec.append((f"{name}.weight", (fan_out, fan_in), "uniform", bound, 0.0))
            spec.append((f"{name}.bias", (fan_out,), "uniform", bound, 0.0))
    return spec


def batch_norm(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, train: bool,
               dtype: torch.dtype, state: Optional[Dict[str, torch.Tensor]] = None,
               calibrate: bool = False) -> torch.Tensor:
    """flax's BatchNorm over axis 1 of NCHW ``x``. ``train``: the batch's
    statistics, with the moved running statistics written to ``state``;
    ``calibrate``: the batch's statistics written in place of the running
    ones (the seeded served trunk's recipe: measured layer by layer)."""
    shape = (1, -1, 1, 1)
    if train or calibrate:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if calibrate:
            with torch.no_grad():
                p[f"{name}.running_mean"].copy_(mean)
                p[f"{name}.running_var"].copy_(var)
        if train and state is not None:
            with torch.no_grad():
                state[f"{name}.running_mean"] = (MOMENTUM * p[f"{name}.running_mean"]
                                                 + (1 - MOMENTUM) * mean)
                state[f"{name}.running_var"] = (MOMENTUM * p[f"{name}.running_var"]
                                                + (1 - MOMENTUM) * var)
        mul = torch.rsqrt(var + EPS) * p[f"{name}.weight"]
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + p[f"{name}.bias"].reshape(shape)
        return y.to(dtype)
    mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    mul = torch.rsqrt(var + EPS) * p[f"{name}.weight"]
    y = ((x.to(torch.float32) - mean.reshape(shape)) * mul.reshape(shape)
         + p[f"{name}.bias"].reshape(shape))
    return y.to(dtype)


def trunk(p: Dict[str, torch.Tensor], x: torch.Tensor, stage_sizes=(3, 4, 6, 3),
          train: bool = False, dtype: torch.dtype = torch.float32,
          state: Optional[Dict[str, torch.Tensor]] = None, calibrate: bool = False,
          quantize=None) -> torch.Tensor:
    """(B, H, W, 3) normalised pixels -> (B, 2048) float32 pooled features.
    ``quantize``: a function applied to every conv's input and weight (the
    lower-precision control)."""
    q = quantize or (lambda t: t)

    def conv(name, y, stride=1, padding=0):
        return F.conv2d(q(y), q(p[f"{name}.weight"].to(dtype)), stride=stride,
                        padding=padding)

    def bn(name, y):
        return batch_norm(p, name, y, train, dtype, state, calibrate)

    y = x.to(dtype).permute(0, 3, 1, 2)
    y = torch.relu(bn("bn1", conv("conv1", y, 2, 3)))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    for name, _, stride, down in blocks(stage_sizes):
        h = torch.relu(bn(f"{name}.bn1", conv(f"{name}.conv1", y)))
        h = torch.relu(bn(f"{name}.bn2", conv(f"{name}.conv2", h, stride, 1)))
        h = bn(f"{name}.bn3", conv(f"{name}.conv3", h))
        res = bn(f"{name}.down_bn", conv(f"{name}.down_conv", y, stride)) if down else y
        y = torch.relu(h + res)
    return y.to(torch.promote_types(y.dtype, torch.float32)).mean(dim=(2, 3))


def classifier(p: Dict[str, torch.Tensor], x: torch.Tensor, stage_sizes=(3, 4, 6, 3),
               train: bool = True, state: Optional[Dict[str, torch.Tensor]] = None):
    """The fine-tuning classifier: (B, 1) logits. ``p`` holds "trunk.*",
    "fc1.*", "fc2.*"; moved running statistics land in ``state`` under the
    same names."""
    tp = {k[len("trunk."):]: v for k, v in p.items() if k.startswith("trunk.")}
    ts = {} if state is not None else None
    f = trunk(tp, x, stage_sizes, train=train, state=ts)
    if state is not None:
        state.update({f"trunk.{k}": v for k, v in ts.items()})
    h = torch.relu(F.linear(f, p["fc1.weight"], p["fc1.bias"]))
    return F.linear(h, p["fc2.weight"], p["fc2.bias"])


def bce_masked(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits over the rows ``mask`` keeps."""
    z = logits.reshape(-1)
    y = labels.reshape(-1).to(z.dtype)
    per = -(y * F.logsigmoid(z) + (1.0 - y) * F.logsigmoid(-z))
    m = mask.reshape(-1).to(z.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1e-12)
