"""ResNet-50 trunk at inference (port of ``med_tpu.models.resnet``).

torchvision's ResNet-v1.5 (stride 2 in the 3x3 conv) sized by the (3, 4, 6,
3) bottleneck stages: (B, H, W, 3) NHWC pixels in, (B, 2048) pooled fp32
features out, NCHW inside (with channels-last strides, so the convolutions
keep NHWC memory). Module names follow the flax tree ("layer1_0.conv1",
"layer1_0.down_bn"), so :mod:`med_tpu_torch.utils.jax_params` carries a
``med_tpu`` checkpoint's ``params`` and ``batch_stats`` straight onto the
``state_dict``.

BatchNorm runs on its running statistics only (eps 1e-5). ``dtype`` is the
compute dtype (float32, or bfloat16 for serving); parameters stay fp32. The
rounding follows flax: a conv rounds its output to ``dtype``; BatchNorm
normalises the ``dtype`` input in fp32 and rounds once; the residual sum
and relu run in ``dtype``; the pool is fp32. Train-mode and ghost-batch
BatchNorm and the classifier head wait for the fine-tune slice (ROADMAP.md
Queue A10).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Module):
    """A bias-free 2-D convolution, weight (O, I, kh, kw) as in
    ``nn.Conv2d``; its flax counterpart is an ``nn.Conv`` with kernel
    (kh, kw, I, O)."""

    flax_layout = "conv2d"

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(features, in_features, kernel_size,
                                               kernel_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming normal over fan-out, as the JAX package's init."""
        o, _, kh, kw = self.weight.shape
        std = math.sqrt(2.0 / (o * kh * kw))
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * std)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                        padding=self.padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the channel axis of NCHW, on the running
    statistics; params weight/bias, buffers running_mean/running_var (the
    flax ``scale``/``bias`` params and ``mean``/``var`` batch stats)."""

    flax_layout = "batchnorm"

    def __init__(self, channels: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        # flax _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias,
        # in fp32 from a dtype input, one rounding to dtype; F.batch_norm
        # with fp32 statistics computes it in one pass (in fp32 for a bf16
        # input, returning bf16)
        return F.batch_norm(x.to(self.dtype), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 1)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm(features, dtype)
        self.conv3 = Conv2d(features, 4 * features, 1)
        self.bn3 = BatchNorm(4 * features, dtype)
        if downsample:
            self.down_conv = Conv2d(in_features, 4 * features, 1, stride=stride)
            self.down_bn = BatchNorm(4 * features, dtype)
        else:
            self.down_conv = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """Feature trunk: (B, H, W, 3) -> (B, 4 * width * 8) pooled features."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.stage_sizes, self.dtype = tuple(stage_sizes), dtype
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3)
        self.bn1 = BatchNorm(width, dtype)
        cin = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"layer{stage + 1}_{block}", Bottleneck(
                    cin, features, stride, downsample=(block == 0), dtype=dtype))
                cin = 4 * features

    def forward(self, x):
        y = x.to(self.dtype).permute(0, 3, 1, 2)
        y = torch.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{block}")(y)
        # pool in fp32 for a stable feature scale
        return y.to(torch.float32).mean(dim=(2, 3))


def import_torchvision_resnet50(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A torchvision resnet50 state_dict (tensors or numpy arrays) -> the
    state_dict of :class:`ResNet50`: "layer1.0.conv1.weight" becomes
    "layer1_0.conv1.weight", "downsample.0"/"downsample.1" become
    "down_conv"/"down_bn"; the fc head and ``num_batches_tracked`` are
    dropped (the trunk ends at the pool, as the reference's fc->Identity)."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        if parts[0].startswith("layer"):
            parts = [f"{parts[0]}_{parts[1]}", *parts[2:]]
            if parts[1] == "downsample":
                parts = [parts[0], {"0": "down_conv", "1": "down_bn"}[parts[2]], *parts[3:]]
        t = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(np.asarray(value))
        out[".".join(parts)] = t.to(torch.float32)
    return out


def load_pretrained_trunk(path: str) -> Dict[str, torch.Tensor]:
    """torchvision-format resnet50 weights from a torch ``.pth``/``.pt`` file
    or an ``.npz`` of the same keys -> the :class:`ResNet50` state_dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return import_torchvision_resnet50(sd)
