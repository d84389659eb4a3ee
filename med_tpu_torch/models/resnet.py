"""ResNet-50 trunk and its fine-tuning classifier (port of
``med_tpu.models.resnet``).

torchvision's ResNet-v1.5 (stride 2 in the 3x3 conv) sized by the (3, 4, 6,
3) bottleneck stages: (B, H, W, 3) NHWC pixels in, (B, 2048) pooled fp32
features out, NCHW inside (with channels-last strides, so the convolutions
keep NHWC memory). Module names follow the flax tree ("layer1_0.conv1",
"layer1_0.down_bn"; "trunk.*", "fc1", "fc2" in the classifier), so
:mod:`med_tpu_torch.utils.jax_params` carries a ``med_tpu`` checkpoint's
``params`` and ``batch_stats`` straight onto the ``state_dict``.

BatchNorm (eps 1e-5) runs on its running statistics at inference and, with
``train=True``, on the batch's, with flax's arithmetic
(:class:`.layers.BatchNorm`: variance E[x²] − E[x]² clipped at 0, running
statistics 0.9 · old + 0.1 · batch with the biased variance). With
``bn_stat_stride`` > 1 the training statistics come from the first
B // stride images alone and the variance is not clipped, as
``med_tpu``'s ghost-batch ``SubsampledBatchNorm``; normalisation still
covers every image. ``dtype`` is the compute dtype (float32, or bfloat16
for serving); parameters stay fp32. The rounding follows flax: a conv
rounds its output to ``dtype``; BatchNorm normalises in fp32 and rounds
once; the residual sum and relu run in ``dtype``; the pool is fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers

# the trunk's and head's relu and the stem's max pool, looked up at each
# call: a card-vs-CPU or float32-vs-float64 check can pin the relu's
# derivative pattern and the pool's choices (a pre-activation within
# rounding of 0, or two values of a window within rounding of each other,
# route one pixel's gradient term elsewhere)
relu = torch.relu


def max_pool(x):
    return F.max_pool2d(x, 3, stride=2, padding=1)


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


class BatchNorm(layers.BatchNorm):
    """BatchNorm over the channel axis of NCHW: flax's, in training on the
    batch's statistics (or the first B // ``stat_stride`` images', not
    clipped: ``SubsampledBatchNorm``), at inference on the running ones,
    rounded to ``dtype``. Params weight/bias, buffers
    running_mean/running_var (the flax ``scale``/``bias`` params and
    ``mean``/``var`` batch stats)."""

    def __init__(self, channels: int, dtype=torch.float32, eps: float = 1e-5,
                 stat_stride: int = 1):
        super().__init__(channels, momentum=0.9, eps=eps)
        self.dtype, self.stat_stride = dtype, stat_stride

    def batch_statistics(self, x):
        if self.stat_stride == 1:
            return super().batch_statistics(x)
        return layers.batch_moments(x[: max(1, x.shape[0] // self.stat_stride)], clip=False)

    def forward(self, x, train: bool = False):
        if train:
            # statistics and normalisation in fp32 (float64 for a float64
            # reference), one rounding to dtype
            wide = torch.promote_types(x.dtype, torch.float32)
            return super().forward(x.to(wide), True).to(self.dtype)
        # flax _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias,
        # in fp32 from a dtype input, one rounding to dtype; F.batch_norm
        # with fp32 statistics computes it in one pass (in fp32 for a bf16
        # input, returning bf16)
        return F.batch_norm(x.to(self.dtype), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32, bn_stat_stride: int = 1):
        super().__init__()

        def bn(channels):
            return BatchNorm(channels, dtype, stat_stride=bn_stat_stride)

        self.conv1 = Conv2d(in_features, features, 1)
        self.bn1 = bn(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1)
        self.bn2 = bn(features)
        self.conv3 = Conv2d(features, 4 * features, 1)
        self.bn3 = bn(4 * features)
        if downsample:
            self.down_conv = Conv2d(in_features, 4 * features, 1, stride=stride)
            self.down_bn = bn(4 * features)
        else:
            self.down_conv = None

    def forward(self, x, train: bool = False):
        y = relu(self.bn1(self.conv1(x), train))
        y = relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x), train)
        return relu(y + residual)


class ResNet50(nn.Module):
    """Feature trunk: (B, H, W, 3) -> (B, 4 * width * 8) pooled features."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype=torch.float32, bn_stat_stride: int = 1):
        super().__init__()
        self.stage_sizes, self.dtype = tuple(stage_sizes), dtype
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3)
        self.bn1 = BatchNorm(width, dtype, stat_stride=bn_stat_stride)
        cin = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"layer{stage + 1}_{block}", Bottleneck(
                    cin, features, stride, downsample=(block == 0), dtype=dtype,
                    bn_stat_stride=bn_stat_stride))
                cin = 4 * features
        self.out_features = cin

    def forward(self, x, train: bool = False):
        y = x.to(self.dtype).permute(0, 3, 1, 2)
        y = relu(self.bn1(self.conv1(y), train))
        y = max_pool(y)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{block}")(y, train)
        # pool in fp32 for a stable feature scale (float64 stays float64)
        return y.to(torch.promote_types(y.dtype, torch.float32)).mean(dim=(2, 3))


class ResNetClassifier(nn.Module):
    """The trunk and the reference's fine-tuning head, 2048 -> 512 -> relu ->
    ``n_classes`` (resnet_finetuning.ipynb cell 7): logits (B, n_classes).
    :meth:`features` is the trunk alone, the head swapped for the identity
    as the feature export does."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 n_classes: int = 1, dtype=torch.float32, bn_stat_stride: int = 1):
        super().__init__()
        self.trunk = ResNet50(stage_sizes, width, dtype, bn_stat_stride)
        self.fc1 = layers.Dense(self.trunk.out_features, 512)
        self.fc2 = layers.Dense(512, n_classes)

    def features(self, x, train: bool = False):
        return self.trunk(x, train)

    def forward(self, x, train: bool = False):
        return self.fc2(relu(self.fc1(self.trunk(x, train))))


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
