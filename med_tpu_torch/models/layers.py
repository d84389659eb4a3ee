"""Shared model building blocks (port of ``med_tpu.models.layers``).

Sequence tensors are channel-last ``(B, T, C)``, as in the JAX package.
Every parameterised module names its flax counterpart's layout in
``flax_layout`` ("dense", "conv", "norm" or "stack"), which is all that
:mod:`med_tpu_torch.utils.jax_params` needs to carry weights between the two.

Parameters are created as zeros (norm scales as ones): serving loads its
weights, and :func:`init_weights` draws fresh ones from an explicit
``torch.Generator`` with the reference's torch-default scheme,
U(±1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.tcn_fused import dilated_residual_stack


def _uniform_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    draw = torch.rand(p.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        p.copy_(draw * (2 * bound) - bound)


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``net`` from ``generator``, in module order."""
    for module in net.modules():
        if hasattr(module, "flax_layout"):
            module.reset_parameters(generator)
    return net


class Dense(nn.Module):
    """A linear layer, weight (out, in) as in ``nn.Linear``; its flax
    counterpart is an ``nn.Dense`` with kernel (in, out)."""

    flax_layout = "dense"

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            _uniform_(self.bias, self.weight.shape[1], generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv1d(nn.Module):
    """1-D convolution on (B, T, C) as shifted matmuls, one per tap (the JAX
    package's tap form). Weight (O, I, K) as in ``nn.Conv1d``; its flax
    counterpart is ``Conv_0`` with kernel (K, I, O)."""

    flax_layout = "conv"

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, padding="VALID", use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        if padding == "VALID":
            self.pad = (0, 0)
        elif padding == "SAME":
            total = dilation * (kernel_size - 1)
            self.pad = (total // 2, total - total // 2)
        else:
            self.pad = tuple(padding[0])
        self.weight = nn.Parameter(torch.zeros(features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.kernel_size
        _uniform_(self.weight, fan_in, generator)
        if self.bias is not None:
            _uniform_(self.bias, fan_in, generator)

    def forward(self, x):
        k, d = self.kernel_size, self.dilation
        left, right = self.pad
        if left or right:
            x = F.pad(x, (0, 0, left, right))
        t_out = x.shape[1] - d * (k - 1)
        y = x[:, :t_out] @ self.weight[:, :, 0].T
        for j in range(1, k):
            y = y + x[:, j * d: j * d + t_out] @ self.weight[:, :, j].T
        if self.bias is not None:
            y = y + self.bias
        return y


class ResidualStack(nn.Module):
    """``num_layers`` dilated residual layers (dilation 2^i) over (B, T, C),
    weights stacked per stage: w3 (L, 3, C, C), b3 (L, C), w1 (L, C, C),
    b1 (L, C) — the layout the TCN kernel takes. Training passes a dropout
    keep-mask (rate 0.5, scale 2.0 in the kernel)."""

    flax_layout = "stack"

    def __init__(self, num_layers: int, channels: int, causal: bool = True):
        super().__init__()
        L, C = num_layers, channels
        self.causal = causal
        self.w3 = nn.Parameter(torch.zeros(L, 3, C, C))
        self.b3 = nn.Parameter(torch.zeros(L, C))
        self.w1 = nn.Parameter(torch.zeros(L, C, C))
        self.b1 = nn.Parameter(torch.zeros(L, C))

    def reset_parameters(self, generator: torch.Generator) -> None:
        C = self.w3.shape[-1]
        for p, fan_in in ((self.w3, 3 * C), (self.b3, 3 * C),
                          (self.w1, C), (self.b1, C)):
            _uniform_(p, fan_in, generator)

    def weights(self):
        return self.w3, self.b3, self.w1, self.b1

    def dropout_mask(self, B: int, T: int, generator: torch.Generator) -> torch.Tensor:
        """The (L, B, T, C) uint8 Bernoulli(0.5) keep-mask of one training
        forward, drawn from ``generator`` (on the model's device). One random
        bit per element, unpacked along T: element t takes bit t % 32 of word
        t // 32, as med_tpu's ResidualStack.dropout_mask does."""
        L, C = self.w3.shape[0], self.w3.shape[-1]
        tw = (T + 31) // 32
        words = torch.randint(0, 2 ** 32, (L, B, tw, 1, C), generator=generator,
                              device=self.w3.device, dtype=torch.int64)
        shifts = torch.arange(32, device=self.w3.device).reshape(1, 1, 1, 32, 1)
        bits = ((words >> shifts) & 1).to(torch.uint8)
        return bits.reshape(L, B, tw * 32, C)[:, :, :T].contiguous()

    def forward(self, x, mask=None):
        """x (B, T, C); ``mask`` the (L, B, T, C) keep-mask, or None (eval)."""
        return torch.stack([
            dilated_residual_stack(xb, *self.weights(), causal=self.causal,
                                   mask=None if mask is None else mask[:, b].contiguous())
            for b, xb in enumerate(x)
        ])


class SingleStageTCN(nn.Module):
    """One MS-TCN stage: conv1x1 in -> dilated residual stack -> conv1x1 out.
    Returns (features, logits)."""

    def __init__(self, num_layers: int, in_dim: int, f_maps: int,
                 out_classes: int, causal: bool = True):
        super().__init__()
        self.conv_in = Conv1d(in_dim, f_maps)
        self.stack = ResidualStack(num_layers, f_maps, causal=causal)
        self.conv_out = Conv1d(f_maps, out_classes)

    def forward(self, x):
        out = self.stack(self.conv_in(x))
        return out, self.conv_out(out)
