"""Shared model building blocks (port of ``med_tpu.models.layers``).

Sequence tensors are channel-last ``(B, T, C)``, as in the JAX package.
Every parameterised module names its flax counterpart's layout in
``flax_layout`` ("dense", "conv", "norm", "batchnorm" or "stack"), which is all that
:mod:`med_tpu_torch.utils.jax_params` needs to carry weights between the two.

Parameters are created as zeros (norm scales as ones): serving loads its
weights, and :func:`init_weights` draws fresh ones from an explicit
``torch.Generator`` with the reference's torch-default scheme,
U(±1/sqrt(fan_in)).

``dtype`` (None or ``torch.bfloat16``) is the compute type of the convs and
stacks, as in the JAX package: parameters stay float32 and are cast, with
the input, at each op. The TCN kernels take float32 alone, so a stack in
bfloat16 runs the plain layer loop of ``med_tpu``'s unfused stack: the
model picks it by its dtype, never a kernel wrapper.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.tcn_fused import dilated_residual_stack
from ..parallel import comm


def _uniform_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    draw = torch.rand(p.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        p.copy_(draw * (2 * bound) - bound)


def ln0(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free layer norm over the feature axis of a feature-major
    (d, N) tensor (the packed attention layout), or of each (d, N) of a
    (B, d, N) batch: axis -2."""
    mean = x.mean(dim=-2, keepdim=True)
    var = (x - mean).square().mean(dim=-2, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def keep_scale(rate: float) -> float:
    """The factor of an element that dropout at ``rate`` keeps, 1 / (1 -
    rate), as med_tpu's ResidualStack computes it (1.0 at rate 0; the
    kernels and the plain versions take it in float32). A rate outside
    [0, 1) raises ValueError, where med_tpu would divide by zero at 1."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"a dropout rate lies in [0, 1); got {rate}")
    return 1.0 / (1.0 - rate)


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
                 dilation: int = 1, padding="VALID", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size, self.dilation, self.dtype = kernel_size, dilation, dtype
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
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        left, right = self.pad
        if left or right:
            x = F.pad(x, (0, 0, left, right))
        t_out = x.shape[1] - d * (k - 1)
        y = x[:, :t_out] @ w[:, :, 0].T
        for j in range(1, k):
            y = y + x[:, j * d: j * d + t_out] @ w[:, :, j].T
        if b is not None:
            y = y + b
        return y


def batch_moments(x: torch.Tensor, clip: bool = True, group=None):
    """flax's training statistics of ``x`` over every axis but 1: the mean
    and the variance E[x²] − E[x]², clipped at 0 as ``nn.BatchNorm`` clips it
    (``med_tpu``'s ghost-batch ``SubsampledBatchNorm`` does not). ``group``:
    the ranks whose rows make up the batch, or None for a whole batch."""
    dims = [d for d in range(x.dim()) if d != 1]
    if group is not None:
        # a data-parallel batch: the global moments (parallel/comm.py)
        mean, sq = comm.global_moments(x, dims, group)
        var = sq - mean * mean
        return mean, torch.clamp(var, min=0.0) if clip else var
    mean = x.mean(dim=dims)
    var = (x * x).mean(dim=dims) - mean * mean
    return mean, torch.clamp(var, min=0.0) if clip else var


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9)`` over axis 1 of (B, C) or
    (B, C, L): statistics over every other axis. Neither ``nn.BatchNorm1d``
    nor ``F.batch_norm`` gives flax's numbers in training, so the arithmetic
    is flax's own:

    - training normalises by the batch's mean and its variance E[x²] − E[x]²
      clipped at 0, as (x − mean) · (rsqrt(var + eps) · scale) + bias, and
      moves the running statistics to 0.9 · running + 0.1 · batch, the
      variance the batch's **biased** one (torch takes the unbiased);
    - eval normalises by the running statistics.

    Params weight/bias, buffers running_mean/running_var (flax's ``scale``,
    ``bias`` and ``batch_stats`` ``mean``, ``var``). ``stats_group``: the
    process group whose ranks hold the rows of a data-parallel batch
    between them, over which training statistics are taken (set by
    ``parallel.mesh.shard_state``); None for a whole batch."""

    flax_layout = "batchnorm"

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.stats_group = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def batch_statistics(self, x):
        """The batch's mean and variance in training (flax's, clipped)."""
        return batch_moments(x, group=self.stats_group)

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            mean, var = self.batch_statistics(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ResidualStack(nn.Module):
    """``num_layers`` dilated residual layers (dilation 2^i) over (B, T, C),
    weights stacked per stage: w3 (L, 3, C, C), b3 (L, C), w1 (L, C, C),
    b1 (L, C) — the layout the TCN kernel takes. Training passes a dropout
    keep-mask drawn at ``dropout_rate`` (0.5 by default, as med_tpu's), and
    a kept element is scaled by 1 / (1 - rate), in the kernel in float32.
    In float32 each trial's stack is one call of the kernel; with a
    ``dtype`` the whole batch runs the plain layer loop in that type (see
    the module docstring)."""

    flax_layout = "stack"

    def __init__(self, num_layers: int, channels: int, causal: bool = True,
                 dtype: Optional[torch.dtype] = None, dropout_rate: float = 0.5):
        super().__init__()
        keep_scale(dropout_rate)        # raises outside [0, 1)
        L, C = num_layers, channels
        self.causal, self.dtype, self.dropout_rate = causal, dtype, dropout_rate
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

    def dropout_mask(self, B: int, T: int, generator: torch.Generator,
                     rate: Optional[float] = None) -> Optional[torch.Tensor]:
        """The (L, B, T, C) uint8 keep-mask of one training forward at
        ``rate`` (the stack's ``dropout_rate`` unless given), drawn from
        ``generator`` on the model's device; None at rate 0. At 0.5 one
        random bit per element, unpacked along T: element t takes bit t % 32
        of word t // 32, as med_tpu's ResidualStack.dropout_mask does; at
        any other rate a Bernoulli(1 - rate) draw, contiguous uint8 as the
        kernels read it."""
        rate = self.dropout_rate if rate is None else rate
        keep_scale(rate)                # raises outside [0, 1)
        if rate == 0.0:
            return None
        L, C = self.w3.shape[0], self.w3.shape[-1]
        if rate != 0.5:
            u = torch.rand((L, B, T, C), generator=generator, device=self.w3.device)
            return (u < 1.0 - rate).to(torch.uint8)
        tw = (T + 31) // 32
        words = torch.randint(0, 2 ** 32, (L, B, tw, 1, C), generator=generator,
                              device=self.w3.device, dtype=torch.int64)
        shifts = torch.arange(32, device=self.w3.device).reshape(1, 1, 1, 32, 1)
        bits = ((words >> shifts) & 1).to(torch.uint8)
        return bits.reshape(L, B, tw * 32, C)[:, :, :T].contiguous()

    def forward(self, x, mask=None, rate: Optional[float] = None):
        """x (B, T, C); ``mask`` the (L, B, T, C) keep-mask, or None (eval),
        drawn at ``rate`` (the stack's ``dropout_rate`` unless given)."""
        if self.dtype is not None:
            return self._layers_in(self.dtype, x, mask,
                                   keep_scale(self.dropout_rate if rate is None else rate))
        return torch.stack(self.trials(x, mask, rate))

    def trials(self, x, mask=None, rate: Optional[float] = None):
        """The stack over x (B, T, C), or over its B trials (T, C): each
        trial's (T, C) output. In float32 one kernel launch a trial; with a
        ``dtype`` the layer loop over the batch."""
        if self.dtype is not None:
            return list(self(torch.stack(list(x)), mask, rate).unbind(0))
        scale = keep_scale(self.dropout_rate if rate is None else rate)
        return [dilated_residual_stack(xb, *self.weights(), causal=self.causal, scale=scale,
                                       mask=None if mask is None else mask[:, b].contiguous())
                for b, xb in enumerate(x)]

    def _layers_in(self, dtype: torch.dtype, x, mask, scale: float):
        """med_tpu's unfused stack (layers.py ResidualStack.__call__), every
        op in ``dtype``: per layer the three dilated taps summed, relu, the
        1x1 conv, dropout (a kept element times ``scale``), the residual
        add."""
        w3, b3, w1, b1 = (t.to(dtype) for t in self.weights())
        x = x.to(dtype)
        T = x.shape[1]
        for i in range(w3.shape[0]):
            d = 2 ** i
            xp = F.pad(x, (0, 0, 2 * d, 0) if self.causal else (0, 0, d, d))
            y = xp[:, :T] @ w3[i, 0]
            for j in (1, 2):
                y = y + xp[:, j * d: j * d + T] @ w3[i, j]
            y = torch.relu(y + b3[i]) @ w1[i] + b1[i]
            if mask is not None:
                y = y * mask[i].to(dtype) * scale
            x = x + y
        return x


class SingleStageTCN(nn.Module):
    """One MS-TCN stage: conv1x1 in -> dilated residual stack -> conv1x1 out.
    Returns (features, logits); the logits are float32 in any ``dtype``
    (float64 for a float64 stage)."""

    def __init__(self, num_layers: int, in_dim: int, f_maps: int,
                 out_classes: int, causal: bool = True,
                 dtype: Optional[torch.dtype] = None, dropout_rate: float = 0.5):
        super().__init__()
        self.conv_in = Conv1d(in_dim, f_maps, dtype=dtype)
        self.stack = ResidualStack(num_layers, f_maps, causal=causal, dtype=dtype,
                                   dropout_rate=dropout_rate)
        self.conv_out = Conv1d(f_maps, out_classes, dtype=dtype)

    def forward(self, x, mask=None, rate: Optional[float] = None):
        """x (B, T, in_dim); ``mask`` the stack's (L, B, T, C) keep-mask in
        training, or None, drawn at ``rate`` (the stack's ``dropout_rate``
        unless given) -> (features, logits)."""
        out = self.stack(self.conv_in(x), mask, rate)
        logits = self.conv_out(out)
        # float32 logits from a bf16 stage; a float64 stage keeps float64
        return out, logits.to(torch.promote_types(logits.dtype, torch.float32))
