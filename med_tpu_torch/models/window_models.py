"""Window-level classifiers: the 1-D CNN, the LSTM and their siamese twins
(port of ``med_tpu.models.window_models``; reference MED/modeling/models.py).

Inputs are (B, W, F) windows, feature-last as in the JAX package. The convs
and the recurrence are library calls, as XLA computes them in ``med_tpu``
(no Pallas kernel serves this path): each conv a sum of shifted cuBLAS
matmuls, one a tap (the frame path's tap form), and the LSTM PyTorch's own
CUDA LSTM. Both keep float32's digits where cuDNN's conv algorithms and
RNN lose about one and two of a twin's or an LSTM's gradients
(chip_smoke.py's window phase logs them beside the port's).

Each model splits into ``features`` (the siamese branch embedding) and
``classify``, and takes its dropout as explicit keep-masks (``masks=``, in
flax's layout and in the order the forward applies them) or draws them from
a ``generator`` with :meth:`dropout_masks`. The traps the parity tests pin:

- BatchNorm is flax's (:class:`.layers.BatchNorm`), in training over the
  whole padded batch;
- the LSTM has one bias a gate, on the recurrent side, as flax's
  ``OptimizedLSTMCell``; each layer is one ``torch.lstm`` call with a zero
  input-side bias that is not a parameter, so its gradient is not counted
  twice;
- the CNN keeps ``med_tpu``'s (B, L, C) layout through its convs and
  flattens its output L-major, so ``dense0`` takes ``med_tpu``'s kernel
  unchanged (pooling and BatchNorm run on channels-first views).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv1d, Dense

DROP_RATE = 0.2


def _keep_masks(shapes, generator: torch.Generator, device) -> List[torch.Tensor]:
    """Bernoulli(1 - DROP_RATE) keep-masks of the given shapes."""
    return [torch.rand(s, generator=generator, device=device) >= DROP_RATE
            for s in shapes]


def _dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.Dropout``: kept entries scaled by 1/keep_prob, others 0."""
    keep = keep.to(device=x.device, dtype=torch.bool)
    return torch.where(keep, x / (1.0 - DROP_RATE), torch.zeros_like(x))


def _masks_for(module, masks, B: int, generator):
    if masks is not None:
        return masks
    if generator is None:
        raise ValueError("a training forward needs dropout masks or a generator")
    return module.dropout_masks(B, generator)


class XavierDense(Dense):
    """A head layer: flax's ``nn.Dense(kernel_init=xavier_normal)``, a
    truncated normal of variance 1/fan_avg, and a zero bias."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        out, inp = self.weight.shape
        std = math.sqrt(2.0 / (inp + out)) / 0.87962566103423978
        draw = torch.empty(self.weight.shape)      # on the CPU, as the generator
        nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
        with torch.no_grad():
            self.weight.copy_(draw)
            self.bias.zero_()


class WindowConv(Conv1d):
    """flax's ``nn.Conv(3, padding="VALID")`` named in place (its kernel (K,
    I, O) at ``convI/kernel``), on (B, L, C) in the tap form: weight (O, I,
    K), kaiming normal over the fan-out, bias U(±1/sqrt(I·K))."""

    flax_layout = "conv1d"

    def __init__(self, in_features: int, features: int, kernel_size: int = 3):
        super().__init__(in_features, features, kernel_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, k = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                              * math.sqrt(2.0 / (o * k)))
            bound = 1.0 / math.sqrt(i * k)
            self.bias.copy_(torch.rand(o, generator=generator) * (2 * bound) - bound)


class LSTMLayer(nn.Module):
    """One layer of flax's ``nn.RNN(OptimizedLSTMCell(H))`` over (B, T, I),
    from zero state: w_ih (4H, I) and w_hh (4H, H) in gate order i, f, g, o
    (torch's and flax's), one bias b (4H) a gate. All U(±1/sqrt(H))."""

    flax_layout = "lstm"

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.w_ih = nn.Parameter(torch.zeros(4 * H, in_features))
        self.w_hh = nn.Parameter(torch.zeros(4 * H, H))
        self.b = nn.Parameter(torch.zeros(4 * H))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.w_hh.shape[1])
        with torch.no_grad():
            for p in (self.w_ih, self.w_hh, self.b):
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    # set by a fold-parallel runner (parallel/folds.py): the recurrence as
    # plain matmuls and pointwise ops, which torch.func.vmap batches over
    # folds (torch.lstm has no batching rule)
    unrolled = False

    def forward(self, x):
        if self.unrolled:
            return self._unrolled(x)
        B, H = x.shape[0], self.w_hh.shape[1]
        h0 = torch.zeros(1, B, H, dtype=x.dtype, device=x.device)
        zero = torch.zeros_like(self.b)       # the input side has no bias
        # PyTorch's own CUDA LSTM (cuBLAS GEMMs, a fused cell kernel a step),
        # not cuDNN's: on an H100 at the CLI's shapes cuDNN's fp32 RNN sits
        # 2.8e-5 of a gradient leaf's largest from float64, against 4.7e-6
        # here (chip_smoke.py's window phase); its backward is recorded with it
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            out, _, _ = torch.lstm(x, (h0, h0), [self.w_ih, self.w_hh, zero, self.b],
                                   True, 1, 0.0, torch.is_grad_enabled(), False, True)
        return out

    def _unrolled(self, x):
        """The same LSTM, one step at a time: gates x W_ih^T + h W_hh^T + b,
        in the order i, f, g, o."""
        xi = x @ self.w_ih.T
        h = c = None
        outs = []
        for t in range(x.shape[1]):
            gates = xi[:, t] + self.b if h is None else xi[:, t] + h @ self.w_hh.T + self.b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = (torch.sigmoid(i) * torch.tanh(g) if c is None
                 else torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class Head(nn.Module):
    """Dense -> ReLU -> BatchNorm stack, then a linear classifier
    (``med_tpu``'s ``_Head``; reference models.py:102-111, :177-184)."""

    def __init__(self, in_features: int, dims: Sequence[int], n_classes: int):
        super().__init__()
        sizes = [in_features, *dims]
        for i, d in enumerate(dims):
            self.add_module(f"dense{i}", XavierDense(sizes[i], d))
            self.add_module(f"bn{i}", BatchNorm(d))
        self.n_hidden = len(dims)
        self.out = XavierDense(sizes[-1], n_classes)

    def forward(self, x, train: bool = False):
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"dense{i}")(x))
            x = getattr(self, f"bn{i}")(x, train)
        return self.out(x)


class WindowCNN(nn.Module):
    """2 or 3 blocks of conv(k=3, valid) -> maxpool(2, 2) -> dropout(0.2) ->
    BatchNorm, then the Dense 256-32-16 head (reference models.py:49-131).
    Channels (64, 128) for window 10, (64, 128, 256) otherwise."""

    def __init__(self, in_features: int = 58, window_size: int = 10, n_classes: int = 1):
        super().__init__()
        self.channels: Tuple[int, ...] = (64, 128) if window_size == 10 else (64, 128, 256)
        fan = [in_features, *self.channels]
        self.lengths = []                  # each block's pooled length
        L = window_size
        for i, ch in enumerate(self.channels):
            self.add_module(f"conv{i}", WindowConv(fan[i], ch))
            self.add_module(f"bn{i}", BatchNorm(ch))
            L = (L - 2) // 2
            self.lengths.append(L)
        self.head = Head(L * self.channels[-1], (256, 32, 16), n_classes)

    def dropout_masks(self, B: int, generator: torch.Generator) -> List[torch.Tensor]:
        """One forward's keep-masks, a block each, (B, L_i, C_i) as flax
        lays the block's output out."""
        return _keep_masks([(B, L, C) for L, C in zip(self.lengths, self.channels)],
                           generator, self.conv0.weight.device)

    def features(self, x, train: bool = False, masks=None, generator=None):
        """(B, W, F) -> the flattened conv-stack output (B, L·C), L-major."""
        if train:
            masks = _masks_for(self, masks, x.shape[0], generator)
        for i in range(len(self.channels)):
            y = F.max_pool1d(getattr(self, f"conv{i}")(x).transpose(1, 2), 2, 2)
            if train:
                y = _dropout(y, masks[i].transpose(1, 2))
            x = getattr(self, f"bn{i}")(y, train).transpose(1, 2)
        return x.reshape(x.shape[0], -1)

    def classify(self, f, train: bool = False):
        return self.head(f, train)

    def forward(self, x, train: bool = False, masks=None, generator=None):
        return self.classify(self.features(x, train, masks, generator), train)


class WindowLSTM(nn.Module):
    """A stack of LSTM layers (hidden 128, dropout 0.2 between layers), ReLU,
    the last time step into the Dense 256-64 head (reference
    models.py:135-220)."""

    def __init__(self, in_features: int = 58, window_size: int = 10,
                 hidden_size: int = 128, num_layers: int = 3, n_classes: int = 1):
        super().__init__()
        self.window_size, self.hidden_size, self.num_layers = (
            window_size, hidden_size, num_layers)
        for layer in range(num_layers):
            self.add_module(f"lstm{layer}",
                            LSTMLayer(in_features if layer == 0 else hidden_size,
                                      hidden_size))
        self.head = Head(hidden_size, (256, 64), n_classes)

    def dropout_masks(self, B: int, generator: torch.Generator) -> List[torch.Tensor]:
        """One forward's keep-masks, (B, W, H) after each layer but the last."""
        shape = (B, self.window_size, self.hidden_size)
        return _keep_masks([shape] * (self.num_layers - 1), generator,
                           self.lstm0.w_ih.device)

    def features(self, x, train: bool = False, masks=None, generator=None):
        """(B, W, F) -> the ReLU'd last hidden state (B, H)."""
        if train:
            masks = _masks_for(self, masks, x.shape[0], generator)
        for layer in range(self.num_layers):
            x = getattr(self, f"lstm{layer}")(x)
            if train and layer < self.num_layers - 1:
                x = _dropout(x, masks[layer])
        return torch.relu(x)[:, -1, :]

    def classify(self, f, train: bool = False):
        return self.head(f, train)

    def forward(self, x, train: bool = False, masks=None, generator=None):
        return self.classify(self.features(x, train, masks, generator), train)


class _Siamese(nn.Module):
    """Shared-weight twins: |f(x1) - f(x2)| through the branch's head, one
    similarity logit (reference models.py:223-312). The branch runs x1, then
    x2, so its BatchNorm statistics move twice a training forward, in that
    order, and the head's once. ``masks``: (x1's, x2's)."""

    branch: nn.Module

    def dropout_masks(self, B: int, generator: torch.Generator):
        return (self.branch.dropout_masks(B, generator),
                self.branch.dropout_masks(B, generator))

    def forward(self, x1, x2, train: bool = False, masks=None, generator=None):
        if train:
            masks = _masks_for(self, masks, x1.shape[0], generator)
        m1, m2 = masks if train else (None, None)
        f1 = self.branch.features(x1, train, m1, generator)
        f2 = self.branch.features(x2, train, m2, generator)
        return self.branch.classify(torch.abs(f1 - f2), train)


class SiameseCNN(_Siamese):
    def __init__(self, in_features: int = 58, window_size: int = 10):
        super().__init__()
        self.branch = WindowCNN(in_features, window_size, n_classes=1)


class SiameseLSTM(_Siamese):
    def __init__(self, in_features: int = 58, window_size: int = 10):
        super().__init__()
        self.branch = WindowLSTM(in_features, window_size, n_classes=1)


def window_model(name: str, in_features: int, window_size: int, n_classes: int,
                 hidden_size: int = 128, num_layers: int = 3) -> Optional[nn.Module]:
    """The window model called ``name`` (None for another family), as
    ``med_tpu``'s factory builds it: the twins take one logit and the
    LSTM's default sizes."""
    if name == "SimpleCNN":
        return WindowCNN(in_features, window_size, n_classes)
    if name == "SimpleLSTM":
        return WindowLSTM(in_features, window_size, hidden_size, num_layers, n_classes)
    if name == "Siamese_CNN":
        return SiameseCNN(in_features, window_size)
    if name == "Siamese_LSTM":
        return SiameseLSTM(in_features, window_size)
    return None
