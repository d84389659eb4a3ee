"""Operations and bytes of the port's COG kernels from their call shapes:
"inputs read once, outputs written once, operations at their type's peak".
The arithmetic is that of the smoke test's bound column (PERF.md, the table
of the TPU kernels), kept here so that a later change to the smoke cannot
move the yardstick. float32 throughout (4 bytes a value, masks 1)."""

from __future__ import annotations

from typing import Sequence, Tuple


def tcn_forward(T: int, C: int, layers: Sequence[int], n_in: int, n_out: int,
                saved: bool = False, masked: bool = False) -> Tuple[float, float]:
    """(bytes, flops) of TCN stacks of ``layers`` run back to back at T
    frames (K2a: one call of all stages; K2b: one call a stack). Per layer
    8·T·C² + 4·T·C operations (three dilated taps and the 1x1 conv, the
    biases, relu, residual). Bytes: the weights and ``n_in`` (T, C) inputs
    read, ``n_out`` (T, C) outputs written; a training forward (``saved``)
    also writes each layer's input and post-relu activation, and reads the
    uint8 keep-masks when ``masked``."""
    Lt = sum(layers)
    weights = sum(L * (4 * C * C + 2 * C) for L in layers)
    flops = sum(L * (8 * T * C * C + 4 * T * C) for L in layers)
    nbytes = 4 * (weights + (n_in + n_out) * T * C)
    if saved:
        nbytes += 4 * 2 * Lt * T * C
    if masked:
        nbytes += Lt * T * C
    return float(nbytes), float(flops)


def tcn_backward(T: int, C: int, layers: Sequence[int], n_g: int,
                 n_dx: int) -> Tuple[float, float]:
    """(bytes, flops) of the TCN backward (K4: the slow stages in one call;
    K5: one stack a call). Per layer 8 products of (T, C) by (C, C); bytes:
    ``n_g`` cotangents, the saved activations, the uint8 masks and the
    weights read, ``n_dx`` input gradients and the weight gradients
    written."""
    Lt = sum(layers)
    flops = Lt * (16 * T * C * C + 8 * T * C)
    nbytes = (4 * (n_g * T * C + 2 * Lt * T * C + Lt * 4 * C * C)
              + Lt * T * C + 4 * (n_dx * T * C + Lt * (4 * C * C + 2 * C)))
    return float(nbytes), float(flops)


def attention_forward(H: int, d: int, N: int, Fk: int, W: int) -> Tuple[float, float]:
    """(bytes, flops) of the packed banded attention forward (K1): H heads of
    width d, N query tokens, Fk key frames, window W. Bytes: q read, out and
    the (2, N) statistics written per query, k and v read per key frame.
    Operations per (query, key) pair: score and values 2d each, ~4 for the
    exponential and the sums."""
    return float(4 * (2 * H * d * N + 2 * H * d * Fk + 2 * H * N)), float(H * N * W * (4 * d + 4))


def attention_backward(H: int, d: int, N: int, Fk: int, W: int) -> Tuple[float, float]:
    """(bytes, flops) of the packed attention backward (K3): q, g and out
    read, the logsumexp row read and dq written per query; k, v read and dk,
    dv written per key frame. Per pair: score, g.v, dq, dk, dv (2d each) and
    ~4 for the softmax and ds, plus delta = out.g per query."""
    nbytes = 4 * (4 * H * d * N + H * N + 4 * H * d * Fk)
    flops = H * N * W * (10 * d + 4) + 2 * H * d * N
    return float(nbytes), float(flops)
