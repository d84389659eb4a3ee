"""MiMo-V2-Flash's work from its configuration file and a trial's length:
the model FLOPs of a forward and of a training step, and the operations and
bytes of its two kernels' calls (the packed attention's sink instance and
a held expert's SwiGLU) from their shapes. Elementwise work (norms, RoPE,
softmax, routing, the loss) is not counted, as MFU conventionally leaves it
out. Counted at the trial's true length: padding is not model work. The
held experts' share is the expected one: each frame sends top_k ·
held / n_experts of its assignments here (0.25 at the cut's 8 of 256)."""

from __future__ import annotations

from typing import Tuple

from core.spec import load_module


def _arch(cfg: dict) -> dict:
    return load_module("reference", "mimo_v2_flash").arch(cfg)


def _mm(m: float, n: float, k: float) -> float:
    return 2.0 * m * n * k


def window_pairs(T: int, window: int) -> int:
    """(query frame, key frame) pairs of a T-frame trial whose windows leave
    out the frames before 0."""
    n = min(T, window)
    return n * (n + 1) // 2 + (T - n) * window


def forward_flops(cfg: dict, T: int) -> dict:
    """One forward of a T-frame trial, by part: "input" (W_in, whose input
    takes no gradient), "projections" (q, k, v, o and W_out), "attention"
    (scores and values, windowed and full), "dense" (layer 0's SwiGLU),
    "experts" (router and the held experts' SwiGLU)."""
    a = _arch(cfg)
    D, H, dk, dv = a["hidden"], a["heads"], a["qk_dim"], a["v_dim"]
    proj = attn = dense = experts = 0.0
    for i, kind in enumerate(a["pattern"]):
        kv = a["kv_heads_window"] if kind == "W" else a["kv_heads_full"]
        proj += _mm(T, D, H * dk + kv * (dk + dv)) + _mm(T, H * dv, D)
        pairs = window_pairs(T, a["window"]) if kind == "W" else T * (T + 1) // 2
        attn += H * pairs * 2.0 * (dk + dv)
        if i < a["dense_layers"]:
            dense += 3 * _mm(T, D, a["dense_width"])
        else:
            share = a["top_k"] * a["held"][1] / a["n_experts"]
            experts += _mm(T, D, a["n_experts"]) + share * 3 * _mm(T, D, a["expert_width"])
    proj += _mm(T, D, a["out_classes"])
    return {"input": _mm(T, a["in_dim"], D), "projections": proj, "attention": attn,
            "dense": dense, "experts": experts}


def train_flops(cfg: dict, T: int) -> float:
    """Forward and backward of one training step: each product three times
    (forward, input gradient, weight gradient), less the input gradient of
    W_in, whose input is the trial."""
    f = forward_flops(cfg, T)
    return 3 * sum(f.values()) - f["input"]


def sink_forward(H: int, dk: int, dv: int, T: int, m: int, window: int) -> Tuple[float, float]:
    """(bytes, flops) of the sink instance's forward: q read, out and the
    (2, N) statistics written per query, k and v read per key frame; per
    (query, key) pair 2·dk for the score, 2·dv for the values and ~4 for
    the exponential and the sums."""
    N = T * m
    pairs = H * m * window_pairs(T, window)
    nbytes = 4 * (H * dk * N + H * dv * N + 2 * H * N + H * (dk + dv) * T)
    return float(nbytes), float(pairs * (2 * dk + 2 * dv + 4))


def sink_backward(H: int, dk: int, dv: int, T: int, m: int, window: int) -> Tuple[float, float]:
    """(bytes, flops) of the sink instance's backward: q, g, out and the
    logsumexp read and dq written per query, k and v read and dk, dv written
    per key frame; per pair the score again (2·dk), g·v (2·dv), dv (2·dv),
    dq and dk (2·dk each) and ~4 for the softmax and ds, plus delta = out·g
    per query."""
    N = T * m
    pairs = H * m * window_pairs(T, window)
    nbytes = 4 * (H * N * (2 * dk + 2 * dv + 1) + 2 * H * (dk + dv) * T)
    flops = pairs * (6 * dk + 4 * dv + 4) + 2 * H * dv * N
    return float(nbytes), float(flops)


def expert_forward(n: int, hidden: int, width: int) -> Tuple[float, float]:
    """(bytes, flops) of one held expert's SwiGLU on the n frames routed to
    it: its three weight matrices read once, the frames read and its output
    written; three products."""
    nbytes = 4 * (3 * hidden * width + 2 * n * hidden)
    return float(nbytes), float(3 * _mm(n, hidden, width))


def expert_backward(n: int, hidden: int, width: int) -> Tuple[float, float]:
    """(bytes, flops) of its backward: the weights, the frames, the output's
    gradient and the two saved (n, width) products read, the frames' and
    the weights' gradients written; six products."""
    nbytes = 4 * (6 * hidden * width + 3 * n * hidden + 2 * n * width)
    return float(nbytes), float(6 * _mm(n, hidden, width))
