"""COG's model FLOPs from its configuration file and a trial's length: the
matrix products, convolutions and attention of one forward, and of a
training step (forward and backward, nothing recomputed). Elementwise work
(norms, softmax, the loss) is not counted, as MFU conventionally leaves it
out. Counted at the trial's true length: padding is not model work."""

from __future__ import annotations


def _mm(m: float, n: float, k: float) -> float:
    return 2.0 * m * n * k


def _sizes(cfg: dict):
    e = cfg["experiment"]
    f_dim = e["video_dims"] + cfg["kinematic_dims"]
    return dict(F=f_dim, D=e["d_model"], H=cfg["n_heads"], dq=e["d_q"],
                W=e["sequence_length"], M=cfg["prompts"], P=cfg["prompt_dim"],
                C=e["mstcn_f_maps"], L0=e["num_layers_Basic"], Lr=e["num_layers_R"],
                R=e["num_R"], K=e["out_features"], E=cfg["encoder_layers"],
                pool=cfg["fast_pool"], d_ff=f_dim)


def forward_flops(cfg: dict, T: int) -> dict:
    """One forward of one trial of T frames, by part: "chain" (the
    chain-of-gesture block), "slow" and "fast" (the TCN paths and their
    heads), and "input" and "prompt" (the two products whose inputs need no
    gradient: the trial's features and the frozen prompt table)."""
    s = _sizes(cfg)
    F, D, H, dq, W, M, P = (s[k] for k in ("F", "D", "H", "dq", "W", "M", "P"))
    C, L0, Lr, R, K, E = (s[k] for k in ("C", "L0", "Lr", "R", "K", "E"))
    N = T * M
    per_layer = (_mm(N, D, D)                    # W_Q on the text tokens
                 + 2 * _mm(T, D, D)               # W_K, W_V on the frames
                 + N * W * H * 4 * dq             # banded scores and values
                 + 2 * _mm(N, D, s["d_ff"]))      # the FFN
    chain = (E * per_layer
             + _mm(N, D, D) + 2 * _mm(M, D, D)    # the prompt attention's projections
             + 2 * _mm(M, N, D))                  # its scores and context
    layers = L0 + R * Lr
    stack = 8.0 * C * C                           # three dilated taps and the 1x1, a frame
    slow = (_mm(T, M * D, C) + layers * stack * T
            + R * _mm(T, C, C)                    # the FPN's lateral conv
            + (R + 1) * _mm(T, C, K))             # the FPN's class convs
    Tf = T // s["pool"]
    fast = (_mm(Tf, M * D, C) + R * _mm(Tf, K, C) + layers * stack * Tf
            + (R + 1) * _mm(Tf, C, K))
    return {"input": _mm(T, F, D), "prompt": _mm(M, P, D), "chain": chain,
            "slow": slow, "fast": fast}


def inference_flops(cfg: dict, T: int) -> float:
    return sum(forward_flops(cfg, T).values())


def train_flops(cfg: dict, T: int) -> float:
    """Forward and backward of one training step on one trial: each product
    three times (forward, input gradient, weight gradient), less the input
    gradients of the two products whose inputs take none."""
    f = forward_flops(cfg, T)
    return 3 * sum(f.values()) - f["input"] - f["prompt"]
