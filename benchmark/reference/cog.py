"""Plain COG (chain-of-gesture; reference MED/models/models_COG.py) forward
and training loss, as functions of a flat parameter dict in the checkpoint
layout's names ("model.cot.linear1.weight", "model.TCN.stack.w3", ...),
float32, one trial at a time (B = 1).

The forward, for a trial x (T, F) of video features and kinematics:

1. Chain of gestures: the visual rows x W1 are left-padded with len_q - 1
   zero rows and layer-normed (eps 1e-6, E[x²] - E[x]² clipped at 0, so the
   pad rows become the norm's bias); every frame holds the M prompt rows
   (the frozen prompt table x W2) as its tokens. Two encoder layers: a
   token's learned pre-norm (eps 1e-5 over the features), 8 heads of d_q
   8 attending the window of the len_q most recent visual rows (its own
   frame and the 29 before, pad rows included; no output projection),
   residual and an unlearned norm, the learned norm, then an FFN of width
   F (relu) with residual and an unlearned norm. Then one single-head
   attention of each token over the M prompt rows (no output projection),
   residual, unlearned norm. A frame's M tokens side by side make its
   M * d_model features.
2. Slow path: a 1x1 conv to f_maps, channel dropout in training (a kept
   channel times 2), then the TCN stage and num_R refinements back to
   back, each a stack of dilated causal residual layers (layer i: taps at
   t - 2^(i+1), t - 2^i and t, relu, 1x1, dropout of rate 0.5 with kept
   elements times 2, residual); an FPN adds each stage's output through one
   shared lateral 1x1 conv to the upsampled (here same-length) sum of the
   stages after it, and one shared class conv makes 4 tracks.
3. Fast path: the features average-pooled by 16, a 1x1 conv, channel
   dropout, a stack of num_layers_Basic, a class conv; then num_R stages on
   the softmax of the previous track (1x1 conv, stack, class conv).

The loss (reference modeling_utils.py:1501-1521) over the 4 + 4 tracks: a
track's labels are the trial's, nearest-resampled to its length with the
index arithmetic in float32; cross-entropy and the truncated MSE of
consecutive log-softmaxes (the earlier one detached, clipped at 16) over
its valid frames; loss = mean CE + 0.15 mean smoothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

P = "model."


def stage_names(num_r: int):
    slow = ["TCN"] + [f"R{r}" for r in range(num_r)]
    fast = ["fast_stage1"] + [f"fast_R{r}" for r in range(num_r)]
    return slow, fast


def param_spec(cfg: dict):
    """The model's weight spec for :mod:`core.weights`: every product and
    bias U(±1/sqrt(fan_in)) (the reference's torch default), learned norms'
    scales 1 and biases 0."""
    e = cfg["experiment"]
    D, dq, H = e["d_model"], e["d_q"], cfg["n_heads"]
    F_in = e["video_dims"] + cfg["kinematic_dims"]
    M, Pd, C, K = cfg["prompts"], cfg["prompt_dim"], e["mstcn_f_maps"], e["out_features"]
    L0, Lr, R = e["num_layers_Basic"], e["num_layers_R"], e["num_R"]
    spec = []

    def dense(name, d_in, d_out, bias=False, fan_in=None):
        bound = 1.0 / math.sqrt(fan_in or d_in)
        spec.append((f"{P}{name}.weight", (d_out, d_in), "uniform", bound, 0.0))
        if bias:
            spec.append((f"{P}{name}.bias", (d_out,), "uniform", bound, 0.0))

    def conv(name, d_in, d_out):
        bound = 1.0 / math.sqrt(d_in)
        spec.append((f"{P}{name}.weight", (d_out, d_in, 1), "uniform", bound, 0.0))
        spec.append((f"{P}{name}.bias", (d_out,), "uniform", bound, 0.0))

    def norm(name, d):
        spec.append((f"{P}{name}.weight", (d,), "fill", 1.0, 0.0))
        spec.append((f"{P}{name}.bias", (d,), "fill", 0.0, 0.0))

    def stack(name, L):
        for leaf, shape, fan in (("w3", (L, 3, C, C), 3 * C), ("b3", (L, C), 3 * C),
                                 ("w1", (L, C, C), C), ("b1", (L, C), C)):
            spec.append((f"{P}{name}.stack.{leaf}", shape, "uniform",
                         1.0 / math.sqrt(fan), 0.0))

    dense("cot.linear1", F_in, D)
    dense("cot.linear2", Pd, D)
    norm("cot.enc_norm", D)
    for i in range(cfg["encoder_layers"]):
        norm(f"cot.layer{i}.norm1", D)
        for w in ("W_Q", "W_K", "W_V"):
            dense(f"cot.layer{i}.{w}", D, H * dq)
        norm(f"cot.layer{i}.norm3", D)
        dense(f"cot.layer{i}.ffn.Dense_0", D, F_in)
        dense(f"cot.layer{i}.ffn.Dense_1", F_in, D)
    for w in ("W_Q", "W_K", "W_V"):
        dense(f"cot.atten.{w}", D, D)
    slow, fast = stage_names(R)
    for s, name in enumerate(slow):
        if s == 0:
            conv(f"{name}.conv_in", M * D, C)
        stack(name, L0 if s == 0 else Lr)
        conv(f"{name}.conv_out", C, K)
    conv("latlayer1", C, C)
    conv("conv_out", C, K)
    for s, name in enumerate(fast):
        conv(f"{name}.conv_in", M * D if s == 0 else K, C)
        stack(name, L0 if s == 0 else Lr)
        conv(f"{name}.conv_out", C, K)
    return spec


def prompt_table(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """The frozen (M, prompt_dim) prompt table: seeded rows, each scaled to
    the typical norm of a CLIP ViT-B/32 text embedding."""
    t = torch.randn((cfg["prompts"], cfg["prompt_dim"]), generator=gen, device=device)
    return t / t.norm(dim=1, keepdim=True) * cfg["prompt_norm"]


def _ln_learned(x, w, b, eps=1e-6):
    """LayerNorm over the last axis, E[x²] - E[x]² clipped at 0."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _ln(x, eps=1e-5):
    """Unlearned LayerNorm over the last axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _conv1x1(p, name, x):
    return x @ p[f"{P}{name}.weight"][:, :, 0].T + p[f"{P}{name}.bias"]


def stack(p, name: str, x: torch.Tensor, mask: Optional[torch.Tensor],
          scale: float = 2.0) -> torch.Tensor:
    """A stack of dilated causal residual layers over x (T, C); ``mask`` the
    (L, T, C) 0/1 keep-mask in training."""
    w3, b3 = p[f"{P}{name}.stack.w3"], p[f"{P}{name}.stack.b3"]
    w1, b1 = p[f"{P}{name}.stack.w1"], p[f"{P}{name}.stack.b1"]
    T = x.shape[0]
    for i in range(w3.shape[0]):
        d = 2 ** i
        xp = torch.cat([x.new_zeros((2 * d, x.shape[1])), x])
        y = xp[0:T] @ w3[i, 0] + xp[d:d + T] @ w3[i, 1] + xp[2 * d:2 * d + T] @ w3[i, 2] + b3[i]
        z = torch.relu(y) @ w1[i] + b1[i]
        if mask is not None:
            z = z * (mask[i].to(z.dtype) * scale)
        x = x + z
    return x


def _window_attention(q, k, v, window: int):
    """q (T, M, H, dq) queries of each frame; k, v (T + window - 1, H, dq)
    the padded visual rows -> (T, M, H, dq): frame t attends rows t .. t +
    window - 1 of the padded sequence (its own and the window - 1 before)."""
    T = q.shape[0]
    idx = torch.arange(T, device=q.device)[:, None] + torch.arange(window, device=q.device)
    kw, vw = k[idx], v[idx]                                     # (T, W, H, dq)
    scores = torch.einsum("tmhd,twhd->tmhw", q, kw) / math.sqrt(q.shape[-1])
    return torch.einsum("tmhw,twhd->tmhd", torch.softmax(scores, dim=-1), vw)


def chain(p, cfg: dict, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The chain-of-gesture block: x (T, F) -> (T, M * d_model)."""
    e = cfg["experiment"]
    D, dq, H, W = e["d_model"], e["d_q"], cfg["n_heads"], e["sequence_length"]
    c = P + "cot."
    visual = x @ p[c + "linear1.weight"].T                      # (T, D)
    text0 = table @ p[c + "linear2.weight"].T                   # (M, D)
    T, M = visual.shape[0], text0.shape[0]
    visual = torch.cat([visual.new_zeros((W - 1, D)), visual])
    visual = _ln_learned(visual, p[c + "enc_norm.weight"], p[c + "enc_norm.bias"])
    text = text0[None].expand(T, M, D)                          # (T, M, D)
    for i in range(cfg["encoder_layers"]):
        lp = f"{c}layer{i}."
        q_in = _ln(text) * p[lp + "norm1.weight"] + p[lp + "norm1.bias"]
        q = (q_in @ p[lp + "W_Q.weight"].T).reshape(T, M, H, dq)
        k = (visual @ p[lp + "W_K.weight"].T).reshape(-1, H, dq)
        v = (visual @ p[lp + "W_V.weight"].T).reshape(-1, H, dq)
        ctx = _window_attention(q, k, v, W).reshape(T, M, H * dq)
        out = _ln(_ln(ctx + q_in)) * p[lp + "norm3.weight"] + p[lp + "norm3.bias"]
        y = torch.relu(out @ p[lp + "ffn.Dense_0.weight"].T)
        text = _ln(y @ p[lp + "ffn.Dense_1.weight"].T + out)
    qp = text @ p[c + "atten.W_Q.weight"].T                     # (T, M, D)
    k0 = text0 @ p[c + "atten.W_K.weight"].T                    # (M, D)
    v0 = text0 @ p[c + "atten.W_V.weight"].T
    a = torch.softmax(qp @ k0.T / math.sqrt(D), dim=-1)         # (T, M, M)
    return _ln(a @ v0 + text).reshape(T, M * D)


def forward(p, cfg: dict, table: torch.Tensor, x: torch.Tensor,
            masks: Optional[Dict] = None) -> List[torch.Tensor]:
    """One trial x (T, F) -> the 4 slow and 4 fast tracks, each (T_i, K);
    ``masks`` (training) by stage name: {"channel": (1, 1, C), "stack":
    (L, 1, T_i, C)}, as the harness draws them."""
    e = cfg["experiment"]
    slow, fast = stage_names(e["num_R"])
    train = masks is not None
    xx = chain(p, cfg, table, x)                                # (T, M*D)

    def pre(name, h):
        h = _conv1x1(p, f"{name}.conv_in", h)
        if train and "channel" in masks[name]:
            h = h * masks[name]["channel"][0].to(h.dtype) * 2.0
        return h

    def stack_mask(name):
        return masks[name]["stack"][:, 0] if train else None

    h, feats = pre("TCN", xx), []
    for name in slow:
        h = stack(p, name, h, stack_mask(name))
        feats.append(h)
    top = feats[-1]
    pyramid = [top]
    for f in reversed(feats[:-1]):
        top = top + _conv1x1(p, "latlayer1", f)
        pyramid.insert(0, top)
    tracks = [_conv1x1(p, "conv_out", q) for q in pyramid]

    pool = cfg["fast_pool"]
    Tf = xx.shape[0] // pool
    h = xx[:Tf * pool].reshape(Tf, pool, -1).mean(dim=1)
    out = None
    for s, name in enumerate(fast):
        h = pre(name, h if s == 0 else torch.softmax(out, dim=-1))
        h = stack(p, name, h, stack_mask(name))
        out = _conv1x1(p, f"{name}.conv_out", h)
        tracks.append(out)
    return tracks


def _resample(labels: torch.Tensor, true_len: int, t_pad: int, t_track: int):
    """Nearest resampling of the (t_pad,) labels to the track: position i <
    true_out = max(true_len * t_track // t_pad, 1) reads floor(i *
    (true_len / true_out)), the ratio and product in float32."""
    true_out = max(true_len * t_track // t_pad, 1)
    ratio = torch.tensor(true_len, dtype=torch.float32) / torch.tensor(true_out, dtype=torch.float32)
    i = torch.arange(t_track, dtype=torch.float32)
    src = torch.clamp(torch.floor(i * ratio).to(torch.int64), 0, t_pad - 1)
    return labels[src.to(labels.device)], true_out


def loss(tracks: List[torch.Tensor], labels: torch.Tensor, true_len: int,
         smooth_lambda: float) -> torch.Tensor:
    """The COG training loss over a trial padded to len(labels) frames."""
    t_pad = labels.shape[0]
    ce_sum = sm_sum = 0.0
    for logits in tracks:
        t_track = logits.shape[0]
        y, true_out = _resample(labels, true_len, t_pad, t_track)
        valid = (torch.arange(t_track, device=logits.device) < true_out).to(logits.dtype)
        logp = F.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, 1, y[:, None].long())[:, 0]
        ce_sum = ce_sum + (ce * valid).sum() / valid.sum()
        sq = torch.clamp((logp[1:] - logp[:-1].detach()) ** 2, 0.0, 16.0).mean(dim=-1)
        pair = valid[1:] * valid[:-1]
        sm_sum = sm_sum + (sq * pair).sum() / torch.clamp(pair.sum(), min=1e-12)
    n = len(tracks)
    return ce_sum / n + smooth_lambda * (sm_sum / n)


def probabilities(p, cfg: dict, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Served per-frame probabilities of the error class: the softmax of the
    first slow track (eval mode: no dropout)."""
    return torch.softmax(forward(p, cfg, table, x)[0], dim=-1)[:, 1]
