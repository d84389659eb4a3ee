"""Plain MiMo-V2-Flash block over frames (the published description:
XiaomiMiMo/MiMo-V2-Flash ``config.json``), as functions of a flat parameter
dict in the program's state-dict names ("model.layers.1.attn.q_proj.weight",
...), float32, one trial at a time (B = 1). It imports no kernel of the
program: the windows are gathered, the masks explicit, the held experts a
loop.

For a trial x (T, F) of 2,048 video features and 26 kinematics:

1. h = W_in x + b_in (F -> hidden): the frames are the tokens, so this
   stands in for the token embedding.
2. Each layer of the cut (the pattern's first ``num_hidden_layers``, F
   full, W windowed), pre-norm: h += Attn(RMSNorm(h)), h += FFN(RMSNorm(h));
   RMSNorm eps ``layernorm_epsilon`` with a learned scale.
   - Attention: q = W_q u (heads of ``head_dim``), k = W_k u (KV heads of
     ``head_dim``), v = W_v u (KV heads of ``v_head_dim``), no biases; RoPE
     on each q and k head's first ``partial_rotary_factor`` of its dims
     (rotate-half, pairs (i, i + half), angles t·theta^(-2i/rope) in float64
     stored as float32), theta ``swa_rope_theta`` windowed and
     ``rope_theta`` full; query head h reads KV head h // (heads / KV heads);
     s_tj = q_t·k_j / sqrt(head_dim).
     Windowed: j in [max(0, t - window + 1), t] (frames before 0 left out,
     not scored), p_tj = exp(s_tj) / (exp(sink_h) + sum_j exp(s_tj)).
     Full: j in [0, t], a plain softmax.
     o = 0.707 · sum_j p_tj v_j (``attention_value_scale``), then W_o.
   - FFN: layer 0 SwiGLU W_2 (silu(W_1 u) * W_3 u) of ``intermediate_size``;
     the MoE layers score every expert, s = sigmoid(W_r u) (all
     ``published.n_routed_experts``), pick the top ``num_experts_per_tok``
     of s + the fixed correction bias, weight each pick by s_e / sum of the
     picked s (``norm_topk_prob``; ``routed_scaling_factor`` null: no
     scale), and add sum over the picks this chip holds of w_e ·
     SwiGLU_e(u) (``moe_intermediate_size``). The experts held elsewhere add
     nothing here, as in the program.
3. A final RMSNorm and W_out (hidden -> 2): per-frame error logits, in
   place of the LM head.

The loss: the soft cross-entropy against [1 - y, y] averaged over the
trial's true frames (``binary_frame_loss``'s TransSVNet branch).

Departures from the published model, each in the configuration file's
``assumed``: no vocabulary (W_in and W_out stand in for the embedding and
the head), the cut's depth and experts, the sink as one logit a query head
in the denominator, the value scale on the output (linear: the same as on
v), no QK-norm (the config has no key for one), the correction bias a
seeded fixed tensor (no update rule), the window counting the query's own
frame, ``attention_chunk_size`` a serving-time chunking that changes no
result, no multi-token prediction layers.

For the card's check at the published widths, :func:`blocked_step` runs a
training step one layer at a time: the layer's weights on the card, the
rest and Adam's moments on the host, the activations between the layers
kept and each layer's forward recomputed for its backward."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

P = "model."


def arch(cfg: dict) -> dict:
    """The block's sizes from the configuration file, as the program's
    ``MiMoArch`` fields."""
    L = cfg["num_hidden_layers"]
    pattern = "".join("W" if s else "F" for s in cfg["hybrid_layer_pattern"][:L])
    dense = 0
    while dense < L and cfg["moe_layer_freq"][dense] == 0:
        dense += 1
    d = cfg["deployment"]
    return dict(in_dim=cfg["video_dims"] + cfg["kinematic_dims"], hidden=cfg["hidden_size"],
                heads=cfg["swa_num_attention_heads"],
                kv_heads_window=cfg["swa_num_key_value_heads"],
                kv_heads_full=cfg["num_key_value_heads"], qk_dim=cfg["head_dim"],
                v_dim=cfg["v_head_dim"],
                rope_dim=int(cfg["head_dim"] * cfg["partial_rotary_factor"]) // 2 * 2,
                theta_window=float(cfg["swa_rope_theta"]), theta_full=float(cfg["rope_theta"]),
                window=cfg["sliding_window"], sink=bool(cfg["add_swa_attention_sink_bias"]),
                value_scale=cfg["attention_value_scale"],
                dense_width=cfg["intermediate_size"], dense_layers=dense,
                expert_width=cfg["moe_intermediate_size"],
                n_experts=cfg["published"]["n_routed_experts"],
                top_k=cfg["num_experts_per_tok"],
                held=[d["first_expert"], cfg["n_routed_experts"]], pattern=pattern,
                eps=cfg["layernorm_epsilon"], out_classes=cfg["experiment"]["out_features"])


def layer_params(cfg: dict, i: int) -> List[str]:
    """The names of layer i's parameters."""
    return [n for n, *_ in param_spec(cfg) if n.startswith(f"{P}layers.{i}.")]


def param_spec(cfg: dict):
    """The weight spec for ``core.weights``: every product U(±1/sqrt(fan_in))
    (torch's default), RMSNorm scales 1, the sinks U(±1), the correction
    bias U(±0.05)."""
    a = arch(cfg)
    H, kvw, kvf = a["heads"], a["kv_heads_window"], a["kv_heads_full"]
    D, dk, dv = a["hidden"], a["qk_dim"], a["v_dim"]
    spec = []

    def dense(name, d_in, d_out, bias=False):
        bound = 1.0 / math.sqrt(d_in)
        spec.append((f"{P}{name}.weight", (d_out, d_in), "uniform", bound, 0.0))
        if bias:
            spec.append((f"{P}{name}.bias", (d_out,), "uniform", bound, 0.0))

    def norm(name):
        spec.append((f"{P}{name}.weight", (D,), "fill", 1.0, 0.0))

    dense("W_in", a["in_dim"], D, bias=True)
    n_held, E, We = a["held"][1], a["n_experts"], a["expert_width"]
    for i, kind in enumerate(a["pattern"]):
        lp = f"layers.{i}."
        kv = kvw if kind == "W" else kvf
        norm(lp + "attn_norm")
        dense(lp + "attn.q_proj", D, H * dk)
        dense(lp + "attn.k_proj", D, kv * dk)
        dense(lp + "attn.v_proj", D, kv * dv)
        dense(lp + "attn.o_proj", H * dv, D)
        if kind == "W" and a["sink"]:
            spec.append((f"{P}{lp}attn.sinks.sinks", (kv, H // kv), "uniform", 1.0, 0.0))
        norm(lp + "ffn_norm")
        if i < a["dense_layers"]:
            dense(lp + "ffn.w1", D, a["dense_width"])
            dense(lp + "ffn.w3", D, a["dense_width"])
            dense(lp + "ffn.w2", a["dense_width"], D)
        else:
            spec.append((f"{P}{lp}ffn.gate.weight", (E, D), "uniform", 1.0 / math.sqrt(D), 0.0))
            spec.append((f"{P}{lp}ffn.gate.e_score_correction_bias", (E,), "uniform", 0.05, 0.0))
            for w, shape, fan in (("w1", (n_held, We, D), D), ("w3", (n_held, We, D), D),
                                  ("w2", (n_held, D, We), We)):
                spec.append((f"{P}{lp}ffn.experts.{w}", shape, "uniform",
                             1.0 / math.sqrt(fan), 0.0))
    norm("norm")
    dense("W_out", D, a["out_classes"])
    return spec


FIXED = ("e_score_correction_bias",)   # parameters that take no gradient


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x, theta: float, rope_dim: int):
    """x (T, n, d): rotate-half RoPE on the first rope_dim dims of each head."""
    T, half = x.shape[0], rope_dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) * 2.0 / rope_dim)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    cos = ang.cos().to(torch.float32).to(x.device)[:, None]
    sin = ang.sin().to(torch.float32).to(x.device)[:, None]
    x1, x2 = x[..., :half], x[..., half:rope_dim]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rope_dim:]], dim=-1)


def window_attention(q, k, v, sinks: Optional[torch.Tensor], window: int):
    """q (T, H, dk), k (T, G, dk), v (T, G, dv), sinks (H,) or None ->
    (T, H, dv): query t attends the keys of frames max(0, t - window + 1)
    .. t, gathered; the slots before frame 0 are masked out."""
    T, H, dk = q.shape
    G = k.shape[1]
    idx = torch.arange(T, device=q.device)[:, None] + torch.arange(window, device=q.device) \
        - (window - 1)                                             # (T, W) frame of each slot
    valid = idx >= 0
    kw = k[idx.clamp(min=0)]                                       # (T, W, G, dk)
    vw = v[idx.clamp(min=0)]
    qg = q.reshape(T, G, H // G, dk)
    s = torch.einsum("tgmd,twgd->tgmw", qg, kw) / math.sqrt(dk)    # (T, G, m, W)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    if sinks is not None:
        sink = sinks.reshape(1, G, H // G, 1).expand(T, G, H // G, 1)
        p = torch.softmax(torch.cat([s, sink], dim=-1), dim=-1)[..., :-1]
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("tgmw,twgd->tgmd", p, vw).reshape(T, H, -1)


def full_attention(q, k, v):
    """q (T, H, dk), k (T, G, dk), v (T, G, dv) -> (T, H, dv): a causal
    softmax over every frame up to t."""
    T, H, dk = q.shape
    G = k.shape[1]
    qg = q.reshape(T, G, H // G, dk)
    s = torch.einsum("tgmd,sgd->gmts", qg, k) / math.sqrt(dk)
    later = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
    return torch.einsum("gmts,sgd->tgmd", p, v).reshape(T, H, -1)


def route(p, lp: str, u, a: dict, pinned: Optional[torch.Tensor] = None):
    """(scores (T, E), picks (T, k)): the sigmoid scores and the top k of
    scores + bias. ``pinned``: another computation's picks, taken instead
    where they are a top k of this one's biased scores up to ``tie``
    (:func:`pick_gap` measures how far they are from one)."""
    scores = torch.sigmoid(u @ p[f"{lp}ffn.gate.weight"].T)
    if pinned is not None:
        return scores, pinned
    biased = scores.detach() + p[f"{lp}ffn.gate.e_score_correction_bias"]
    return scores, torch.topk(biased, a["top_k"], dim=-1).indices


def pick_gap(p, lp: str, u, a: dict, picks: torch.Tensor) -> float:
    """How far ``picks`` are from a top k of this computation's biased
    scores: the largest, over the frames, of the k-th largest biased score
    less the smallest picked one (0 where the picks are a top k)."""
    with torch.no_grad():
        biased = torch.sigmoid(u @ p[f"{lp}ffn.gate.weight"].T) + \
            p[f"{lp}ffn.gate.e_score_correction_bias"]
        kth = torch.topk(biased, a["top_k"], dim=-1).values[:, -1]
        least = torch.gather(biased, 1, picks).min(dim=-1).values
        return float((kth - least).clamp(min=0).max())


def moe(p, lp: str, u, a: dict, pinned: Optional[torch.Tensor] = None):
    """The held experts' part of the MoE layer's output, a loop over them."""
    scores, picks = route(p, lp, u, a, pinned)
    picked = torch.gather(scores, 1, picks)
    weights = picked / picked.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(u)
    first, n_held = a["held"]
    for e in range(n_held):
        rows, slot = (picks == first + e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = u[rows]
        w1, w3, w2 = (p[f"{lp}ffn.experts.{w}"][e] for w in ("w1", "w3", "w2"))
        y = (F.silu(x @ w1.T) * (x @ w3.T)) @ w2.T
        out = out.index_add(0, rows, y * weights[rows, slot][:, None])
    return out, picks


def attention_part(p, i: int, h, a: dict):
    """h + Attn(RMSNorm(h)) of layer i of the cut."""
    lp = f"{P}layers.{i}."
    kind = a["pattern"][i]
    T = h.shape[0]
    H, dk, dv = a["heads"], a["qk_dim"], a["v_dim"]
    G = a["kv_heads_window"] if kind == "W" else a["kv_heads_full"]
    theta = a["theta_window"] if kind == "W" else a["theta_full"]
    u = _rms(h, p[lp + "attn_norm.weight"], a["eps"])
    q = _rope((u @ p[lp + "attn.q_proj.weight"].T).reshape(T, H, dk), theta, a["rope_dim"])
    k = _rope((u @ p[lp + "attn.k_proj.weight"].T).reshape(T, G, dk), theta, a["rope_dim"])
    v = (u @ p[lp + "attn.v_proj.weight"].T).reshape(T, G, dv)
    if kind == "W":
        sinks = p.get(lp + "attn.sinks.sinks")
        o = window_attention(q, k, v, None if sinks is None else sinks.reshape(-1), a["window"])
    else:
        o = full_attention(q, k, v)
    return h + (o.reshape(T, H * dv) * a["value_scale"]) @ p[lp + "attn.o_proj.weight"].T


def ffn_part(p, i: int, h, a: dict, pinned: Optional[torch.Tensor] = None):
    """h + FFN(RMSNorm(h)) of layer i -> (h, the MoE's picks or None)."""
    lp = f"{P}layers.{i}."
    u = _rms(h, p[lp + "ffn_norm.weight"], a["eps"])
    if i < a["dense_layers"]:
        y = (F.silu(u @ p[lp + "ffn.w1.weight"].T) * (u @ p[lp + "ffn.w3.weight"].T)) \
            @ p[lp + "ffn.w2.weight"].T
        return h + y, None
    y, picks = moe(p, lp, u, a, pinned)
    return h + y, picks


def layer(p, i: int, h, a: dict, pinned: Optional[torch.Tensor] = None):
    """Layer i of the cut on h (T, hidden) -> (h, the MoE's picks or None)."""
    return ffn_part(p, i, attention_part(p, i, h, a), a, pinned)


def forward(p, cfg: dict, x: torch.Tensor, pinned: Optional[Sequence] = None):
    """One trial x (T, F) -> (logits (T, out_classes), each MoE layer's
    picks); ``pinned`` a list of picks a layer (None for a layer to route
    itself)."""
    a = arch(cfg)
    h = x @ p[P + "W_in.weight"].T + p[P + "W_in.bias"]
    picks = []
    for i in range(len(a["pattern"])):
        h, pk = layer(p, i, h, a, None if pinned is None else pinned[i])
        picks.append(pk)
    return _rms(h, p[P + "norm.weight"], a["eps"]) @ p[P + "W_out.weight"].T, picks


def loss(logits: torch.Tensor, labels: torch.Tensor, true_len: int) -> torch.Tensor:
    """The soft CE against [1 - y, y], averaged over the first true_len
    frames."""
    y = labels.to(logits.dtype)
    target = torch.stack([1.0 - y, y], dim=-1)
    per = -(target * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return per[:true_len].mean()


def probabilities(p, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Served per-frame probabilities of the error class."""
    return torch.softmax(forward(p, cfg, x)[0], dim=-1)[:, 1]


def blocked_step(host: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
                 labels: torch.Tensor, true_len: int, device,
                 pinned: Optional[Sequence] = None):
    """One training step's loss and gradients with one layer's weights on
    ``device`` at a time: ``host`` holds every parameter (on the host). The
    forward keeps each layer's input; the backward recomputes each layer's
    forward under autograd, from the top down. Returns (loss, {name:
    gradient on the host}, each MoE layer's picks, each MoE layer's pick
    gap against ``pinned``)."""
    a = arch(cfg)
    L = len(a["pattern"])

    def on(names, grad):
        return {n: host[n].detach().to(device).requires_grad_(grad and not n.endswith(FIXED))
                for n in names}

    grads: Dict[str, torch.Tensor] = {}
    stem = on([P + "W_in.weight", P + "W_in.bias"], True)
    x = x.to(device)
    h0 = x @ stem[P + "W_in.weight"].T + stem[P + "W_in.bias"]
    inputs, picks, gaps = [], [], []
    h = h0.detach()
    with torch.no_grad():
        for i in range(L):
            inputs.append(h)
            w = on(layer_params(cfg, i), False)
            pin = None if pinned is None else pinned[i]
            h = attention_part(w, i, h, a)
            if pin is not None:
                u = _rms(h, w[f"{P}layers.{i}.ffn_norm.weight"], a["eps"])
                gaps.append(pick_gap(w, f"{P}layers.{i}.", u, a, pin))
            h, pk = ffn_part(w, i, h, a, pin)
            picks.append(pk)
            del w
    head = on([P + "norm.weight", P + "W_out.weight"], True)
    top = h.requires_grad_(True)
    logits = _rms(top, head[P + "norm.weight"], a["eps"]) @ head[P + "W_out.weight"].T
    value = loss(logits, labels.to(device), true_len)
    g_top, *g_head = torch.autograd.grad(value, [top] + list(head.values()))
    for n, g in zip(head, g_head):
        grads[n] = g.cpu()
    g = g_top
    for i in reversed(range(L)):
        w = on(layer_params(cfg, i), True)
        hin = inputs[i].requires_grad_(True)
        out, _ = layer(w, i, hin, a, picks[i])
        leaves = [n for n in w if w[n].requires_grad]
        got = torch.autograd.grad(out, [hin] + [w[n] for n in leaves], g)
        g = got[0]
        for n, gn in zip(leaves, got[1:]):
            grads[n] = gn.cpu()
        for n in w:
            if n not in grads:
                grads[n] = torch.zeros_like(host[n])
        del w, out, got
        inputs[i] = None
    g_stem = torch.autograd.grad(h0, list(stem.values()), g)
    for n, gn in zip(stem, g_stem):
        grads[n] = gn.cpu()
    return float(value.detach()), grads, picks, gaps


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, tuple], t: int, lr: float, betas, eps: float, device) -> None:
    """Adam's step ``t`` (``reference/adam.py``'s arithmetic, no weight
    decay) on host-held ``params``, one leaf on ``device`` at a time; the
    moments ``state`` (name -> (m, v)) stay on the host. The fixed
    parameters do not move."""
    b1, b2 = betas
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for name in params:
            if name.endswith(FIXED):
                continue
            p, g = params[name].to(device), grads[name].to(device)
            m, v = (s.to(device) for s in state.get(name, (torch.zeros_like(params[name]),) * 2))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            p -= (lr / c1) * m / (v.sqrt() / math.sqrt(c2) + eps)
            params[name], state[name] = p.cpu(), (m.cpu(), v.cpu())
