"""MiMo-V2-Flash's hybrid block as a frame model: a causal backbone over one
token a frame.

Published (XiaomiMiMo/MiMo-V2-Flash, ``config.json``): 48 layers at hidden
size 4,096, five windowed layers to one full (``hybrid_layer_pattern``):

- windowed layers: 64 query heads over 8 KV heads, q and k of width 192
  and v of 128, a 128-token window, a learnable sink logit a head, RoPE
  theta 10,000;
- full layers: 64 query heads over 4 KV heads, the same widths, no sink,
  RoPE theta 5,000,000;
- RoPE on the first 64 of each q and k head's 192 dims (partial rotary
  0.334), the attention's output times 0.707 (``attention_value_scale``);
- layer 0 a dense SwiGLU MLP of width 16,384; every later layer a MoE of
  256 experts of width 2,048, top 8 of sigmoid scores plus a fixed
  correction bias (``noaux_tc``), the weights the selected scores over
  their sum, no shared expert.

Here the tokens are frames: ``W_in`` maps a frame's 2,048 video features
and 26 kinematics to the hidden size (in place of the token embedding),
and a final RMSNorm and ``W_out`` give per-frame error logits (B, T, 2) (in
place of the LM head). Each layer is pre-norm: ``h += Attn(RMSNorm(h))``,
``h += FFN(RMSNorm(h))``, RMSNorm eps 1e-5 with a learned scale.

The windowed layers run the packed banded attention's sink instance
(``ops/attention.py``, ``csrc/swa_sink_{fwd,bwd}.cu``): the 8 query heads
that share a KV head are the packed layout's m = 8 query slots of a frame,
keys before frame 0 are left out, and each slot has its sink. The full
layers are a plain causal softmax in float32 (matrix products, a mask).

A MoE layer holds the experts ``arch.held`` names (an expert-parallel
deployment spreads the 256 over 32 chips, 8 each): it routes every frame
over all 256 and adds what its own experts give, dropping no token and
with no capacity limit. Gathering a held expert's frames needs their
count on the host: one sync a layer.

The held experts that got frames run as one autograd node
(``_HeldExperts``): its backward writes each expert's weight gradients once
into its slices of the three stacked gradients and zeroes the slices of a
held expert given no frames, so no expert makes a zero-filled gradient the
size of the whole stack (slicing the stack under autograd would, one for
each slice, and add them all up).

Spans (``utils/profiling.py``, recorded only under a profiler):
``med.model.window_attn``, ``med.model.full_attn``, ``med.model.moe``;
counters ``med.moe.assignments`` (every top-k assignment),
``med.moe.held`` (those this layer computed), ``med.moe.grad_slices``
(held experts whose gradient slices a backward wrote from their products)
and ``med.moe.grad_zeroed`` (held experts without frames, their slices
zeroed)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sliding_window_attention_packed
from ..utils.profiling import count, span
from .layers import Dense, _uniform_


@dataclasses.dataclass(frozen=True)
class MiMoArch:
    """The block's sizes: the published widths, and the cut this chip holds
    (published layers 0-6, the first pipeline stage of the 48: ``pattern``
    "F" full, "W" windowed; experts ``held[0]`` .. ``held[0] + held[1] - 1``
    of ``n_experts``)."""

    in_dim: int = 2074
    hidden: int = 4096
    heads: int = 64
    kv_heads_window: int = 8
    kv_heads_full: int = 4
    qk_dim: int = 192
    v_dim: int = 128
    rope_dim: int = 64
    theta_window: float = 10000.0
    theta_full: float = 5000000.0
    window: int = 128
    sink: bool = True
    value_scale: float = 0.707
    dense_width: int = 16384
    dense_layers: int = 1
    expert_width: int = 2048
    n_experts: int = 256
    top_k: int = 8
    held: Tuple[int, int] = (0, 8)
    pattern: str = "FWWWWFW"
    eps: float = 1e-5
    out_classes: int = 2

    @classmethod
    def from_dict(cls, d: Dict) -> "MiMoArch":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"MiMoArch has no fields {unknown}")
        d = dict(d)
        if "held" in d:
            d["held"] = tuple(d["held"])
        return cls(**d)


class RMSNorm(nn.Module):
    """x / sqrt(mean(x²) + eps) times a learned scale (flax's "scale")."""

    flax_layout = "norm"

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps) * self.weight


def rope_tables(T: int, theta: float, rope_dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, 1, rope_dim // 2) cos and sin of frame t's angles t·theta^(-2i/rope_dim),
    computed in float64 and stored in float32."""
    half = rope_dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) * 2.0 / rope_dim)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    return (ang.cos().to(torch.float32).to(device)[:, None],
            ang.sin().to(torch.float32).to(device)[:, None])


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on the first 2·half dims of each head of x (B, T, n,
    d), pairing dims i and i + half; the rest pass through."""
    half = cos.shape[-1]
    x1, x2, rest = x[..., :half], x[..., half:2 * half], x[..., 2 * half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


class Sinks(nn.Module):
    """A windowed layer's sink logits, (KV heads, query heads a KV head):
    head h = g·m + j is slot j of KV group g."""

    flax_layout = "stack"

    def __init__(self, groups: int, m: int):
        super().__init__()
        self.sinks = nn.Parameter(torch.zeros(groups, m))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.sinks.zero_()


class MiMoAttention(nn.Module):
    """GQA attention of one layer, windowed (with sinks) or full."""

    def __init__(self, arch: MiMoArch, windowed: bool):
        super().__init__()
        a = arch
        self.arch, self.windowed = a, windowed
        self.kv = a.kv_heads_window if windowed else a.kv_heads_full
        self.m = a.heads // self.kv
        self.theta = a.theta_window if windowed else a.theta_full
        self.q_proj = Dense(a.hidden, a.heads * a.qk_dim, bias=False)
        self.k_proj = Dense(a.hidden, self.kv * a.qk_dim, bias=False)
        self.v_proj = Dense(a.hidden, self.kv * a.v_dim, bias=False)
        self.o_proj = Dense(a.heads * a.v_dim, a.hidden, bias=False)
        self.sinks = Sinks(self.kv, self.m) if windowed and a.sink else None
        self._tables: Dict = {}

    def _rope(self, T: int, device):
        key = (T, device)
        if key not in self._tables:
            self._tables = {key: rope_tables(T, self.theta, self.arch.rope_dim, device)}
        return self._tables[key]

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        a = self.arch
        B, T, _ = u.shape
        cos, sin = self._rope(T, u.device)
        q = apply_rope(self.q_proj(u).view(B, T, a.heads, a.qk_dim), cos, sin)
        k = apply_rope(self.k_proj(u).view(B, T, self.kv, a.qk_dim), cos, sin)
        v = self.v_proj(u).view(B, T, self.kv, a.v_dim)
        if self.windowed:
            with span("med.model.window_attn"):
                o = self._windowed(q, k, v)
        else:
            with span("med.model.full_attn"):
                o = self._full(q, k, v)
        return self.o_proj(o * a.value_scale)

    def _windowed(self, q, k, v):
        """The packed layout: q (B·kv, qk, T·m), token t·m + j the slot j of
        frame t; k (B·kv, qk, T), v (B·kv, dv, T)."""
        a, kv, m = self.arch, self.kv, self.m
        B, T = q.shape[:2]
        # the kernels read the operands where they lie: contiguous copies
        qp = q.view(B, T, kv, m, a.qk_dim).permute(0, 2, 4, 1, 3).reshape(
            B * kv, a.qk_dim, T * m).contiguous()
        kp = k.permute(0, 2, 3, 1).reshape(B * kv, a.qk_dim, T).contiguous()
        vp = v.permute(0, 2, 3, 1).reshape(B * kv, a.v_dim, T).contiguous()
        sinks = None if self.sinks is None else self.sinks.sinks.repeat(B, 1)
        o = sliding_window_attention_packed(qp, kp, vp, a.window, m, exclude_start=True,
                                            sinks=sinks)
        return o.view(B, kv, a.v_dim, T, m).permute(0, 3, 1, 4, 2).reshape(B, T, a.heads * a.v_dim)

    def _full(self, q, k, v):
        """A causal softmax over every earlier frame, each KV head's m query
        heads against it in one product."""
        a, kv, m = self.arch, self.kv, self.m
        B, T = q.shape[:2]
        qg = q.view(B, T, kv, m, a.qk_dim).permute(0, 2, 3, 1, 4)      # (B, kv, m, T, qk)
        kg = k.permute(0, 2, 1, 3).unsqueeze(2)                         # (B, kv, 1, T, qk)
        vg = v.permute(0, 2, 1, 3).unsqueeze(2)                         # (B, kv, 1, T, dv)
        s = (qg @ kg.transpose(-1, -2)) * (1.0 / math.sqrt(a.qk_dim))
        later = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
        p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
        o = p @ vg                                                       # (B, kv, m, T, dv)
        return o.permute(0, 3, 1, 2, 4).reshape(B, T, a.heads * a.v_dim)


class SwiGLU(nn.Module):
    """W_2 (silu(W_1 u) ⊙ W_3 u), no biases."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.w1 = Dense(hidden, width, bias=False)
        self.w3 = Dense(hidden, width, bias=False)
        self.w2 = Dense(width, hidden, bias=False)

    def forward(self, u):
        return self.w2(F.silu(self.w1(u)) * self.w3(u))


class Router(nn.Module):
    """The router's (n_experts, hidden) weight and its fixed correction bias,
    which only selects (a parameter without a gradient: the optimiser leaves
    it alone)."""

    flax_layout = "stack"

    def __init__(self, hidden: int, n_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_experts, hidden))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n_experts), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.e_score_correction_bias.zero_()


class Experts(nn.Module):
    """The held experts' SwiGLU weights, stacked: w1 and w3 (E, width,
    hidden), w2 (E, hidden, width)."""

    flax_layout = "stack"

    def __init__(self, n: int, hidden: int, width: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(n, width, hidden))
        self.w3 = nn.Parameter(torch.zeros(n, width, hidden))
        self.w2 = nn.Parameter(torch.zeros(n, hidden, width))

    def reset_parameters(self, generator: torch.Generator) -> None:
        hidden, width = self.w1.shape[2], self.w1.shape[1]
        for p, fan_in in ((self.w1, hidden), (self.w3, hidden), (self.w2, width)):
            _uniform_(p, fan_in, generator)


def expert_swiglu(x, w1, w3, w2):
    """One held expert's SwiGLU on the frames routed to it: x (n, hidden),
    w1 and w3 (width, hidden), w2 (hidden, width) -> the output (n, hidden)
    and the two (n, width) products its backward,
    :func:`expert_swiglu_bwd`, reads: h1 = x w1ᵀ, h3 = x w3ᵀ."""
    h1, h3 = x @ w1.T, x @ w3.T
    return (F.silu(h1) * h3) @ w2.T, h1, h3


def expert_swiglu_bwd(g, x, w1, w3, w2, h1, h3, *, out):
    """dx of :func:`expert_swiglu` from the output's gradient g and the
    saved h1 and h3; the weights' gradients are written into ``out`` (dw1,
    dw3, dw2)."""
    dw1, dw3, dw2 = out
    s = torch.sigmoid(h1)
    act = h1 * s                                   # silu(h1)
    da = g @ w2                                    # (n, width)
    torch.mm(g.T, act * h3, out=dw2)
    dh3 = da * act
    dh1 = da * h3 * (s * (1.0 + h1 * (1.0 - s)))   # silu'(h1)
    torch.mm(dh1.T, x, out=dw1)
    torch.mm(dh3.T, x, out=dw3)
    return dh1 @ w1 + dh3 @ w3


class _HeldExperts(torch.autograd.Function):
    """The held experts ``experts`` (indices into the stacks w1, w3, w2) on
    their gathered frames xs, one output each. The backward makes each
    stacked gradient once and writes every expert's slices from its
    products; the slices of a held expert not in ``experts`` are zeroed."""

    @staticmethod
    def forward(ctx, experts, w1, w3, w2, *xs):
        ys, hs = [], []
        for e, x in zip(experts, xs):
            y, h1, h3 = expert_swiglu(x, w1[e], w3[e], w2[e])
            ys.append(y)
            hs += [h1, h3]
        ctx.experts = experts
        ctx.save_for_backward(w1, w3, w2, *xs, *hs)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        experts = ctx.experts
        w1, w3, w2, *rest = ctx.saved_tensors
        xs, hs = rest[:len(experts)], rest[len(experts):]
        dw = [torch.empty_like(w) for w in (w1, w3, w2)]
        dxs = [expert_swiglu_bwd(gs[i].contiguous(), xs[i], w1[e], w3[e], w2[e],
                                 hs[2 * i], hs[2 * i + 1], out=[d[e] for d in dw])
               for i, e in enumerate(experts)]
        idle = sorted(set(range(w1.shape[0])) - set(experts))
        for e in idle:
            for d in dw:
                d[e].zero_()
        count("med.moe.grad_slices", len(experts))
        count("med.moe.grad_zeroed", len(idle))
        return (None, *dw, *dxs)


class MiMoMoE(nn.Module):
    """Top-k routing over every expert; the sum of the held experts' SwiGLU
    outputs, each weighted by its normalised score."""

    def __init__(self, arch: MiMoArch):
        super().__init__()
        self.arch = arch
        self.first, n_held = arch.held
        self.gate = Router(arch.hidden, arch.n_experts)
        self.experts = Experts(n_held, arch.hidden, arch.expert_width)

    def select(self, scores: torch.Tensor) -> torch.Tensor:
        """(N, top_k) expert ids: the top k of the scores plus the bias."""
        biased = scores + self.gate.e_score_correction_bias
        return torch.topk(biased, self.arch.top_k, dim=-1).indices

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        with span("med.model.moe"):
            shape = u.shape
            x = u.reshape(-1, shape[-1])
            scores = torch.sigmoid(x @ self.gate.weight.T)                 # (N, E)
            chosen = self.select(scores.detach())                          # (N, k)
            picked = torch.gather(scores, 1, chosen)
            weights = picked / picked.sum(dim=-1, keepdim=True)            # (N, k)
            n_held = self.experts.w1.shape[0]
            ids = torch.arange(self.first, self.first + n_held, device=u.device)
            hit = chosen[:, :, None] == ids                                # (N, k, held)
            w_held = (weights[:, :, None] * hit).sum(dim=1)                # (N, held)
            # (expert, frame) pairs, by expert then frame: the one sync
            pairs = hit.any(dim=1).T.nonzero().cpu()
            counts = torch.bincount(pairs[:, 0], minlength=n_held).tolist()
            count("med.moe.assignments", chosen.numel())
            count("med.moe.held", len(pairs))
            rows = pairs[:, 1].to(u.device)
            out = torch.zeros_like(x)         # each call's rows distinct: no two adds meet
            held = [e for e, n in enumerate(counts) if n]
            if not held:                      # no gradient reaches the experts
                return out.reshape(shape)
            idxs = rows.split([counts[e] for e in held])
            ys = _HeldExperts.apply(tuple(held), self.experts.w1, self.experts.w3,
                                    self.experts.w2, *(x.index_select(0, i) for i in idxs))
            for e, idx, ye in zip(held, idxs, ys):
                out.index_add_(0, idx, ye * w_held.index_select(0, idx)[:, e:e + 1])
            return out.reshape(shape)


class MiMoLayer(nn.Module):
    def __init__(self, arch: MiMoArch, kind: str, dense: bool):
        super().__init__()
        self.attn_norm = RMSNorm(arch.hidden, arch.eps)
        self.attn = MiMoAttention(arch, windowed=kind == "W")
        self.ffn_norm = RMSNorm(arch.hidden, arch.eps)
        self.ffn = SwiGLU(arch.hidden, arch.dense_width) if dense else MiMoMoE(arch)

    def forward(self, h):
        h = h + self.attn(self.attn_norm(h))
        return h + self.ffn(self.ffn_norm(h))


class MiMoV2Flash(nn.Module):
    """x (B, T, in_dim) -> per-frame logits (B, T, out_classes)."""

    def __init__(self, arch: Optional[MiMoArch] = None):
        super().__init__()
        self.arch = a = arch or MiMoArch()
        if set(a.pattern) - {"F", "W"}:
            raise ValueError(f"a layer pattern takes 'F' (full) and 'W' (windowed); got "
                             f"{a.pattern!r}")
        first, n_held = a.held
        if not (0 <= first and n_held >= 1 and first + n_held <= a.n_experts):
            raise ValueError(f"held experts {a.held} do not lie in 0..{a.n_experts - 1}")
        self.W_in = Dense(a.in_dim, a.hidden, bias=True)
        self.layers = nn.ModuleList([MiMoLayer(a, kind, i < a.dense_layers)
                                     for i, kind in enumerate(a.pattern)])
        self.norm = RMSNorm(a.hidden, a.eps)
        self.W_out = Dense(a.hidden, a.out_classes, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.W_in(x)
        for layer in self.layers:
            h = layer(h)
        return self.W_out(self.norm(h))
