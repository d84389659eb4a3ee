"""COG — Chain-of-Gesture vision-language frame model (port of
``med_tpu.models.cog``; reference ``MED/modeling/models_COG.py``).

Per trial (B=1, T frames):

1. *Chain-of-gesture block*: project the visual features (T, F) and the
   frozen 15x512 gesture-prompt table to d_model; for every frame the 15
   text tokens cross-attend the last len_q=30 visual frames (2 encoder
   layers, 8 heads, d_q=8, banded attention kernel), then one single-head
   attention over the text tokens. Output (T, 15*d_model). The encoder runs
   feature-major and 2-D, (d, N = T*15), as in the JAX package.
2. *Slow path*: the TCN stage (11 layers) and num_R refinement stages (10
   layers, fed features) run back to back through the multi-stage TCN
   kernel; an FPN over the stage outputs gives 4 logit tracks at T.
3. *Fast path*: 16x average-pooled features through its own TCN stage and
   num_R refinements (fed softmaxed logits) -> 1 + num_R tracks at T/16.

Reference quirks kept on purpose: the MHA has no output projection and its
LayerNorm is unlearned; ``enc_norm`` is a flax ``nn.LayerNorm`` (eps 1e-6)
applied after the visual sequence is left-padded, so pad rows become its
bias; the FPN shares one lateral conv; the refinement AvgPool is a no-op.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sliding_window_attention_packed
from ..ops.interpolate import interp1d_linear
from ..ops.tcn_fused import dilated_residual_multistack_stages
from .layers import Conv1d, Dense, ResidualStack
from .prompts import EMBED_DIM, GESTURES, load_prompt_embeddings


def _ln0(x, eps: float = 1e-5):
    """Affine-free layer norm over axis 0, the feature axis of the
    feature-major (d, N) encoder layout."""
    mean = x.mean(dim=0, keepdim=True)
    var = (x - mean).square().mean(dim=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class _Norm(nn.Module):
    """Learned scale and bias of a LayerNorm; its flax counterpart has
    ("scale", "bias")."""

    flax_layout = "norm"

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class LayerNorm(_Norm):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6 and the variance
    taken as E[x^2] - E[x]^2, clipped at 0."""

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp(x.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
        return (x - mean) * torch.rsqrt(var + 1e-6) * self.weight + self.bias


class _LayerNormD(_Norm):
    """Learned LayerNorm over AXIS 0 of a (d, N) feature-major tensor."""

    def forward(self, x):
        return _ln0(x) * self.weight[:, None] + self.bias[:, None]


class _PackedProj(Dense):
    """Bias-free QKV projection emitting the attention kernel's packed
    layout (H, dk, N): from feature-major (d, N) input when ``transposed``,
    else from (N, d)."""

    def __init__(self, d_in: int, d_q: int, n_heads: int, transposed: bool = False):
        super().__init__(d_in, d_q * n_heads, bias=False)
        self.d_q, self.n_heads, self.transposed = d_q, n_heads, transposed

    def forward(self, x):
        y = self.weight @ (x if self.transposed else x.T)          # (H*dk, N)
        return y.reshape(self.n_heads, self.d_q, -1)


class _FFNT(nn.Module):
    """Position-wise FFN in the feature-major layout, residual + unlearned
    LN (flax children Dense_0 / Dense_1, bias-free)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.Dense_0 = Dense(d_model, d_ff, bias=False)
        self.Dense_1 = Dense(d_ff, d_model, bias=False)

    def forward(self, x):
        y = torch.relu(self.Dense_0.weight @ x)
        return _ln0(self.Dense_1.weight @ y + x)


class _COGAttentionD(nn.Module):
    """Single-head COG attention (no output projection, residual + unlearned
    LN) in the feature-major layout, with the frame-invariant K/V (the
    prompt tokens) projected once."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.W_Q = Dense(d_model, d_model, bias=False)
        self.W_K = Dense(d_model, d_model, bias=False)
        self.W_V = Dense(d_model, d_model, bias=False)

    def forward(self, text, text0):
        """text (d, N) feature-major queries; text0 (M, d) shared K/V rows."""
        qp = self.W_Q.weight @ text                   # (d, N)
        k0 = self.W_K(text0)                          # (M, d)
        v0 = self.W_V(text0)
        scores = k0 @ qp / math.sqrt(self.d_model)    # (M, N)
        ctx = v0.T @ torch.softmax(scores, dim=0)     # (d, N)
        return _ln0(ctx + text)


class COGEncoderLayer(nn.Module):
    """EncoderLayer_COG: learned pre-norms around the banded local attention
    of the per-frame text queries over the whole visual sequence."""

    def __init__(self, d_model: int, d_ff: int, d_q: int, n_heads: int,
                 window: int, m_tokens: int = 15):
        super().__init__()
        self.d_q, self.n_heads, self.window, self.m_tokens = d_q, n_heads, window, m_tokens
        self.norm1 = _LayerNormD(d_model)
        self.W_Q = _PackedProj(d_model, d_q, n_heads, transposed=True)
        self.W_K = _PackedProj(d_model, d_q, n_heads)
        self.W_V = _PackedProj(d_model, d_q, n_heads)
        self.norm3 = _LayerNormD(d_model)
        self.ffn = _FFNT(d_model, d_ff)

    def forward(self, text, visual_seq):
        """text (d_model, N = T*M) feature-major; visual_seq (T + window - 1,
        d_model) with its left pad rows -> (d_model, N)."""
        M = self.m_tokens
        q_in = self.norm1(text)
        q = self.W_Q(q_in)
        k = self.W_K(visual_seq)
        v = self.W_V(visual_seq)
        pad = self.window - 1
        T = visual_seq.shape[0] - pad
        # dummy queries for the pad frames, dropped after the attention
        q = F.pad(q, (pad * M, 0))
        ctx = sliding_window_attention_packed(q, k, v, self.window, M)[:, :, pad * M:]
        ctx = ctx.reshape(self.n_heads * self.d_q, T * M)
        out = self.norm3(_ln0(ctx + q_in))
        return self.ffn(out)


class ChainOfGestureTransformer(nn.Module):
    """MyTransformer + TransformerCOT: the chain-of-gesture block."""

    def __init__(self, f_dim: int, gest_dim: int, d_model: int, d_q: int,
                 len_q: int, n_heads: int = 8, n_layers: int = 2,
                 m_tokens: int = len(GESTURES)):
        super().__init__()
        self.len_q = len_q
        self.linear1 = Dense(f_dim, d_model, bias=False)
        self.linear2 = Dense(gest_dim, d_model, bias=False)
        self.enc_norm = LayerNorm(d_model)
        for i in range(n_layers):
            self.add_module(f"layer{i}", COGEncoderLayer(
                d_model, f_dim, d_q, n_heads, len_q, m_tokens=m_tokens))
        self.n_layers = n_layers
        self.atten = _COGAttentionD(d_model)

    def forward(self, gest_embed, long_feature):
        """gest_embed (M, gest_dim), long_feature (T, f_dim) -> (T, M*d_model)."""
        visual = self.linear1(long_feature)
        text0 = self.linear2(gest_embed)
        T, M = visual.shape[0], text0.shape[0]
        # the reference norms its zero-padded windows, so pad rows become
        # enc_norm(0) = its bias: pad first, then norm
        visual = self.enc_norm(F.pad(visual, (0, 0, self.len_q - 1, 0)))
        text = text0.T.repeat(1, T)                   # token n = t*M + m
        for i in range(self.n_layers):
            text = getattr(self, f"layer{i}")(text, visual)
        out = self.atten(text, text0)
        return out.T.reshape(T, M * out.shape[0])


class COGStage(nn.Module):
    """SingleStageModel1_COG: optional 1x1 input conv, optional channel
    dropout, dilated residual stack, 1x1 class conv. Returns (features,
    logits). A training forward takes its dropout masks from ``masks``
    ({"channel": (B, 1, C) keep, "stack": (L, B, T, C) uint8}, as
    :meth:`dropout_masks` draws them)."""

    def __init__(self, num_layers: int, in_dim: int, f_maps: int,
                 out_classes: int, causal: bool = True,
                 use_input_conv: bool = True, channel_dropout: bool = False):
        super().__init__()
        self.channel_dropout = channel_dropout
        self.conv_in = Conv1d(in_dim, f_maps) if use_input_conv else None
        self.stack = ResidualStack(num_layers, f_maps, causal=causal)
        self.conv_out = Conv1d(f_maps, out_classes)

    def dropout_masks(self, B: int, T: int, generator: torch.Generator):
        masks = {}
        if self.channel_dropout:
            # torch Dropout2d on (B, C, T, 1): whole channels kept or zeroed
            C = self.stack.w3.shape[-1]
            masks["channel"] = torch.randint(
                0, 2, (B, 1, C), generator=generator, device=self.stack.w3.device
            ).to(torch.float32)
        masks["stack"] = self.stack.dropout_mask(B, T, generator)
        return masks

    def pre(self, x, train: bool = False, keep=None):
        out = self.conv_in(x) if self.conv_in is not None else x
        if self.channel_dropout and train:
            out = out * keep * 2.0
        return out

    def forward(self, x, train: bool = False, masks=None):
        if train:
            out = self.stack(self.pre(x, True, masks.get("channel")), masks["stack"])
        else:
            out = self.stack(self.pre(x))
        return out, self.conv_out(out)


class COG(nn.Module):
    """The default COG configuration: 15 gesture prompts, one chain. The
    gesture table is a buffer outside the state_dict, as it sits outside
    'params' in the JAX package; serving copies a checkpoint's table in."""

    def __init__(self, num_layers_basic: int = 11, num_layers_r: int = 10,
                 num_r: int = 3, f_maps: int = 64, f_dim: int = 2048,
                 out_classes: int = 2, causal: bool = True, d_model: int = 64,
                 d_q: int = 8, len_q: int = 30, gest_dim: int = EMBED_DIM,
                 fast_pool: int = 16, prompt_path: Optional[str] = None):
        super().__init__()
        self.num_layers_basic, self.num_layers_r = num_layers_basic, num_layers_r
        self.num_r, self.causal, self.fast_pool = num_r, causal, fast_pool
        gest = load_prompt_embeddings(prompt_path, GESTURES, gest_dim)
        self.register_buffer("gest_embed", torch.from_numpy(gest), persistent=False)
        M = len(GESTURES)
        self.cot = ChainOfGestureTransformer(f_dim, gest_dim, d_model, d_q, len_q,
                                             m_tokens=M)
        width = M * d_model
        self.slow_names = ["TCN"] + [f"R{r}" for r in range(num_r)]
        self.add_module("TCN", COGStage(num_layers_basic, width, f_maps,
                                        out_classes, causal, channel_dropout=True))
        for r in range(num_r):
            self.add_module(f"R{r}", COGStage(num_layers_r, f_maps, f_maps,
                                              out_classes, causal,
                                              use_input_conv=False))
        self.latlayer1 = Conv1d(f_maps, f_maps)
        self.conv_out = Conv1d(f_maps, out_classes)
        self.fast_names = ["fast_stage1"] + [f"fast_R{r}" for r in range(num_r)]
        self.add_module("fast_stage1", COGStage(num_layers_basic, width, f_maps,
                                                out_classes, causal,
                                                channel_dropout=True))
        for r in range(num_r):
            self.add_module(f"fast_R{r}", COGStage(num_layers_r, out_classes,
                                                   f_maps, out_classes, causal))

    def dropout_masks(self, T: int, generator: torch.Generator):
        """One training forward's dropout masks, by stage name (see
        :class:`COGStage`), drawn from ``generator`` on the model's device:
        channel dropout on the TCN and fast_stage1 stages, stack masks on all
        eight stacks."""
        Tf = T // self.fast_pool
        return {name: getattr(self, name).dropout_masks(
                    1, T if name in self.slow_names else Tf, generator)
                for name in self.slow_names + self.fast_names}

    def forward(self, x, train: bool = False, masks=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """x (1, T, f_dim), one trial -> (out_list, f_list): 4 slow FPN logit
        tracks at T and 1 + num_r fast tracks at T // fast_pool, each
        (1, T_i, out_classes). ``train`` applies dropout with ``masks``
        (:meth:`dropout_masks`' layout), or with masks drawn from
        ``generator`` when none are given."""
        if x.shape[0] != 1:
            raise ValueError("COG processes one trial at a time (B=1)")
        if train and masks is None:
            if generator is None:
                raise ValueError("a training forward needs masks or a generator")
            masks = self.dropout_masks(x.shape[1], generator)
        xx = self.cot(self.gest_embed, x[0])[None]    # (1, T, M*d_model)

        # slow path: all stages back to back through the multi-stage kernel;
        # the stages' own class convs are dead here, as in the JAX package
        slow = [getattr(self, n) for n in self.slow_names]
        keep = masks["TCN"].get("channel") if train else None
        stack_masks = ([masks[n]["stack"][:, 0].contiguous() for n in self.slow_names]
                       if train else None)
        hs = dilated_residual_multistack_stages(
            slow[0].pre(xx, train, keep)[0], [s.stack.weights() for s in slow],
            self.num_layers_basic, self.num_layers_r, causal=self.causal,
            masks=stack_masks)
        f_list = [h[None] for h in hs]

        # FPN upsample-add with a single shared lateral conv
        p = f_list[-1]
        pyramid = [p]
        for c in reversed(f_list[:-1]):
            p = interp1d_linear(p, c.shape[1], axis=1) + self.latlayer1(c)
            pyramid.insert(0, p)
        out_list = [self.conv_out(p) for p in pyramid]

        # fast path
        fast = F.avg_pool1d(xx.transpose(1, 2), self.fast_pool).transpose(1, 2)
        fast_f, fast_out = self.fast_stage1(
            fast, train, masks["fast_stage1"] if train else None)
        f_list.append(fast_f)
        out_list.append(fast_out)
        for name in self.fast_names[1:]:
            fast_f, fast_out = getattr(self, name)(
                torch.softmax(fast_out, dim=-1), train, masks[name] if train else None)
            f_list.append(fast_f)
            out_list.append(fast_out)
        return out_list, f_list

