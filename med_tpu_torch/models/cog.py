"""COG — Chain-of-Gesture vision-language frame model (port of
``med_tpu.models.cog``; reference ``MED/modeling/models_COG.py``).

Per trial (T frames; B trials of one length go together, see below):

1. *Chain-of-gesture block*: project the visual features (T, F) and the
   frozen M x 512 prompt table (M = 15 gestures by default; 8 or 45 in the
   variants, see :class:`COG`) to d_model; for every frame the M text
   tokens cross-attend the last len_q=30 visual frames (2 encoder layers,
   8 heads, d_q=8, banded attention kernel), then one single-head attention
   over the text tokens. Output (T, M*d_model). The encoder runs
   feature-major, (d, N = T*M), as in the JAX package. SRM adds a second
   chain over 15 skill statements, concatenated on the feature axis.
2. *Slow path*: the TCN stage (11 layers) and num_R refinement stages (10
   layers, fed features) run back to back through the multi-stage TCN
   kernel; an FPN over the stage outputs gives 4 logit tracks at T.
3. *Fast path*: 16x average-pooled features through its own TCN stage and
   num_R refinements (fed softmaxed logits) -> 1 + num_R tracks at T/16.

A batch of B trials (a trial group, ``trial_batch`` > 1) folds into the
attention's head axis, B*8 heads in one kernel launch, as ``med_tpu``'s
batching rule of the attention op does; the TCN kernels take one launch a
trial.

Reference quirks kept on purpose: the MHA has no output projection and its
LayerNorm is unlearned; ``enc_norm`` is a flax ``nn.LayerNorm`` (eps 1e-6)
applied after the visual sequence is left-padded, so pad rows become its
bias; the FPN shares one lateral conv; the refinement AvgPool is a no-op.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sliding_window_attention_packed
from ..ops.interpolate import interp1d_linear
from ..ops.tcn_fused import dilated_residual_multistack_stages
from .layers import Conv1d, Dense, ResidualStack
from .layers import ln0 as _ln0
from .prompts import (EMBED_DIM, GESTURES, GESTURES_OBSERVED, SKILL_LEVEL_PROMPTS,
                      SKILL_STATEMENTS, load_prompt_embeddings)


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
    """Learned LayerNorm over the feature axis of a (B, d, N) feature-major
    tensor."""

    def forward(self, x):
        return _ln0(x) * self.weight[:, None] + self.bias[:, None]


class _PackedProj(Dense):
    """Bias-free QKV projection emitting the attention kernel's packed
    layout with the batch folded into the heads, (B*H, dk, N): from
    feature-major (B, d, N) input when ``transposed``, else from (B, N, d)."""

    def __init__(self, d_in: int, d_q: int, n_heads: int, transposed: bool = False):
        super().__init__(d_in, d_q * n_heads, bias=False)
        self.d_q, self.n_heads, self.transposed = d_q, n_heads, transposed

    def forward(self, x):
        y = self.weight @ (x if self.transposed else x.transpose(-1, -2))  # (B, H*dk, N)
        return y.reshape(-1, self.d_q, y.shape[-1])


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
        """text (B, d, N) feature-major queries; text0 (M, d) shared K/V rows."""
        qp = self.W_Q.weight @ text                   # (B, d, N)
        k0 = self.W_K(text0)                          # (M, d)
        v0 = self.W_V(text0)
        scores = k0 @ qp / math.sqrt(self.d_model)    # (B, M, N)
        ctx = v0.T @ torch.softmax(scores, dim=-2)    # (B, d, N)
        return _ln0(ctx + text)


class COGEncoderLayer(nn.Module):
    """EncoderLayer_COG: learned pre-norms around the banded local attention
    of the per-frame text queries over the whole visual sequence. The trials
    of a batch ride the attention's head axis: one kernel launch for all of
    them, as med_tpu's batching rule of the op does."""

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
        """text (B, d_model, N = T*M) feature-major; visual_seq (B, T +
        window - 1, d_model) with its left pad rows -> (B, d_model, N)."""
        q_in, q, k, v = self.open(text, visual_seq)
        return self.close(sliding_window_attention_packed(q, k, v, self.window,
                                                          self.m_tokens), q_in)

    def open(self, text, visual_seq):
        """The layer up to its attention: (q_in, q, k, v), the packed q with
        dummy queries for the pad frames in front."""
        q_in = self.norm1(text)
        q = self.W_Q(q_in)
        k = self.W_K(visual_seq)
        v = self.W_V(visual_seq)
        q = F.pad(q, ((self.window - 1) * self.m_tokens, 0))
        return q_in, q, k, v

    def close(self, ctx, q_in):
        """The layer after its attention: the pad frames' queries dropped,
        residual, norms and FFN -> (B, d_model, N)."""
        B, N = q_in.shape[0], q_in.shape[-1]
        ctx = ctx[:, :, (self.window - 1) * self.m_tokens:]
        ctx = ctx.reshape(B, self.n_heads * self.d_q, N)
        out = self.norm3(_ln0(ctx + q_in))
        return self.ffn(out)


class ChainOfGestureTransformer(nn.Module):
    """MyTransformer + TransformerCOT: the chain-of-gesture block over the
    ``m_tokens`` rows of its prompt table."""

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
        """gest_embed (M, gest_dim), long_feature (B, T, f_dim) -> (B, T,
        M*d_model); one trial's (T, f_dim) -> (T, M*d_model)."""
        if long_feature.dim() == 2:
            return self(gest_embed, long_feature[None])[0]
        visual, text0, text = self.embed(gest_embed, long_feature)
        for layer in self.layers():
            text = layer(text, visual)
        return self.close(text, text0)

    def layers(self) -> List[COGEncoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.n_layers)]

    def embed(self, gest_embed, long_feature):
        """The block's inputs: visual (B, T + len_q - 1, d_model) with its
        normed pad rows, the projected prompt rows text0 (M, d_model) and
        the per-frame text tokens (B, d_model, T*M)."""
        visual = self.linear1(long_feature)
        text0 = self.linear2(gest_embed)
        B, T = visual.shape[0], visual.shape[1]
        # the reference norms its zero-padded windows, so pad rows become
        # enc_norm(0) = its bias: pad first, then norm
        visual = self.enc_norm(F.pad(visual, (0, 0, self.len_q - 1, 0)))
        text = text0.T.repeat(1, T).expand(B, -1, -1)  # token n = t*M + m
        return visual, text0, text

    def close(self, text, text0):
        """The attention over the prompt rows -> (B, T, M*d_model)."""
        out = self.atten(text, text0)
        B, M = out.shape[0], text0.shape[0]
        return out.transpose(-1, -2).reshape(B, out.shape[-1] // M, M * out.shape[1])


class COGStage(nn.Module):
    """SingleStageModel1_COG: optional 1x1 input conv, optional channel
    dropout, dilated residual stack, 1x1 class conv. Returns (features,
    logits), the logits float32 in any ``dtype``. A training forward takes
    its dropout masks from ``masks`` ({"channel": (B, 1, C) keep, "stack":
    (L, B, T, C) uint8}, as :meth:`dropout_masks` draws them)."""

    def __init__(self, num_layers: int, in_dim: int, f_maps: int,
                 out_classes: int, causal: bool = True,
                 use_input_conv: bool = True, channel_dropout: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channel_dropout, self.dtype = channel_dropout, dtype
        self.conv_in = Conv1d(in_dim, f_maps, dtype=dtype) if use_input_conv else None
        self.stack = ResidualStack(num_layers, f_maps, causal=causal, dtype=dtype)
        self.conv_out = Conv1d(f_maps, out_classes, dtype=dtype)

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
        if self.dtype is not None:
            x = x.to(self.dtype)
        out = self.conv_in(x) if self.conv_in is not None else x
        if self.channel_dropout and train:
            out = out * keep.to(out.dtype) * 2.0
        return out

    def forward(self, x, train: bool = False, masks=None):
        out = (self.stack(self.pre(x, True, masks.get("channel")), masks["stack"]) if train
               else self.stack(self.pre(x)))
        return out, self.conv_out(out).to(torch.float32)


class COG(nn.Module):
    """COG and its configuration variants (reference models_COG.py:262-480,
    med_tpu's ``COG``):

    - default: the 15 gesture prompts through the chain-of-gesture block;
    - ``use_all_gestures=False``: the 8 gestures observed in the dataset;
    - ``use_skill_prompt=True``: the skill-conditioned prompts, 3 skill
      levels x the gestures (45 rows with all of them);
    - ``srm=True``: a second chain, ``cot_skill``, over the 15 skill
      statements, concatenated with the gesture chain before the TCN paths.

    The prompt tables are buffers outside the state_dict, as they sit in
    'constants' in the JAX package; serving copies a checkpoint's tables
    in. ``dtype=torch.bfloat16`` computes the TCN paths, the FPN and the
    class convs in bfloat16 (the chains stay float32, through the attention
    kernels); the stacks then run the plain layer loop, stage by stage, as
    ``med_tpu``'s unfused path does, and the logits are float32."""

    def __init__(self, num_layers_basic: int = 11, num_layers_r: int = 10,
                 num_r: int = 3, f_maps: int = 64, f_dim: int = 2048,
                 out_classes: int = 2, causal: bool = True, d_model: int = 64,
                 d_q: int = 8, len_q: int = 30, gest_dim: int = EMBED_DIM,
                 fast_pool: int = 16, prompt_path: Optional[str] = None,
                 use_all_gestures: bool = True, use_skill_prompt: bool = False,
                 srm: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers_basic, self.num_layers_r = num_layers_basic, num_layers_r
        self.num_r, self.causal, self.fast_pool = num_r, causal, fast_pool
        self.dtype = dtype
        texts = prompt_texts(use_all_gestures, use_skill_prompt, srm)
        gest = load_prompt_embeddings(prompt_path, texts, gest_dim)
        self.register_buffer("gest_embed", torch.from_numpy(gest), persistent=False)
        self.cot = ChainOfGestureTransformer(f_dim, gest_dim, d_model, d_q, len_q,
                                             m_tokens=len(texts))
        width = len(texts) * d_model
        self.cot_skill = None
        if srm:
            skill = load_prompt_embeddings(
                prompt_path.replace("gest", "skill") if prompt_path else None,
                SKILL_STATEMENTS, gest_dim)
            self.register_buffer("skill_embed", torch.from_numpy(skill), persistent=False)
            self.cot_skill = ChainOfGestureTransformer(
                f_dim, gest_dim, d_model, d_q, len_q, m_tokens=len(SKILL_STATEMENTS))
            width += len(SKILL_STATEMENTS) * d_model
        self.slow_names = ["TCN"] + [f"R{r}" for r in range(num_r)]
        self.add_module("TCN", COGStage(num_layers_basic, width, f_maps,
                                        out_classes, causal, channel_dropout=True,
                                        dtype=dtype))
        for r in range(num_r):
            self.add_module(f"R{r}", COGStage(num_layers_r, f_maps, f_maps,
                                              out_classes, causal,
                                              use_input_conv=False, dtype=dtype))
        self.latlayer1 = Conv1d(f_maps, f_maps, dtype=dtype)
        self.conv_out = Conv1d(f_maps, out_classes, dtype=dtype)
        self.fast_names = ["fast_stage1"] + [f"fast_R{r}" for r in range(num_r)]
        self.add_module("fast_stage1", COGStage(num_layers_basic, width, f_maps,
                                                out_classes, causal,
                                                channel_dropout=True, dtype=dtype))
        for r in range(num_r):
            self.add_module(f"fast_R{r}", COGStage(num_layers_r, out_classes,
                                                   f_maps, out_classes, causal,
                                                   dtype=dtype))

    def dropout_masks(self, T: int, generator: torch.Generator, B: int = 1):
        """One training forward's dropout masks for B trials, by stage name
        (see :class:`COGStage`), drawn from ``generator`` on the model's
        device: channel dropout on the TCN and fast_stage1 stages, stack
        masks on all eight stacks."""
        Tf = T // self.fast_pool
        return {name: getattr(self, name).dropout_masks(
                    B, T if name in self.slow_names else Tf, generator)
                for name in self.slow_names + self.fast_names}

    def forward(self, x, train: bool = False, masks=None,
                generator: Optional[torch.Generator] = None, run=None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """x (B, T, f_dim), B trials of one length (one, outside a trial
        group) -> (out_list, f_list): 4 slow FPN logit tracks at T and 1 +
        num_r fast tracks at T // fast_pool, each (B, T_i, out_classes), and
        the stages' features, detached (nothing differentiates them).
        ``train`` applies dropout with ``masks`` (:meth:`dropout_masks`'
        layout), or with masks drawn from ``generator`` when none are given.

        The kernels run here, the rest in the stretches between them
        (:meth:`stretch`): K1 after "embed" and each "layer<i>", K2a (the
        slow stages) after "slow", each fast stage's K2b after the stretch
        before it. ``run(name, *inputs)`` runs a stretch and returns its
        outputs: by default the stretch itself; the train step's graphs
        pass their replay of it (``train/graphs.py``). SRM's skill chain
        runs whole before "slow", which concatenates it."""
        if not train:
            masks = None
        elif masks is None:
            if generator is None:
                raise ValueError("a training forward needs masks or a generator")
            masks = self.dropout_masks(x.shape[1], generator, x.shape[0])
        if run is None:
            def run(name, *xs):
                return self.stretch(name)(*xs)

        def mask(name, key):
            return None if masks is None else masks[name].get(key)

        layers = self.cot.layers()
        text0, visual, q_in, q, k, v = run("embed", x)
        for i, layer in enumerate(layers):
            ctx = sliding_window_attention_packed(q, k, v, layer.window, layer.m_tokens)
            if i + 1 < len(layers):
                q_in, q, k, v = run(f"layer{i + 1}", ctx, q_in, visual)
        skill = [] if self.cot_skill is None else [self.cot_skill(self.skill_embed, x)]
        xx, *x0 = run("slow", ctx, q_in, text0, mask("TCN", "channel"), *skill)
        out = run("fpn", xx, mask("fast_stage1", "channel"), *self._slow_stacks(x0, masks))
        n = len(self.slow_names)
        out_list, f_list, fx = list(out[:n]), list(out[n:2 * n]), out[2 * n:]
        for name in self.fast_names:
            fast_out, f, *fx = run(name, *getattr(self, name).stack.trials(fx, mask(name, "stack")))
            out_list.append(fast_out)
            f_list.append(f)
        return out_list, f_list

    def stretch(self, name: str):
        """The stretch of :meth:`forward` called ``name``: a pure tensor
        function of its inputs and of its submodules' parameters. Nothing in
        it launches a hand-written kernel, draws random numbers or syncs the
        host, so a CUDA graph can hold it. It hands a kernel its input trial
        by trial, (T, C) each."""
        if name.startswith("layer"):
            return functools.partial(self._layer, int(name[len("layer"):]))
        if name in self.fast_names:
            return functools.partial(self._fast, self.fast_names.index(name))
        return {"embed": self._embed, "slow": self._slow, "fpn": self._fpn}[name]

    def _embed(self, x):
        """"embed": the chain's projections, enc_norm, the text tokens and
        layer 0 up to its K1 -> (text0, visual, q_in, q, k, v)."""
        visual, text0, text = self.cot.embed(self.gest_embed, x)
        return (text0, visual, *self.cot.layer0.open(text, visual))

    def _layer(self, i, ctx, q_in, visual):
        """"layer<i>": layer i-1 after its K1 and layer i up to its own."""
        layers = self.cot.layers()
        return layers[i].open(layers[i - 1].close(ctx, q_in), visual)

    def _slow(self, ctx, q_in, text0, keep, *skill):
        """"slow": the last layer after its K1, the prompt attention (SRM's
        skill chain concatenated), the TCN stage's input conv and channel
        dropout -> (xx, the TCN stage's input trials)."""
        xx = self.cot.close(self.cot.layers()[-1].close(ctx, q_in), text0)
        if skill:
            xx = torch.cat([xx, *skill], dim=-1)
        return xx, *self.TCN.pre(xx, keep is not None, keep).unbind(0)

    def _slow_stacks(self, x0, masks=None):
        """K2a: the slow stages' stacks over x0's trials -> each trial's S
        stage outputs. In float32 all stages of a trial run back to back
        through the multi-stage kernel, one launch a trial (the stages' own
        class convs are dead here, as in the JAX package); in another dtype
        stage by stage."""
        slow = [getattr(self, n) for n in self.slow_names]
        if self.dtype is not None:
            per_stage = []
            for name, stage in zip(self.slow_names, slow):
                x0 = stage.stack.trials(x0, None if masks is None else masks[name]["stack"])
                per_stage.append(x0)
            return list(zip(*per_stage))
        per_trial = []
        for b, xb in enumerate(x0):
            stack_masks = (None if masks is None else
                           [masks[n]["stack"][:, b].contiguous() for n in self.slow_names])
            per_trial.append(dilated_residual_multistack_stages(
                xb, [s.stack.weights() for s in slow],
                self.num_layers_basic, self.num_layers_r, causal=self.causal,
                masks=stack_masks))
        return per_trial

    def _fpn(self, xx, keep, *per_trial):
        """"fpn": the FPN's upsample-adds over the slow stages' features
        with its one shared lateral conv, the 16x pool and fast_stage1's
        input conv and channel dropout -> (the 4 slow tracks, the slow
        features, fast_stage1's input trials)."""
        f_list = [torch.stack(hs) for hs in zip(*per_trial)]
        p = f_list[-1]
        pyramid = [p]
        for c in reversed(f_list[:-1]):
            p = interp1d_linear(p, c.shape[1], axis=1) + self.latlayer1(c)
            pyramid.insert(0, p)
        tracks = [self.conv_out(p).to(torch.float32) for p in pyramid]
        fast = F.avg_pool1d(xx.transpose(1, 2), self.fast_pool).transpose(1, 2)
        fast = self.fast_stage1.pre(fast, keep is not None, keep)
        return (*tracks, *(f.detach() for f in f_list), *fast.unbind(0))

    def _fast(self, i, *trials):
        """Fast stage i after its K2b: its class conv, then the next stage's
        input conv on the softmax -> (its track, its features, the next
        stage's input trials); the last stage's class conv alone."""
        names = self.fast_names
        f = torch.stack(trials)
        out = getattr(self, names[i]).conv_out(f).to(torch.float32)
        if i + 1 == len(names):
            return out, f.detach()
        nxt = getattr(self, names[i + 1])
        return out, f.detach(), *nxt.pre(torch.softmax(out, dim=-1)).unbind(0)


class Segment(nn.Module):
    """A stretch of :meth:`COG.forward` (:meth:`COG.stretch`) holding the
    submodules whose parameters it uses: a CUDA graph of it differentiates
    those (``train/graphs.py``)."""

    def __init__(self, fn, *modules: nn.Module):
        super().__init__()
        self.fn = fn
        self.uses = nn.ModuleList(modules)

    def forward(self, *xs):
        return self.fn(*xs)


def segments(model: COG) -> Dict[str, Segment]:
    """The stretches of a float32 COG without SRM as :class:`Segment`
    modules, in the order :meth:`COG.forward` runs them."""
    if model.dtype is not None or model.cot_skill is not None:
        raise ValueError("the segments cut a float32 COG without SRM")
    layers = model.cot.layers()

    def proj(layer):
        return layer.norm1, layer.W_Q, layer.W_K, layer.W_V

    def close(layer):
        return layer.norm3, layer.ffn

    uses = {"embed": (model.cot.linear1, model.cot.linear2, model.cot.enc_norm,
                      *proj(layers[0]))}
    for i in range(1, len(layers)):
        uses[f"layer{i}"] = (*close(layers[i - 1]), *proj(layers[i]))
    uses["slow"] = (*close(layers[-1]), model.cot.atten, model.TCN.conv_in)
    uses["fpn"] = (model.latlayer1, model.conv_out, model.fast_stage1.conv_in)
    fast = [getattr(model, n) for n in model.fast_names]
    for name, stage, nxt in zip(model.fast_names, fast, fast[1:] + [None]):
        uses[name] = (stage.conv_out,) + (() if nxt is None else (nxt.conv_in,))
    return {name: Segment(model.stretch(name), *mods) for name, mods in uses.items()}


def prompt_texts(use_all_gestures: bool = True, use_skill_prompt: bool = False,
                 srm: bool = False):
    """The rows of COG's gesture-prompt table (med_tpu's
    ``COG._prompt_texts``): the 15 gestures or the 8 observed ones; with
    the skill prompt and no SRM, each of them for each skill level."""
    gestures = GESTURES if use_all_gestures else GESTURES_OBSERVED
    if use_skill_prompt and not srm:
        return tuple(f"A self-reported {skill}-skilled surgeon is {g} ..."
                     for skill in SKILL_LEVEL_PROMPTS for g in gestures)
    return gestures
