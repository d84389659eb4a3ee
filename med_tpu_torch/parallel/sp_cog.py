"""Sequence-parallel COG: the flagship frame model on one trial whose time
axis is split over the ranks (port of ``med_tpu.parallel.sp_cog``).

Everything in COG is frame-local except three things, each one cheap
exchange:

1. the chain-of-gesture encoder's sliding window (len_q frames): the keys
   and values need the last ``len_q - 1`` normed visual rows of the left
   neighbour (:func:`halo_left`). At the global left edge those rows are
   the single-rank path's zero-padded rows through ``enc_norm``, i.e. its
   bias: the edge halo is β rows, not zeros. Each shard's encoder layers
   are the model's own, so the packed attention kernel (K1 forward, K3
   backward) runs on every rank;
2. the causal dilated taps of the TCN stacks (``seqpar.seq_shift_right``);
3. the masked means of the CE and smoothing losses (one psum pair a
   reduction; the smoothing pair (t-1, t) takes a one-frame shift).

The fast path's average pool, the nearest-resampled track labels and the
FPN (every slow track is full length, so its upsample is the identity) are
shard-local when the local length is a multiple of ``fast_pool``. The
functions run the port's ``COG`` module, its checkpoints unchanged. SRM
and the skill prompts stay on the single-rank path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..train import losses
from .comm import halo_left, seq_shift_right
from .seqpar import _conv1x1, _logits, sp_residual_stack

__all__ = ["halo_left", "sp_cog_transformer", "sp_cog_forward", "sp_cog_loss",
           "sp_cog_loss_masked", "sp_cog_dropout"]


def sp_cog_transformer(cot, gest_embed: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """``ChainOfGestureTransformer`` on a (T_local, f_dim) block ->
    (T_local, M*d_model): one halo of ``len_q - 1`` normed visual rows
    replaces the single-rank left pad."""
    visual = cot.linear1(x)
    text0 = cot.linear2(gest_embed)
    normed = cot.enc_norm(visual)
    halo = halo_left(normed, cot.len_q - 1, group, fill_row=cot.enc_norm.bias)
    visual_seq = torch.cat([halo, normed], dim=0).contiguous()[None]
    T, M = x.shape[0], text0.shape[0]
    text = text0.T.repeat(1, T)[None]                 # token n = t*M + m
    for i in range(cot.n_layers):
        text = getattr(cot, f"layer{i}")(text, visual_seq)
    out = cot.atten(text, text0)
    return out[0].T.reshape(T, M * out.shape[1])


def _stage(stage, x, group, masks=None):
    """A ``COGStage`` on a (T_local, C) block: optional input conv and
    channel dropout (keep (C,) x 2), the SP stack, the class conv."""
    h = _conv1x1(stage.conv_in, x) if stage.conv_in is not None else x
    if masks is not None and "channel" in masks:
        h = h * masks["channel"].to(h.dtype) * 2.0
    h = sp_residual_stack(h, stage.stack, group, None if masks is None else masks["stack"])
    return h, _logits(stage.conv_out, h)


def sp_cog_forward(model, x: torch.Tensor, group, dropout: Optional[Dict] = None):
    """``COG.forward`` on a (T_local, f_dim) block -> the local blocks of its
    out_list: 1 + num_r slow tracks (T_local, C) and 1 + num_r fast tracks
    (T_local // fast_pool, C). ``dropout``: None (eval) or this rank's
    masks, {stage: {"stack": (L, T_track_local, C), ["channel": (C,)]}}."""
    if model.cot_skill is not None or model.dtype is not None:
        raise ValueError("SP COG runs the base chain in float32 (SRM, skill prompts "
                         "and bf16 stay on the single-rank path)")
    T, pool = x.shape[0], model.fast_pool
    if T % pool:
        raise ValueError(f"local shard length {T} must be a multiple of fast_pool={pool}")
    dp = dropout or {}
    xx = sp_cog_transformer(model.cot, model.gest_embed, x, group)
    f, _ = _stage(model.TCN, xx, group, dp.get("TCN"))
    f_list = [f]
    for name in model.slow_names[1:]:
        f, _ = _stage(getattr(model, name), f, group, dp.get(name))
        f_list.append(f)
    p = f_list[-1]
    pyramid = [p]
    for c in reversed(f_list[:-1]):
        p = p + _conv1x1(model.latlayer1, c)
        pyramid.insert(0, p)
    out_list = [_logits(model.conv_out, p) for p in pyramid]
    fast = xx.reshape(T // pool, pool, xx.shape[-1]).mean(dim=1)
    _, fast_out = _stage(model.fast_stage1, fast, group, dp.get("fast_stage1"))
    out_list.append(fast_out)
    for name in model.fast_names[1:]:
        _, fast_out = _stage(getattr(model, name), torch.softmax(fast_out, dim=-1), group,
                             dp.get(name))
        out_list.append(fast_out)
    return out_list


def _track_ce_sm(logits, labels, mask, group, class_weights=None):
    """One track's (CE, smoothing) over its global length with a per-position
    mask: CE = psum(per·w) / psum(w), w the mask (times the label's class
    weight); smoothing over pairs (t-1, t) with pair mask m_t · m_{t-1}, the
    previous frame detached, the shifted mask by the same distributed shift
    (zero at the global t = 0)."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    m = mask.to(logp.dtype)
    w = m if class_weights is None else class_weights[labels.long()] * m
    ce = losses._global_ratio((per * w).sum(), w.sum(), group)
    prev = seq_shift_right(logp.detach(), 1, group)
    pairm = m * seq_shift_right(m, 1, group)
    sq = torch.clamp((logp - prev).square(), 0.0, 16.0)
    sm = losses._global_ratio((sq.mean(dim=-1) * pairm).sum(), pairm.sum(), group)
    return ce, sm


def sp_cog_loss_masked(model, x, tl_full, tm_full, tl_fast, tm_fast, group,
                       smooth_lambda: float = 0.15, class_weights=None, dropout=None):
    """The engine's COG objective under SP, with padded trials and every
    label regime: the per-track labels and masks (fixed per trial, made on
    the host by ``sp_train._track_targets``) arrive as this rank's blocks,
    every slow track sharing (tl_full, tm_full) and every fast track the
    fast pair. Returns (loss, out_list)."""
    out_list = sp_cog_forward(model, x, group, dropout)
    ce_total = sm_total = 0.0
    for track in out_list:
        full = track.shape[0] == tl_full.shape[0]
        ce, sm = _track_ce_sm(track, tl_full if full else tl_fast,
                              tm_full if full else tm_fast, group, class_weights)
        ce_total = ce_total + ce
        sm_total = sm_total + sm
    n = len(out_list)
    return ce_total / n + smooth_lambda * (sm_total / n), out_list


def sp_cog_loss(model, x, labels, group, smooth_lambda: float = 0.15, dropout=None):
    """Track-averaged CE + λ·smoothing when the trial fills its whole length
    (true_len == T): ``labels`` (T_local,) sharded like x."""
    pool = model.fast_pool
    ones = torch.ones(labels.shape[0], device=labels.device)
    loss, _ = sp_cog_loss_masked(model, x, labels, ones, labels[::pool], ones[::pool],
                                 group, smooth_lambda, dropout=dropout)
    return loss


def sp_cog_dropout(model, T: int, generator: torch.Generator, group=None) -> Dict:
    """One SP train step's COG dropout: the model's own draw for one trial of
    global length T (channel keeps, bit-packed stack masks), then this
    rank's rows of each stack mask (along the track's T) and the channel
    keeps whole."""
    from .seqpar import shard_sequence

    out = {}
    for name, masks in model.dropout_masks(T, generator, 1).items():
        stage = {"stack": shard_sequence(masks["stack"][:, 0], group, axis=1)}
        if "channel" in masks:
            stage["channel"] = masks["channel"].reshape(-1)
        out[name] = stage
    return out
