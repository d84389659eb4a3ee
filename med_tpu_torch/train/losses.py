"""Losses (port of ``med_tpu.train.losses``).

Window families: BCE with logits, with an optional ``pos_weight`` (the
binary model and the siamese pairs), and CE over integer labels with
optional class weights (the 6-class model; masked to true errors in the
sequential regime) (reference modeling_utils.py:233-248, :612-625).
COG, per output track: cross-entropy plus the truncated-MSE temporal
smoothing of the reference (modeling_utils.py:1501-1521), over labels
nearest-resampled to the track's length. TeCNo and TransSVNet: the
cross-entropy against the soft targets [1 - y, y] (modeling_utils.py:278-297),
averaged over TeCNo's stages. Every loss takes an explicit
validity mask, so trials padded to bucket lengths count only their frames.
All arithmetic stays float32, index arithmetic included: the resampling
floors i * (true_len / true_out), and float64 would move its boundaries.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.comm import psum


def _masked_mean(per: torch.Tensor, mask: Optional[torch.Tensor], group=None) -> torch.Tensor:
    """The mean of ``per`` over its unmasked entries; with a data-parallel
    ``group``, over the entries of every rank's rows (one psum pair)."""
    if group is not None:
        m = torch.ones_like(per) if mask is None else mask.reshape(per.shape).to(per.dtype)
        return _global_ratio((per * m).sum(), m.sum(), group)
    if mask is None:
        return per.mean()
    m = mask.reshape(per.shape).to(per.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1e-12)


def _global_ratio(num: torch.Tensor, den: torch.Tensor, group) -> torch.Tensor:
    """psum(num) / max(psum(den), 1e-12): a weighted mean over a data axis.
    The loss's all-reduce has the identity as its backward (every rank
    computes the same loss from it; parallel/comm.py)."""
    return psum(num, group) / torch.clamp(psum(den.detach(), group), min=1e-12)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    pos_weight: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Mean binary cross-entropy with logits (torch BCEWithLogitsLoss), the
    positive term weighted by ``pos_weight``; over a data-parallel batch
    with ``group``."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    w_pos = 1.0 if pos_weight is None else pos_weight
    per = -(w_pos * labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return _masked_mean(per, mask, group)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  class_weights: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Mean CE over integer labels (torch CrossEntropyLoss semantics: with
    class weights, the mean is weighted by each example's class weight);
    over a data-parallel batch with ``group``."""
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.reshape(logits.shape[:-1]).long()
    per = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights[labels]
        if mask is not None:
            w = w * mask.reshape(w.shape)
        if group is not None:
            return _global_ratio((per * w).sum(), w.sum(), group)
        return (per * w).sum() / torch.clamp(w.sum(), min=1e-12)
    return _masked_mean(per, mask, group)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE against probability targets (torch CE with soft targets)."""
    per = -(target_probs * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _masked_mean(per, mask)


def binary_targets(labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The soft targets [1 - y, y] of 0/1 labels y, on a new last axis."""
    y = labels.to(dtype)
    return torch.stack([1.0 - y, y], dim=-1)


def tecno_stage_loss(stage_logits: torch.Tensor, binary_labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The soft CE of each stage, averaged: stage_logits (S, B, T, 2),
    binary_labels (B, T) or (T,)."""
    targets = binary_targets(binary_labels, stage_logits.dtype)
    return torch.stack([soft_cross_entropy(logits, targets, mask)
                        for logits in stage_logits]).mean()


def smooth_loss(track_logits: torch.Tensor,
                pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over clamp((logsoftmax p_t - logsoftmax p_{t-1}.detach)^2, 0, 16)
    of track_logits (T, C); the previous frame is detached."""
    logp = F.log_softmax(track_logits, dim=-1)
    sq = torch.clamp((logp[1:] - logp[:-1].detach()).square(), 0.0, 16.0)
    if pair_mask is None:
        return sq.mean()
    return _masked_mean(sq.mean(dim=-1), pair_mask)


def nearest_resample_dynamic(x: torch.Tensor, true_len: torch.Tensor,
                             out_len_static: int) -> torch.Tensor:
    """Nearest resampling with a dynamic source length: x (Tpad, ...) holds
    ``true_len`` valid entries; position i < true_out = max(true_len *
    out_len // Tpad, 1) reads source floor(i * (true_len / true_out));
    later positions are padding."""
    t_pad = x.shape[0]
    true_out = torch.clamp((true_len * out_len_static) // t_pad, min=1)
    i = torch.arange(out_len_static, device=x.device, dtype=torch.int32)
    ratio = true_len.to(torch.float32) / true_out.to(torch.float32)
    src = torch.floor(i.to(torch.float32) * ratio).to(torch.int64)
    return x[torch.clamp(src, 0, t_pad - 1)]


def cog_track_loss(track_logits: torch.Tensor, labels: torch.Tensor,
                   true_len: torch.Tensor):
    """(CE, smoothing) of one COG output track: track_logits (1, T_track, C);
    labels (Tpad,) on the full-resolution grid; true_len the valid frames at
    full resolution. The caller weights the smoothing term."""
    logits = track_logits[0]
    t_track = logits.shape[0]
    track_labels = nearest_resample_dynamic(labels, true_len, t_track)
    true_out = torch.clamp((true_len * t_track) // labels.shape[0], min=1)
    mask = (torch.arange(t_track, device=logits.device) < true_out).to(logits.dtype)
    ce = cross_entropy(logits, track_labels, mask)
    sm = smooth_loss(logits, mask[1:] * mask[:-1])
    return ce, sm
