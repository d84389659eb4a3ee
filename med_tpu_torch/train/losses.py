"""COG's frame losses (port of the COG part of ``med_tpu.train.losses``).

Per output track: cross-entropy plus the truncated-MSE temporal smoothing
of the reference (modeling_utils.py:1501-1521), over labels
nearest-resampled to the track's length. Every loss takes an explicit
validity mask, so trials padded to bucket lengths count only their frames.
All arithmetic stays float32, index arithmetic included: the resampling
floors i * (true_len / true_out), and float64 would move its boundaries.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(per: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return per.mean()
    m = mask.reshape(per.shape).to(per.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1e-12)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over integer labels (torch CrossEntropyLoss semantics)."""
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.reshape(logits.shape[:-1]).long()
    per = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return _masked_mean(per, mask)


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
