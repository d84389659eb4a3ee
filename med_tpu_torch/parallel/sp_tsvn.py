"""Sequence-parallel TransSVNet: the frozen TeCNo and the transformer
refiner with the trial's time axis split over the ranks (port of
``med_tpu.parallel.sp_tsvn``).

- The frozen TeCNo runs through ``seqpar.sp_tecno_forward`` (the
  distributed taps), without dropout and without a gradient, its last
  stage's logits detached, as the single-rank engine takes them;
- the encoder attends each frame's window of the last ``len_q`` logit
  vectors: one :func:`halo_left` of ``len_q - 1`` rows (zeros at the global
  edge, the reference's zero-padded windows) makes every window local. The
  windows are gathered and attended as the reference computes them
  (``TransSVNet.encode_windows``), in float64 as the port's encoder closes;
- the decoder, the collapsed attention matrices and the LayerNorms are
  frame-local; the soft CE is a masked mean over the global T (one psum
  pair).
"""

from __future__ import annotations

import torch

from .comm import halo_left
from .seqpar import soft_ce, sp_tecno_forward

__all__ = ["sp_tsvn_forward", "sp_tsvn_loss"]


def sp_tsvn_forward(model, tecno_logits: torch.Tensor, long_features: torch.Tensor,
                    group) -> torch.Tensor:
    """``TransSVNet.forward`` on this rank's blocks: tecno_logits (T_local,
    C), long_features (T_local, in_dim) -> (T_local, C) in the features'
    type."""
    T, C = tecno_logits.shape
    W = model.len_q
    seq = torch.cat([halo_left(tecno_logits, W - 1, group), tecno_logits], dim=0)
    windows = seq.unfold(0, W, 1).permute(0, 2, 1).double()     # (T, W, C)
    enc = model.enc_ffn0(model.enc_attn0(windows, windows, windows))
    q = torch.tanh(model.fc(long_features)).reshape(T, 1, C).to(enc.dtype)
    dec = model.dec_ffn(model.dec_attn(q, enc, enc))
    return dec.reshape(T, C).to(long_features.dtype)


def sp_tsvn_loss(model, frozen_tecno, x, labels, mask, group) -> torch.Tensor:
    """The engine's TransSVNet objective under SP: the frozen TeCNo (no
    gradient), the refiner, the soft CE over the global T."""
    with torch.no_grad():
        tecno_logits = sp_tecno_forward(frozen_tecno, x, group)[-1]
    out = sp_tsvn_forward(model, tecno_logits, x, group)
    return soft_ce(out, labels, mask, group)
