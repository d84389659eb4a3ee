"""Sequence parallelism (SP) for the frame families: one trial's time axis
split over the ranks of the mesh's ``data`` axis (port of
``med_tpu.parallel.seqpar``).

Each rank holds a (T_local, ...) block of the trial. The causal dilated
taps of the TCN stacks read x[t-d] and x[t-2d]; under SP these are
:func:`seq_shift_right`, the distributed shift (at most two point-to-point
exchanges and a splice; its backward the opposite shift). 1x1 convs,
ReLUs, the softmax over classes and dropout are frame-local. The stage
loss is a masked mean over the global T: local sums and one psum pair,
whose backward is the identity; the parameter gradients are then summed
over the ranks once (``parallel/comm.py``). The stacks run as plain
PyTorch ops, as ``med_tpu``'s do: the TCN kernels take whole sequences.

Dropout masks are drawn whole, from a generator seeded by (seed, step), at
the global T, and each rank takes its rows: a trajectory is the same on 1,
2 or 4 shards. The stack functions take ``dropout_rate`` (0.5 by default,
as ``med_tpu``'s) and scale a kept element by 1 / (1 - rate); the train
step drops at 0.5 or not at all, as ``med_tpu``'s does. The port's modules
(``models/tcn.py``'s TeCNo) carry the weights, so SP runs the single-rank
checkpoints unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import ResidualStack, keep_scale
from ..train import losses
from .comm import all_reduce_grads, group_rank, group_size, seq_shift_right

__all__ = ["seq_shift_right", "sp_residual_stack", "sp_single_stage", "sp_tecno_forward",
           "sp_tecno_loss", "sp_dropout_generator", "sp_dropout_masks",
           "make_sp_tecno_train_step", "shard_sequence"]


# the stacks' ReLU, looked up at each call: a check can pin its pattern to
# another run's (chip_smoke.py, as models.resnet.relu)
relu = torch.relu


def sp_residual_stack(x: torch.Tensor, stack: ResidualStack, group,
                      mask: Optional[torch.Tensor] = None,
                      dropout_rate: float = 0.5) -> torch.Tensor:
    """A causal dilated residual stack (``ResidualStack``'s layer loop) on
    this rank's (T_local, C) block: per layer the taps at t-2d, t-d and t
    (the first two by the distributed shift), ReLU, the 1x1 conv, dropout
    by the (L, T_local, C) keep-mask rows ``mask`` drawn at
    ``dropout_rate`` (a kept element times 1 / (1 - rate)), and the
    residual add."""
    if not stack.causal:
        raise ValueError("sequence parallelism runs causal stacks (mstcn_causal_conv)")
    scale = keep_scale(dropout_rate)
    w3, b3, w1, b1 = stack.weights()
    for i in range(w3.shape[0]):
        d = 2 ** i
        y = (seq_shift_right(x, 2 * d, group) @ w3[i, 0]
             + seq_shift_right(x, d, group) @ w3[i, 1] + x @ w3[i, 2] + b3[i])
        y = relu(y) @ w1[i] + b1[i]
        if mask is not None:
            y = y * mask[i].to(y.dtype) * scale
        x = x + y
    return x


def _conv1x1(conv, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def _logits(conv, h: torch.Tensor) -> torch.Tensor:
    """A stage's class conv: float32 logits (float64 from a float64 stage)."""
    y = _conv1x1(conv, h)
    return y.to(torch.promote_types(y.dtype, torch.float32))


def sp_single_stage(stage, x: torch.Tensor, group, mask=None, dropout_rate: float = 0.5):
    """One MS-TCN stage (``SingleStageTCN``) on a (T_local, C_in) block ->
    (features, logits)."""
    h = sp_residual_stack(_conv1x1(stage.conv_in, x), stage.stack, group, mask,
                          dropout_rate)
    return h, _logits(stage.conv_out, h)


def sp_tecno_forward(model, x: torch.Tensor, group, masks=None,
                     dropout_rate: float = 0.5) -> torch.Tensor:
    """TeCNo on a (T_local, C_in) block -> (num_stages, T_local, 2). ``masks``:
    {"stage<s>": (L, T_local, C)} keep-mask rows drawn at ``dropout_rate``,
    or None (no dropout)."""
    outputs, h = [], x
    for s, stage in enumerate(model.stages()):
        _, logits = sp_single_stage(stage, h, group,
                                    None if masks is None else masks[f"stage{s}"],
                                    dropout_rate)
        outputs.append(logits)
        h = torch.softmax(logits, dim=-1)
    return torch.stack(outputs)


def soft_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, group):
    """The masked soft CE against [1 - y, y] over the global T."""
    per = -(losses.binary_targets(labels, logits.dtype)
            * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    m = mask.to(logits.dtype)
    return losses._global_ratio((per * m).sum(), m.sum(), group)


def sp_tecno_loss(model, x, labels, mask, group, masks=None,
                  dropout_rate: float = 0.5) -> torch.Tensor:
    """The stage-averaged soft CE over the global T (``tecno_stage_loss``)."""
    logits = sp_tecno_forward(model, x, group, masks, dropout_rate)
    return torch.stack([soft_ce(s, labels, mask, group) for s in logits]).mean()


def sp_dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one SP train step's dropout draws: a function of the
    run's seed and the step alone (so of no rank or shard count)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def sp_dropout_masks(model, T: int, generator: torch.Generator):
    """A TeCNo train step's whole (global T) keep-masks, {"stage<s>": (L,
    T, C)}: the model's own draw (bit-packed words along T) for one trial."""
    return {k: v["stack"][:, 0] for k, v in model.dropout_masks(T, generator, 1).items()}


def shard_sequence(x, group, axis: int = 0):
    """This rank's block of ``x`` along ``axis`` (equal blocks)."""
    n = group_size(group)
    per = x.shape[axis] // n
    if per * n != x.shape[axis]:
        raise ValueError(f"length {x.shape[axis]} does not split into {n} shards")
    i = group_rank(group)
    return x.narrow(axis, i * per, per) if isinstance(x, torch.Tensor) else \
        x.take(range(i * per, (i + 1) * per), axis=axis)


def make_sp_tecno_train_step(model, optimizer, group, seed: int = 0,
                             dropout_rate: float = 0.5):
    """An SP TeCNo train step: ``step(x, labels, mask, step_index, masks=None)``
    on this rank's blocks (x (T_local, C_in), labels and mask (T_local,)),
    parameters replicated. Dropout at ``dropout_rate`` 0.5 or 0 (others
    raise NotImplementedError here, as ``med_tpu``'s step does at build
    time): masks (the whole trial's, ``masks`` in :func:`sp_dropout_masks`'
    layout, or drawn from :func:`sp_dropout_generator`) are cut to this
    rank's rows. One psum pair for the loss, one gradient all-reduce.
    Returns the loss."""
    if dropout_rate not in (0.0, 0.5):
        raise NotImplementedError(f"SP dropout supports rate 0.5 (reference) or 0.0, "
                                  f"got {dropout_rate}")

    def step(x, labels, mask, step_index: int, masks=None):
        if not dropout_rate:
            masks = None
        elif masks is None:
            T = x.shape[0] * group_size(group)
            masks = sp_dropout_masks(model, T, sp_dropout_generator(seed, step_index, x.device))
        if masks is not None:
            masks = {k: shard_sequence(v, group, axis=1) for k, v in masks.items()}
        optimizer.zero_grad(set_to_none=False)
        loss = sp_tecno_loss(model, x, labels, mask, group, masks, dropout_rate)
        loss.backward()
        all_reduce_grads(model.parameters(), group)
        optimizer.step()
        return loss.detach()

    return step
