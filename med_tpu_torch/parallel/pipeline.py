"""Pipeline parallelism over TeCNo's refinement stages (port of
``med_tpu.parallel.pipeline``; a library: no CLI flag reaches it, in
``med_tpu`` either).

Rank d holds refinement stage d + 1 (stage 0 runs on every rank, its
parameters replicated). ``M`` microbatches (trials) stream through in
``M + R - 1`` pipeline steps: at step j rank d applies its stage to
microbatch j - d, then every rank passes its output one rank on by a
point-to-point exchange (``comm.fetch``); rank 0 takes microbatch j from
stage 0 instead. Autograd runs the schedule backward, each exchange
sending its cotangent the other way. Every step's output stays in the
graph (the steps outside a rank's window with zero weight), so every rank
makes the same exchanges in the same order, forward and backward.

Dropout after each layer's 1x1 conv, at the step's rate in [0, 1), uses
the port's own convention: the (L, T, C) keep-mask of (global stage s,
microbatch m) is drawn at that rate (``ResidualStack.dropout_mask``) from a
generator seeded by (seed, s, m), so a rank draws its own stage's masks
with no traffic and a sequential chain drawing alike takes the same masks;
tests can inject them. The stacks scale a kept element by 1 / (1 - rate)
(med_tpu's pipeline divides by 1 - rate: the two can differ by an ulp).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..models.layers import SingleStageTCN, keep_scale
from ..train import losses
from .comm import all_reduce_grads, fetch, group_rank, group_size, psum

__all__ = ["stack_stage_params", "shard_stage_params", "stage_dropout_mask",
           "pipeline_refine", "make_pp_tecno_train_step"]


def stack_stage_params(model, first: int = 1) -> Dict[str, torch.Tensor]:
    """TeCNo's stages ``first`` .. S-1 stacked by parameter name, (R, ...):
    the pipeline's layout (every refinement stage has one shape)."""
    stages = model.stages()[first:]
    return {k: torch.stack([s.state_dict()[k] for s in stages]) for k in stages[0].state_dict()}


def shard_stage_params(stacked: Dict[str, torch.Tensor], stage: SingleStageTCN, group) -> None:
    """Load this rank's stage (index = its rank in ``group``) of a stacked
    layout into ``stage``."""
    d = group_rank(group)
    stage.load_state_dict({k: v[d] for k, v in stacked.items()})


def stage_dropout_mask(stage: SingleStageTCN, s: int, m: int, T: int, seed: int,
                       device, rate: float = 0.5) -> Optional[torch.Tensor]:
    """The (L, T, C) keep-mask of global stage ``s`` on microbatch ``m`` at
    dropout ``rate`` (None at 0)."""
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + s) * 1_000_003 + m)
    mask = stage.stack.dropout_mask(1, T, gen, rate)
    return None if mask is None else mask[:, 0]


def _stage_out(stage: SingleStageTCN, x: torch.Tensor, mask=None,
               rate: Optional[float] = None) -> torch.Tensor:
    return stage(x[None], None if mask is None else mask[:, None], rate)[1][0]


def pipeline_refine(stage: SingleStageTCN, logits0: torch.Tensor, group,
                    masks: Optional[List[torch.Tensor]] = None,
                    rate: Optional[float] = None) -> torch.Tensor:
    """Run the R refinement stages (this rank's ``stage`` is stage rank + 1)
    over the M microbatches of ``logits0`` (M, T, C), stage 0's logits.
    ``masks``: this rank's stage's keep-masks a microbatch, drawn at
    ``rate`` (the stack's ``dropout_rate`` unless given), or None.
    Returns this rank's stage's logits for every microbatch, (M, T, C)."""
    R, d = group_size(group), group_rank(group)
    M = logits0.shape[0]
    first = torch.tensor(d == 0, device=logits0.device)
    buf = torch.zeros_like(logits0[0])
    outs = []
    for j in range(M + R - 1):
        m = min(max(j - d, 0), M - 1)
        inp = torch.where(first, logits0[min(j, M - 1)], buf)
        out = _stage_out(stage, torch.softmax(inp, dim=-1),
                         None if masks is None else masks[m], rate)
        outs.append(out)
        if j < M + R - 2:
            buf = fetch(out, -1, group)
    # step d + m is microbatch m here; the other steps join with zero weight
    return torch.stack(outs)[d:d + M]


def make_pp_tecno_train_step(stage0: SingleStageTCN, stage: SingleStageTCN, opt0, opt_r,
                             group, dropout_rate: float = 0.0, seed: int = 0):
    """A pipelined TeCNo train step: ``step(x, labels, mask, masks=None)`` on
    M trials, x (M, T, C_in), labels and mask (M, T): stage 0 on every rank
    over the M trials, the refinement stages through
    :func:`pipeline_refine`, the stage-averaged soft CE over all S = R + 1
    stages (``tecno_stage_loss``). Stage 0's gradient (made on rank 0) is
    summed over the ranks; each rank's stage updates by its own optimizer.
    Dropout runs at ``dropout_rate`` in [0, 1), whatever rate the stages
    were built with.
    ``masks``: {(s, m): (L, T, C)} keep-masks to take instead of
    :func:`stage_dropout_mask`'s draws. Returns the loss."""
    keep_scale(dropout_rate)            # raises outside [0, 1)
    R, d = group_size(group), group_rank(group)
    S = R + 1

    def step(x, labels, mask, masks=None):
        M, T = x.shape[0], x.shape[1]

        def mask_for(st, s, m):
            if dropout_rate == 0.0:
                return None
            if masks is not None:
                return masks[(s, m)]
            return stage_dropout_mask(st, s, m, T, seed, x.device, dropout_rate)

        opt0.zero_grad(set_to_none=False)
        opt_r.zero_grad(set_to_none=False)
        out0 = torch.stack([_stage_out(stage0, x[m], mask_for(stage0, 0, m), dropout_rate)
                            for m in range(M)])
        own = [mask_for(stage, d + 1, m) for m in range(M)]
        outs = pipeline_refine(stage, out0, group, None if own[0] is None else own,
                               dropout_rate)
        targets = losses.binary_targets(labels, outs.dtype)
        ce = losses.soft_cross_entropy(outs, targets, mask)
        ce0 = losses.soft_cross_entropy(out0, targets, mask)
        local = ce + ce0 * float(d == 0)
        loss = psum(local, group) / S
        loss.backward()
        all_reduce_grads(stage0.parameters(), group)
        opt0.step()
        opt_r.step()
        return loss.detach()

    return step
