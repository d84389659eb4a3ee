"""The numbers that decide ``correct``, each held to a limit set from
readings of sound runs and of the control (PERF.md gives both readings).

Training: each step's loss (and the first step's alone: Adam's first
update moves every weight by about the learning rate whatever its
gradient's size, so the later steps' losses part by the noise of the
weights whose gradient is rounding), the norm of each leaf's first
gradient (the program's worked out from its optimizer's first moment after
one step), and the norm of each leaf's change over the first steps, taken
by the worst leaf: the gap between the program's norm and the reference's, over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the change."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm in float64, on the host."""
    if not tensors:
        return {}
    names = list(tensors)
    stacked = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu()
    return dict(zip(names, stacked.tolist()))


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2]) if n else 0.0


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   leaves: Sequence[str]) -> float:
    """max over ``leaves`` of |program - reference| / max(reference, the
    median leaf's reference norm)."""
    med = _median([reference[n] for n in leaves])
    worst = 0.0
    for n in leaves:
        scale = max(reference[n], med, 1e-30)
        worst = max(worst, abs(program[n] - reference[n]) / scale)
    return worst


def moving_leaves(ref_grad: Dict[str, float], ratio: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient norm is at least ``ratio`` of the
    median leaf's: the others move by round-off alone."""
    med = _median(list(ref_grad.values()))
    return [n for n, v in ref_grad.items() if v >= ratio * med]


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def training_numbers(prog_losses, ref_losses, prog_grad, ref_grad, prog_change,
                     ref_change, state_leaves: Sequence[str] = ()) -> Dict[str, float]:
    """The training numbers: the loss gap over every checked step and over
    the first alone, the first gradient's and the change's worst leaf.
    ``state_leaves``: running statistics, which have no gradient and are
    compared by their change alone. A cell's limits file says which it
    compares."""
    moving = moving_leaves(ref_grad) + list(state_leaves)
    return {"loss_gap": loss_gap(prog_losses, ref_losses),
            "loss_gap_first": loss_gap(prog_losses[:1], ref_losses[:1]),
            "grad_gap": worst_leaf_gap(prog_grad, ref_grad, list(ref_grad)),
            "change_gap": worst_leaf_gap(prog_change, ref_change, moving)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a non-finite number fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = value == value and abs(value) != float("inf") and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
