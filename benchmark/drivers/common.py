"""What the drivers share: the run's context, the device's clock fence, and
log-uniform lengths that every seed draws alike."""

from __future__ import annotations

import dataclasses
import math
import time
from types import ModuleType
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class Context:
    """One run: the cell's entry, its configuration and traffic files, the
    seed, the device, the tracer (spans are no-ops without ``--trace 1``),
    the limits, the configuration's reference module, the window's length
    and whether the run reads the control."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    tracer: object
    limits: Dict[str, float]
    reference: ModuleType
    log: Callable[[str], None] = print
    seconds: float = 0.0
    control: bool = False


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def log_uniform_lengths(n: int, lo: int, hi: int) -> List[int]:
    """n lengths at the midpoints of n equal steps of log(lo)..log(hi): every
    seed gets this same set (a seed only orders it), so the work of a run
    does not move with the seed."""
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (b - a) * (i + 0.5) / n))) for i in range(n)]


def bucket(t: int, step: int = 256, cap: int = 4096) -> int:
    """The padded length of a t-frame trial: the next multiple of ``step``,
    at most ``cap`` (``frame_batch``'s buckets)."""
    return min(max(-(-t // step) * step, step), cap)


def permutation(seed: int, n: int, stream: int) -> np.ndarray:
    return np.random.default_rng([int(seed), stream]).permutation(n)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def label_runs(r: np.random.Generator, T: int, lo: int, hi: int) -> np.ndarray:
    """0/1 labels in runs of lo..hi frames (the smoke test's synthetic
    trials: error segments the kinematics betray)."""
    labels = np.zeros(T, np.int32)
    t = 0
    while t < T:
        run = int(r.integers(lo, hi))
        labels[t:t + run] = int(r.integers(0, 2))
        t += run
    return labels


def first_moment_grads(optimizer: torch.optim.Optimizer, named) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as the optimizer got it, from Adam's first
    moment after one step: exp_avg = (1 - beta1) * g."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for n, p in named:
        state = optimizer.state.get(p, {})
        # a step that never reached the optimizer leaves no moment: nothing moved
        out[n] = (state["exp_avg"] / (1.0 - beta1) if "exp_avg" in state
                  else torch.zeros_like(p))
    return out
