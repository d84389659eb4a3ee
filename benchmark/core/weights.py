"""Weights made from the seed on the device, in a few large draws.

A reference module gives its parameters as a spec, entries of
``(name, shape, kind, a, b)``: ``"uniform"`` U(-a, a), ``"normal"``
N(a, b²), ``"fill"`` the constant a. Every uniform entry is cut from one
draw and every normal one from another, in the spec's order, so the same
seed gives the same weights on any run."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Entry = Tuple[str, Tuple[int, ...], str, float, float]


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for the seed's ``stream``-th use (weights,
    data, masks each take their own)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))


def make(spec: Sequence[Entry], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    sizes = {kind: sum(math.prod(shape) for _, shape, k, _, _ in spec if k == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, a, b in spec:
        n = math.prod(shape)
        if kind == "fill":
            out[name] = torch.full(shape, float(a), device=device)
            continue
        cut = pools[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        out[name] = cut * (2 * a) - a if kind == "uniform" else cut * b + a
    return out
