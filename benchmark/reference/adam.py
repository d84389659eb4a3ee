"""Plain Adam (Kingma and Ba, arXiv:1412.6980) as torch.optim.Adam computes
it: L2 added to the gradient, first and second moments, bias corrections,
eps added to the corrected root."""

from __future__ import annotations

import math
from typing import Dict

import torch


class Adam:
    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.betas, self.eps, self.wd = lr, tuple(betas), eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for name, p in params.items():
            g = grads[name]
            if self.wd:
                g = g + self.wd * p
            m = self.m.get(name, torch.zeros_like(p))
            v = self.v.get(name, torch.zeros_like(p))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            self.m[name], self.v[name] = m, v
            p -= (self.lr / c1) * m / (v.sqrt() / math.sqrt(c2) + self.eps)
