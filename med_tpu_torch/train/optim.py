"""Optimizer (port of ``med_tpu.train.optim``): one Adam over the feature
extractor and the model together, with L2 added to the gradient before the
moments (coupled, as torch's ``Adam(weight_decay=...)`` does; not AdamW),
b1 0.9, b2 0.999, eps 1e-8, and the learning rate set once per epoch,
optionally on torch's cosine schedule with eta_min 1e-6."""

from __future__ import annotations

import math
from typing import Iterable

import torch

from ..config import ExperimentConfig


def cosine_lr(epoch: int, base_lr: float, n_epochs: int, eta_min: float = 1e-6) -> float:
    """torch CosineAnnealingLR value at the start of ``epoch`` (0-based)."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / n_epochs)) / 2


def epoch_lr(cfg: ExperimentConfig, epoch: int) -> float:
    if cfg.lr_scheduler:
        return cosine_lr(epoch, cfg.lr, cfg.n_epochs)
    return cfg.lr


def make_optimizer(cfg: ExperimentConfig,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam with coupled L2. Every parameter starts with a zero gradient, so
    a parameter the loss does not reach still takes its weight decay each
    step, as it does under optax (torch skips parameters whose grad is
    None); clear gradients with ``zero_grad(set_to_none=False)``."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (the epoch loop calls
    it once per epoch)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
