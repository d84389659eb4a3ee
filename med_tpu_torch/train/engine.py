"""Train and eval steps of the COG frame family (port of the COG part of
``med_tpu.train.engine``): input assembly, the multi-track loss with its
confusion matrices, and one optimiser step per trial."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import ExperimentConfig
from ..models import build_feature_extractor, build_model, init_weights
from ..ops.metrics import confusion_matrix
from ..utils.device import resolve_device
from . import losses
from .optim import make_optimizer


class FrameNet(nn.Module):
    """The jointly held model and optional FeatureExtractor; its state_dict
    keys ("model.*", "fe.*") follow the JAX package's params tree."""

    def __init__(self, model: nn.Module, fe: Optional[nn.Module] = None):
        super().__init__()
        self.model = model
        self.fe = fe


def cog_loss(cfg: ExperimentConfig, out_list, batch: Dict[str, torch.Tensor]):
    """The COG branch of med_tpu's ``_loss_for_family`` ('global' and
    'all_errors'): CE and smoothing summed over every track and divided by
    the number of tracks; metrics from the first slow track. Returns
    (loss, {"cm", ["cm_binary"], "preds", "probs"})."""
    if cfg.error_type == "global":
        n_classes = 2
    elif cfg.error_type == "all_errors":
        n_classes = cfg.out_features
    else:
        raise NotImplementedError(
            f"COG error_type {cfg.error_type!r} is not ported yet: ROADMAP.md "
            "Queue A6 (other frame families)")
    labels, true_len, mask = batch["labels"], batch["true_len"], batch.get("mask")
    n_stages = len(out_list)
    ce_total = sm_total = 0.0
    for track in out_list:
        ce, sm = losses.cog_track_loss(track, labels, true_len)
        ce_total = ce_total + ce
        sm_total = sm_total + sm
    loss = ce_total / n_stages + cfg.smooth_lambda * (sm_total / n_stages)
    track0 = out_list[0][0].detach()
    preds = torch.argmax(track0, dim=-1)
    probs = torch.softmax(track0, dim=-1)
    metrics = {"cm": confusion_matrix(labels, preds, n_classes, mask), "preds": preds,
               "probs": probs[..., 1] if n_classes == 2 else probs}
    if cfg.error_type == "all_errors":
        metrics["cm_binary"] = confusion_matrix(
            (labels > 0).to(torch.int32), (preds > 0).to(torch.int32), 2, mask)
    return loss, metrics


class Experiment:
    """Binds a config to its model, optimiser and dropout generator on one
    device (CUDA unless the caller passes ``device="cpu"``). Parameters start
    at zero (serving loads them); :meth:`init_weights` draws them from a
    seed."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 prompt_path: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        net = FrameNet(build_model(cfg, prompt_path), build_feature_extractor(cfg))
        self.net = net.to(self.device).eval()
        self.optimizer = make_optimizer(cfg, self.net.parameters())
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def init_weights(self, seed: int) -> None:
        """Draw every parameter from ``seed`` (U(±1/sqrt(fan_in)), on the
        CPU so the draw is the same on every device) and restart the
        optimiser and the dropout stream from the config's seed."""
        init_weights(self.net, torch.Generator().manual_seed(seed))
        self.optimizer = make_optimizer(self.cfg, self.net.parameters())
        self.generator.manual_seed(self.cfg.seed)

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device (keys starting with '_' stay)."""
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                continue
            dtype = torch.float32 if k in ("images", "kinematics", "mask") else None
            out[k] = torch.as_tensor(v, dtype=dtype, device=self.device)
        return out

    def _assemble(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """define_inputs (modeling_utils.py:19-134) in channel-last layout."""
        cfg = self.cfg
        if cfg.data_type == "kinematics":
            return batch["kinematics"]
        images = batch["images"]
        if cfg.uses_feature_extractor():
            images = self.net.fe(images)
        if cfg.data_type == "video":
            return images
        return torch.cat([images, batch["kinematics"]], dim=-1)

    def compute_gradients(self, batch: Dict[str, np.ndarray], masks=None):
        """Forward in training mode (dropout ``masks`` in COG.dropout_masks'
        layout, or drawn from the experiment's generator), the loss, and its
        backward into every parameter's ``.grad``. Returns (loss, metrics)."""
        data = self._tensors(batch)
        self.optimizer.zero_grad(set_to_none=False)
        out_list, _ = self.net.model(self._assemble(data), train=True, masks=masks,
                                     generator=self.generator)
        loss, metrics = cog_loss(self.cfg, out_list, data)
        loss.backward()
        return loss.detach(), metrics

    def train_step(self, batch: Dict[str, np.ndarray], masks=None
                   ) -> Dict[str, torch.Tensor]:
        """One trial: forward, loss, backward and one optimiser step. Returns
        the metrics ("loss", "cm", ...) as device tensors: nothing syncs the
        host."""
        loss, metrics = self.compute_gradients(batch, masks)
        self.optimizer.step()
        metrics["loss"] = loss
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One padded trial -> {"preds", "probs"} over its frames, from COG's
        first slow track: argmax, and the class-1 softmax when binary; with
        "loss" and "cm" too when the batch carries labels."""
        cfg = self.cfg
        if cfg.error_type == "sequential":
            raise NotImplementedError(
                "the sequential COG regime is not ported yet: ROADMAP.md "
                "Queue A6 (other frame families)")
        data = self._tensors(batch)
        out_list, _ = self.net.model(self._assemble(data))
        if "labels" in data:
            loss, metrics = cog_loss(cfg, out_list, data)
            metrics["loss"] = loss
            return metrics
        track0 = out_list[0][0]
        preds = torch.argmax(track0, dim=-1)
        probs = torch.softmax(track0, dim=-1)
        n_classes = 2 if cfg.error_type == "global" else cfg.out_features
        return {"preds": preds, "probs": probs[..., 1] if n_classes == 2 else probs}
