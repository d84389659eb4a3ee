"""Eval step of the COG frame family (port of the eval side of
``med_tpu.train.engine``): input assembly and the metrics serving reads.
The loss, the confusion matrices and training belong to the training
slice."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import ExperimentConfig
from ..models import build_feature_extractor, build_model
from ..utils.device import resolve_device


class FrameNet(nn.Module):
    """The jointly held model and optional FeatureExtractor; its state_dict
    keys ("model.*", "fe.*") follow the JAX package's params tree."""

    def __init__(self, model: nn.Module, fe: Optional[nn.Module] = None):
        super().__init__()
        self.model = model
        self.fe = fe


class Experiment:
    """Binds a config to its model on one device (CUDA unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 prompt_path: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        net = FrameNet(build_model(cfg, prompt_path), build_feature_extractor(cfg))
        self.net = net.to(self.device).eval()

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

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One padded trial -> {"preds", "probs"} over its frames, from COG's
        first slow track: argmax, and the class-1 softmax when binary."""
        cfg = self.cfg
        if cfg.error_type == "sequential":
            raise NotImplementedError(
                "the sequential COG regime is not ported yet: ROADMAP.md "
                "Queue A6 (other frame families)")
        data = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=self.device)
                for k in ("images", "kinematics")}
        out_list, _ = self.net.model(self._assemble(data))
        track0 = out_list[0][0]
        preds = torch.argmax(track0, dim=-1)
        probs = torch.softmax(track0, dim=-1)
        n_classes = 2 if cfg.error_type == "global" else cfg.out_features
        return {"preds": preds, "probs": probs[..., 1] if n_classes == 2 else probs}
