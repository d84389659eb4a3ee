"""Live frame-level serving of COG (port of
``med_tpu.eval.serving.FrameModelServer``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.datasets import FrameTrial, frame_batch
from ..data.labels import skill_one_hot
from ..train.engine import Experiment
from ..utils.jax_params import load_jax_params


class FrameModelServer:
    """Standardize kinematics with the fold statistics, bucket-pad the trial,
    run the eval step, return per-frame predictions and positive-class
    probabilities.

    ``checkpoint`` is a ``med_tpu`` checkpoint tree (``load_checkpoint`` of
    a ``best_model_<setting>_<fold>.npz``); it runs on CUDA unless
    ``device="cpu"``."""

    def __init__(self, cfg: ExperimentConfig, checkpoint: Dict,
                 stats: Optional[Dict] = None, device=None):
        # fp32 as in the JAX package: no TF32 in matmuls or cuDNN on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.stats = stats
        self.exp = Experiment(cfg, device=device)
        state, constants = load_jax_params(checkpoint, self.exp.net)
        self.exp.net.load_state_dict(state, strict=True)
        with torch.no_grad():
            for name, value in constants.items():
                self.exp.net.get_buffer(name).copy_(value)

    def predict_trial(self, images, kinematics):
        """images (T, 2048), kinematics (T, 26) raw -> (preds (T,), probs (T,))
        as numpy arrays; a trial longer than ``cfg.max_frames`` is cut there."""
        kin = kinematics
        if self.stats is not None:
            kin = (kinematics - self.stats["kinematics"]["mean"]) / (
                self.stats["kinematics"]["std"]
            )
        T = len(kin)
        trial = FrameTrial(
            name="Needle_Passing_B000",
            images=np.asarray(images, np.float32),
            kinematics=np.asarray(kin, np.float32),
            g_labels=np.ones(T, np.int64),
            e_powerset=np.zeros((T, 7), np.int32),
            skill=skill_one_hot("Needle_Passing_B000", T),
        )
        m = self.exp.eval_step(frame_batch(trial, self.cfg))
        return (m["preds"].cpu().numpy()[:T], m["probs"].cpu().numpy()[:T])
