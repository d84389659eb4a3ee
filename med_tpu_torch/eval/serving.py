"""Live frame-level serving of the frame families (COG, TeCNo, TransSVNet),
from features or from raw frames (port of ``med_tpu.eval.serving``'s
``FrameModelServer`` and ``PixelFrontEnd``).
The window-level ``predict_trial_from_pixels`` needs ``EnsembleServer`` and
is not ported yet (ROADMAP.md Queue A8)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.datasets import FrameTrial, frame_batch
from ..data.labels import skill_one_hot
from ..data.preprocessing import preprocess_frames
from ..models.resnet import ResNet50
from ..train.checkpoint import load_checkpoint, load_checkpoint_meta
from ..train.engine import Experiment
from ..utils.device import resolve_device
from ..utils.jax_params import load_jax_params


class PixelFrontEnd:
    """Raw frames -> pooled ResNet-50 trunk features, live.

    The trunk is :class:`models.resnet.ResNet50`, as in the JAX package, at
    ``dtype`` (bfloat16 by default, or float32), on CUDA unless
    ``device="cpu"``.

    Preprocessing: with per-fold pixel channel stats (``mean``/``std``, what
    the fine-tune CLI stores in the checkpoint meta) frames are /255 and
    standardised; without them the ImageNet resize-240/crop-224 path
    (:func:`data.preprocessing.preprocess_frames`) runs. Frames go to the
    device in chunks of ``batch_size``, the last one zero-padded, so every
    chunk has one shape. The int8 trunk (``int8=True``) and serving on a
    mesh (``mesh=``) are not ported yet and raise.
    """

    def __init__(self, trunk_params, trunk_stats, *, mean=None, std=None,
                 int8=False, dtype=torch.bfloat16,
                 stage_sizes=(3, 4, 6, 3), width=64, batch_size=128,
                 mesh=None, device=None):
        if int8:
            raise NotImplementedError(
                "the int8 PTQ trunk is not ported yet: ROADMAP.md Queue A9")
        if mesh is not None:
            raise NotImplementedError(
                "serving on a mesh is not ported yet: ROADMAP.md Queue A12")
        # fp32 as in the JAX package: no TF32 in matmuls or cuDNN on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.mean = self.std = None
        if mean is not None:
            self.mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
            self.std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)
        self.net = ResNet50(tuple(stage_sizes), width, dtype)
        state, _ = load_jax_params({"params": trunk_params, "batch_stats": trunk_stats},
                                   self.net)
        self.net.load_state_dict(state, strict=True)
        self.net.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path, **kw):
        """Build from a fine-tune checkpoint (``resnet50_<fold>.npz`` with
        the trunk under ``params/trunk`` and ``batch_stats/trunk``, plus its
        ``.json`` meta holding the fold's pixel channel mean/std)."""
        ckpt = load_checkpoint(path)
        meta = load_checkpoint_meta(path)
        if meta is not None:
            kw.setdefault("mean", meta.get("mean"))
            kw.setdefault("std", meta.get("std"))
        return cls(ckpt["params"]["trunk"], ckpt["batch_stats"]["trunk"], **kw)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        if self.mean is not None:
            x = (x.to(torch.float32) / 255.0 - self.mean) / self.std
        else:
            x = preprocess_frames(x)
        return self.net(x)

    @torch.no_grad()
    def features(self, frames) -> np.ndarray:
        """(N, H, W, 3) uint8/float raw frames -> (N, F) fp32 features, as a
        numpy array. Any N: chunks of ``batch_size``, the last one
        zero-padded and sliced back."""
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32)
        bs = self.batch_size
        out = []
        for s in range(0, len(frames), bs):
            chunk = frames[s:s + bs]
            n = len(chunk)
            if n < bs:
                chunk = np.pad(chunk, ((0, bs - n),) + ((0, 0),) * 3)
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            out.append(self._features(x)[:n].cpu().numpy())
        return np.concatenate(out, axis=0)


class FrameModelServer:
    """Standardize kinematics with the fold statistics, bucket-pad the trial,
    run the eval step, return per-frame predictions and probabilities: the
    positive class's of a binary model, every class's otherwise (a 6-class
    or named-error-type COG with ``out_features`` > 2). Any COG variant and
    ``compute_dtype`` of the config serves the same way.

    ``checkpoint`` is a ``med_tpu`` checkpoint tree (``load_checkpoint`` of
    a ``best_model_<setting>_<fold>.npz``); ``frozen`` TransSVNet's frozen
    TeCNo, ``{"tecno_params": <params tree>}`` as med_tpu takes it. It runs
    on CUDA unless ``device="cpu"``."""

    def __init__(self, cfg: ExperimentConfig, checkpoint: Dict,
                 stats: Optional[Dict] = None, frozen: Optional[Dict] = None,
                 device=None):
        self.cfg = cfg
        self.stats = stats
        self.exp = Experiment(cfg, device=device)
        self.exp.load_params(checkpoint)
        if frozen is not None:
            self.exp.load_frozen(frozen)

    def predict_trial_from_pixels(self, frontend: PixelFrontEnd, frames, kinematics):
        """Serving from raw frames: the trunk front-end makes the (T, F)
        features in-process, then :meth:`predict_trial` runs."""
        return self.predict_trial(frontend.features(frames), kinematics)

    def predict_trial(self, images, kinematics):
        """images (T, 2048), kinematics (T, 26) raw -> (preds (T,), probs (T,)
        or (T, classes)) as numpy arrays; a trial longer than
        ``cfg.max_frames`` is cut there."""
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
        batch = frame_batch(trial, self.cfg)
        # inputs only: with labels, eval_step would also compute the loss
        m = self.exp.eval_step({k: batch[k] for k in ("images", "kinematics")})
        return (m["preds"].cpu().numpy()[:T], m["probs"].cpu().numpy()[:T])
