"""Live serving (port of ``med_tpu.eval.serving``): window ensembles
(``WindowModelBundle``, ``EnsembleServer``, ``load_ensemble``), the raw-frame
front end (``PixelFrontEnd``, bf16/fp32 or the int8 PTQ trunk) and the
window-level ``predict_trial_from_pixels`` that chains them, and frame-level
serving of the frame families (``FrameModelServer``). Each runs on CUDA
unless the caller passes ``device="cpu"``, and raises without a GPU.

``med_tpu`` compiles an ensemble's members and its fusion rule into one jit
program; here the members run one after another under ``torch.no_grad()``
on one device, the rule in PyTorch ops on their fp32 outputs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig, run_config
from ..data.datasets import FrameTrial, frame_batch, standardize
from ..data.labels import skill_one_hot
from ..data.preprocessing import preprocess_frames
from ..data.windowing import window_scan
from ..models.resnet import ResNet50
from ..ops.quant import (fe_int8_apply, quantize_fe, quantize_resnet50_trunk,
                         resnet50_int8_apply, tree_to)
from ..tracking import RunTracker
from ..train.checkpoint import load_best_checkpoint, load_checkpoint, load_checkpoint_meta
from ..train.engine import WINDOW_MODELS, Experiment
from ..utils.device import resolve_device
from ..utils.jax_params import load_jax_params
from ..utils.profiling import span


def _on_mesh(fn, mesh, *xs: torch.Tensor):
    """``fn`` over the rows of ``xs`` split across the mesh's ``data`` axis:
    the batch padded (zeros) to a multiple of the axis, each rank its block,
    the outputs gathered in row order and the padding cut back. A mesh of
    one data rank, or none, runs ``fn`` on the whole batch."""
    n_data = 1 if mesh is None else mesh.shape["data"]
    if n_data == 1:
        return fn(*xs)
    from ..parallel.comm import all_gather

    n = xs[0].shape[0]
    per = -(-n // n_data)
    i = mesh.coord("data")
    local = [torch.cat([x, x.new_zeros((per * n_data - n,) + x.shape[1:])])[i * per:(i + 1) * per]
             for x in xs]
    outs = fn(*local)
    group = mesh.group("data")
    if isinstance(outs, tuple):
        return tuple(all_gather(o.contiguous(), group)[:n] for o in outs)
    return all_gather(outs.contiguous(), group)[:n]


class WindowModelBundle:
    """One window model (SimpleCNN or SimpleLSTM) with its FeatureExtractor
    and trained weights, a ``med_tpu`` checkpoint tree ({"params",
    "batch_stats", "constants"}, as ``load_best_checkpoint`` gives it), on
    CUDA unless ``device="cpu"``. The siamese twins take window pairs, which
    an ensemble of windows does not have: they raise ``ValueError``."""

    def __init__(self, cfg: ExperimentConfig, checkpoint: Dict, device=None):
        if cfg.model_name not in WINDOW_MODELS:
            raise ValueError(f"{cfg.model_name} is not a window model: ensembles take "
                             f"SimpleCNN or SimpleLSTM members")
        if cfg.model_name.startswith("Siamese") or cfg.siamese:
            raise ValueError(f"{cfg.model_name} compares window pairs; an ensemble serves "
                             "single windows: take SimpleCNN or SimpleLSTM members")
        self.cfg = cfg
        self.exp = Experiment(cfg, device=device)
        self.exp.load_params(checkpoint)
        self.device = self.exp.device
        self.params = checkpoint["params"]
        self.qfe = None  # the int8 PTQ FeatureExtractor (quantize_fe())

    def quantize_fe(self, calib_images) -> None:
        """Serve the member's FeatureExtractor through the int8 PTQ path
        (``ops.quant.quantize_fe``), calibrated on a representative
        (B, W, 2048) feature batch. No-op for a member without one
        (kinematics, or the 2048-d features taken directly)."""
        if self.exp.net.fe is not None and self.cfg.data_type != "kinematics":
            self.qfe = tree_to(quantize_fe(self.params["fe"], calib_images), self.device)

    def logits(self, images: torch.Tensor, kinematics: torch.Tensor) -> torch.Tensor:
        """(B, W, 2048) features (fp32, or the int8 feature store when the
        member has a ``qfe``) and (B, W, 26) kinematics on the member's
        device -> the model's logits."""
        cfg = self.cfg
        if cfg.data_type == "kinematics":
            x = kinematics
        else:
            if images.dtype == torch.int8 and self.qfe is None:
                raise ValueError("int8 feature-store codes reach a member without an int8 "
                                 "FeatureExtractor; feed it fp32 windows")
            if self.qfe is not None:
                feats = fe_int8_apply(self.qfe, images)
            elif self.exp.net.fe is not None:
                feats = self.exp.net.fe(images)
            else:
                feats = images
            x = feats if cfg.data_type == "video" else torch.cat([feats, kinematics], dim=-1)
        return self.exp.net(x, train=False)


class EnsembleServer:
    """Fused inference over window members on one device:

    - soft vote: the mean of the members' fp32 sigmoids (summed in member
      order), ``>= threshold``;
    - cascade: (binary, multiclass) members; where the binary member's
      sigmoid is ``> threshold`` the multiclass argmax, else 0.

    ``predict`` takes numpy windows and returns numpy (preds, probs)."""

    def __init__(self, members: List[WindowModelBundle], mode: str = "soft_vote",
                 mesh=None, threshold: float = 0.5):
        if mode not in ("soft_vote", "cascade"):
            raise ValueError(mode)
        if mode == "cascade" and len(members) != 2:
            raise ValueError("cascade needs exactly (binary, multiclass) members")
        devices = {m.device for m in members}
        if len(devices) != 1:
            raise ValueError(f"members on several devices: {sorted(map(str, devices))}")
        self.members = members
        self.mode = mode
        self.mesh = mesh
        self.threshold = threshold
        self.device = members[0].device

    @torch.no_grad()
    def predict_tensors(self, images: torch.Tensor, kinematics: torch.Tensor):
        """The fusion on the device: (preds int32, probs fp32) tensors. On a
        mesh each rank serves its rows of the window batch over ``data``
        and every rank gets the whole batch's outputs."""
        return _on_mesh(self._fuse, self.mesh, images, kinematics)

    def _fuse(self, images: torch.Tensor, kinematics: torch.Tensor):
        if self.mode == "soft_vote":
            probs = [torch.sigmoid(m.logits(images, kinematics).reshape(-1))
                     for m in self.members]
            p = sum(probs) / len(probs)
            return (p >= self.threshold).to(torch.int32), p
        binary, multi = self.members
        b_logits = binary.logits(images, kinematics).reshape(-1)
        b_pred = (torch.sigmoid(b_logits) > self.threshold).to(torch.int32)
        m_pred = torch.argmax(multi.logits(images, kinematics), dim=-1).to(torch.int32)
        return torch.where(b_pred == 1, m_pred, torch.zeros_like(m_pred)), \
            torch.sigmoid(b_logits)

    def predict(self, images, kinematics):
        """Numpy (B, W, F) windows (fp32, or the int8 feature store) and
        (B, W, 26) kinematics -> numpy (preds, probs)."""
        images = np.asarray(images)
        dtype = torch.int8 if images.dtype == np.int8 else torch.float32
        x = torch.as_tensor(images, dtype=dtype, device=self.device)
        k = torch.as_tensor(np.asarray(kinematics), dtype=torch.float32, device=self.device)
        preds, probs = self.predict_tensors(x, k)
        return preds.cpu().numpy(), probs.cpu().numpy()


def load_ensemble(runs_root: str, run_ids: List[str], setting: str, fold: str,
                  mode: str = "soft_vote", mesh=None, int8_fe_calib=None,
                  device=None) -> EnsembleServer:
    """A server from stored runs of either package (``params.json`` and the
    fold's best checkpoint). ``int8_fe_calib``: an optional (B, W, 2048)
    feature batch; when given, every member with a FeatureExtractor serves
    through the int8 PTQ FE calibrated on it. ``mesh``: serve the window
    batches over its ``data`` axis (:class:`EnsembleServer`)."""
    members = []
    for run_id in run_ids:
        run_dir = RunTracker.find_run(runs_root, run_id)
        cfg = run_config(run_dir)
        ckpt = load_best_checkpoint(os.path.join(run_dir, "checkpoints"), setting, fold,
                                    model_name=cfg.model_name)
        member = WindowModelBundle(cfg, ckpt, device=device)
        if int8_fe_calib is not None:
            member.quantize_fe(int8_fe_calib)
        members.append(member)
    return EnsembleServer(members, mode=mode, mesh=mesh)


class PixelFrontEnd:
    """Raw frames -> pooled ResNet-50 trunk features, live.

    The trunk is :class:`models.resnet.ResNet50`, as in the JAX package, at
    ``dtype`` (bfloat16 by default, or float32), or with ``int8=True`` the
    PTQ serving trunk (``ops.quant``: 53 launches of the int8 kernel a
    batch) calibrated on ``calib_frames``, one representative raw-frame
    batch, on the CPU; on CUDA unless ``device="cpu"``.

    Preprocessing: with per-fold pixel channel stats (``mean`` and ``std``,
    what the fine-tune CLI stores in the checkpoint meta; one without the
    other raises ``ValueError``) frames are /255 and standardised; without
    them the ImageNet resize-240/crop-224 path
    (:func:`data.preprocessing.preprocess_frames`) runs. Frames go to the
    device in chunks of ``batch_size``, the last one zero-padded, so every
    chunk has one shape. On a ``mesh`` each chunk's frames split over its
    ``data`` axis and the features are gathered.
    """

    def __init__(self, trunk_params, trunk_stats, *, mean=None, std=None,
                 int8=False, calib_frames=None, dtype=torch.bfloat16,
                 stage_sizes=(3, 4, 6, 3), width=64, batch_size=128,
                 mesh=None, device=None):
        if (mean is None) != (std is None):
            given, missing = ("mean", "std") if std is None else ("std", "mean")
            raise ValueError(f"pixel statistics: a {given} without a {missing}; pass "
                             "both (the fold's channel statistics) or neither (the "
                             "ImageNet path)")
        if int8 and calib_frames is None:
            raise ValueError("int8=True needs calib_frames (one representative raw-frame "
                             "batch)")
        # fp32 as in the JAX package: no TF32 in matmuls or cuDNN on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = resolve_device(device)
        self.mesh = mesh
        self.batch_size = int(batch_size)
        self.stage_sizes = tuple(stage_sizes)
        self.mean = self.std = None
        if mean is not None:
            self.mean = torch.as_tensor(np.asarray(mean, np.float32))
            self.std = torch.as_tensor(np.asarray(std, np.float32))
        self.net = self.qt = None
        variables = {"params": trunk_params, "batch_stats": trunk_stats}
        if int8:
            calib = self._preprocess(torch.as_tensor(np.asarray(calib_frames, np.float32)))
            self.qt = tree_to(quantize_resnet50_trunk(variables, calib.numpy(),
                                                      self.stage_sizes), self.device)
        else:
            self.net = ResNet50(self.stage_sizes, width, dtype)
            state, _ = load_jax_params(variables, self.net)
            self.net.load_state_dict(state, strict=True)
            self.net.to(self.device).eval()
        if self.mean is not None:
            self.mean, self.std = self.mean.to(self.device), self.std.to(self.device)

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

    def _preprocess(self, x: torch.Tensor) -> torch.Tensor:
        if self.mean is not None:
            mean, std = self.mean.to(x.device), self.std.to(x.device)
            return (x.to(torch.float32) / 255.0 - mean) / std
        return preprocess_frames(x)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        x = self._preprocess(x)
        if self.qt is not None:
            return resnet50_int8_apply(self.qt, x, self.stage_sizes)
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
            with span("med.serve.upload"):
                chunk = frames[s:s + bs]
                n = len(chunk)
                if n < bs:
                    chunk = np.pad(chunk, ((0, bs - n),) + ((0, 0),) * 3)
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            with span("med.serve.trunk"):
                f = _on_mesh(self._features, self.mesh, x)
            with span("med.serve.to_host"):
                out.append(f[:n].cpu().numpy())
        return np.concatenate(out, axis=0)


def predict_trial_from_pixels(frontend: PixelFrontEnd, server: EnsembleServer, frames,
                              kinematics, g_labels, cfg: ExperimentConfig, stats):
    """Live pixels -> window predictions for one trial: trunk features
    (:class:`PixelFrontEnd`), the reference's windowing (``window_scan`` over
    the trial's gesture vector), the fold's standardization, the ensemble
    (:class:`EnsembleServer`). Returns numpy ``(starts, preds, probs)``: each
    emitted window's first frame and the ensemble's outputs, what the
    offline chain (feature export, ``build_window_fold``, the members on the
    stored windows) gives for the same trial."""
    feats = frontend.features(frames)
    kin = np.asarray(kinematics, np.float32)
    starts = window_scan(np.asarray(g_labels), cfg.window_size, cfg.stride)
    if starts.size == 0:
        return starts, np.empty(0, np.int32), np.empty(0, np.float32)
    gather = starts[:, None] + np.arange(cfg.window_size)[None, :]
    preds, probs = server.predict(standardize(feats[gather], stats["image"]),
                                  standardize(kin[gather], stats["kinematics"]))
    return starts, preds, probs


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
        with span("med.serve.request", root=True):
            return self.predict_trial(frontend.features(frames), kinematics)

    def predict_trial(self, images, kinematics):
        """images (T, 2048), kinematics (T, 26) raw -> (preds (T,), probs (T,)
        or (T, classes)) as numpy arrays; a trial longer than
        ``cfg.max_frames`` is cut there."""
        # the trial's root span, unless predict_trial_from_pixels opened it
        with span("med.serve.request", root=True):
            with span("med.serve.model"):
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
            with span("med.serve.to_host"):
                return (m["preds"].cpu().numpy()[:T], m["probs"].cpu().numpy()[:T])
