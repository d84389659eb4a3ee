"""Train and eval steps of every family (port of ``med_tpu.train.engine``):
input assembly, each family's loss with its confusion matrices, and one
optimiser step per window batch, trial or trial group.

=========  ===========================================================
family     model and loss
=========  ===========================================================
window     SimpleCNN / SimpleLSTM: binary BCE (train/validate_single
           _epoch), 6-class CE (_ES), the sequential regime's 5-class
           CE masked to true errors (_Sequential)
siamese    Siamese_CNN / Siamese_LSTM: BCE on the pair's similarity
           logit (train/validate_single_epoch_siamese)
cog        COG: multi-track CE + smoothing (train_..._COG), for the
           global, all_errors or one named error type; the sequential
           regime's gated 5-class loss (train_..._Sequential)
tecno      TeCNo: soft CE averaged over the stages (compute_loss)
tsvn       a frozen TeCNo, then TransSVNet on its last stage's logits:
           soft CE (train_..._TSVN)
mimo       MiMoV2Flash (models/mimo.py, the port's own): its (B, T, 2)
           logits, TransSVNet's soft CE
=========  ===========================================================

With ``trial_batch`` = G > 1 a step takes a group of G trials stacked on a
new leading axis, with their ``trial_weight`` (0 for the repeats that pad a
short group): the loss is the weighted mean of the trials' losses and each
confusion matrix their weighted sum, as ``med_tpu``'s trial-parallel step
computes them. COG runs the group as one batch, so its attention takes the
G trials in one launch a layer.

A window batch carries its 0/1 ``mask`` (the padding of a fold's last
batch repeats window 0); BatchNorm runs over the whole padded batch, in
training mode for a train step and on its running statistics for an eval
step, as in ``med_tpu``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import ExperimentConfig
from ..models import build_feature_extractor, build_model, build_tecno, init_weights
from ..ops.metrics import confusion_matrix
from ..parallel import comm
from ..parallel.mesh import full_view, shard_state, split_rows, unshard_state
from ..utils.device import resolve_device
from ..utils.jax_params import export_jax_params, load_jax_params
from ..utils.profiling import NO_SPAN, span
from . import losses
from .graphs import StepGraphs
from .optim import make_optimizer


class FrameNet(nn.Module):
    """The jointly held model and optional FeatureExtractor; its state_dict
    keys ("model.*", "fe.*") follow the JAX package's params tree."""

    def __init__(self, model: nn.Module, fe: Optional[nn.Module] = None):
        super().__init__()
        self.model = model
        self.fe = fe


class WindowNet(FrameNet):
    """A window model and its FeatureExtractor: (B, W, F) windows, or a
    siamese family's (B, 2, W, F) pairs, to logits. ``train`` puts its
    BatchNorms in training mode (batch statistics, running statistics
    updated) and draws dropout from ``masks`` or ``generator``; otherwise
    they normalise by the running statistics and nothing is dropped."""

    def forward(self, x: torch.Tensor, train: bool = False, masks=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() == 4:
            return self.model(x[:, 0], x[:, 1], train=train, masks=masks,
                              generator=generator)
        return self.model(x, train=train, masks=masks, generator=generator)


def window_loss(cfg: ExperimentConfig, family: str, out: torch.Tensor,
                batch: Dict[str, torch.Tensor], class_counts=None, group=None):
    """The window branch of med_tpu's ``_loss_for_family``. With
    ``pos_weight`` and the train fold's ``class_counts``: BCE's pos_weight
    cc[0] / cc[1] for 'global', CE's class weights cc otherwise. With a
    data-parallel ``group`` the means run over every rank's rows (the
    confusion matrices stay this rank's).

    - siamese, or 'global': BCE on the logit; preds sigmoid > 0.5, a
      binary "cm";
    - 'all_errors': CE over the 6 classes; "cm" and "cm_binary";
    - 'sequential': 5-class CE on the true-error windows against labels
      shifted to 0..4; preds argmax + 1, gated by ``batch["gate"]`` (the
      true errors when there is none) into the 6-class "cm";
      "cm_specific" over the 5 error classes on the true errors.

    Returns (loss, {"cm", ..., "probs", "preds"})."""
    mask, labels = batch.get("mask"), batch["labels"]
    pos_weight = class_weights = None
    if cfg.pos_weight and class_counts is not None:
        if cfg.error_type == "global":
            pos_weight = class_counts[0] / class_counts[1]
        else:
            class_weights = class_counts
    if family == "siamese" or cfg.error_type == "global":
        logits = out.reshape(-1)
        loss = losses.bce_with_logits(logits, labels, mask, pos_weight, group)
        probs = torch.sigmoid(logits.detach())
        preds = (probs > 0.5).to(torch.int32)
        return loss, {"cm": confusion_matrix(labels, preds, 2, mask), "probs": probs,
                      "preds": preds}
    detached = out.detach()
    if cfg.error_type == "all_errors":
        loss = losses.cross_entropy(out, labels, mask, class_weights, group)
        preds = torch.argmax(detached, dim=-1)
        return loss, {
            "cm": confusion_matrix(labels, preds, cfg.out_features, mask),
            "cm_binary": confusion_matrix((labels > 0).to(torch.int32),
                                          (preds > 0).to(torch.int32), 2, mask),
            "probs": torch.softmax(detached, dim=-1), "preds": preds}
    if cfg.error_type == "sequential":
        err = (labels != 0).to(torch.float32)
        m = err if mask is None else err * mask
        loss = losses.cross_entropy(out, torch.clamp(labels - 1, min=0), m, group=group)
        preds = torch.argmax(detached, dim=-1) + 1
        gate = batch.get("gate", err)
        gated = torch.where(gate > 0, preds, torch.zeros_like(preds))
        return loss, {
            "cm": confusion_matrix(labels, gated, 6, mask),
            "cm_specific": confusion_matrix(torch.clamp(labels - 1, min=0), preds - 1,
                                            5, m),
            "probs": torch.softmax(detached, dim=-1), "preds": preds}
    raise ValueError(f"the window families take 'global', 'all_errors' or "
                     f"'sequential', not {cfg.error_type!r}")


def cog_loss(cfg: ExperimentConfig, out_list, batch: Dict[str, torch.Tensor]):
    """The COG branch of med_tpu's ``_loss_for_family``: CE and smoothing
    summed over every track and divided by the number of tracks; metrics
    from the first slow track, over 2 classes for 'global' and
    ``out_features`` for 'all_errors' or a named error type ('all_errors'
    adds "cm_binary", error against none). The 'sequential' regime takes
    :func:`cog_sequential_loss`. Returns (loss, {"cm", ["cm_binary"],
    "preds", "probs"})."""
    if cfg.error_type == "sequential":
        return cog_sequential_loss(cfg, out_list, batch)
    n_classes = 2 if cfg.error_type == "global" else cfg.out_features
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


def cog_sequential_loss(cfg: ExperimentConfig, out_list, batch: Dict[str, torch.Tensor]):
    """Stage 2 of the sequential regime (med_tpu's ``_cog_sequential_loss``;
    reference modeling_utils.py:1761-2187): over the frames its ``gate``
    opens (true errors in training, the binary stage's predictions at
    eval), each track's 5-class CE and smoothing against the powerset
    labels shifted to 0..4, labels and gate nearest-resampled to the track.
    Predictions are argmax + 1; "cm" is over 6 classes with the closed
    frames predicted 0, "cm_specific" over the 5 error classes on the open
    ones. Returns (loss, {"cm", "cm_specific", "preds", "probs"})."""
    if "gate" not in batch:
        raise ValueError("the sequential regime needs each trial's gate: pass "
                         "gates= (train_frame_fold) or a batch with 'gate'")
    labels, true_len, mask = batch["labels"], batch["true_len"], batch.get("mask")
    gate = batch["gate"].to(torch.float32)
    m = gate if mask is None else gate * mask
    t_pad = labels.shape[0]
    shifted = torch.clamp(labels - 1, min=0)
    n_stages = len(out_list)
    ce_total = sm_total = 0.0
    for track in out_list:
        logits = track[0]
        t_track = logits.shape[0]
        track_labels = losses.nearest_resample_dynamic(shifted, true_len, t_track)
        track_gate = losses.nearest_resample_dynamic(m, true_len, t_track)
        true_out = torch.clamp((true_len * t_track) // t_pad, min=1)
        valid = (torch.arange(t_track, device=logits.device) < true_out).to(torch.float32)
        tm = track_gate * valid
        ce_total = ce_total + losses.cross_entropy(logits, track_labels, tm)
        sm_total = sm_total + losses.smooth_loss(logits, tm[1:] * tm[:-1])
    loss = ce_total / n_stages + cfg.smooth_lambda * (sm_total / n_stages)
    track0 = out_list[0][0].detach()
    preds = torch.argmax(track0, dim=-1) + 1
    gated = torch.where(gate > 0, preds, torch.zeros_like(preds))
    return loss, {"cm": confusion_matrix(labels, gated, 6, mask),
                  "cm_specific": confusion_matrix(shifted, preds - 1, 5, m),
                  "preds": preds, "probs": torch.softmax(track0, dim=-1)}


def binary_frame_loss(family: str, out, batch: Dict[str, torch.Tensor]):
    """The TeCNo and TransSVNet branch of med_tpu's ``_loss_for_family``:
    the soft CE against [1 - y, y] (TeCNo: averaged over its stages, ``out``
    (S, B, T, 2); TransSVNet: ``out`` (B, T, 2)); metrics from the final
    output, a binary confusion matrix. Returns (loss, {"cm", "preds",
    "probs"})."""
    labels, mask = batch["labels"], batch.get("mask")
    if family == "tecno":
        final = out[-1]
        loss = losses.tecno_stage_loss(out, labels, mask)
    else:
        final = out
        loss = losses.soft_cross_entropy(
            final, losses.binary_targets(labels, final.dtype), mask)
    preds, probs = _predictions(final.detach(), 2)
    return loss, {"cm": confusion_matrix(labels, preds, 2, mask), "preds": preds,
                  "probs": probs}


def _predictions(final: torch.Tensor, n_classes: int):
    """Per-frame argmax and probabilities of a (1, T, n) output: the class-1
    softmax when binary, else every class's."""
    preds = torch.argmax(final, dim=-1).reshape(-1)
    probs = torch.softmax(final, dim=-1)
    if n_classes == 2:
        return preds, probs[..., 1].reshape(-1)
    return preds, probs.reshape(-1, n_classes)


_FAMILIES = {"COG": "cog", "TeCNo": "tecno", "TransSVNet": "tsvn", "MiMoV2Flash": "mimo",
             "SimpleCNN": "window", "SimpleLSTM": "window",
             "Siamese_CNN": "siamese", "Siamese_LSTM": "siamese"}
WINDOW_FAMILIES = ("window", "siamese")
WINDOW_MODELS = tuple(n for n, f in _FAMILIES.items() if f in WINDOW_FAMILIES)


class Experiment:
    """Binds a config to its model, optimiser and dropout generator on one
    device (CUDA unless the caller passes ``device="cpu"``). Parameters start
    at zero (serving loads them); :meth:`init_weights` draws them from a
    seed. Matmuls and cuDNN compute in full fp32, as the JAX package's do:
    constructing an Experiment switches TF32 off for both. ``arch``:
    MiMoV2Flash's sizes (``models.mimo.MiMoArch``; the published widths and
    this chip's cut when None)."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 prompt_path: Optional[str] = None, arch=None):
        # PyTorch leaves cuDNN's TF32 on by default, and the window models'
        # convs and LSTMs run on cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self.family = _FAMILIES[cfg.model_name]
        container = WindowNet if self.family in WINDOW_FAMILIES else FrameNet
        net = container(build_model(cfg, prompt_path, arch), build_feature_extractor(cfg))
        self.net = net.to(self.device).eval()
        self.optimizer = make_optimizer(cfg, self.net.parameters())
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.frozen = None
        # the window families' loss weights: the train fold's class counts
        # (med_tpu's ``constants["class_counts"]``), set by init_weights
        self.class_counts: Optional[torch.Tensor] = None
        # data/tensor parallelism (parallel/mesh.py::shard_state)
        self.mesh = None
        self.tp: Dict[str, int] = {}
        # COG's train steps from CUDA graphs, where they engage (train/graphs.py)
        self.graphs = StepGraphs(self)

    def load_frozen(self, frozen: Dict) -> None:
        """Give a TransSVNet experiment its frozen TeCNo, a TeCNo of the same
        config (reference modeling_utils.py:2263-2268), from med_tpu's
        ``{"tecno_params": <TeCNo params tree>}``. It stays outside the net,
        so neither the optimiser nor a checkpoint of the net holds it."""
        if self.family != "tsvn":
            raise ValueError(f"a frozen stage belongs to TransSVNet; this experiment "
                             f"runs {self.cfg.model_name}")
        tecno = build_tecno(self.cfg)
        state, _ = load_jax_params({"params": frozen["tecno_params"]}, tecno)
        tecno.load_state_dict(state, strict=True)
        self.frozen = tecno.to(self.device).eval().requires_grad_(False)

    def load_params(self, checkpoint: Dict) -> None:
        """Take a ``med_tpu`` checkpoint tree's parameters, running
        statistics, class counts and frozen prompt tables
        (``load_best_checkpoint`` of a run of either package). The step
        graphs are dropped."""
        self.graphs.clear()
        consts = dict(checkpoint.get("constants", {}))
        counts = consts.pop("class_counts", None)
        self.class_counts = (None if counts is None else
                             torch.tensor(np.asarray(counts, np.float32),
                                             device=self.device))
        checkpoint = {**checkpoint, "constants": consts}
        state, constants = load_jax_params(checkpoint, self.net)
        self.net.load_state_dict(state, strict=True)
        with torch.no_grad():
            for name, value in constants.items():
                self.net.get_buffer(name).copy_(value)

    def init_weights(self, seed: int, class_counts=None) -> None:
        """Draw every parameter from ``seed`` (each module's scheme, on the
        CPU so the draw is the same on every device), reset the running
        statistics, restart the optimiser and the dropout stream from the
        config's seed, and take the train fold's ``class_counts`` (the
        window families' loss weights, or None). The step graphs are
        dropped (``unshard_state``)."""
        mesh = self.mesh
        unshard_state(self)         # drawn at their whole shapes, then placed
        init_weights(self.net, torch.Generator().manual_seed(seed))
        self.optimizer = make_optimizer(self.cfg, self.net.parameters())
        if mesh is not None:
            shard_state(self, mesh)
        self.generator.manual_seed(self.cfg.seed)
        self.class_counts = (None if class_counts is None else
                             torch.tensor(np.asarray(class_counts, np.float32),
                                             device=self.device))

    def checkpoint(self) -> Dict:
        """The parameters, running statistics and constants as a ``med_tpu``
        checkpoint tree (numpy copies): {"params", "batch_stats",
        "constants"}, the class counts among the constants when set."""
        with full_view(self):
            tree = export_jax_params(self.net)
        tree.setdefault("batch_stats", {})
        if self.class_counts is not None:
            tree.setdefault("constants", {})["class_counts"] = (
                self.class_counts.cpu().numpy().copy())
        return tree

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device (keys starting with '_' stay)."""
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                continue
            dtype = (torch.float32 if k in ("images", "kinematics", "mask", "gate",
                                            "trial_weight") else None)
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

    def _forward(self, data: Dict[str, torch.Tensor], train: bool, masks=None):
        """The model's output for the family's loss: COG's track list,
        TeCNo's (S, 1, T, 2) stage logits, TransSVNet's and MiMoV2Flash's
        (1, T, 2) (MiMo has no dropout). The frozen
        TeCNo runs under no_grad, so it saves nothing for a backward."""
        x = self._assemble(data)
        model = self.net.model
        if self.family in WINDOW_FAMILIES:
            return self.net(x, train=train, masks=masks, generator=self.generator)
        if self.family == "tsvn":
            if self.frozen is None:
                raise ValueError("TransSVNet needs its frozen TeCNo: pass frozen= "
                                 "(or call load_frozen) first")
            with torch.no_grad():
                tecno_logits = self.frozen(x)[-1]
            return model(tecno_logits, x)
        if self.family == "tecno":
            return model(x, train=train, masks=masks, generator=self.generator)
        if self.family == "mimo":
            return model(x)
        out_list, _ = model(x, train=train, masks=masks, generator=self.generator)
        return out_list

    def _loss(self, out, data: Dict[str, torch.Tensor], group=None):
        if self.family in WINDOW_FAMILIES:
            return window_loss(self.cfg, self.family, out, data, self.class_counts, group)
        if self.family == "cog":
            return cog_loss(self.cfg, out, data)
        return binary_frame_loss(self.family, out, data)

    def _trial_loss(self, data: Dict[str, torch.Tensor], train: bool, masks=None,
                    group=None):
        """One trial's (loss, metrics), or a trial group's (see the module
        docstring) when ``trial_batch`` > 1. With a data-parallel ``group``
        the loss is the whole batch's or group's (the metrics this rank's)."""
        if self.cfg.trial_batch <= 1 or self.family in WINDOW_FAMILIES:
            with _phase("med.train.forward", train):
                out = self._forward(data, train, masks)
            with _phase("med.train.loss", train):
                return self._loss(out, data, group)
        weight = data.pop("trial_weight", None)
        G = data["labels"].shape[0]
        trials = [{k: v[g] for k, v in data.items()} for g in range(G)]
        if self.family == "cog":
            # one batch of G trials: the attention folds them into its heads
            with _phase("med.train.forward", train):
                out_list, _ = self.net.model(self._assemble(data)[:, 0], train=train,
                                             masks=masks, generator=self.generator)
            with _phase("med.train.loss", train):
                results = [self._loss([t[g:g + 1] for t in out_list], trials[g])
                           for g in range(G)]
        else:
            results = []
            for g, trial in enumerate(trials):
                with _phase("med.train.forward", train):
                    out = self._forward(trial, train, _trial_masks(masks, g))
                with _phase("med.train.loss", train):
                    results.append(self._loss(out, trial))
        if weight is None:
            weight = torch.ones(G, device=self.device)
        per_trial = torch.stack([loss for loss, _ in results])
        if group is not None:
            # a short group's zero-weight repeats: the global weighted mean,
            # not a mean of the ranks' means
            loss = losses._global_ratio((per_trial * weight).sum(), weight.sum(), group)
        else:
            loss = (per_trial * weight).sum() / torch.clamp(weight.sum(), min=1e-12)
        metrics = {}
        for key in results[0][1]:
            values = torch.stack([m[key] for _, m in results])
            if key.startswith("cm"):
                values = (values * weight.to(torch.int32)[:, None, None]).sum(dim=0)
            metrics[key] = values
        return loss, metrics

    def compute_gradients(self, batch: Dict[str, np.ndarray], masks=None):
        """Forward in training mode (dropout ``masks`` in the model's
        ``dropout_masks`` layout, with the group's trials on its batch axis
        when ``trial_batch`` > 1, or drawn from the experiment's generator;
        TransSVNet has no dropout), the loss, and its backward into every
        parameter's ``.grad``. Returns (loss, metrics). Where the step
        graphs engage (``train/graphs.py``), the forward, the loss and the
        backward run from them, the kernels between them."""
        with span("med.train.inputs"):
            data = self._tensors(batch)
            data, masks, group = self._local_rows(data, masks, True)
        graphed = self.graphs.engages()
        if graphed:
            loss, metrics = self.graphs.loss(data, masks)
        else:
            loss, metrics = self._trial_loss(data, True, masks, group)
        with span("med.train.backward"):
            self.optimizer.zero_grad(set_to_none=False)
            loss.backward()
            comm.all_reduce_grads(self.net.parameters(), group)
        # a graph's loss lies in its memory, which the next step overwrites
        loss = loss.detach()
        return (loss.clone() if graphed else loss), _whole_batch(metrics, group)

    def _local_rows(self, data, masks, train: bool):
        """This rank's rows of a window batch or trial group over the mesh's
        ``data`` axis, with the rows of the dropout masks that one rank would
        draw for the whole batch (or of the ``masks`` given, in the same
        global layout), and the axis' group; (data, masks, None) where the
        batch stays whole."""
        if (self.mesh is None or self.mesh.shape["data"] == 1
                or (self.family not in WINDOW_FAMILIES and self.cfg.trial_batch <= 1)):
            return data, masks, None
        rows = split_rows(data["labels"].shape[0], self.mesh)
        if rows is None:
            return data, masks, None
        if train and masks is None:
            masks = self._global_masks(data)
        local = {k: v[rows] if v.dim() else v for k, v in data.items()}
        return local, _mask_rows(masks, rows), self.mesh.group("data")

    def _global_masks(self, data):
        """The dropout masks a one-rank step draws for this whole batch or
        group, in the same order from the same generator."""
        model = self.net.model
        n = data["labels"].shape[0]
        if self.family in WINDOW_FAMILIES:
            return model.dropout_masks(n, self.generator)
        T = data["labels"].shape[-1]
        if self.family == "cog":
            return model.dropout_masks(T, self.generator, n)
        if self.family == "tecno":
            per = [model.dropout_masks(T, self.generator, 1) for _ in range(n)]
            return {s: {"stack": torch.cat([m[s]["stack"] for m in per], dim=1)}
                    for s in per[0]}
        return None

    def train_step(self, batch: Dict[str, np.ndarray], masks=None
                   ) -> Dict[str, torch.Tensor]:
        """One window batch, trial or trial group: forward, loss, backward
        and one optimiser step. Returns the metrics ("loss", "cm", ...) as device
        tensors: nothing syncs the host."""
        with span("med.train.step", root=True):
            loss, metrics = self.compute_gradients(batch, masks)
            with span("med.train.optimizer"):
                self.optimizer.step()
        metrics["loss"] = loss
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One padded trial (or trial group, or window batch, with its
        labels) -> {"preds", "probs"} over its frames or windows, from the
        family's final output (COG's first slow track): argmax, and the
        class-1 softmax when binary; with "loss" and "cm" too when the batch
        carries labels."""
        cfg = self.cfg
        data = self._tensors(batch)
        if "labels" in data:
            data, _, group = self._local_rows(data, None, False)
            loss, metrics = self._trial_loss(data, False, group=group)
            metrics = _whole_batch(metrics, group)
            metrics["loss"] = loss
            return metrics
        if (cfg.error_type == "sequential" or cfg.trial_batch > 1
                or self.family in WINDOW_FAMILIES):
            raise ValueError("a window, sequential or trial-group eval step takes "
                             "the batch's labels (and the sequential regime its gate)")
        out = self._forward(data, False)
        if self.family == "cog":
            n_classes = 2 if cfg.error_type == "global" else cfg.out_features
            final = out[0]
        else:
            n_classes, final = 2, out[-1] if self.family == "tecno" else out
        preds, probs = _predictions(final, n_classes)
        return {"preds": preds, "probs": probs}


def _phase(name: str, train: bool):
    """A train step's phase span; an eval step's forward and loss open none."""
    return span(name) if train else NO_SPAN


def _mask_rows(masks, rows: slice):
    """The rows of a batch's dropout masks (a window model's list, a twin
    pair's two lists, or a frame model's {stage: {"stack": (L, B, T, C),
    "channel": (B, 1, C)}})."""
    if masks is None:
        return None
    if isinstance(masks, dict):
        return {name: {k: v[:, rows] if k == "stack" else v[rows] for k, v in stage.items()}
                for name, stage in masks.items()}
    if isinstance(masks, tuple):
        return tuple(_mask_rows(m, rows) for m in masks)
    return [m[rows] for m in masks]


def _whole_batch(metrics, group):
    """A data-parallel step's metrics for the whole batch: confusion matrices
    summed over the ranks, predictions gathered in row order."""
    if group is None:
        return metrics
    out = {}
    for k, v in metrics.items():
        if k.startswith("cm"):
            out[k] = comm.psum(v, group)
        elif k in ("preds", "probs"):
            out[k] = comm.all_gather(v, group)
        else:
            out[k] = v
    return out


def _trial_masks(masks, g: int):
    """Trial ``g``'s dropout masks of a group's (stage -> {"stack": (L, G,
    T, C), "channel": (G, 1, C)}), with a batch axis of one."""
    if masks is None:
        return None
    return {name: {k: v[:, g:g + 1] if k == "stack" else v[g:g + 1]
                   for k, v in stage.items()}
            for name, stage in masks.items()}
