"""MiMo-V2-Flash's block trained on whole trials, as ``train_frame_fold``
steps a fold: each epoch visits the trials in ``default_rng(seed +
epoch)``'s order, pads every trial to the fold's common bucket
(``frame_batch``), prefetches them to the card and calls
``Experiment.train_step`` on each. The window runs epoch after epoch and
syncs once, at the end of the first epoch that ends past ``--seconds``
(as ``frame_train``'s, whose feed and rules this driver shares).

The model is the configuration's cut at its published widths (~2.07 B
parameters: ~33 GB of weights, gradients and Adam's moments). Its weights
come from the seed on the card; the program gets them, and the initial
copy goes to the host, so the window holds one model.

Set-up's first ``check_steps`` steps go through the same call and feed and
keep the experts each MoE layer picked (``MiMoMoE.select``, recorded as it
returns them). After the window the program is freed, and the reference
(``reference/mimo_v2_flash.py::blocked_step``) runs the same steps from
the same weights one layer at a time on the card, its parameters and
Adam's moments on the host. It follows the program's picks where they are
a top k of its own scores (``pick_gap``: how far the worst frame's picks
are from one; 0 where they are), since a score that rounding moves across
the k-th can move one frame between experts."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from core import weights as W
from core.compare import norms, training_numbers
from drivers.common import (bucket, first_moment_grads, label_runs, log_uniform_lengths,
                            permutation, rng, sync)
from drivers.frame_train import Driver as FrameTrainDriver
from drivers.frame_train import _powerset
from work import mimo_v2_flash as mimo_work


# the port's kernels this path launches: built together, in parallel, by the
# first run in a checkout (``med_tpu_torch/build/``), loaded by later runs
KERNELS = ("swa_sink_fwd", "swa_sink_bwd")

# the traffic file's parameters (a nested group by its keys): anything else
# is refused, so that a parameter this driver does not read cannot pass
TRAFFIC = {"trials": None, "frames": ("min", "max"), "label_runs": ("min", "max"),
           "kinematic_shift": None, "shifted_channels": None, "check_steps": None}


def build_kernels(device) -> None:
    if device.type == "cuda":
        from med_tpu_torch.ops import cuda_build

        cuda_build.build(KERNELS)


class Driver(FrameTrainDriver):
    """``frame_train``'s feed, window, counters and release; MiMo's trials
    (no prompt table), set-up, step accounting, check and control."""

    # ------------------------------------------------------------ inputs
    def _trials(self):
        ctx, cfgf, t = self.ctx, self.ctx.config, self.ctx.traffic
        lengths = log_uniform_lengths(t["trials"], t["frames"]["min"], t["frames"]["max"])
        lengths = [lengths[i] for i in permutation(ctx.seed, len(lengths), 0)]
        r = rng(ctx.seed, 1)
        images = W.generator(ctx.seed, ctx.device, 2)
        self.trials = []
        for i, T in enumerate(lengths):
            labels = label_runs(r, T, t["label_runs"]["min"], t["label_runs"]["max"])
            kin = r.standard_normal((T, cfgf["kinematic_dims"]), dtype=np.float32)
            kin[:, :t["shifted_channels"]] += labels[:, None] * t["kinematic_shift"]
            feats = torch.randn((T, cfgf["video_dims"]), generator=images,
                                device=ctx.device).cpu().numpy()
            self.trials.append(dict(name=f"Suturing_B{i:03d}", images=feats,
                                    kinematics=kin, labels=labels))

    def _weights(self) -> Dict[str, torch.Tensor]:
        ref = self.ctx.reference
        return W.make(ref.param_spec(self.ctx.config),
                      W.generator(self.ctx.seed, self.ctx.device, 0), self.ctx.device)

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        from med_tpu_torch.config import ExperimentConfig
        from med_tpu_torch.data.datasets import FrameTrial
        from med_tpu_torch.models.mimo import MiMoArch, MiMoMoE
        from med_tpu_torch.train.engine import Experiment
        from med_tpu_torch.train.loop import _common_bucket

        ctx, ref = self.ctx, self.ctx.reference
        build_kernels(ctx.device)
        self._trials()
        self.cfg = ExperimentConfig(**{**ctx.config["experiment"], "seed": ctx.seed})
        self.exp = Experiment(self.cfg, device=ctx.device,
                              arch=MiMoArch.from_dict(ref.arch(ctx.config)))
        weights = self._weights()
        self.exp.net.load_state_dict(weights, strict=True)
        # the initial weights on the host: the check's start and the change's origin
        self.host = {k: v.cpu() for k, v in weights.items()}
        del weights
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        self.program_trials = [
            FrameTrial(name=t["name"], images=t["images"], kinematics=t["kinematics"],
                       g_labels=np.zeros(len(t["labels"]), np.int64),
                       e_powerset=_powerset(t["labels"]),
                       skill=np.tile(np.float32([1, 0, 0]), (len(t["labels"]), 1)))
            for t in self.trials]
        self.bucket = _common_bucket(self.cfg, self.program_trials)
        self.feed = self._feed()
        moes = [(i, layer.ffn) for i, layer in enumerate(self.exp.net.model.layers)
                if isinstance(layer.ffn, MiMoMoE)]
        picked: Dict[int, torch.Tensor] = {}

        def recorder(i, select):
            def record(scores):
                picked[i] = select(scores)
                return picked[i]
            return record

        for i, moe in moes:
            moe.select = recorder(i, moe.select)     # the checked steps' own picks, kept
        self.first = []                                # (trial index, picks a layer, loss)
        L = len(self.exp.net.model.layers)
        for s in range(ctx.traffic["check_steps"]):
            picked.clear()
            i, m = self._step(record=False)
            self.first.append((i, [picked[j].cpu() if j in picked else None for j in range(L)],
                               m["loss"]))
            if s == 0:
                named = list(self.exp.net.named_parameters())
                self.prog_grad = norms(first_moment_grads(self.exp.optimizer, named))
        for _, moe in moes:
            del moe.select                             # the window runs the class's own
        self.prog_change = {k: float((p.detach() - self.host[k].to(p.device)).double().norm())
                            for k, p in self.exp.net.named_parameters()}
        self.prog_losses = [float(l) for _, _, l in self.first]
        sync(ctx.device)
        _log_peak(ctx, "set-up")

    def _step(self, record: bool):
        tracer = self.ctx.tracer
        with tracer.span("bench.feed"):
            i, batch, self.epoch_end = next(self.feed)
        with tracer.span("bench.step"):
            m = self.exp.train_step(batch)
        if record:
            real = min(len(self.trials[i]["labels"]), self.bucket)
            self.frames += real
            self.stepped += self.bucket
            self.model_flops += mimo_work.train_flops(self.ctx.config, real)
            self.losses.append(m["loss"])
        return i, m

    # ---------------------------------------------------------------- check
    def _reference_steps(self, pinned: bool):
        """The reference's losses, first-gradient norms, change norms and
        worst pick gap over the checked steps, from the same weights and
        trials, one layer on the card at a time."""
        ctx, cfgf, ref = self.ctx, self.ctx.config, self.ctx.reference
        e = cfgf["experiment"]
        p = {k: v.clone() for k, v in self.host.items()}
        state: Dict[str, tuple] = {}
        losses, grad, gap = [], None, 0.0
        for s, (i, picks, _) in enumerate(self.first):
            t = self.trials[i]
            T = min(len(t["labels"]), self.bucket)
            x = np.zeros((self.bucket, cfgf["video_dims"] + cfgf["kinematic_dims"]), np.float32)
            x[:T, :cfgf["video_dims"]] = t["images"][:T]
            x[:T, cfgf["video_dims"]:] = t["kinematics"][:T]
            labels = np.zeros(self.bucket, np.int64)
            labels[:T] = t["labels"][:T]
            pins = [None if q is None else q.to(ctx.device) for q in picks] if pinned else None
            value, grads, _, gaps = ref.blocked_step(p, cfgf, torch.from_numpy(x),
                                                     torch.from_numpy(labels), T, ctx.device,
                                                     pins)
            gap = max([gap] + gaps)
            if s == 0:
                grad = norms(grads)
            ref.adam_step(p, grads, state, s + 1, e["lr"], cfgf["adam"]["betas"],
                          cfgf["adam"]["eps"], ctx.device)
            losses.append(value)
        change = {k: float((p[k] - self.host[k]).double().norm()) for k in p}
        return losses, grad, change, gap

    def check(self) -> Dict[str, float]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.ctx.device)
        losses, grad, change, gap = self._reference_steps(pinned=True)
        _log_peak(self.ctx, "check")
        numbers = training_numbers(self.prog_losses, losses, self.prog_grad, grad,
                                   self.prog_change, change)
        numbers["pick_gap"] = gap
        return numbers

    def control(self) -> Dict[str, float]:
        """The reference in TF32 in the program's place, against the
        reference in float32, each routing on its own scores."""
        self._trials()
        self.host = {k: v.cpu() for k, v in self._weights().items()}
        self.bucket = bucket(max(len(x["labels"]) for x in self.trials))
        order = np.random.default_rng(self.ctx.seed).permutation(len(self.trials))
        L = len(self.ctx.reference.arch(self.ctx.config)["pattern"])
        self.first = [(int(order[s]), [None] * L, None)
                      for s in range(self.ctx.traffic["check_steps"])]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        low = self._reference_steps(pinned=False)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        exact = self._reference_steps(pinned=False)
        numbers = training_numbers(low[0], exact[0], low[1], exact[1], low[2], exact[2])
        numbers["pick_gap"] = 0.0
        return numbers


def _log_peak(ctx, phase: str) -> None:
    """The card's peak memory so far (since the last reset) on stderr: the
    result's ``memory_peak_bytes`` covers set-up and the windows together."""
    if ctx.device.type == "cuda":
        ctx.log(f"memory: {phase} peak {torch.cuda.max_memory_allocated(ctx.device) / 1e9:.2f} GB")
