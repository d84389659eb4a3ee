"""A frame model trained on whole trials, as ``train_frame_fold`` steps a
fold: each epoch visits the trials in ``default_rng(seed + epoch)``'s
order, pads every trial to the fold's common bucket (``frame_batch``),
prefetches them to the card at the configuration's depth and calls
``Experiment.train_step`` on each, which draws its own dropout masks, as
the CLI's steps do. The window runs epoch after epoch and syncs once, at its
end: at the end of the first epoch that ends past ``--seconds``, so that
every window holds whole epochs (the host pads a whole epoch's trials
before its first step, and a window cut inside that pause would read
another rate than one cut inside the steps).

Set-up's first ``check_steps`` steps go through the same call and feed,
each on another trial, and keep the masks the program drew for them
(``COG.dropout_masks``, recorded as it returns them): the reference
follows them from the same weights, trials and masks. Eval, selection and
checkpoints are not driven."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from core import weights as W
from core.compare import norms, training_numbers
from drivers.common import (Context, bucket, first_moment_grads, label_runs,
                            log_uniform_lengths, now, permutation, rng, sync)
from work import cog as cog_work
from work.peaks import FP32_FLOPS


# the port's kernels this path launches: built together, in parallel, by the
# first run in a checkout (``med_tpu_torch/build/``), loaded by later runs
KERNELS = ("swa_packed_fwd", "swa_packed_bwd", "tcn_stack_fwd", "tcn_stack_bwd")

# the traffic file's parameters (a nested group by its keys): anything else
# is refused, so that a parameter this driver does not read cannot pass
TRAFFIC = {"trials": None, "frames": ("min", "max"), "label_runs": ("min", "max"),
           "kinematic_shift": None, "shifted_channels": None, "check_steps": None}


def build_kernels(device) -> None:
    if device.type == "cuda":
        from med_tpu_torch.ops import cuda_build

        cuda_build.build(KERNELS)


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.attempted = self.failed = 0

    # ------------------------------------------------------------ inputs
    def _inputs(self):
        """Weights, prompt table and trials from the seed (no program)."""
        ctx, cfgf, t = self.ctx, self.ctx.config, self.ctx.traffic
        dev, ref = ctx.device, ctx.reference
        self.weights = W.make(ref.param_spec(cfgf), W.generator(ctx.seed, dev, 0), dev)
        self.table = ref.prompt_table(cfgf, W.generator(ctx.seed, dev, 1), dev)
        lengths = log_uniform_lengths(t["trials"], t["frames"]["min"], t["frames"]["max"])
        lengths = [lengths[i] for i in permutation(ctx.seed, len(lengths), 0)]
        r = rng(ctx.seed, 1)
        video = cfgf["experiment"]["video_dims"]
        images = W.generator(ctx.seed, dev, 2)
        self.trials = []
        for i, T in enumerate(lengths):
            labels = label_runs(r, T, t["label_runs"]["min"], t["label_runs"]["max"])
            kin = r.standard_normal((T, cfgf["kinematic_dims"]), dtype=np.float32)
            kin[:, :t["shifted_channels"]] += labels[:, None] * t["kinematic_shift"]
            feats = torch.randn((T, video), generator=images, device=dev).cpu().numpy()
            self.trials.append(dict(name=f"Suturing_B{i:03d}", images=feats,
                                    kinematics=kin, labels=labels))

    def _masks(self, T: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """The control's dropout masks, in the model's layout: a stack's (L,
        1, T_i, C) 0/1 uint8 keep-mask for every stage, a (1, 1, C) channel
        keep-mask for the two input stages; one draw for all of them."""
        e = self.ctx.config["experiment"]
        C, L0, Lr, R = e["mstcn_f_maps"], e["num_layers_Basic"], e["num_layers_R"], e["num_R"]
        Tf = T // self.ctx.config["fast_pool"]
        slow, fast = self.ctx.reference.stage_names(R)
        shapes = [(n, L0 if i == 0 else Lr, T) for i, n in enumerate(slow)]
        shapes += [(n, L0 if i == 0 else Lr, Tf) for i, n in enumerate(fast)]
        # each mask starts on a 16-byte boundary: the kernels read them 16
        # bytes at a time
        sizes = [-(-L * t * C // 16) * 16 for _, L, t in shapes]
        bits = torch.randint(0, 2, (sum(sizes) + 2 * C,), generator=self.mask_gen,
                             device=self.ctx.device, dtype=torch.uint8)
        out, at = {}, 0
        for (n, L, t), size in zip(shapes, sizes):
            out[n] = {"stack": bits[at:at + L * t * C].view(L, 1, t, C)}
            at += size
        for n in (slow[0], fast[0]):
            out[n]["channel"] = bits[at:at + C].view(1, 1, C).to(torch.float32)
            at += C
        return out

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        from med_tpu_torch.config import ExperimentConfig
        from med_tpu_torch.data.datasets import FrameTrial
        from med_tpu_torch.train.engine import Experiment
        from med_tpu_torch.train.loop import _common_bucket

        ctx = self.ctx
        build_kernels(ctx.device)
        self._inputs()
        self.cfg = ExperimentConfig(**{**ctx.config["experiment"], "seed": ctx.seed})
        self.exp = Experiment(self.cfg, device=ctx.device)
        self.exp.net.load_state_dict(self.weights, strict=True)
        with torch.no_grad():
            self.exp.net.model.gest_embed.copy_(self.table)
        self.program_trials = [
            FrameTrial(name=t["name"], images=t["images"], kinematics=t["kinematics"],
                       g_labels=np.zeros(len(t["labels"]), np.int64),
                       e_powerset=_powerset(t["labels"]),
                       skill=np.tile(np.float32([1, 0, 0]), (len(t["labels"]), 1)))
            for t in self.trials]
        self.bucket = _common_bucket(self.cfg, self.program_trials)
        self.feed = self._feed()
        model, drawn = self.exp.net.model, []
        draw = model.dropout_masks

        def record(*args, **kwargs):
            drawn.append(draw(*args, **kwargs))
            return drawn[-1]

        model.dropout_masks = record          # the checked steps' own draws, kept
        self.first = []                       # (trial index, masks, loss) of the checked steps
        for s in range(ctx.traffic["check_steps"]):
            i, m = self._step(record=False)
            if len(drawn) != s + 1:
                raise RuntimeError(f"step {s} drew dropout masks {len(drawn) - s} times")
            self.first.append((i, drawn[-1], m["loss"]))
            if s == 0:
                named = list(self.exp.net.named_parameters())
                self.prog_grad = norms(first_moment_grads(self.exp.optimizer, named))
        del model.dropout_masks               # the window runs the class's own draw
        self.prog_change = norms({k: p.detach() - self.weights[k]
                                  for k, p in self.exp.net.named_parameters()})
        self.prog_losses = [float(l) for _, _, l in self.first]
        sync(ctx.device)

    def _feed(self):
        """(trial index, device batch, last of its epoch) of every step,
        epoch after epoch."""
        from med_tpu_torch.data.datasets import frame_batch
        from med_tpu_torch.utils.prefetch import prefetch_to_device

        tracer, cfg = self.ctx.tracer, self.cfg
        epoch = 0
        while True:
            order = np.random.default_rng(cfg.seed + epoch).permutation(len(self.trials))
            with tracer.span("bench.batches"):
                batches = [frame_batch(self.program_trials[i], cfg, bucket=self.bucket)
                           for i in order]
            for k, (i, b) in enumerate(zip(order, prefetch_to_device(
                    batches, cfg.prefetch_depth, self.exp.device))):
                yield int(i), b, k == len(order) - 1
            epoch += 1

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
            self.model_flops += cog_work.train_flops(self.ctx.config, real)
            self.losses.append(m["loss"])
        return i, m

    # --------------------------------------------------------------- window
    def window(self, seconds: float) -> None:
        self.frames = self.stepped = 0
        self.attempted = self.failed = 0
        self.model_flops = 0.0
        self.losses: List[torch.Tensor] = []
        t0 = now()
        while True:
            self._step(record=True)
            if self.epoch_end and now() - t0 >= seconds:
                break
        sync(self.ctx.device)
        self.window_s = now() - t0
        self.attempted = len(self.losses)
        losses = torch.stack(self.losses).cpu() if self.losses else torch.zeros(0)
        self.failed = int((~torch.isfinite(losses)).sum())

    def end_to_end(self) -> dict:
        return {"train_frames_per_s": self.frames / self.window_s}

    def counters(self) -> dict:
        return {"frames": self.frames, "real_frames": self.frames, "stepped_frames": self.stepped,
                "window_s": self.window_s,
                "model_seconds_at_peak": self.model_flops / FP32_FLOPS}

    def release(self) -> None:
        del self.exp, self.feed
        self.losses = []

    # ---------------------------------------------------------------- check
    def _reference_steps(self):
        """The reference's losses, first-gradient norms and change norms over
        the checked steps, from the same weights, trials and masks."""
        ctx, cfgf, ref = self.ctx, self.ctx.config, self.ctx.reference
        from reference.adam import Adam

        e = cfgf["experiment"]
        p = {k: v.clone().requires_grad_(True) for k, v in self.weights.items()}
        opt = Adam(e["lr"], cfgf["adam"]["betas"], cfgf["adam"]["eps"], e["weight_decay"])
        losses, grad = [], None
        for s, (i, masks, _) in enumerate(self.first):
            t = self.trials[i]
            T = min(len(t["labels"]), self.bucket)
            x = np.zeros((self.bucket, e["video_dims"] + cfgf["kinematic_dims"]), np.float32)
            x[:T, :e["video_dims"]] = t["images"][:T]
            x[:T, e["video_dims"]:] = t["kinematics"][:T]
            labels = np.zeros(self.bucket, np.int64)
            labels[:T] = t["labels"][:T]
            tracks = ref.forward(p, cfgf, self.table, torch.from_numpy(x).to(ctx.device), masks)
            loss = ref.loss(tracks, torch.from_numpy(labels).to(ctx.device), T,
                            e["smooth_lambda"])
            names = list(p)
            gs = torch.autograd.grad(loss, [p[n] for n in names], allow_unused=True)
            grads = {n: (g if g is not None else torch.zeros_like(p[n]))
                     for n, g in zip(names, gs)}
            if s == 0:
                grad = norms(grads)
            opt.step(p, grads)
            losses.append(float(loss.detach()))
        change = norms({k: p[k].detach() - self.weights[k] for k in p})
        return losses, grad, change

    def check(self) -> Dict[str, float]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        losses, grad, change = self._reference_steps()
        return training_numbers(self.prog_losses, losses, self.prog_grad, grad,
                                self.prog_change, change)

    def control(self) -> Dict[str, float]:
        """The reference in TF32 in the program's place, against the
        reference in float32."""
        self._inputs()
        t = self.ctx.traffic
        self.bucket = bucket(max(len(x["labels"]) for x in self.trials))
        self.mask_gen = W.generator(self.ctx.seed, self.ctx.device, 3)
        order = np.random.default_rng(self.ctx.seed).permutation(len(self.trials))
        self.first = [(int(order[s]), self._masks(self.bucket), None)
                      for s in range(t["check_steps"])]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        low = self._reference_steps()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        exact = self._reference_steps()
        return training_numbers(low[0], exact[0], low[1], exact[1], low[2], exact[2])


def _powerset(labels: np.ndarray) -> np.ndarray:
    """(T, 7) powerset labels whose last column, the global error flag, is
    ``labels``."""
    e = np.zeros((len(labels), 7), np.int32)
    e[:, -1] = labels
    return e

