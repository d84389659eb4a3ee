"""The backbone fine-tune as ``cli/resnet_finetune.py`` runs an epoch: the
fold's frames held as float32 on the host, batches from ``_batches`` in
``default_rng(seed + epoch)``'s order (the last one padded and masked),
the CLI's ``draw_augment`` per batch from a generator seeded by the seed,
and ``train_step`` (augment on the card, the classifier with train-mode
BatchNorm, masked BCE, Adam). The window runs epoch after epoch and syncs
once, at its end.

Set-up's first ``check_steps`` steps go through the same call and feed,
and keep the draws the program made for them: the reference follows them
from the same weights, frames and draws."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from core import weights as W
from core.compare import norms, training_numbers
from drivers.common import Context, first_moment_grads, now, rng, sync
from work import resnet50 as rn_work
from work.peaks import FP32_FLOPS


# the traffic file's parameters: anything else is refused, so that a
# parameter this driver does not read cannot pass
TRAFFIC = {"frames": None, "error_share": None, "check_steps": None}


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.attempted = self.failed = 0

    def _inputs(self):
        ctx, c, t = self.ctx, self.ctx.config, self.ctx.traffic
        dev, ref = ctx.device, ctx.reference
        spec = ref.param_spec(c["stage_sizes"], c["width"], c["residual_bn_scale"],
                              c["bn_perturbation"], prefix="trunk.",
                              head=(c["head_hidden"], c["classes"]))
        self.weights = W.make(spec, W.generator(ctx.seed, dev, 0), dev)
        n, side = t["frames"], c["frame"]
        frames = torch.randint(0, 256, (n, side, side, 3), generator=W.generator(ctx.seed, dev, 1),
                               device=dev, dtype=torch.uint8).to(torch.float32)
        flat = frames.reshape(-1, 3) / 255.0
        self.mean = flat.mean(dim=0)
        self.std = flat.std(dim=0, unbiased=False) + 1e-6
        self.images = frames.cpu().numpy()
        del frames, flat
        self.labels = (rng(ctx.seed, 2).random(n) < t["error_share"]).astype(np.float32)
        self.draw_gen = torch.Generator().manual_seed(int(ctx.seed) % (2 ** 63))

    def setup(self) -> None:
        from med_tpu_torch.cli.resnet_finetune import _batches, draw_augment, train_step
        from med_tpu_torch.models.resnet import ResNetClassifier

        ctx, c = self.ctx, self.ctx.config
        # the CLI's settings: float32 without TF32, cuDNN's deterministic
        # algorithms (cli/resnet_finetune.py::main)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        self.aug = _augment_module()
        self._inputs()
        self.model = ResNetClassifier(c["stage_sizes"], c["width"], c["classes"])
        self.model.load_state_dict(self.weights, strict=True)
        self.model.to(ctx.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=c["lr"],
                                          betas=tuple(c["adam"]["betas"]), eps=c["adam"]["eps"])
        self._train_step, self._batches, self._draw = train_step, _batches, draw_augment
        self.feed = self._feed()
        self.first = []
        for s in range(ctx.traffic["check_steps"]):
            batch, loss = self._step(record=False)
            self.first.append((batch, loss))
            if s == 0:
                named = list(self.model.named_parameters())
                self.prog_grad = norms(first_moment_grads(self.optimizer, named))
        state = dict(self.model.named_parameters())
        state.update({k: v for k, v in self.model.named_buffers()})
        self.prog_change = norms({k: v.detach() - self.weights[k] for k, v in state.items()})
        self.prog_losses = [float(l) for _, l in self.first]
        sync(ctx.device)

    def _feed(self):
        c, seed, a = self.ctx.config, self.ctx.seed, self.ctx.config["augment"]
        epoch = 0
        while True:
            for imgs, labels, mask in self._batches(self.images, self.labels, c["batch_size"],
                                                    True, seed + epoch):
                yield imgs, labels, mask, self._draw(len(imgs), self.draw_gen, a["crop_pad"],
                                                     a["max_degrees"], a["brightness"],
                                                     a["contrast"])
            epoch += 1

    def _step(self, record: bool):
        tracer = self.ctx.tracer
        with tracer.span("bench.feed"):
            batch = next(self.feed)
        imgs, labels, mask, draws = batch
        with tracer.span("bench.step"):
            loss = self._train_step(self.model, self.optimizer, imgs, labels, mask,
                                    (self.mean, self.std), False, draws)
        if record:
            real = int(mask.sum())
            self.frames += real
            self.losses.append(loss)
        return batch, loss

    def window(self, seconds: float) -> None:
        self.frames = 0
        self.attempted = self.failed = 0
        self.losses: List[torch.Tensor] = []
        t0 = now()
        while now() - t0 < seconds:
            self._step(record=True)
        sync(self.ctx.device)
        self.window_s = now() - t0
        self.attempted = len(self.losses)
        losses = torch.stack(self.losses).cpu() if self.losses else torch.zeros(0)
        self.failed = int((~torch.isfinite(losses)).sum())

    def end_to_end(self) -> dict:
        return {"train_frames_per_s": self.frames / self.window_s}

    def counters(self) -> dict:
        c = self.ctx.config
        per = rn_work.train_flops(c["stage_sizes"], c["width"], c["frame"], c["head_hidden"],
                                  c["classes"])
        return {"frames": self.frames, "window_s": self.window_s,
                "model_seconds_at_peak": self.frames * per / FP32_FLOPS}

    def release(self) -> None:
        del self.model, self.optimizer, self.feed
        self.losses = []

    def _reference_steps(self):
        from reference.adam import Adam

        ctx, c, ref = self.ctx, self.ctx.config, self.ctx.reference
        aug = self.aug
        p = {k: v.clone() for k, v in self.weights.items()}
        learn = [k for k in p if not k.endswith(("running_mean", "running_var"))]
        for k in learn:
            p[k].requires_grad_(True)
        opt = Adam(c["lr"], c["adam"]["betas"], c["adam"]["eps"], c["adam"]["weight_decay"])
        losses, grad = [], None
        for s, ((imgs, labels, mask, draws), _) in enumerate(self.first):
            x = aug.augment(torch.from_numpy(imgs).to(ctx.device), draws, self.mean, self.std,
                            c["augment"]["crop_pad"])
            state = {}
            logits = ref.classifier(p, x, c["stage_sizes"], train=True, state=state)
            loss = ref.bce_masked(logits, torch.from_numpy(labels).to(ctx.device),
                                  torch.from_numpy(mask).to(ctx.device))
            gs = torch.autograd.grad(loss, [p[k] for k in learn])
            grads = dict(zip(learn, gs))
            if s == 0:
                grad = norms(grads)
            opt.step({k: p[k] for k in learn}, grads)
            for k, v in state.items():
                p[k] = v
            losses.append(float(loss.detach()))
        change = norms({k: p[k].detach() - self.weights[k] for k in p})
        return losses, grad, change

    def _numbers(self, program, reference):
        stats = [k for k in reference[2] if k.endswith(("running_mean", "running_var"))]
        return training_numbers(program[0], reference[0], program[1], reference[1],
                                program[2], reference[2], state_leaves=stats)

    def check(self) -> Dict[str, float]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = self._reference_steps()
        return self._numbers((self.prog_losses, self.prog_grad, self.prog_change), ref)

    def control(self) -> Dict[str, float]:
        """The reference in TF32 in the program's place, against the
        reference in float32, on the program's first batches and draws."""
        from med_tpu_torch.cli.resnet_finetune import _batches, draw_augment

        ctx, c = self.ctx, self.ctx.config
        torch.backends.cudnn.deterministic = True
        self.aug = _augment_module()
        self._inputs()
        self._batches, self._draw = _batches, draw_augment
        feed = self._feed()
        self.first = [(next(feed), None) for _ in range(ctx.traffic["check_steps"])]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        low = self._reference_steps()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self._numbers(low, self._reference_steps())


def _augment_module():
    from core import spec

    return spec.load_module("reference", "augment")
