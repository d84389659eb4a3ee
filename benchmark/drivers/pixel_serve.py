"""A frame model served from raw frames: each request is one recorded
trial, uint8 224x224 frames and its kinematics, through
``FrameModelServer.predict_trial_from_pixels(PixelFrontEnd, ...)`` (trunk
features in 128-frame chunks, then the frame model), from the call to the
numpy result in hand.

One client in a closed loop: each request is sent when the one before it
has returned, so the window's rate and its tail are the server's own. The
window ends with the first request that returns past ``--seconds``; every
request in it counts, frames and latency. The requests cycle through a
fixed set of ``cycle`` lengths (log-uniform over the mix's ``frames``),
which every seed serves alike in its own order: a golden-ratio interleave,
so that long and short requests alternate evenly, rotated by the seed. The
sampled requests the check re-serves lie in the first cycle, the longest
among them; those a short window does not reach are served after it."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from core import weights as W
from core.spec import load_module
from drivers.common import Context, bucket, log_uniform_lengths, now, permutation, rng, sync
from work import cog as cog_work
from work import resnet50 as rn_work
from work.peaks import BF16_FLOPS, FP32_FLOPS


# the port's kernels this path launches: built together, in parallel, by the
# first run in a checkout (``med_tpu_torch/build/``), loaded by later runs
KERNELS = ("swa_packed_fwd", "tcn_stack_fwd")

# the traffic file's parameters (a nested group by its keys): anything else
# is refused, so that a parameter this driver does not read cannot pass
TRAFFIC = {"frames": ("min", "max"), "cycle": None, "pool_frames": None,
           "check_requests": None}


def build_kernels(device) -> None:
    if device.type == "cuda":
        from med_tpu_torch.ops import cuda_build

        cuda_build.build(KERNELS)


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.attempted = self.failed = 0
        self.rn = load_module("reference", "resnet50")

    def _inputs(self):
        ctx, c, t = self.ctx, self.ctx.config, self.ctx.traffic
        dev, ref, fe = ctx.device, ctx.reference, self.ctx.config["front_end"]
        self.weights = W.make(ref.param_spec(c), W.generator(ctx.seed, dev, 0), dev)
        self.table = ref.prompt_table(c, W.generator(ctx.seed, dev, 1), dev)
        self.trunk = W.make(self.rn.param_spec(fe["stage_sizes"], fe["width"],
                                               fe["residual_bn_scale"], fe["bn_perturbation"]),
                            W.generator(ctx.seed, dev, 4), dev)
        side, n_pool = fe["frame"], t["pool_frames"]
        pool = torch.randint(0, 256, (n_pool, side, side, 3), generator=W.generator(ctx.seed, dev, 5),
                             device=dev, dtype=torch.uint8)
        flat = pool[:min(n_pool, 256)].reshape(-1, 3).to(torch.float32) / 255.0
        self.mean, self.std = flat.mean(dim=0), flat.std(dim=0, unbiased=False)
        with torch.no_grad():   # running statistics measured layer by layer on 32 frames
            calib = (pool[:32].to(torch.float32) / 255.0 - self.mean) / self.std
            self.rn.trunk(self.trunk, calib, fe["stage_sizes"], calibrate=True)
        self.pool = pool.cpu().numpy()
        del pool, flat, calib
        r = rng(ctx.seed, 6)
        self.kin = r.standard_normal((n_pool, c["kinematic_dims"]), dtype=np.float32) * 2.0 + 0.5
        self.stats = {"kinematics": {"mean": self.kin.mean(axis=0),
                                     "std": self.kin.std(axis=0) + 1e-6}}
        n = t["cycle"]
        lengths_sorted = log_uniform_lengths(n, t["frames"]["min"], t["frames"]["max"])
        lengths = [lengths_sorted[i] for i in _order(ctx.seed, n)]
        self.requests = [(L, int(r.integers(0, n_pool - L + 1))) for L in lengths]
        k = min(t["check_requests"], n)
        longest = int(np.argmax(lengths))
        others = [i for i in permutation(ctx.seed, n, 7) if i != longest][:k - 1]
        self.sample = set([longest] + others)

    def setup(self) -> None:
        from med_tpu_torch.config import ExperimentConfig
        from med_tpu_torch.eval.serving import FrameModelServer, PixelFrontEnd
        from med_tpu_torch.models.resnet import ResNet50
        from med_tpu_torch.train.engine import Experiment
        from med_tpu_torch.utils.jax_params import export_jax_params

        ctx, fe = self.ctx, self.ctx.config["front_end"]
        build_kernels(ctx.device)
        self._inputs()
        self.cfg = ExperimentConfig(**{**ctx.config["experiment"], "seed": ctx.seed})
        exp = Experiment(self.cfg, device=ctx.device)
        exp.net.load_state_dict(self.weights, strict=True)
        with torch.no_grad():
            exp.net.model.gest_embed.copy_(self.table)
        tree = exp.checkpoint()
        del exp
        self.server = FrameModelServer(self.cfg, tree, stats=self.stats, device=ctx.device)
        net = ResNet50(fe["stage_sizes"], fe["width"])
        net.load_state_dict({k: v.cpu() for k, v in self.trunk.items()}, strict=True)
        trunk_tree = export_jax_params(net)
        del net
        kw = dict(mean=self.mean.cpu().numpy(), std=self.std.cpu().numpy(),
                  dtype=getattr(torch, fe["dtype"]), stage_sizes=fe["stage_sizes"],
                  width=fe["width"], batch_size=fe["chunk"], device=ctx.device)
        if ctx.control:
            # the control: the program's own int8 path in place of the trunk
            kw.update(int8=True, calib_frames=self.pool[:32])
        self.frontend = PixelFrontEnd(trunk_tree["params"], trunk_tree["batch_stats"], **kw)
        self._features = self.frontend.features
        self.frontend.features = self._tap
        self.keep = False
        self.kept = {}
        self.outputs: Dict[int, tuple] = {}
        for b in sorted({bucket(L) for L, _ in self.requests}):    # every shape served
            self.server.predict_trial_from_pixels(self.frontend, self.pool[:b], self.kin[:b])
        sync(ctx.device)

    def _tap(self, frames):
        out = self._features(frames)
        if self.keep:
            self.kept["features"] = out
        return out

    def window(self, seconds: float) -> None:
        tracer, fe, c = self.ctx.tracer, self.ctx.config["front_end"], self.ctx.config
        trunk_f = rn_work.trunk_forward_flops(fe["stage_sizes"], fe["width"], fe["frame"])
        self.lat: List[float] = []
        self.frames = 0
        self.model_seconds = 0.0
        self.attempted = self.failed = 0
        n = len(self.requests)
        t0 = now()
        while True:
            k = self.attempted
            L, o = self.requests[k % n]
            self.keep = k in self.sample and k not in self.outputs
            self.attempted += 1
            start = now()
            try:
                with tracer.span("bench.request"):
                    preds, probs = self.server.predict_trial_from_pixels(
                        self.frontend, self.pool[o:o + L], self.kin[o:o + L])
            except RuntimeError as err:
                self.ctx.log(f"request {k} ({L} frames) failed: {err}")
                self.failed += 1
            else:
                end = now()
                self.lat.append(end - start)
                self.frames += L
                self.model_seconds += (L * trunk_f / BF16_FLOPS
                                       + cog_work.inference_flops(c, L) / FP32_FLOPS)
                if preds.shape != (L,) or probs.shape != (L,) or not np.isfinite(probs).all():
                    self.failed += 1
                if self.keep:
                    self.outputs[k] = (self.kept.pop("features"), probs)
            if now() - t0 >= seconds:
                break
        self.keep = False
        self.window_s = now() - t0
        for k in sorted(self.sample - set(self.outputs)):
            # a sampled request a short window did not reach: served after it,
            # outside the window's time and counts
            L, o = self.requests[k]
            self.keep = True
            try:
                _, probs = self.server.predict_trial_from_pixels(
                    self.frontend, self.pool[o:o + L], self.kin[o:o + L])
            except RuntimeError as err:
                self.ctx.log(f"sampled request {k} ({L} frames) failed: {err}")
                self.failed += 1
            else:
                self.outputs[k] = (self.kept.pop("features"), probs)
            self.keep = False

    def end_to_end(self) -> dict:
        out = {"serve_frames_per_s": self.frames / self.window_s}
        if self.lat and self.failed == 0:
            out["serve_p95_ms"] = _nearest_rank(self.lat, 0.95) * 1e3
        return out

    def counters(self) -> dict:
        return {"latencies": list(self.lat), "frames": self.frames, "window_s": self.window_s,
                "model_seconds_at_peak": self.model_seconds}

    def release(self) -> None:
        del self.server, self.frontend, self._features

    def check(self) -> Dict[str, float]:
        ctx, c, ref, fe = self.ctx, self.ctx.config, self.ctx.reference, self.ctx.config["front_end"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dtype = getattr(torch, fe["dtype"])
        mean = torch.as_tensor(self.stats["kinematics"]["mean"], device=ctx.device)
        std = torch.as_tensor(self.stats["kinematics"]["std"], device=ctx.device)
        feature_gap = prob_gap = 0.0
        missing = 0
        for k in sorted(self.sample):
            if k not in self.outputs:
                missing += 1
                continue
            L, o = self.requests[k]
            feats, probs = self.outputs[k]
            with torch.no_grad():
                parts = []
                for s in range(0, L, fe["chunk"]):
                    x = torch.from_numpy(self.pool[o + s:o + min(L, s + fe["chunk"])]).to(ctx.device)
                    x = (x.to(torch.float32) / 255.0 - self.mean) / self.std
                    parts.append(self.rn.trunk(self.trunk, x, fe["stage_sizes"], dtype=dtype))
                f_ref = torch.cat(parts)
                got = torch.from_numpy(feats).to(ctx.device)
                feature_gap = max(feature_gap, float((got - f_ref).norm() / f_ref.norm()))
                kin = (torch.from_numpy(self.kin[o:o + L]).to(ctx.device) - mean) / std
                Tp = bucket(L)
                x = torch.zeros((Tp, f_ref.shape[1] + kin.shape[1]), device=ctx.device)
                x[:L] = torch.cat([f_ref, kin], dim=1)
                p_ref = ref.probabilities(self.weights, c, self.table, x)[:L]
                prob_gap = max(prob_gap, float((torch.from_numpy(probs).to(ctx.device)
                                                - p_ref).abs().max()))
        numbers = {"feature_gap": feature_gap, "prob_gap": prob_gap}
        if missing:
            numbers = {k: float("inf") for k in numbers}
        return numbers


def _order(seed: int, n: int) -> List[int]:
    """The order of n sorted lengths: each index's golden-ratio fraction
    (j * 0.618... mod 1) ranked, so that long and short requests alternate
    evenly, rotated by a seeded offset."""
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    base = sorted(range(n), key=lambda j: (j * phi) % 1.0)
    shift = int(rng(seed, 8).integers(0, n))
    return base[shift:] + base[:shift]


def _nearest_rank(values: List[float], q: float) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
