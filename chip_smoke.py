"""Smoke run of the PyTorch port (med_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # what the acceptance run does
    python3 chip_smoke.py --profile   # also: device time by kernel, per request

Phases, one line or more each; any failed check raises, so the exit code is
non-zero and the last line is not printed:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: every CUDA kernel of ``med_tpu_torch/csrc``, one ``nvcc`` each,
   started together;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes, with its time, the plain version's, the
   card's bound for the same work and, for the attention, the time of
   ``scaled_dot_product_attention`` with a band mask as a yardstick (the
   port never calls it);
4. serving: a full-width COG (the default of `med_tpu.cli.train_frame`,
   2048-d video features + 26-d kinematics) with weights drawn from a seed,
   saved in the JAX package's checkpoint layout, loaded back and served
   through ``FrameModelServer``: 3 requests (T = 300, 1000, 4096), counting
   kernel launches; one request again on the CPU for agreement; one request
   through the FeatureExtractor variant (video_dims=32);
5. a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Runs from the repository root; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks: fp32 outside the tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
REQUEST_FRAMES = (300, 1000, 4096)
CPU_CHECK_FRAMES = 1000
KERNEL_FRAMES = (1024, 4096)      # shapes timed in phase 3; the JSON line uses the last
# (rtol, atol) of each kernel against its plain version: float32 summed in
# another order; the TCN activations reach O(10) over 41 layers
TOL = {"swa_packed_fwd": (1e-4, 1e-5), "tcn_layer/multistack": (1e-4, 1e-4),
       "tcn_layer/stack": (1e-4, 1e-4)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls
    (CUDA events, after a warm-up; inputs stay in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere; returns the
    max absolute error."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise RuntimeError(f"{name}: max abs error {err.max().item():.3e} over "
                           f"rtol {rtol}, atol {atol}")
    return err.max().item()


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    from med_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"[build] {len(cuda_build.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s ({len(logs)} compiled, "
        f"{len(cuda_build.KERNELS) - len(logs)} cached)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _attention_case(T: int, gen: torch.Generator):
    """COG's attention call at T frames: 8 heads, d=8, 15 queries a frame,
    window 30, over the T + 29 frames of the left-padded visual sequence."""
    from med_tpu_torch.ops.attention import (
        sliding_window_attention_packed, sliding_window_attention_packed_plain)

    H, d, m, W = 8, 8, 15, 30
    Tv = T + W - 1
    N = Tv * m
    q, k, v = (torch.randn(s, generator=gen).cuda()
               for s in ((H, d, N), (H, d, Tv), (H, d, Tv)))
    out, stats = sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    p_out, p_stats = sliding_window_attention_packed_plain(q, k, v, W, m)
    tol = TOL["swa_packed_fwd"]
    err = max(check_close(f"attention T={T} out", out, p_out, *tol),
              check_close(f"attention T={T} stats", stats, p_stats, *tol))

    # yardstick: one library call computing the same function
    qs = q.permute(0, 2, 1)[None]
    ks = F.pad(k, (W - 1, 0)).permute(0, 2, 1)[None]
    vs = F.pad(v, (W - 1, 0)).permute(0, 2, 1)[None]
    frame = torch.arange(N, device="cuda")[:, None] // m
    col = torch.arange(Tv + W - 1, device="cuda")[None, :]
    band = (col >= frame) & (col < frame + W)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band)  # noqa: E731
    # sanity only: the library may take other summation paths
    check_close(f"attention T={T} library yardstick", lib()[0].permute(0, 2, 1), out,
                5e-3, 5e-3)

    nbytes = 4 * (2 * H * d * N + 2 * H * d * Tv + 2 * H * N)
    flops = H * N * W * (2 * d + 2 * d + 4)
    b_ms, b_by = bound(nbytes, flops)
    return dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: sliding_window_attention_packed(q, k, v, W, m), 50),
        plain_ms=cuda_ms(lambda: sliding_window_attention_packed_plain(q, k, v, W, m), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1))


def _stage_weights(gen: torch.Generator, layers, C: int = 64):
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2 * b - b).cuda()
    return [(u((L, 3, C, C), 3 * C), u((L, C), 3 * C), u((L, C, C), C), u((L, C), C))
            for L in layers]


def _tcn_flops_bytes(T: int, C: int, layers, n_in: int, n_out: int):
    weights = sum(L * (4 * C * C + 2 * C) for L in layers)
    flops = sum(L * (8 * T * C * C + 4 * T * C) for L in layers)
    return 4 * (weights + (n_in + n_out) * T * C), flops


def _multistack_case(T: int, gen: torch.Generator):
    """COG's slow path at T frames: 11 + 3x10 layers at C=64, causal."""
    from med_tpu_torch.ops.tcn_fused import (
        dilated_residual_multistack_stages, dilated_stack_xla)

    layers = (11, 10, 10, 10)
    ws = _stage_weights(gen, layers)
    x = torch.randn((T, 64), generator=gen).cuda()
    run = lambda: dilated_residual_multistack_stages(x, ws, 11, 10)  # noqa: E731

    def plain():
        h, outs = x, []
        for w in ws:
            h = dilated_stack_xla(h, *w)
            outs.append(h)
        return torch.stack(outs)

    err = check_close(f"multistack T={T}", run(), plain(), *TOL["tcn_layer/multistack"])
    nbytes, flops = _tcn_flops_bytes(T, 64, layers, 1, len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _fast_stacks_case(T: int, gen: torch.Generator):
    """COG's fast path stacks at T // 16 frames: one of 11 layers and three of
    10, each its own call."""
    from med_tpu_torch.ops.tcn_fused import dilated_residual_stack, dilated_stack_xla

    layers = (11, 10, 10, 10)
    ws = _stage_weights(gen, layers)
    Tf = T // 16
    xs = [torch.randn((Tf, 64), generator=gen).cuda() for _ in layers]
    run = lambda: [dilated_residual_stack(x, *w) for x, w in zip(xs, ws)]  # noqa: E731
    plain = lambda: [dilated_stack_xla(x, *w) for x, w in zip(xs, ws)]  # noqa: E731
    err = max(check_close(f"fast stack {i} T={Tf}", g, w, *TOL["tcn_layer/stack"])
              for i, (g, w) in enumerate(zip(run(), plain())))
    nbytes, flops = _tcn_flops_bytes(Tf, 64, layers, len(layers), len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase_kernels():
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for T in KERNEL_FRAMES:
        for name, case in (("swa_packed_fwd", _attention_case),
                           ("tcn_layer/multistack", _multistack_case),
                           ("tcn_layer/stack", _fast_stacks_case)):
            r = case(T, gen)
            results[name] = r
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            rtol, atol = TOL[name]
            log(f"[kernels] {name} at T={T}: max_abs_err {r['max_abs_err']:.3e} "
                f"(tol rtol {rtol}, atol {atol}), "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms")
    return results


def _serving_config(video_dims: int):
    from med_tpu_torch.config import ExperimentConfig

    # COG as med_tpu.cli.train_frame configures it: default depths and widths
    return ExperimentConfig(model_name="COG", dataset_type="frame",
                            data_type="multimodal", video_dims=video_dims,
                            out_features=2)


def _seeded_checkpoint(cfg, directory: str):
    """Seeded weights for ``cfg``, written with the port's save_checkpoint in
    the JAX package's layout and loaded back as a served run would be."""
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.train.checkpoint import load_best_checkpoint, save_checkpoint
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    exp = Experiment(cfg, device="cpu")
    init_weights(exp.net, torch.Generator().manual_seed(SEED))
    tree = export_jax_params(exp.net)
    save_checkpoint(str(Path(directory) / "best_model_COG_1Out.npz"),
                    tree["params"], constants=tree["constants"])
    return load_best_checkpoint(directory, "COG", "1Out")


def _request(rng: np.random.Generator, T: int):
    return (rng.standard_normal((T, 2048), dtype=np.float32),
            rng.standard_normal((T, 26), dtype=np.float32))


def _check_served(name: str, preds, probs, T: int) -> None:
    if preds.shape != (T,) or probs.shape != (T,):
        raise RuntimeError(f"{name}: shapes {preds.shape}, {probs.shape} != ({T},)")
    if not np.isfinite(probs).all() or probs.min() < 0 or probs.max() > 1:
        raise RuntimeError(f"{name}: probabilities outside [0, 1]")
    if not set(np.unique(preds)) <= {0, 1}:
        raise RuntimeError(f"{name}: predictions outside {{0, 1}}")
    disagree = preds != (probs > 0.5)
    if bool((disagree & (np.abs(probs - 0.5) > 1e-6)).any()):
        raise RuntimeError(f"{name}: predictions disagree with probabilities")


def phase_serving(profile: bool):
    from med_tpu_torch import ops
    from med_tpu_torch.eval.serving import FrameModelServer

    rng = np.random.default_rng(SEED)
    stats = {"kinematics": {"mean": rng.standard_normal(26, dtype=np.float32),
                            "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}}
    cfg = _serving_config(2048)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = _seeded_checkpoint(cfg, tmp)
    server = FrameModelServer(cfg, ckpt, stats=stats)       # on the card
    if server.exp.device.type != "cuda":
        raise RuntimeError(f"server runs on {server.exp.device}, not the card")
    requests = {T: _request(rng, T) for T in REQUEST_FRAMES}
    server.predict_trial(*_request(rng, 256))              # warm-up, not counted

    ops.reset_launch_counts()
    served = {}
    for T, req in requests.items():
        t0 = time.perf_counter()
        served[T] = server.predict_trial(*req)
        ms = (time.perf_counter() - t0) * 1e3
        _check_served(f"request T={T}", *served[T], T)
        log(f"[serving] request T={T}: {ms:.2f} ms (first pass)")
    launches = ops.launch_counts()
    n = len(REQUEST_FRAMES)
    want = {"sliding_window_attention_packed": 2 * n,
            "dilated_residual_multistack_stages": 41 * n,
            "dilated_residual_stack": 41 * n}
    log(f"[serving] launches over {n} requests: {launches} (expected {want})")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")

    for T, req in requests.items():
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            server.predict_trial(*req)
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        log(f"[serving] request T={T}: median {med:.2f} ms of 5 "
            f"(min {min(times):.2f}, max {max(times):.2f}), "
            f"{T / med * 1e3:.0f} frames/s")

    cpu = FrameModelServer(cfg, ckpt, stats=stats, device="cpu")
    c_preds, c_probs = cpu.predict_trial(*requests[CPU_CHECK_FRAMES])
    g_preds, g_probs = served[CPU_CHECK_FRAMES]
    err = float(np.abs(g_probs - c_probs).max())
    if err > 1e-4:
        raise RuntimeError(f"card vs CPU probabilities differ by {err:.3e} > 1e-4")
    # a prediction may flip only where the probability sits within the
    # tolerance of the 0.5 decision threshold
    flips = g_preds != c_preds
    if bool((flips & (np.abs(c_probs - 0.5) > 1e-4)).any()):
        raise RuntimeError("card vs CPU predictions differ away from the threshold")
    log(f"[serving] card vs CPU at T={CPU_CHECK_FRAMES}: max prob diff {err:.3e} "
        f"(tol 1e-4), {int(flips.sum())} of {CPU_CHECK_FRAMES} predictions differ")

    fe_cfg = _serving_config(32)
    with tempfile.TemporaryDirectory() as tmp:
        fe_server = FrameModelServer(fe_cfg, _seeded_checkpoint(fe_cfg, tmp), stats=stats)
    _check_served("FeatureExtractor variant", *fe_server.predict_trial(*requests[CPU_CHECK_FRAMES]),
                  CPU_CHECK_FRAMES)
    log(f"[serving] FeatureExtractor variant (video_dims=32): request "
        f"T={CPU_CHECK_FRAMES} ok")

    if profile:
        for req in requests.values():
            _profile_request(server, req)
    return launches


def _profile_request(server, req) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    server.predict_trial(*req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.predict_trial(*req)
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] T={len(req[0])}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "med_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    # fp32 as in the JAX package: no TF32 in matmuls or cuDNN on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_serving("--profile" in argv)

    sources = {"swa_packed_fwd": ("med_tpu_torch/csrc/swa_packed_fwd.cu",
                                  "med_tpu/ops/attention.py:390",
                                  "sliding_window_attention_packed"),
               "tcn_layer/multistack": ("med_tpu_torch/csrc/tcn_layer.cu",
                                        "med_tpu/ops/tcn_fused.py:750",
                                        "dilated_residual_multistack_stages"),
               "tcn_layer/stack": ("med_tpu_torch/csrc/tcn_layer.cu",
                                   "med_tpu/ops/tcn_fused.py:91",
                                   "dilated_residual_stack")}
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[wrapper], **kernels[name]}
            for name, (src, rep, wrapper) in sources.items()]
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
