"""Smoke run of the PyTorch port (med_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # what the acceptance run does
    python3 chip_smoke.py --profile   # also: device time by kernel, per
                                      # request and per train step

Phases, one line or more each; any failed check raises, so the exit code is
non-zero and the last line is not printed:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: every CUDA kernel of ``med_tpu_torch/csrc``, one ``nvcc`` each,
   started together;
3. kernels: each forward kernel (K1 attention, K2 TCN layer) and each
   backward kernel (K3 attention, K4 slow-path TCN, K5 fast-path TCN)
   against its plain PyTorch version on the card at the COG path's shapes,
   with its time, the plain version's, the card's bound for the same work
   and, for the attention, the time of ``scaled_dot_product_attention``
   (forward; autograd backward for K3) with a band mask as a yardstick (the
   port never calls it);
4. serving: a full-width COG (the default of `med_tpu.cli.train_frame`,
   2048-d video features + 26-d kinematics) with weights drawn from a seed,
   saved in the JAX package's checkpoint layout, loaded back and served
   through ``FrameModelServer``: 3 requests (T = 300, 1000, 4096), counting
   kernel launches; one request again on the CPU for agreement; one request
   through the FeatureExtractor variant (video_dims=32);
5. training: the same COG trained by ``train_frame_fold`` with the
   optimiser of `med_tpu.cli.train_frame` (lr 5e-4, no weight decay, no
   schedule) for 2 epochs
   on 4 synthetic trials (T = 300, 1000, 2000, 4096) with a learnable label
   and 2 test trials, counting kernel launches against the design; then
   step time per T, peak device memory, and one train step at T=300 on the
   card and on the CPU with the same dropout masks: the loss compared, and
   every gradient leaf with the card's encoder FFN relu pattern pinned to
   the CPU's (the flips counted);
6. a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Runs from the repository root; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
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
TRAIN_FRAMES = (300, 1000, 2000, 4096)
TEST_FRAMES = (500, 1500)
CPU_TRAIN_FRAMES = 300
# (rtol, atol) of each kernel against its plain version: float32 summed in
# another order; the TCN activations reach O(10) over 41 layers. For the
# backward kernels atol is that factor times the tensor's largest |value|:
# weight gradients are sums over T taken in another order.
TOL = {"swa_packed_fwd": (1e-4, 1e-5), "tcn_layer/multistack": (1e-4, 1e-4),
       "tcn_layer/stack": (1e-4, 1e-4), "swa_packed_bwd": (1e-4, 1e-5),
       "tcn_layer_bwd/multistack": (1e-4, 1e-5), "tcn_layer_bwd/stack": (1e-4, 1e-5)}
# card vs CPU train step: loss rtol; per gradient leaf rtol, and atol as a
# fraction of that leaf's own largest |value|. float32 summed in another
# order flips a few relu derivatives of the encoder FFNs (pre-activations
# within rounding of 0), and each flip moves one token's term of Dense_0's
# weight gradient and of every gradient upstream of it. So the leaves are
# held to this tolerance with the card's FFN relu pattern pinned to the
# CPU's; the run without the pin is printed beside it, with the flips and
# how close to 0 their pre-activations were (at most FLIP_PRE of the
# call's largest |pre-activation|).
TRAIN_TOL = {"loss": 1e-5, "grad_rtol": 1e-4, "grad_atol": 1e-5}
FLIP_PRE = 1e-4


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


def check_grads(name: str, got, want, rtol: float, atol_frac: float) -> float:
    """check_close with atol = atol_frac * max|want| over all of ``want``."""
    scale = max(max(w.abs().max().item() for w in want), 1e-30)
    return max(check_close(f"{name} [{i}]", g, w, rtol, atol_frac * scale)
               for i, (g, w) in enumerate(zip(got, want)))


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
        run=lambda: sliding_window_attention_packed(q, k, v, W, m), max_abs_err=err,
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
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
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
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _attention_bwd_case(T: int, gen: torch.Generator):
    """K3 at COG's attention shapes (see _attention_case), with a cotangent
    on every query."""
    from med_tpu_torch.ops.attention import (
        sliding_window_attention_packed, sliding_window_attention_packed_bwd,
        sliding_window_attention_packed_bwd_plain)

    H, d, m, W = 8, 8, 15, 30
    Tv = T + W - 1
    N = Tv * m
    q, k, v, g = (torch.randn(s, generator=gen).cuda()
                  for s in ((H, d, N), (H, d, Tv), (H, d, Tv), (H, d, N)))
    out, stats = sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    run = lambda: sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)  # noqa: E731
    plain = lambda: sliding_window_attention_packed_bwd_plain(  # noqa: E731
        q, k, v, g, out, stats, W, m)
    rtol, atol = TOL["swa_packed_bwd"]
    err = max(check_grads(f"attention bwd T={T} {n}", [a], [b], rtol, atol)
              for n, a, b in zip(("dq", "dk", "dv"), run(), plain()))

    # yardstick: autograd backward of one library call, same function
    qs = q.permute(0, 2, 1)[None].detach().requires_grad_()
    ks = F.pad(k, (W - 1, 0)).permute(0, 2, 1)[None].detach().requires_grad_()
    vs = F.pad(v, (W - 1, 0)).permute(0, 2, 1)[None].detach().requires_grad_()
    frame = torch.arange(N, device="cuda")[:, None] // m
    col = torch.arange(Tv + W - 1, device="cuda")[None, :]
    band = (col >= frame) & (col < frame + W)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band)
    gs = g.permute(0, 2, 1)[None]
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), gs, retain_graph=True)  # noqa: E731
    check_close(f"attention bwd T={T} library yardstick dq",
                lib()[0][0].permute(0, 2, 1), run()[0], 5e-3, 5e-3)

    # bytes: q, g, out and stats read, dq written (per query); k, v read,
    # dk, dv written (per key). Operations per (query, key) pair: score,
    # g.v, dq, dk, dv (2d each) and ~4 for a, ds
    nbytes = 4 * (4 * H * d * N + 2 * H * N + 4 * H * d * Tv)
    flops = H * N * W * (10 * d + 4) + 2 * H * d * N
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1))


def _tcn_bwd_flops_bytes(T: int, C: int, layers, n_g: int, n_dx: int):
    """Per layer: 8 products of (T, C) by (C, C) (dW1, dy, 3 dW3, 3 dh);
    bytes: n_g cotangents g, saved h and y, the uint8 masks and the weights
    read, n_dx input gradients dx and the weight gradients written."""
    Lt = sum(layers)
    flops = Lt * (16 * T * C * C + 8 * T * C)
    nbytes = (4 * (n_g * T * C + 2 * Lt * T * C + Lt * 4 * C * C)
              + Lt * T * C + 4 * (n_dx * T * C + Lt * (4 * C * C + 2 * C)))
    return nbytes, flops


def _multistack_bwd_case(T: int, gen: torch.Generator):
    """K4: the slow path's backward at T frames, 11 + 3x10 layers at C=64,
    causal, with dropout masks and a cotangent on every stage output."""
    from med_tpu_torch.ops import tcn_fused as tcn

    layers = (11, 10, 10, 10)
    ws = _stage_weights(gen, layers)
    masks = [torch.randint(0, 2, (L, T, 64), generator=gen, dtype=torch.uint8).cuda()
             for L in layers]
    x = torch.randn((T, 64), generator=gen).cuda()
    g = torch.randn((len(layers), T, 64), generator=gen).cuda()
    _, h_saved, y_saved = tcn._stages_fwd(x, ws, masks, True,
                                          tcn.dilated_residual_multistack_stages, save=True)
    run = lambda: tcn.dilated_residual_multistack_stages_bwd(  # noqa: E731
        g, h_saved, y_saved, ws, 11, 10, masks=masks)
    plain = lambda: tcn._stages_bwd_plain(  # noqa: E731
        g, h_saved, y_saved, [(w[0], w[2]) for w in ws], masks, True)
    rtol, atol = TOL["tcn_layer_bwd/multistack"]
    (dx, dws), (p_dx, p_dws) = run(), plain()
    err = check_grads(f"multistack bwd T={T} dx", [dx], [p_dx], rtol, atol)
    for s, (got, want) in enumerate(zip(dws, p_dws)):
        for n, a, b in zip(("dw3", "db3", "dw1", "db1"), got, want):
            err = max(err, check_grads(f"multistack bwd T={T} stage {s} {n}",
                                       [a], [b], rtol, atol))
    nbytes, flops = _tcn_bwd_flops_bytes(T, 64, layers, len(layers), 1)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _fast_stacks_bwd_case(T: int, gen: torch.Generator):
    """K5: the fast path's four stack backwards at T // 16 frames, each its
    own call, with dropout masks."""
    from med_tpu_torch.ops import tcn_fused as tcn

    layers = (11, 10, 10, 10)
    ws = _stage_weights(gen, layers)
    Tf = T // 16
    cases = []
    for L, w in zip(layers, ws):
        mask = torch.randint(0, 2, (L, Tf, 64), generator=gen, dtype=torch.uint8).cuda()
        x = torch.randn((Tf, 64), generator=gen).cuda()
        g = torch.randn((Tf, 64), generator=gen).cuda()
        _, h, y = tcn._stages_fwd(x, [w], [mask], True, tcn.dilated_residual_stack,
                                  save=True)
        cases.append((g, h, y, w, mask))
    run = lambda: [tcn.dilated_residual_stack_bwd(  # noqa: E731
        g, h, y, w[0], w[2], mask=mk) for g, h, y, w, mk in cases]
    plain = lambda: [tcn._stages_bwd_plain(  # noqa: E731
        g[None], h, y, [(w[0], w[2])], [mk], True) for g, h, y, w, mk in cases]
    rtol, atol = TOL["tcn_layer_bwd/stack"]
    err = 0.0
    for i, (got, (p_dx, (p_dw,))) in enumerate(zip(run(), plain())):
        for n, a, b in zip(("dx", "dw3", "db3", "dw1", "db1"), got, (p_dx, *p_dw)):
            err = max(err, check_grads(f"fast stack {i} bwd T={Tf} {n}", [a], [b],
                                       rtol, atol))
    nbytes, flops = _tcn_bwd_flops_bytes(Tf, 64, layers, len(layers), len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


KERNEL_CASES = (("swa_packed_fwd", _attention_case),
                ("tcn_layer/multistack", _multistack_case),
                ("tcn_layer/stack", _fast_stacks_case),
                ("swa_packed_bwd", _attention_bwd_case),
                ("tcn_layer_bwd/multistack", _multistack_bwd_case),
                ("tcn_layer_bwd/stack", _fast_stacks_bwd_case))


def phase_kernels(profile: bool):
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for T in KERNEL_FRAMES:
        for name, case in KERNEL_CASES:
            r = case(T, gen)
            if profile and T == KERNEL_FRAMES[-1]:
                _profile(f"{name} T={T}", r.pop("run"))
            r.pop("run", None)
            results[name] = r
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            rtol, atol = TOL[name]
            atol_txt = f"{atol} x max|want|" if "bwd" in name else f"{atol}"
            log(f"[kernels] {name} at T={T}: max_abs_err {r['max_abs_err']:.3e} "
                f"(tol rtol {rtol}, atol {atol_txt}), "
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


def forward_launches(n: int):
    """Forward launches of n COG passes: 2 attention layers, 41 slow-path
    and 41 fast-path TCN layers."""
    return {"sliding_window_attention_packed": 2 * n,
            "dilated_residual_multistack_stages": 41 * n,
            "dilated_residual_stack": 41 * n}


def backward_launches(n: int):
    """Backward launches of n COG train steps: one K3 per attention layer;
    two per TCN layer plus one weight-gradient reduction per call (the slow
    path is one call of 41 layers, the fast path four of 11 + 3x10)."""
    return {"sliding_window_attention_packed_bwd": 2 * n,
            "dilated_residual_multistack_stages_bwd": (2 * 41 + 1) * n,
            "dilated_residual_stack_bwd": (2 * 41 + 4) * n}


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
    want = {**forward_launches(n), "sliding_window_attention_packed_bwd": 0,
            "dilated_residual_multistack_stages_bwd": 0, "dilated_residual_stack_bwd": 0}
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
            _profile(f"request T={len(req[0])}", lambda: server.predict_trial(*req))
    return launches


def _profile(label: str, fn) -> None:
    """Device time by kernel of one call of ``fn`` (after one warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # user annotations (Optimizer.step, ...) are host ranges mirrored onto
    # the device's timeline: they are not device work
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")


def _train_config():
    # COG as med_tpu.cli.train_frame trains it: its optimiser settings, the
    # seed and smoothing weight of med_tpu.config; each trial in its own
    # 256-frame bucket (fused_epoch off), so step times follow T
    return _serving_config(2048).replace(
        error_type="global", lr=5e-4, weight_decay=0.0, lr_scheduler=False,
        seed=42, smooth_lambda=0.15, n_epochs=2, fused_epoch=False)


def _trial(rng: np.random.Generator, T: int, name: str):
    """A synthetic trial whose error label (runs of 20-60 frames) shifts
    five kinematic channels, so the loss can fall."""
    from med_tpu_torch.data.datasets import FrameTrial
    from med_tpu_torch.data.labels import skill_one_hot

    labels = np.zeros(T, np.int32)
    t = 0
    while t < T:
        run = int(rng.integers(20, 60))
        labels[t:t + run] = int(rng.integers(0, 2))
        t += run
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = labels
    kin = rng.standard_normal((T, 26), dtype=np.float32)
    kin[:, :5] += labels[:, None] * 2.0
    return FrameTrial(name=name, images=rng.standard_normal((T, 2048), dtype=np.float32),
                      kinematics=kin, g_labels=rng.integers(0, 15, T),
                      e_powerset=e, skill=skill_one_hot(name, T))


def _step_gradients(cfg, batch, masks, device: str):
    """Loss and every gradient leaf (JAX tree paths) of one train step."""
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    exp = Experiment(cfg, device=device)
    exp.init_weights(SEED)
    dev_masks = {n: {k: v.to(exp.device) for k, v in d.items()} for n, d in masks.items()}
    loss, _ = exp.compute_gradients(batch, masks=dev_masks)
    tree = export_jax_params(exp.net, grads=True)["params"]
    return loss.item(), {k: torch.from_numpy(v) for k, v in _flat(tree).items()}


@contextlib.contextmanager
def _ffn_relu(record=None, pin=None, flips=None):
    """Within the block, every encoder FFN call (COG's _FFNT, in call order)
    appends its relu pattern (pre-activation > 0) to ``record``, or, given
    ``pin``, takes its relu derivative from the pattern of the same call in
    another run and appends (flipped entries, their largest |pre-activation|
    over the call's largest) to ``flips``."""
    from med_tpu_torch.models import cog

    plain = cog._FFNT.forward
    calls = iter(range(1 << 30))

    def forward(self, x):
        pre = self.Dense_0.weight @ x
        if pin is None:
            record.append((pre > 0).cpu())
            y = torch.relu(pre)
        else:
            keep = pin[next(calls)].to(pre.device)
            flip = keep != (pre > 0)
            near = pre[flip].abs().max().item() if bool(flip.any()) else 0.0
            flips.append((int(flip.sum()), near / pre.abs().max().item()))
            y = pre * keep.to(pre.dtype)
        return cog._ln0(self.Dense_1.weight @ y + x)

    cog._FFNT.forward = forward
    try:
        yield
    finally:
        cog._FFNT.forward = plain


def _card_vs_cpu_step(cfg, trial) -> None:
    """One train step at full width on the card and on the CPU, same weights
    and dropout masks: the loss must agree, and every gradient leaf once the
    card's encoder FFN relu pattern is pinned to the CPU's (TRAIN_TOL)."""
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.train.engine import Experiment

    batch = frame_batch(trial, cfg)
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        batch["images"].shape[1], torch.Generator().manual_seed(SEED))
    patterns, flips = [], []
    with _ffn_relu(record=patterns):
        cpu_loss, cpu = _step_gradients(cfg, batch, masks, "cpu")
    card_loss, card = _step_gradients(cfg, batch, masks, "cuda")
    with _ffn_relu(pin=patterns, flips=flips):
        _, pinned = _step_gradients(cfg, batch, masks, "cuda")

    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"[training] card vs CPU train step at T={trial.n_frames}: loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {rel:.2e}, tol {TRAIN_TOL['loss']}); "
        f"encoder FFN relu flips per call {[n for n, _ in flips]} of "
        f"{patterns[0].numel()}, at |pre-activation| up to "
        f"{max(r for _, r in flips):.2e} of the call's largest (tol {FLIP_PRE})")
    rows, failed = [], []
    for n in sorted(cpu):
        scale = max(cpu[n].abs().max().item(), 1e-30)
        errs = [(got[n] - cpu[n]).abs() for got in (card, pinned)]
        over = (errs[1] - TRAIN_TOL["grad_rtol"] * cpu[n].abs()).max().item()
        rows.append((errs[0].max().item() / scale, errs[1].max().item() / scale, n))
        if over > TRAIN_TOL["grad_atol"] * scale:
            failed.append(n)
    # per leaf, max |card - CPU| over the leaf's own largest |value|
    for free, pin_rel, n in sorted(rows, reverse=True)[:10]:
        log(f"[training]   {n}: {free:.2e} free, {pin_rel:.2e} pinned")
    log(f"[training] {len(rows)} gradient leaves: {sum(r[0] > TRAIN_TOL['grad_atol'] for r in rows)}"
        f" off the CPU by more than {TRAIN_TOL['grad_atol']} of their max with the relu "
        f"pattern free, largest pinned {max(r[1] for r in rows):.2e} (tol rtol "
        f"{TRAIN_TOL['grad_rtol']}, atol {TRAIN_TOL['grad_atol']} x leaf max, every leaf)")
    if rel > TRAIN_TOL["loss"]:
        raise RuntimeError(f"card vs CPU loss {card_loss} vs {cpu_loss}: "
                           f"relative difference {rel:.3e} > {TRAIN_TOL['loss']}")
    if max(r for _, r in flips) > FLIP_PRE:
        raise RuntimeError(f"encoder FFN relu flips away from 0: {flips}")
    if failed:
        raise RuntimeError(f"card vs CPU gradients (relu pattern pinned) out of "
                           f"tolerance: {failed}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def phase_training(profile: bool):
    from med_tpu_torch import ops
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.train.loop import train_frame_fold

    cfg = _train_config()
    rng = np.random.default_rng(SEED)
    train = [_trial(rng, T, f"Needle_Passing_{'BCDE'[i]}00{i + 1}")
             for i, T in enumerate(TRAIN_FRAMES)]
    test = [_trial(rng, T, f"Needle_Passing_F00{i + 1}") for i, T in enumerate(TEST_FRAMES)]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_frame_fold(cfg, train, test)            # on the card
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    exp = res["exp"]
    if exp.device.type != "cuda":
        raise RuntimeError(f"training ran on {exp.device}, not the card")
    steps = cfg.n_epochs * len(train)
    passes = steps + cfg.n_epochs * len(test)
    want = {**forward_launches(passes), **backward_launches(steps)}
    log(f"[training] launches over {steps} train steps and {passes - steps} eval "
        f"passes: {launches} (expected {want})")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    for row in res["history"]:
        if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
            raise RuntimeError(f"non-finite loss in epoch {row['epoch']}: {row}")
        log(f"[training] epoch {row['epoch']}: train_loss {row['train_loss']:.6f}, "
            f"test_loss {row['test_loss']:.6f}, test_f1 {row['test_f1']:.4f}, "
            f"train {row['train_time']:.2f} s")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[training] train_frame_fold: {cfg.n_epochs} epochs x {len(train)} trials "
        f"in {wall:.2f} s (first steps included); peak device memory {peak:.2f} GiB; "
        f"best epoch {res['best']['epoch']}")

    per_step = {}
    for trial in train:
        batch = frame_batch(trial, cfg)
        exp.train_step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            exp.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        per_step[trial.n_frames] = med
        log(f"[training] step T={trial.n_frames} (bucket {batch['labels'].shape[0]}): "
            f"median {med:.2f} ms of 5 (min {min(times):.2f}, max {max(times):.2f}), "
            f"{trial.n_frames / med * 1e3:.0f} frames/s")
    ops.reset_launch_counts()
    exp.train_step(frame_batch(train[0], cfg))
    one = ops.launch_counts()
    log(f"[training] launches per train step: {one}")
    if one != {**forward_launches(1), **backward_launches(1)}:
        raise RuntimeError(f"launches per train step {one} differ from the design")

    _card_vs_cpu_step(cfg, _trial(rng, CPU_TRAIN_FRAMES, "Needle_Passing_G001"))
    if profile:
        for trial in (train[1], train[3]):
            batch = frame_batch(trial, cfg)
            _profile(f"train step T={trial.n_frames}", lambda: exp.train_step(batch))
    return launches


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
    kernels = phase_kernels("--profile" in argv)
    serving = phase_serving("--profile" in argv)
    training = phase_training("--profile" in argv)

    sources = {"swa_packed_fwd": ("med_tpu_torch/csrc/swa_packed_fwd.cu",
                                  "med_tpu/ops/attention.py:390",
                                  "sliding_window_attention_packed"),
               "tcn_layer/multistack": ("med_tpu_torch/csrc/tcn_layer.cu",
                                        "med_tpu/ops/tcn_fused.py:750",
                                        "dilated_residual_multistack_stages"),
               "tcn_layer/stack": ("med_tpu_torch/csrc/tcn_layer.cu",
                                   "med_tpu/ops/tcn_fused.py:91",
                                   "dilated_residual_stack"),
               "swa_packed_bwd": ("med_tpu_torch/csrc/swa_packed_bwd.cu",
                                  "med_tpu/ops/attention.py:506",
                                  "sliding_window_attention_packed_bwd"),
               "tcn_layer_bwd/multistack": ("med_tpu_torch/csrc/tcn_layer_bwd.cu",
                                            "med_tpu/ops/tcn_fused.py:872",
                                            "dilated_residual_multistack_stages_bwd"),
               "tcn_layer_bwd/stack": ("med_tpu_torch/csrc/tcn_layer_bwd.cu",
                                       "med_tpu/ops/tcn_fused.py:193",
                                       "dilated_residual_stack_bwd")}
    # launches: the training run (this slice's path); the serving run's
    # count beside it for the forward kernels
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": training[wrapper], "launches_serving": serving[wrapper],
             **kernels[name]}
            for name, (src, rep, wrapper) in sources.items()]
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
