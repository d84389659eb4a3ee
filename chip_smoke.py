"""Smoke run of the PyTorch port (med_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # what the acceptance run does
    python3 chip_smoke.py --profile   # also: device time by kernel, per
                                      # request and per train step

Phases, one line or more each; any failed check raises, so the exit code is
non-zero and the last line is not printed:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: every CUDA kernel of ``med_tpu_torch/csrc``, one ``nvcc`` each,
   started together;
3. kernels: each forward kernel (K1 attention, K2 TCN stacks, one launch a
   call) and each
   backward kernel (K3 attention, K4 slow-path TCN, K5 fast-path TCN)
   against its plain PyTorch version on the card at the COG path's shapes,
   with its time, the plain version's, the card's bound for the same work,
   for the TCN forward and backward the barrier floor of their one-launch
   design (the same grid running its grid barriers and no work) and the
   grid, for the TCN backward also two runs equal bit for bit,
   and, for the attention, the time of ``scaled_dot_product_attention``
   (forward; autograd backward for K3) with a band mask as a yardstick (the
   port never calls it); the same for the public op entry points' kernels:
   K6/K7, the multistack with the stacks' weights concatenated on the layer
   axis (with and without dropout mask), and K8/K9, the head-major
   attention and its backward that recomputes the softmax; then (``[ops]``
   lines) ``torch.autograd.grad`` through ``dilated_residual_multistack``
   and ``sliding_window_attention``, counting launches, equal to the direct
   backward calls;
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
6. pixels: a full-width ResNet-50 trunk (3, 4, 6, 3) at width 64 with
   weights drawn from a seed and BatchNorm statistics measured on seeded
   frames, saved as a ``med_tpu`` fine-tune checkpoint
   (``resnet50_1Out.npz`` + meta) and loaded through
   ``PixelFrontEnd.from_checkpoint``: K10 (the bottleneck-stage kernel)
   against its plain version on stages 0 and 1 at B = 128 in bf16 (tensor
   cores) and B = 8 in fp32 (CUDA cores), per stage and in total: its time,
   TFLOP/s, the ops bound and the three-launch bytes floor with the share
   of each, launches by instance (16-byte or guarded) and, as a yardstick,
   the same blocks on the module path (cuDNN); with ``--profile``, device
   time by launch kind (reduce, 3x3, expand); ``resnet50_fused_apply``
   (K10's entry point, launches counted) against the module trunk at B =
   128 in bf16, the two timed in turns (A/B), the fp32 B = 8 pair beside
   them, and the fused trunk folded every call;
   the fp32 trunk and the ImageNet resize path (480x640 frames) on the
   card against the CPU; then a T = 300 raw-frame request through
   ``FrameModelServer.predict_trial_from_pixels`` (``PixelFrontEnd``'s
   ``ResNet50`` trunk ahead of phase 4's COG), counting launches, against
   ``predict_trial`` on the same features, and its latency;
7. driver: two synthetic LOSO folds written with ``save_trial_npz`` (6
   trials of 300-4096 frames, 2048-d features, 26-d kinematics, fold
   statistics), then ``med_tpu_torch.cli.train_frame.main`` at full COG
   width, multimodal, 2 epochs, on the card: every file of the run layout,
   finite numbers in ``summary.json`` and ``windowed_metrics.json``, kernel
   launches against the design; then the same command with ``--resume
   --n-epochs 3``, which must train epoch 2 alone; wall time per fold;
8. a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Runs from the repository root; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks: fp32 outside the tensor cores, bf16 on the
# tensor cores (dense), HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
TOL = {"swa_packed_fwd": (1e-4, 1e-5), "tcn_stack_fwd/multistack": (1e-4, 1e-4),
       "tcn_stack_fwd/stack": (1e-4, 1e-4), "swa_packed_bwd": (1e-4, 1e-5),
       "tcn_stack_bwd/multistack": (1e-4, 1e-5), "tcn_stack_bwd/stack": (1e-4, 1e-5),
       "tcn_stack_fwd/concatenated": (1e-4, 1e-4), "tcn_stack_bwd/concatenated": (1e-4, 1e-5),
       "swa_headmajor_fwd": (1e-4, 1e-5), "swa_headmajor_bwd": (1e-4, 1e-5)}
# the driver phase: 6 trials, the first 4 train fold 1Out and the last 2 test
# it; fold 2Out tests trials 0 and 3 and trains on the rest
DRIVER_FRAMES = (300, 1000, 2000, 4096, 500, 1500)
DRIVER_TEST = {"1Out": (4, 5), "2Out": (0, 3)}
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
# the pixel phase: the trunk of the reference's feature export (torchvision
# resnet50 at 224x224), K10 at the serving batch, the JIGSAWS frame size
TRUNK = {"stage_sizes": (3, 4, 6, 3), "width": 64, "frame": 224}
TRUNK_BATCH, FP32_BATCH, CALIB_FRAMES = 128, 8, 32
RESIDUAL_SCALE = 0.2
JIGSAWS_FRAME, IMAGENET_FRAMES, PIXEL_FRAMES = (480, 640), 16, 300
# K10 against its plain version: (relative L2, max |error| over the
# tensor's largest |value|). float32: sums in another order. bfloat16: such a
# sum may round a y1 or y2 value one bf16 step the other way.
STAGE_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -5)}
# pooled features, relative L2. fp32 (TF32 off): the fused trunk against
# the module trunk on the card, and the module trunk on the card against the
# CPU (sums over 53 convolutions taken in another order). bf16: each trunk
# rounds ~50 times on the way, the fused one with BN folded before the
# rounding instead of after (on an H100 each lands ~1% from the fp32 trunk);
# each against the fp32 trunk, and the two against each other. ImageNet
# preprocessing, card vs CPU: max |error| (values within +-2.7).
TRUNK_TOL = {"fused_vs_module_fp32": 1e-5, "card_vs_cpu_fp32": 1e-5,
             "fused_vs_module_bf16": 5e-2, "fused_vs_fp32": 5e-2, "module_vs_fp32": 5e-2,
             "preprocess": 1e-4}


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


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
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


def _barrier_floor(wrapper, layers) -> dict:
    """The one-launch TCN forward's floor for stacks of ``layers``, one call
    a stack: the grid of ``wrapper``'s last launch at C=64, launched with
    the barriers the calls make (one between layers) and no work. The
    timed floor, and under ``floor_note`` (for the log only) the barriers
    and the grid."""
    from med_tpu_torch.ops.tcn_fused import forward_barriers

    blocks, rows = launch = wrapper.last_launch
    return dict(barrier_floor_ms=cuda_ms(
        lambda: [forward_barriers(launch, 64, L - 1) for L in layers], 20),
        floor_note=f"{sum(L - 1 for L in layers)} grid barriers, {blocks} blocks x "
                   f"{rows} rows")


def _multistack_case(T: int, gen: torch.Generator):
    """COG's slow path at T frames: 11 + 3x10 layers at C=64, causal, one
    call (K2a)."""
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

    err = check_close(f"multistack T={T}", run(), plain(), *TOL["tcn_stack_fwd/multistack"])
    nbytes, flops = _tcn_flops_bytes(T, 64, layers, 1, len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **_barrier_floor(dilated_residual_multistack_stages, [sum(layers)]))


def _fast_stacks_case(T: int, gen: torch.Generator):
    """COG's fast path stacks at T // 16 frames: one of 11 layers and three of
    10, each its own call (K2b)."""
    from med_tpu_torch.ops.tcn_fused import dilated_residual_stack, dilated_stack_xla

    layers = (11, 10, 10, 10)
    ws = _stage_weights(gen, layers)
    Tf = T // 16
    xs = [torch.randn((Tf, 64), generator=gen).cuda() for _ in layers]
    run = lambda: [dilated_residual_stack(x, *w) for x, w in zip(xs, ws)]  # noqa: E731
    plain = lambda: [dilated_stack_xla(x, *w) for x, w in zip(xs, ws)]  # noqa: E731
    err = max(check_close(f"fast stack {i} T={Tf}", g, w, *TOL["tcn_stack_fwd/stack"])
              for i, (g, w) in enumerate(zip(run(), plain())))
    nbytes, flops = _tcn_flops_bytes(Tf, 64, layers, len(layers), len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **_barrier_floor(dilated_residual_stack, layers))


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


def _bwd_barrier_floor(wrapper, calls) -> dict:
    """The one-launch TCN backward's floor for ``calls``, the (layers, T) of
    each backward call: the grid of ``wrapper``'s last launch at C=64,
    launched with the barriers each call makes and no work. The timed
    floor, and under ``floor_note`` (for the log only) the barriers and the
    grid."""
    from med_tpu_torch.ops.tcn_fused import backward_barrier_count, backward_barriers

    blocks, rows = launch = wrapper.last_launch
    counts = [backward_barrier_count(L, T) for L, T in calls]
    return dict(barrier_floor_ms=cuda_ms(
        lambda: [backward_barriers(launch, 64, n) for n in counts], 20),
        floor_note=f"{sum(counts)} grid barriers, {blocks} blocks x {rows} rows; "
                   f"two runs equal bit for bit")


def _same_bits(name: str, run) -> None:
    """Raise unless two calls of ``run`` return equal tensors bit for bit."""
    def flat(x):
        return [t for y in x for t in flat(y)] if isinstance(x, (list, tuple)) else [x]
    for i, (a, b) in enumerate(zip(flat(run()), flat(run()))):
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: two runs differ in output {i}")


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
    rtol, atol = TOL["tcn_stack_bwd/multistack"]
    (dx, dws), (p_dx, p_dws) = run(), plain()
    err = check_grads(f"multistack bwd T={T} dx", [dx], [p_dx], rtol, atol)
    for s, (got, want) in enumerate(zip(dws, p_dws)):
        for n, a, b in zip(("dw3", "db3", "dw1", "db1"), got, want):
            err = max(err, check_grads(f"multistack bwd T={T} stage {s} {n}",
                                       [a], [b], rtol, atol))
    _same_bits(f"multistack bwd T={T}", run)
    nbytes, flops = _tcn_bwd_flops_bytes(T, 64, layers, len(layers), 1)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                phase_note=_bwd_phases(g, h_saved, y_saved, ws, masks),
                **_bwd_barrier_floor(tcn.dilated_residual_multistack_stages_bwd,
                                     [(sum(layers), T)]))


def _bwd_phases(g, h_saved, y_saved, ws, masks, runs: int = 5) -> str:
    """Where one K4 launch spends its time, from block 0's device clock:
    the layer chain, the weight-gradient items (until the last block ends
    its items) and the sum of their partials; medians of ``runs`` launches,
    for the log."""
    from types import SimpleNamespace

    from med_tpu_torch.ops import tcn_fused as tcn

    marks = torch.zeros(4, dtype=torch.int64, device="cuda")
    spans = []
    for _ in range(runs):
        tcn._stages_bwd_cuda(g, h_saved, y_saved, [(w[0], w[2]) for w in ws], masks, True,
                             SimpleNamespace(launches=0, last_launch=None), marks=marks)
        m = marks.tolist()
        spans.append([(b - a) / 1e6 for a, b in zip(m, m[1:])])
    chain, items, total = (statistics.median(x) for x in zip(*spans))
    return (f"chain {chain:.4f} ms, weight-gradient items {items:.4f} ms, "
            f"their sum {total:.4f} ms (block 0's clock)")


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
    rtol, atol = TOL["tcn_stack_bwd/stack"]
    err = 0.0
    for i, (got, (p_dx, (p_dw,))) in enumerate(zip(run(), plain())):
        for n, a, b in zip(("dx", "dw3", "db3", "dw1", "db1"), got, (p_dx, *p_dw)):
            err = max(err, check_grads(f"fast stack {i} bwd T={Tf} {n}", [a], [b],
                                       rtol, atol))
    _same_bits(f"fast stacks bwd T={Tf}", run)
    nbytes, flops = _tcn_bwd_flops_bytes(Tf, 64, layers, len(layers), len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **_bwd_barrier_floor(tcn.dilated_residual_stack_bwd,
                                     [(L, Tf) for L in layers]))


COG_STACKS = dict(L0=11, Lr=10, S=4)      # the slow path: 11 + 3x10 layers, Lt = 41


def _concatenated_stacks(T: int, gen: torch.Generator):
    """COG's slow path with the stacks' weights concatenated on the layer
    axis: x, (w3, b3, w1, b1) of 41 layers at C=64, a keep-mask, a cotangent
    on every stage output."""
    layers = (COG_STACKS["L0"],) + (COG_STACKS["Lr"],) * (COG_STACKS["S"] - 1)
    ws = [torch.cat(t) for t in zip(*_stage_weights(gen, layers))]
    mask = torch.randint(0, 2, (sum(layers), T, 64), generator=gen, dtype=torch.uint8).cuda()
    x = torch.randn((T, 64), generator=gen).cuda()
    g = torch.randn((len(layers), T, 64), generator=gen).cuda()
    return layers, x, ws, mask, g


def _concat_multistack_case(T: int, gen: torch.Generator):
    """K6 at COG's slow-path shapes, causal, without mask (serving) and with
    mask saving h and y (training); timed as K2a is, without mask."""
    from med_tpu_torch.ops import tcn_fused as tcn

    layers, x, ws, mask, _ = _concatenated_stacks(T, gen)
    L0, Lr = COG_STACKS["L0"], COG_STACKS["Lr"]
    run = lambda: tcn.dilated_residual_multistack(x, *ws, L0, Lr)  # noqa: E731
    plain = lambda: tcn.dilated_residual_multistack_plain(x, *ws, L0, Lr)  # noqa: E731
    saving = lambda: tcn._multistack_fwd(x, *ws, mask, L0, Lr, True, save=True)  # noqa: E731
    tol = TOL["tcn_stack_fwd/concatenated"]
    err = check_close(f"concatenated multistack T={T}", run(), plain(), *tol)
    want = tcn.dilated_residual_multistack_plain(x, *ws, L0, Lr, mask=mask, save=True)
    for n, a, b in zip(("stage outputs", "saved h", "saved y"), saving(), want):
        err = max(err, check_close(f"concatenated multistack T={T}, mask, {n}", a, b, *tol))
    nbytes, flops = _tcn_flops_bytes(T, 64, layers, 1, len(layers))
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                saving_ms=cuda_ms(saving, 20), bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                **_barrier_floor(tcn.dilated_residual_multistack, [sum(layers)]))


def _concat_multistack_bwd_case(T: int, gen: torch.Generator):
    """K7 at COG's slow-path shapes, causal, with and without mask; timed as
    K4 is, with masks."""
    from med_tpu_torch.ops import tcn_fused as tcn

    layers, x, ws, mask, g = _concatenated_stacks(T, gen)
    L0, Lr = COG_STACKS["L0"], COG_STACKS["Lr"]
    w3, _, w1, _ = ws
    rtol, atol = TOL["tcn_stack_bwd/concatenated"]
    err = 0.0
    for m in (None, mask):
        _, h_saved, y_saved = tcn._multistack_fwd(x, *ws, m, L0, Lr, True, save=True)
        run = lambda: tcn.dilated_residual_multistack_bwd(  # noqa: E731
            g, h_saved, y_saved, w3, w1, L0, Lr, mask=m)
        plain = lambda: tcn.dilated_residual_multistack_bwd_plain(  # noqa: E731
            g, h_saved, y_saved, w3, w1, L0, Lr, mask=m)
        for n, a, b in zip(("dx", "dw3", "db3", "dw1", "db1"), run(), plain()):
            err = max(err, check_grads(
                f"concatenated multistack bwd T={T} mask={m is not None} {n}",
                [a], [b], rtol, atol))
    _same_bits(f"concatenated multistack bwd T={T}", run)
    nbytes, flops = _tcn_bwd_flops_bytes(T, 64, layers, len(layers), 1)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **_bwd_barrier_floor(tcn.dilated_residual_multistack_bwd,
                                     [(sum(layers), T)]))


COG_HEADS = dict(H=8, d=8, m=15, W=30)


def _head_major_inputs(T: int, gen: torch.Generator):
    H, d, m = COG_HEADS["H"], COG_HEADS["d"], COG_HEADS["m"]
    return [torch.randn(s, generator=gen).cuda()
            for s in ((H, T, m, d), (H, T, d), (H, T, d), (H, T, m, d))]


def _band_mask(T: int):
    """Head-major queries against the keys left-padded by W - 1 zero rows."""
    m, W = COG_HEADS["m"], COG_HEADS["W"]
    frame = torch.arange(T * m, device="cuda")[:, None] // m
    col = torch.arange(T + W - 1, device="cuda")[None, :]
    return (col >= frame) & (col < frame + W)


def _head_major_case(T: int, gen: torch.Generator):
    """K8 at COG's head-major shapes: 8 heads, d=8, 15 queries a frame,
    window 30, T frames."""
    from med_tpu_torch.ops import attention as att

    H, d, m, W = (COG_HEADS[k] for k in "HdmW")
    q, k, v, _ = _head_major_inputs(T, gen)
    run = lambda: att.sliding_window_attention_pallas(q, k, v, W)  # noqa: E731
    plain = lambda: att.sliding_window_attention_xla(q, k, v, W)  # noqa: E731
    err = check_close(f"head-major attention T={T}", run(), plain(),
                      *TOL["swa_headmajor_fwd"])
    # yardstick: one library call computing the same function
    qs = q.reshape(1, H, T * m, d)
    ks, vs = (F.pad(t, (0, 0, W - 1, 0))[None] for t in (k, v))
    band = _band_mask(T)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band)  # noqa: E731
    check_close(f"head-major attention T={T} library yardstick",
                lib().reshape(H, T, m, d), run(), 5e-3, 5e-3)
    nbytes = 4 * (2 * H * T * m * d + 2 * H * T * d)
    flops = H * T * m * W * (2 * d + 2 * d + 4)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1))


def _head_major_bwd_case(T: int, gen: torch.Generator):
    """K9 at K8's shapes, a cotangent on every query; given q, k, v, g only."""
    from med_tpu_torch.ops import attention as att

    H, d, m, W = (COG_HEADS[k] for k in "HdmW")
    q, k, v, g = _head_major_inputs(T, gen)
    run = lambda: att.sliding_window_attention_bwd_pallas(q, k, v, g, W)  # noqa: E731
    plain = lambda: att.sliding_window_attention_bwd_plain(q, k, v, g, W)  # noqa: E731
    rtol, atol = TOL["swa_headmajor_bwd"]
    err = max(check_grads(f"head-major attention bwd T={T} {n}", [a], [b], rtol, atol)
              for n, a, b in zip(("dq", "dk", "dv"), run(), plain()))
    # yardstick: autograd backward of one library call, same function
    qs = q.reshape(1, H, T * m, d).detach().requires_grad_()
    ks, vs = (F.pad(t, (0, 0, W - 1, 0))[None].detach().requires_grad_() for t in (k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=_band_mask(T))
    gs = g.reshape(1, H, T * m, d)
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), gs, retain_graph=True)  # noqa: E731
    check_close(f"head-major attention bwd T={T} library yardstick dq",
                lib()[0].reshape(H, T, m, d), run()[0], 5e-3, 5e-3)
    # bytes: q, g read and dq written (per query); k, v read and dk, dv
    # written (per key). Operations per (query, key) pair: score, g.v, dq,
    # dk, dv (2d each) and ~4 for the softmax and ds
    nbytes = 4 * (3 * H * T * m * d + 4 * H * T * d)
    flops = H * T * m * W * (10 * d + 4)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1))


KERNEL_CASES = (("swa_packed_fwd", _attention_case),
                ("tcn_stack_fwd/multistack", _multistack_case),
                ("tcn_stack_fwd/stack", _fast_stacks_case),
                ("swa_packed_bwd", _attention_bwd_case),
                ("tcn_stack_bwd/multistack", _multistack_bwd_case),
                ("tcn_stack_bwd/stack", _fast_stacks_bwd_case),
                ("tcn_stack_fwd/concatenated", _concat_multistack_case),
                ("tcn_stack_bwd/concatenated", _concat_multistack_bwd_case),
                ("swa_headmajor_fwd", _head_major_case),
                ("swa_headmajor_bwd", _head_major_bwd_case))


def phase_kernels(profile: bool):
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for T in KERNEL_FRAMES:
        for name, case in KERNEL_CASES:
            r = case(T, gen)
            if profile and T == KERNEL_FRAMES[-1]:
                _profile(f"{name} T={T}", r.pop("run"))
            r.pop("run", None)
            floor_note = r.pop("floor_note", None)
            phase_note = r.pop("phase_note", None)
            results[name] = r
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            saving = (f", saving forward with mask {r['saving_ms']:.4f} ms"
                      if "saving_ms" in r else "")
            if floor_note is not None:
                saving += f", barrier floor {r['barrier_floor_ms']:.4f} ms ({floor_note})"
            if phase_note is not None:
                saving += f"; {phase_note}"
            rtol, atol = TOL[name]
            atol_txt = f"{atol} x max|want|" if "bwd" in name else f"{atol}"
            log(f"[kernels] {name} at T={T}: max_abs_err {r['max_abs_err']:.3e} "
                f"(tol rtol {rtol}, atol {atol_txt}), "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms{saving}")
    return results


def op_api_launches(n: int):
    """Launches of n forward and backward passes through the two public op
    entry points at COG's shapes: K6 and K7 one launch a call (41 layers),
    K8 and K9 one launch each."""
    return {"dilated_residual_multistack": n,
            "dilated_residual_multistack_bwd": n,
            "sliding_window_attention_pallas": n,
            "sliding_window_attention_bwd_pallas": n}


def phase_op_api():
    """The public differentiable ops (K6-K9's path): ``torch.autograd.grad``
    through each at T = 4096, counting launches; then the same gradients
    from the direct backward calls, which must be equal bit for bit."""
    from med_tpu_torch import ops
    from med_tpu_torch.ops import attention as att
    from med_tpu_torch.ops import tcn_fused as tcn

    gen = torch.Generator().manual_seed(SEED + 2)
    T = KERNEL_FRAMES[-1]
    L0, Lr, W = COG_STACKS["L0"], COG_STACKS["Lr"], COG_HEADS["W"]
    _, x, ws, mask, g = _concatenated_stacks(T, gen)
    q, k, v, ga = _head_major_inputs(T, gen)
    stack_leaves = [t.requires_grad_() for t in (x, *ws)]
    att_leaves = [t.requires_grad_() for t in (q, k, v)]

    ops.reset_launch_counts()
    hs = tcn.dilated_residual_multistack(*stack_leaves, L0, Lr, mask=mask)
    stack_grads = torch.autograd.grad(hs, stack_leaves, g)
    out = att.sliding_window_attention(*att_leaves, W)
    att_grads = torch.autograd.grad(out, att_leaves, ga)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {**forward_launches(0), **backward_launches(0), **op_api_launches(1)}
    log(f"[ops] launches of one forward and backward through dilated_residual_multistack "
        f"and sliding_window_attention at T={T}: {launches} (expected {want})")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    for name, t in (("stage outputs", hs), ("attention", out), *zip("x w3 b3 w1 b1".split(),
                                                                   stack_grads)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"non-finite {name} through the op entry points")

    with torch.no_grad():
        _, h_saved, y_saved = tcn._multistack_fwd(x, *ws, mask, L0, Lr, True, save=True)
        direct = tcn.dilated_residual_multistack_bwd(g, h_saved, y_saved, ws[0], ws[2],
                                                     L0, Lr, mask=mask)
        direct_att = att.sliding_window_attention_bwd_pallas(q, k, v, ga, W)
        plain_out = att.sliding_window_attention(q, k, v, W, use_pallas=False)
    for name, a, b in (*zip(("dx", "dw3", "db3", "dw1", "db1"), stack_grads, direct),
                       *zip(("dq", "dk", "dv"), att_grads, direct_att)):
        if not torch.equal(a, b):
            raise RuntimeError(f"autograd {name} differs from the direct backward call")
    err = check_close("sliding_window_attention vs use_pallas=False", out, plain_out,
                      *TOL["swa_headmajor_fwd"])
    log(f"[ops] autograd through both ops equals the direct backward calls bit for bit; "
        f"use_pallas=True vs False: max abs diff {err:.3e}")
    return launches


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
    """Forward launches of n COG passes: 2 attention layers, one launch for
    the slow path's 41 TCN layers and one for each of the fast path's 4
    stacks (the softmax and 1x1 convs between fast stages run in PyTorch);
    no trunk stage (COG reads features), and none of the op entry points'
    kernels (COG uses the packed attention and the per-stage multistack)."""
    return {"sliding_window_attention_packed": 2 * n,
            "dilated_residual_multistack_stages": n,
            "dilated_residual_stack": 4 * n,
            "fused_bottleneck_stage": 0,
            "dilated_residual_multistack": 0,
            "sliding_window_attention_pallas": 0}


def backward_launches(n: int):
    """Backward launches of n COG train steps: one K3 per attention layer;
    one TCN backward launch per call, its weight gradients included (the
    slow path is one call of 41 layers, the fast path four of 11 + 3x10)."""
    return {"sliding_window_attention_packed_bwd": 2 * n,
            "dilated_residual_multistack_stages_bwd": n,
            "dilated_residual_stack_bwd": 4 * n,
            "dilated_residual_multistack_bwd": 0,
            "sliding_window_attention_bwd_pallas": 0}


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
    want = {**forward_launches(n), **backward_launches(0)}
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


def _seeded_trunk(directory: str, device="cuda", residual_scale: float = RESIDUAL_SCALE):
    """A full-width trunk with weights from SEED, saved as ``med_tpu``'s
    fine-tune CLI saves one: the trunk under params/trunk and
    batch_stats/trunk, the fold's pixel mean/std in the meta. Returns the
    checkpoint's path and the frames' mean/std.

    BN scales and biases are perturbed around 1 and 0, and those of each
    block's last BN (bn3) are scaled by ``residual_scale``, as a trained
    ResNet's are small (torchvision's zero_init_residual starts them at 0);
    the running statistics are measured layer by layer on seeded frames, so
    activations are normalised as in a trained trunk. Without the small bn3
    scales (``residual_scale=1``) the random trunk amplifies rounding far
    more: ``trunk_gain.py`` measures both on the CPU. The phase prints the
    trunk's gain: how far a 1e-6 relative change of its input moves its
    features."""
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.models.resnet import BatchNorm, ResNet50
    from med_tpu_torch.train.checkpoint import save_checkpoint
    from med_tpu_torch.utils.jax_params import export_jax_params

    gen = torch.Generator().manual_seed(SEED)
    net = init_weights(ResNet50(TRUNK["stage_sizes"], TRUNK["width"]), gen)
    norms = [m for m in net.modules() if isinstance(m, BatchNorm)]
    residual = {id(m) for name, m in net.named_modules() if name.endswith(".bn3")}
    with torch.no_grad():
        for m in norms:
            m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=gen))
            m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=gen))
            if id(m) in residual:
                m.weight.mul_(residual_scale)
                m.bias.mul_(residual_scale)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (CALIB_FRAMES, TRUNK["frame"], TRUNK["frame"], 3), np.uint8)
    mean = (frames / 255.0).mean(axis=(0, 1, 2)).astype(np.float32)
    std = (frames / 255.0).std(axis=(0, 1, 2)).astype(np.float32)

    def measure(module, args):
        h = args[0].to(torch.float32)
        module.running_mean.copy_(h.mean(dim=(0, 2, 3)))
        module.running_var.copy_(h.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(measure) for m in norms]
    try:
        x = (torch.from_numpy(frames).to(device).float() / 255.0
             - torch.from_numpy(mean).to(device)) / torch.from_numpy(std).to(device)
        with torch.no_grad():
            net.to(device)(x)
    finally:
        for h in hooks:
            h.remove()
    tree = export_jax_params(net.cpu())
    path = str(Path(directory) / "resnet50_1Out.npz")
    save_checkpoint(path, {"trunk": tree["params"]}, {"trunk": tree["batch_stats"]},
                    meta={"mean": mean.tolist(), "std": std.tolist()})
    return path, mean, std


def _stage_inputs(net, x):
    """The module trunk's input to each stage's first stride-1 block (stage
    0: layer1_0, stage 1: layer2_1), as (B, H*W, C) rows."""
    got = {}
    blocks = {0: net.layer1_0, 1: net.layer2_1}

    def keep(stage):
        def hook(module, args):
            y = args[0].permute(0, 2, 3, 1)
            got[stage] = (y.reshape(y.shape[0], -1, y.shape[3]).contiguous(), y.shape[2])
        return hook

    hooks = [b.register_forward_pre_hook(keep(s)) for s, b in blocks.items()]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return got


def _stage_case(stage: int, x, Wr: int, variables, net, dtype):
    """K10 on one stage's stride-1 blocks: against the plain version, its
    time, the plain version's, the module path's (cuDNN) on the same
    blocks, and the bound for the work."""
    from med_tpu_torch import ops
    from med_tpu_torch.ops.resnet_fused import (
        fold_bottleneck_params, fused_bottleneck_stage, fused_bottleneck_stage_plain,
        stage_work)

    names = [f"layer{stage + 1}_{b}" for b in range(0 if stage == 0 else 1,
                                                     TRUNK["stage_sizes"][stage])]
    blocks = [{k: v.cuda() for k, v in fold_bottleneck_params(
        variables["params"][n], variables["batch_stats"][n]).items()} for n in names]
    x = x.to(dtype)
    run = lambda: fused_bottleneck_stage(x, blocks, Wr=Wr, dtype=dtype)  # noqa: E731
    plain = lambda: fused_bottleneck_stage_plain(x, blocks, Wr=Wr, dtype=dtype)  # noqa: E731
    B, HW, _ = x.shape
    ops.reset_launch_counts()
    before = dict(fused_bottleneck_stage.instances)
    got = run()
    torch.cuda.synchronize()
    instances = _instances_since(before)
    if ops.launch_counts()["fused_bottleneck_stage"] != 3 * len(blocks):
        raise RuntimeError(f"stage {stage}: {ops.launch_counts()} launches, "
                           f"expected 3 per block")
    want = plain()
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    peak = (err.max() / want.abs().max()).item()
    tol = STAGE_TOL[dtype]
    if not (torch.isfinite(got).all() and rel <= tol[0] and peak <= tol[1]):
        raise RuntimeError(f"K10 stage {stage} {dtype} B={B}: relative L2 {rel:.3e}, "
                           f"max error {peak:.3e} of the largest value; tolerance {tol}")

    img = x.view(B, HW // Wr, Wr, -1).permute(0, 3, 1, 2)   # NCHW, channels-last

    def module():
        y = img
        for n in names:
            y = getattr(net, n)(y)
        return y

    work = stage_work(B, HW, [(*blk["w1"].shape, "wd" in blk) for blk in blocks],
                      torch.finfo(dtype).bits // 8)
    peak_flops = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    b_ms, b_by = bound(work["bytes"], work["flops"], peak_flops)
    with torch.no_grad():
        cudnn_ms = cuda_ms(module, 10)
    return dict(max_abs_err=err.max().item(), rel=rel, peak=peak, blocks=len(blocks),
                ms=cuda_ms(run, 5), plain_ms=cuda_ms(plain, 2), cudnn_ms=cudnn_ms,
                bound_ms=b_ms, bound_by=b_by, floor_ms=work["floor_bytes"] / PEAK_BYTES * 1e3,
                flops=work["flops"], nbytes=work["bytes"], work=work, run=run,
                peak_flops=peak_flops, instances=instances)


def _instances_since(before: dict) -> dict:
    """K10 launches by instance (16-byte, guarded, fp32) since ``before``."""
    from med_tpu_torch.ops.resnet_fused import fused_bottleneck_stage

    now = fused_bottleneck_stage.instances
    return {k: v - before.get(k, 0) for k, v in now.items() if v - before.get(k, 0)}


def _k10_summary(label: str, ms: float, flops: float, bound_ms: float, floor_ms: float,
                 peak_flops: float) -> str:
    return (f"{label}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s; ops bound "
            f"{flops / peak_flops * 1e3:.4f} ms, bound {bound_ms:.4f} ms "
            f"({100 * bound_ms / ms:.1f}% of the time), three-launch bytes floor "
            f"{floor_ms:.4f} ms ({100 * floor_ms / ms:.1f}%)")


def _profile_k10_instances(cases) -> None:
    """Device time of K10's bf16 launches by template instance (reduce, 3x3,
    expand) over one run of each stage, beside each launch kind's bytes and
    ops times: which launch sets the pace."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in cases:
        r["run"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in cases:
            r["run"]()
        torch.cuda.synchronize()
    names = ("reduce", "conv3", "expand")
    by_mode = {}
    for e in prof.key_averages():
        hit = re.search(r"stage_mma_kernel<(\d+), (\d+), (true|false)>", e.key)
        if e.device_type != DeviceType.CUDA or hit is None:
            continue
        mode, bn, aligned = names[int(hit[1])], hit[2], hit[3] == "true"
        log(f"[profile] K10 {mode} BN={bn} {'16-byte' if aligned else 'guarded'}: "
            f"{e.self_device_time_total / 1e3:.4f} ms over x{e.count}")
        by_mode[mode] = by_mode.get(mode, 0.0) + e.self_device_time_total / 1e3
    for mode in names:
        w = {k: sum(r["work"]["launches"][mode][k] for r in cases) for k in ("flops", "bytes")}
        t_bytes, t_ops = w["bytes"] / PEAK_BYTES * 1e3, w["flops"] / PEAK_BF16_FLOPS * 1e3
        ms = by_mode.get(mode, float("nan"))
        log(f"[profile] K10 {mode} launches, stages 0+1: {ms:.4f} ms of device time; bytes "
            f"{t_bytes:.4f} ms, ops {t_ops:.4f} ms: {'bytes' if t_bytes >= t_ops else 'ops'} "
            f"side, {100 * max(t_bytes, t_ops) / ms:.1f}% of the time; "
            f"{w['flops'] / ms / 1e9:.1f} TFLOP/s, {w['bytes'] / ms / 1e6:.1f} GB/s")


def _tree_to(tree, device):
    """A numpy variables tree as fp32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def phase_pixels(profile: bool):
    from med_tpu_torch import ops
    from med_tpu_torch.data.preprocessing import preprocess_frames
    from med_tpu_torch.eval.serving import FrameModelServer, PixelFrontEnd
    from med_tpu_torch.ops.resnet_fused import (
        fold_trunk, fused_bottleneck_stage, resnet50_fused_apply)
    from med_tpu_torch.train.checkpoint import load_checkpoint

    rng = np.random.default_rng(SEED + 1)
    geometry = dict(stage_sizes=TRUNK["stage_sizes"], width=TRUNK["width"])
    with tempfile.TemporaryDirectory() as tmp:
        path, mean, std = _seeded_trunk(tmp)
        module = PixelFrontEnd.from_checkpoint(path, **geometry)
        fp32 = PixelFrontEnd.from_checkpoint(path, dtype=torch.float32, **geometry)
        fp32_cpu = PixelFrontEnd.from_checkpoint(path, dtype=torch.float32, device="cpu",
                                                 **geometry)
        ckpt = load_checkpoint(path)
    tree = {"params": ckpt["params"]["trunk"], "batch_stats": ckpt["batch_stats"]["trunk"]}
    bf16 = torch.bfloat16
    folded = {dt: fold_trunk(tree, dtype=dt, device="cuda") for dt in (bf16, torch.float32)}
    log(f"[pixels] trunk: ResNet-50 {TRUNK['stage_sizes']} width {TRUNK['width']}, "
        f"{sum(p.numel() for p in module.net.parameters())} parameters; fold pixel "
        f"mean {np.round(mean, 4).tolist()} std {np.round(std, 4).tolist()}")

    side = TRUNK["frame"]
    frames = rng.integers(0, 256, (TRUNK_BATCH, side, side, 3), np.uint8)
    x = (torch.from_numpy(frames).cuda().float() / 255.0 - module.mean) / module.std
    inputs = _stage_inputs(module.net, x)
    cases = {}
    for dtype, B in ((bf16, TRUNK_BATCH), (torch.float32, FP32_BATCH)):
        net = module.net if dtype == bf16 else fp32.net
        for stage, (xs, Wr) in inputs.items():
            r = _stage_case(stage, xs[:B], Wr, tree, net, dtype)
            cases[(dtype, stage)] = r
            log(f"[pixels] K10 stage {stage} ({r['blocks']} blocks, {xs.shape[1]} pixels x "
                f"{xs.shape[2]} channels) {str(dtype)[6:]} B={B}: relative L2 {r['rel']:.3e}, "
                f"max error {r['peak']:.3e} of the largest value (tol {STAGE_TOL[dtype]}); "
                f"launches by instance {r['instances']}; plain {r['plain_ms']:.4f} ms, module "
                f"path (cuDNN) {r['cudnn_ms']:.4f} ms; bound by {r['bound_by']} "
                f"({r['flops'] / 1e9:.1f} GFLOP, {r['nbytes'] / 1e6:.1f} MB; three-launch "
                f"floor {r['work']['floor_bytes'] / 1e6:.1f} MB), library none")
            log("[pixels]   " + _k10_summary("kernel", r["ms"], r["flops"], r["bound_ms"],
                                              r["floor_ms"], r["peak_flops"]))
        total = {k: sum(cases[(dtype, s)][k] for s in inputs)
                 for k in ("ms", "flops", "bound_ms", "floor_ms", "cudnn_ms")}
        log(f"[pixels] K10 stages 0+1 {str(dtype)[6:]} B={B}: " + _k10_summary(
            "kernel", total["ms"], total["flops"], total["bound_ms"], total["floor_ms"],
            cases[(dtype, 0)]["peak_flops"]) + f"; module path (cuDNN) {total['cudnn_ms']:.4f} "
            f"ms, kernel / cuDNN {total['ms'] / total['cudnn_ms']:.3f}")

    stage_sizes = TRUNK["stage_sizes"]
    fused = lambda t, v: resnet50_fused_apply(v, t, stage_sizes=stage_sizes)  # noqa: E731
    with torch.no_grad():
        # K10's path: the fused-trunk entry point on one 128-frame batch
        ops.reset_launch_counts()
        before = dict(fused_bottleneck_stage.instances)
        got = fused(x, folded[bf16])
        torch.cuda.synchronize()
        apply_counts = ops.launch_counts()
        apply_instances = _instances_since(before)
        # three a stride-1 block: all of stage 0's, all but the first of stage 1's
        design = {**forward_launches(0), **backward_launches(0),
                  "fused_bottleneck_stage": 3 * (stage_sizes[0] + stage_sizes[1] - 1)}
        if apply_counts != design:
            raise RuntimeError(f"resnet50_fused_apply launches {apply_counts} != {design}")
        apply_launches = apply_counts["fused_bottleneck_stage"]
        want, exact = module.net(x), fp32.net(x)
        small = x[:FP32_BATCH]
        exact_fused = resnet50_fused_apply(folded[torch.float32], small,
                                           stage_sizes=stage_sizes, dtype=torch.float32)
        cpu = fp32_cpu.net(small.cpu())
        noise = torch.randn(small.shape, generator=torch.Generator().manual_seed(SEED)).cuda()
        moved = fp32.net(small + 1e-6 * torch.linalg.norm(small) / torch.linalg.norm(noise)
                         * noise)
        tree_dev = _tree_to(tree, "cuda")
        # the A/B in turns (module, fused, fused, module), each mean of the two
        ab = {"module": lambda: module.net(x), "fused, folded once": lambda: fused(x, folded[bf16])}
        turns = [(k, cuda_ms(ab[k], 5)) for k in ("module", "fused, folded once",
                                                  "fused, folded once", "module")]
        trunk_ms = {k: statistics.mean(ms for name, ms in turns if name == k) for k in ab}
        trunk_ms["fused, folded every call"] = cuda_ms(lambda: fused(x, tree_dev), 3)
        fp32_ms = {"module": cuda_ms(lambda: fp32.net(small), 5),
                   "fused, folded once": cuda_ms(lambda: resnet50_fused_apply(
                       folded[torch.float32], small, stage_sizes=stage_sizes,
                       dtype=torch.float32), 5)}

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        if not torch.isfinite(a).all():
            raise RuntimeError("non-finite trunk features")
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

    errs = {"fused_vs_module_bf16": rel(got, want), "fused_vs_fp32": rel(got, exact),
            "module_vs_fp32": rel(want, exact),
            "fused_vs_module_fp32": rel(exact_fused, exact[:FP32_BATCH]),
            "card_vs_cpu_fp32": rel(exact[:FP32_BATCH], cpu)}
    log(f"[pixels] pooled features {tuple(got.shape)}, relative L2: bf16 B={TRUNK_BATCH} "
        f"resnet50_fused_apply vs ResNet50 {errs['fused_vs_module_bf16']:.3e}, each vs the "
        f"fp32 trunk: fused {errs['fused_vs_fp32']:.3e}, module {errs['module_vs_fp32']:.3e} "
        f"(tol {TRUNK_TOL['fused_vs_module_bf16']} each); fp32 B={FP32_BATCH} fused vs "
        f"module {errs['fused_vs_module_fp32']:.3e}, card (TF32 off) vs CPU "
        f"{errs['card_vs_cpu_fp32']:.3e} (tol {TRUNK_TOL['card_vs_cpu_fp32']} each); "
        f"{apply_launches} K10 launches a batch, by instance {apply_instances}")
    log(f"[pixels] trunk gain (fp32, B={FP32_BATCH}): a 1e-6 relative change of the input "
        f"moves the pooled features by {rel(moved, exact[:FP32_BATCH]):.3e}")
    for key, err in errs.items():
        if err > TRUNK_TOL[key]:
            raise RuntimeError(f"trunk {key}: relative L2 {err:.3e} > {TRUNK_TOL[key]}")
    for name, ms in trunk_ms.items():
        log(f"[pixels] trunk {name} bf16 B={TRUNK_BATCH}: {ms:.3f} ms a batch, "
            f"{TRUNK_BATCH / ms * 1e3:.0f} frames/s (CUDA events over back-to-back calls)")
    diff = trunk_ms["fused, folded once"] - trunk_ms["module"]
    log(f"[pixels] trunk A/B bf16 B={TRUNK_BATCH} (turns module, fused, fused, module: "
        f"{', '.join(f'{ms:.3f}' for _, ms in turns)} ms): fused folded once minus module "
        f"{diff:+.3f} ms ({trunk_ms['fused, folded once'] / trunk_ms['module']:.3f}x); fp32 "
        f"B={FP32_BATCH}: fused folded once {fp32_ms['fused, folded once']:.3f} ms, module "
        f"{fp32_ms['module']:.3f} ms")
    raw = rng.integers(0, 256, (IMAGENET_FRAMES, *JIGSAWS_FRAME, 3), np.uint8)
    pre = preprocess_frames(torch.from_numpy(raw).cuda()).cpu()
    err = (pre - preprocess_frames(torch.from_numpy(raw))).abs().max().item()
    if err > TRUNK_TOL["preprocess"] or pre.shape != (IMAGENET_FRAMES, 224, 224, 3):
        raise RuntimeError(f"ImageNet preprocessing card vs CPU: {err:.3e}, {pre.shape}")
    log(f"[pixels] ImageNet resize path, {IMAGENET_FRAMES} frames of {JIGSAWS_FRAME}: "
        f"card vs CPU max error {err:.3e} (tol {TRUNK_TOL['preprocess']})")

    cfg = _serving_config(2048)
    with tempfile.TemporaryDirectory() as tmp:
        server = FrameModelServer(cfg, _seeded_checkpoint(cfg, tmp), stats={
            "kinematics": {"mean": rng.standard_normal(26, dtype=np.float32),
                           "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}})
    request = (rng.integers(0, 256, (PIXEL_FRAMES, side, side, 3), np.uint8),
               rng.standard_normal((PIXEL_FRAMES, 26), dtype=np.float32))
    server.predict_trial_from_pixels(module, *request)         # warm-up, not counted
    ops.reset_launch_counts()
    preds, probs = server.predict_trial_from_pixels(module, *request)
    launches = ops.launch_counts()
    want = {**forward_launches(1), **backward_launches(0)}
    log(f"[pixels] launches of one T={PIXEL_FRAMES} pixel request "
        f"({-(-PIXEL_FRAMES // module.batch_size)} trunk batches): {launches} "
        f"(expected {want})")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    _check_served("pixel request", preds, probs, PIXEL_FRAMES)
    f_preds, f_probs = server.predict_trial(module.features(request[0]), request[1])
    diff = float(np.abs(probs - f_probs).max())
    if not (np.array_equal(preds, f_preds) and diff <= 1e-6):
        raise RuntimeError(f"pixel request vs predict_trial on its features: "
                           f"probabilities differ by {diff:.3e}")
    log(f"[pixels] pixel request vs predict_trial on the same front end's features: "
        f"predictions equal, max prob diff {diff:.3e} (tol 1e-6)")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.predict_trial_from_pixels(module, *request)
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    log(f"[pixels] pixel request T={PIXEL_FRAMES}, bf16 trunk: median {med:.2f} ms of 5 "
        f"(min {min(times):.2f}, max {max(times):.2f}), {PIXEL_FRAMES / med * 1e3:.0f} frames/s")
    if profile:
        _profile(f"pixel request T={PIXEL_FRAMES}",
                 lambda: server.predict_trial_from_pixels(module, *request))
        with torch.no_grad():
            _profile(f"resnet50_fused_apply bf16 B={TRUNK_BATCH}, folded once",
                     lambda: fused(x, folded[bf16]))
            _profile_k10_instances([cases[(bf16, s)] for s in (0, 1)])
    stages = [cases[(bf16, s)] for s in (0, 1)]
    kernel = {k: sum(r[k] for r in stages)
              for k in ("ms", "plain_ms", "bound_ms", "cudnn_ms")}
    kernel.update(max_abs_err=max(r["max_abs_err"] for r in stages),
                  bound_by=stages[0]["bound_by"], library_ms=None,
                  ms_fp32_b8=sum(cases[(torch.float32, s)]["ms"] for s in (0, 1)),
                  instances_fused_trunk=apply_instances)
    return apply_counts, launches, kernel


def _write_driver_folds(root: Path) -> dict:
    """Two LOSO folds over 6 synthetic trials (DRIVER_FRAMES), as files: each
    trial through ``save_trial_npz``, train.csv / test.csv and the fold's
    statistics. Returns fold -> (train names, test names)."""
    from med_tpu_torch.data.trials import (
        Trial, compute_fold_stats, load_fold, save_fold_stats, save_trial_npz)

    rng = np.random.default_rng(SEED + 3)
    names = [f"Needle_Passing_{'BCDEFG'[i]}00{i + 1}" for i in range(len(DRIVER_FRAMES))]
    first = root / next(iter(DRIVER_TEST))
    for fold in DRIVER_TEST:
        (root / fold).mkdir(parents=True)
    for name, T in zip(names, DRIVER_FRAMES):
        t = _trial(rng, T, name)
        g = np.repeat(rng.integers(1, 9, T // 40 + 1), 40)[:T]     # gesture runs
        e = np.zeros((T, 5), np.int64)
        e[:, 4] = t.e_powerset[:, -1]
        e[np.arange(T), rng.integers(0, 4, T)] = e[:, 4]           # one error kind a frame
        save_trial_npz(str(first / f"{name}.npz"), Trial(name, t.images, t.kinematics, g, e))
    splits = {}
    for fold, test in DRIVER_TEST.items():
        if root / fold != first:
            for name in names:
                shutil.copy(first / f"{name}.npz", root / fold / f"{name}.npz")
        split = ([n for i, n in enumerate(names) if i not in test], [names[i] for i in test])
        for csv, listed in zip(("train.csv", "test.csv"), split):
            (root / fold / csv).write_text("\n".join(n + ".npz" for n in listed))
        img, kin, _, _, _ = load_fold(str(root / fold), "train.csv")
        save_fold_stats(str(root / fold), compute_fold_stats(img, kin))
        splits[fold] = split
    return splits


def _finite_numbers(obj) -> int:
    """The count of numbers in a JSON value ('0.512 ± 0.031' strings too);
    raises on one that is not finite."""
    if isinstance(obj, dict):
        return sum(_finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return sum(_finite_numbers(v) for v in obj)
    if isinstance(obj, str):
        return _finite_numbers([float(x) for x in obj.replace("±", " ").split()])
    if not math.isfinite(obj):
        raise RuntimeError(f"non-finite number {obj} in a run artifact")
    return 1


def phase_driver():
    """The COG fold driver's command line on the card (phase 7 of the module
    docstring)."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import train_frame

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        splits = _write_driver_folds(root / "data")
        log(f"[driver] {len(splits)} folds of {len(DRIVER_FRAMES)} trials "
            f"({min(DRIVER_FRAMES)}-{max(DRIVER_FRAMES)} frames) written in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = ["--model-name", "COG", "--data-type", "multimodal",
                "--data-root", str(root / "data"), "--runs-root", str(root / "runs"),
                "--folds", ",".join(splits)]
        n_train = sum(len(tr) for tr, _ in splits.values())
        n_test = sum(len(te) for _, te in splits.values())

        def drive(epochs_run: int, *extra):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            results, tracker = train_frame.main([*argv, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            steps, evals = epochs_run * n_train, epochs_run * n_test
            want = {**forward_launches(steps + evals), **backward_launches(steps)}
            log(f"[driver] launches over {steps} train steps and {evals} eval passes: "
                f"{launches} (expected {want})")
            if launches != want:
                raise RuntimeError(f"kernel launches {launches} != {want}")
            return results, tracker, wall, launches

        results, tracker, wall, launches = drive(2, "--n-epochs", "2")
        run = Path(tracker.dir)
        if run.parent != root / "runs" / "COG_5Hz_multimodal":
            raise RuntimeError(f"run directory {run} is not under COG_5Hz_multimodal")
        want_files = {"params.json", "metrics.jsonl", "artifacts/summary.json",
                      "artifacts/windowed_metrics.json"}
        for fold in splits:
            want_files |= {f"artifacts/best_model_LOSO_{fold}.json",
                           f"checkpoints/best_model_LOSO_{fold}.npz",
                           f"checkpoints/best_model_LOSO_{fold}.npz.json",
                           f"checkpoints/last_state_LOSO_{fold}.npz"}
        files = {str(f.relative_to(run)) for f in run.rglob("*") if f.is_file()}
        if files != want_files:
            raise RuntimeError(f"run layout: missing {sorted(want_files - files)}, "
                               f"unexpected {sorted(files - want_files)}")
        params = json.loads((run / "params.json").read_text())
        width = {k: params[k] for k in ("model_name", "data_type", "video_dims", "d_model",
                                        "d_q", "sequence_length", "num_layers_Basic",
                                        "num_layers_R", "num_R", "mstcn_f_maps", "n_epochs")}
        if width != {"model_name": "COG", "data_type": "multimodal", "video_dims": 2048,
                     "d_model": 64, "d_q": 8, "sequence_length": 30, "num_layers_Basic": 11,
                     "num_layers_R": 10, "num_R": 3, "mstcn_f_maps": 64, "n_epochs": 2}:
            raise RuntimeError(f"the driver did not run full-width COG: {width}")
        counted = {name: _finite_numbers(json.loads((run / "artifacts" / name).read_text()))
                   for name in ("summary.json", "windowed_metrics.json")}
        for fold, (_, test) in splits.items():
            best = results[fold]
            n = sum(DRIVER_FRAMES[int(t[-1]) - 1] for t in test)
            _check_served(f"driver fold {fold}", best["preds"], best["probs"], n)
            if not (math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])):
                raise RuntimeError(f"driver fold {fold}: non-finite loss {best}")
        log(f"[driver] run layout ok ({len(files)} files); summary.json holds "
            f"{counted['summary.json']} finite numbers, windowed_metrics.json "
            f"{counted['windowed_metrics.json']}; best test F1 "
            f"{ {f: round(results[f]['test_f1'], 4) for f in splits} }")
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        train_s = sum(r["value"] for r in rows if r["key"] == "train_time")
        # the eval rows come fold by fold, 2 epochs each, as ms per test frame
        test_frames = [sum(DRIVER_FRAMES[i] for i in test) for test in DRIVER_TEST.values()]
        per_frame = [r["value"] for r in rows if r["key"] == "test_inference_ms_per_frame"]
        eval_s = sum(v * test_frames[j // 2] for j, v in enumerate(per_frame)) / 1e3
        log(f"[driver] train_frame.main, {len(splits)} folds x 2 epochs: {wall:.2f} s of "
            f"wall, {wall / len(splits):.2f} s a fold: train steps {train_s:.2f} s, eval "
            f"passes {eval_s:.2f} s, the rest (loading the folds, snapshots, checkpoints "
            f"and artifacts) {wall - train_s - eval_s:.2f} s")

        _, resumed, wall_resume, _ = drive(1, "--n-epochs", "3", "--resume")
        if resumed.dir != tracker.dir:
            raise RuntimeError(f"--resume made a new run {resumed.dir}")
        steps = [json.loads(line)["step"] for line in (run / "metrics.jsonl").read_text()
                 .splitlines() if json.loads(line)["key"] == "epoch"]
        if sorted(steps) != sorted([0, 1, 2] * len(splits)):
            raise RuntimeError(f"--resume --n-epochs 3 did not start at epoch 2: the run's "
                               f"epoch rows are {steps}")
        log(f"[driver] --resume --n-epochs 3 trained epoch 2 alone in every fold "
            f"(epoch rows {steps}): {wall_resume:.2f} s of wall, "
            f"{wall_resume / len(splits):.2f} s a fold")
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
    op_api = phase_op_api()
    serving = phase_serving("--profile" in argv)
    training = phase_training("--profile" in argv)
    fused_trunk, pixels, stage_kernel = phase_pixels("--profile" in argv)
    kernels["resnet_stage"] = stage_kernel
    driver = phase_driver()

    sources = {"swa_packed_fwd": ("med_tpu_torch/csrc/swa_packed_fwd.cu",
                                  "med_tpu/ops/attention.py:390",
                                  "sliding_window_attention_packed"),
               "tcn_stack_fwd/multistack": ("med_tpu_torch/csrc/tcn_stack_fwd.cu",
                                            "med_tpu/ops/tcn_fused.py:750",
                                            "dilated_residual_multistack_stages"),
               "tcn_stack_fwd/stack": ("med_tpu_torch/csrc/tcn_stack_fwd.cu",
                                       "med_tpu/ops/tcn_fused.py:91",
                                       "dilated_residual_stack"),
               "swa_packed_bwd": ("med_tpu_torch/csrc/swa_packed_bwd.cu",
                                  "med_tpu/ops/attention.py:506",
                                  "sliding_window_attention_packed_bwd"),
               "tcn_stack_bwd/multistack": ("med_tpu_torch/csrc/tcn_stack_bwd.cu",
                                            "med_tpu/ops/tcn_fused.py:872",
                                            "dilated_residual_multistack_stages_bwd"),
               "tcn_stack_bwd/stack": ("med_tpu_torch/csrc/tcn_stack_bwd.cu",
                                       "med_tpu/ops/tcn_fused.py:193",
                                       "dilated_residual_stack_bwd"),
               "resnet_stage": ("med_tpu_torch/csrc/resnet_stage.cu",
                                "med_tpu/ops/resnet_fused.py:113",
                                "fused_bottleneck_stage"),
               "tcn_stack_fwd/concatenated": ("med_tpu_torch/csrc/tcn_stack_fwd.cu",
                                              "med_tpu/ops/tcn_fused.py:415",
                                              "dilated_residual_multistack"),
               "tcn_stack_bwd/concatenated": ("med_tpu_torch/csrc/tcn_stack_bwd.cu",
                                              "med_tpu/ops/tcn_fused.py:508",
                                              "dilated_residual_multistack_bwd"),
               "swa_headmajor_fwd": ("med_tpu_torch/csrc/swa_headmajor_fwd.cu",
                                     "med_tpu/ops/attention.py:128",
                                     "sliding_window_attention_pallas"),
               "swa_headmajor_bwd": ("med_tpu_torch/csrc/swa_headmajor_bwd.cu",
                                     "med_tpu/ops/attention.py:212",
                                     "sliding_window_attention_bwd_pallas")}
    # launches: each kernel's own path: one 128-frame batch of
    # resnet50_fused_apply for K10, one forward and backward through the
    # public op entry points for K6-K9, and the training run for the others;
    # every phase's count beside it (the pixel request's trunk is ResNet50;
    # the driver's count is its first run, 2 folds x 2 epochs)
    own_path = {"resnet_stage": fused_trunk, "tcn_stack_fwd/concatenated": op_api,
                "tcn_stack_bwd/concatenated": op_api, "swa_headmajor_fwd": op_api,
                "swa_headmajor_bwd": op_api}
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": own_path.get(name, training)[wrapper],
             "launches_serving": serving[wrapper], "launches_training": training[wrapper],
             "launches_fused_trunk": fused_trunk[wrapper],
             "launches_pixel_request": pixels[wrapper],
             "launches_op_api": op_api[wrapper], "launches_driver": driver[wrapper],
             **kernels[name]}
            for name, (src, rep, wrapper) in sources.items()]
    idle = [k["name"] for k in line if k["launches"] < 1]
    if idle:
        raise RuntimeError(f"kernels never launched on their path: {idle}")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
