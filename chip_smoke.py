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
   port never calls it), by the profiler the one kernel a K1 or K3 call runs
   and its own device time a launch, and two K3 runs equal bit for bit;
   the same for the public op entry points' kernels:
   K6/K7, the multistack with the stacks' weights concatenated on the layer
   axis (with and without dropout mask), and K8/K9, the head-major
   attention and its backward that recomputes the softmax; K1 and K3's D=2
   instances at TransSVNet's encoder shapes (8 heads of width 2, m = W =
   30; the yardstick one ``scaled_dot_product_attention`` call over the
   frames' windows as its batch) and K2b/K5 at one TeCNo stage's stack (8
   layers at C=64 over the whole trial), and again in training at dropout
   rate KEEP_RATE (a Bernoulli keep-mask and the keep scale 1 / (1 -
   rate)), each timed in turns against the same call at rate 0.5's scale
   2 on the same mask; K1 and K3 at the shapes of the
   error-specific regime (ES_ATTENTION: m = 45 and m = 8 queries a frame,
   and 16 heads, a trial group of two; the yardstick the windowed
   library call); then (``[ops]``
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
6. families (``[families]`` lines): TeCNo and TransSVNet as
   `med_tpu.cli.train_frame` configures them (2048-d video features; TeCNo
   2 stages of 8 layers at 64 maps; TransSVNet f_maps 64, 8 heads, len_q 30
   over a frozen TeCNo), seeded weights in the JAX package's checkpoint
   layout: ``FrameModelServer`` (TransSVNet with ``frozen=``) at T = 300,
   1000, 4096 with latency, launch counts and card against CPU
   probabilities at each T; a 2-epoch ``train_frame_fold`` on phase 5's
   trials with launch counts, step time per T, launches per step; one train
   step card against CPU (loss, every gradient leaf);
7. pixels: a full-width ResNet-50 trunk (3, 4, 6, 3) at width 64 with
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
8. driver: two synthetic LOSO folds written with ``save_trial_npz`` (6
   trials of 300-4096 frames, 2048-d features, 26-d kinematics, fold
   statistics), then ``med_tpu_torch.cli.train_frame.main`` at full COG
   width, multimodal, 2 epochs, on the card: every file of the run layout,
   finite numbers in ``summary.json`` and ``windowed_metrics.json``, kernel
   launches against the design; then the same command with ``--resume
   --n-epochs 3``, which must train epoch 2 alone; then the command's
   defaults (TeCNo, 2 epochs) and ``--model-name TransSVNet --run-id`` that
   run, each checked the same way; wall time per fold;
9. es (``[es]`` lines): COG's observed-gesture, skill-prompt and SRM
   variants at full width, served at T = 300, 1000, 4096 (latency,
   launches), card against CPU probabilities, one train step counted and
   one card against CPU; ``med_tpu_torch.cli.train_frame_es.main`` and
   ``train_frame_es_sequential.main --run-id`` phase 8's COG run on phase
   8's folds for 2 epochs (launches with the binary stage's gate passes,
   the run layout, 6-class windowed metrics, wall per fold); COG and TeCNo
   with ``compute_dtype="bfloat16"`` served at T = 4096 (no TCN kernel
   launches; logits within 0.1 of the fp32 model's largest) and trained
   for a 2-epoch fold on phase 5's trials; COG with ``trial_batch=2`` for
   a 2-epoch fold on phase 5's trials (K1 and K3 once a group and layer)
   and one grouped step card against CPU;
10. window (``[window]`` lines): SimpleCNN, SimpleLSTM, Siamese_CNN and
   Siamese_LSTM as ``med_tpu_torch.cli.train_window`` configures them
   (FeatureExtractor 2048 -> 32 and 26 kinematics, B = 512), SimpleCNN at
   15 Hz (30-frame windows, a third conv block), SimpleLSTM with the ES
   and sequential CLIs' heads: one train step each on the card (fp32)
   against the CPU (float64; same weights, batch and dropout masks: loss,
   running statistics, and every gradient leaf with the card's relu,
   max-pool and |f1 - f2| choices pinned to the CPU's; the CPU's fp32
   step and cuDNN's convs and RNN beside it); train-step and eval times
   (also on cuDNN's convs and RNN, a yardstick); a
   2-epoch ``train_window_fold`` of each on phase 8's first fold (the
   twins on 20,000 pairs; SimpleLSTM with ``fused_epoch`` on and off);
   ``train_window.main`` (SimpleLSTM, Siamese_CNN), ``train_window_es.main``
   and ``train_window_es_sequential.main --run-id`` the SimpleLSTM run on
   phase 8's folds; no kernel launched in the whole phase (the window path
   reaches none of the eleven; cuDNN and cuBLAS compute it);
11. ensemble (``[ensemble]`` lines): two SimpleCNN runs (video through the
   FeatureExtractor, and kinematics) by ``train_window.main`` on phase 8's
   folds; ``cli.ensemble.main`` offline (the soft vote of the two with its
   overlap line; the cascade of phase 8's binary COG run over phase 9's
   6-class ES run, whose Needle-Drop-only frames it reconciles) and
   ``--serve --data-root`` with and without ``--int8-fe`` (served decisions
   equal the offline soft vote wherever its probability is clear of 0.5;
   the int8 FE's within 3e-2; 3 int8 launches a request), a B = 512
   request's time each way; raw-frame folds (uint8 224x224 trials of 120,
   200 and 300 frames, phase 7's seeded trunk as each fold's fine-tune
   checkpoint) served by ``--serve --pixels-root`` in bf16, fp32 and
   ``--int8-trunk --int8-fe`` (53 int8 launches a trunk batch) and the
   T = 300 request's latency through each trunk; the int8 kernel
   (``csrc/int8_conv.cu``, not a TPU kernel) against its plain version on
   every conv of a full-width trunk at B = 128 and on the FE's layers at
   B = 512 windows (int32 accumulators equal, int8 codes within one step,
   flips counted), the int8 features against the fp32 trunk (per-row
   cosine, card against CPU bit for bit), its time against its bound and
   the yardsticks (the cuDNN bf16 module trunk; ``torch._int_mm`` with the
   epilogue in PyTorch ops); ``cli.results`` over the two runs (``hist``
   and the drivers' ``images/`` where matplotlib is installed);
12. finetune (``[finetune]`` lines): the full-width ``ResNetClassifier``
   at 224x224 and B = 32 (phase 7's seeded trunk, a head from SEED, a
   padded batch of phase 11's frames): one ``cli.resnet_finetune``
   train step on the card (fp32) against the CPU's float64 step (loss,
   running statistics, every gradient leaf, the card's relu patterns and
   max-pool choices pinned to the CPU's and the flips counted; the CPU's
   fp32 step beside it),
   with train-mode BN, ``--freeze-bn`` and ``bn_stat_stride`` 4;
   ``augment_batch`` on the card against the CPU with the same draws;
   step time (median of 5), frames/s, peak memory and the device's busy
   share, with and without augmentation; ``cli.resnet_finetune.main`` on
   phase 11's raw-frame trials (2 folds, 2 epochs): the run layout, each
   checkpoint served by ``PixelFrontEnd.from_checkpoint`` (its fp32
   features the exported ones), the exported 2048-d folds with each
   trial's length, no TPU kernel launched; the same with ``--int8-trunk``
   (53 int8 launches an export batch); ``cli.train_frame.main`` (COG, 1
   epoch) on the exported folds; the CLIP text tower at ViT-B/32's
   geometry with seeded weights, card against CPU on COG's 15, 45 and 15
   prompts; a COG built with ``MED_TPU_CLIP_CKPT`` set, served at T = 300;
13. parallel (``[parallel]`` lines): two ranks sharing the card over gloo
   (``parallel/launch.py::spawn``; ranks on one card check correctness,
   they do not measure scaling), each holding against the single-rank
   step on the card, same weights, batch and dropout masks, loss to 1e-5
   and every gradient leaf to 1e-5 of its largest with the relu patterns
   pinned to the single-rank run's (as phase 5 pins them): sequence-
   parallel COG at full width on one T = 4096 trial in two shards of 2048
   (K1 and K3 launched on each rank, counted: as many as the single-rank
   step's) and sequence-parallel TeCNo; the SimpleCNN window step (the
   CLI's defaults, B = 512) on meshes (2, 1) and (1, 2) with its running
   statistics; the TeCNo pipeline over 2 refinement stages and 4
   microbatches against the sequential chain, at dropout rates 0.5 and
   KEEP_RATE (its launches counted). The ranks also take a
   trial-parallel COG step (trial_batch 2 on T = 1000 and 1500, one trial
   a rank), which the parent holds, with the card's own grouped step,
   against the CPU's float64 grouped step (itself equal to its one-trial
   steps to 1e-9): loss 1e-5, every leaf within twice the CPU float32
   grouped step's distance (the float32 floor of these sums). Then the
   port's entry dry run at 2 ranks; then, in an NCCL group of one, ``train_frame
   --sequence-parallel`` and ``--trial-dp --trial-batch 2`` on phase 8's
   folds, ``train_window --fold-parallel`` (SimpleCNN) against the
   sequential CLI (histories, wall times, no vmap fallback),
   ``resnet_finetune --mesh 1`` on phase 12's trials; one batched step of
   two folds against each fold's engine step (loss, every gradient) and
   its launches against one fold's; ``FoldParallelWindowRun`` against
   ``train_window_fold`` at lr 0 on phase 8's folds; a TeCNo
   fold epoch at T = 4096 with prefetch depth 2 against 0 and the
   host-to-device copy from pinned and pageable memory; K1 and K3 a launch
   at the SP shard's T = 2048; the SP step at one rank;
14. mimo (``[mimo]`` lines): the packed attention's sink instance
   (``csrc/swa_sink_{fwd,bwd}.cu``) at MiMo-V2-Flash's windowed layers
   (SINK: 8 KV heads, q and k of width 192, v of 128, 8 query heads a KV
   head, a 128-frame window, the keys before frame 0 left out, a sink a
   query slot) at T = 1,536 (the main path's bucket) and 4,096, against
   its plain version on the card (out and stats; dq, dk, dv and the sinks'
   gradient), with its time, the plain version's and the bound, by the
   profiler the kernels a call runs (one forward, two backward) and two
   backward runs equal bit for bit; then ``MiMoV2Flash`` at the published
   cut (layers 0-6, experts 0-7, seeded weights) through one
   ``Experiment.train_step`` and one ``eval_step`` on a 1,200-frame trial
   in the 1,536 bucket, the sink kernels' launches counted from 0 on each;
15. a ``kernels`` JSON line (the eleven TPU kernels' entries, then the
   int8 kernel's, on the int8 trunk's and FE's paths, the trunk's with the
   fine-tune export's launches too; K2b/K5 at KEEP_RATE's scale take the
   rate-0.3 pipeline's launches; then the sink instance's, with the MiMo
   step's and request's launches), then ``{"ok": true, "device": ...}``
   last.
A ``[time]`` line gives each phase's wall time.

Runs from the repository root; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import re
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
       "swa_headmajor_fwd": (1e-4, 1e-5), "swa_headmajor_bwd": (1e-4, 1e-5),
       "swa_packed_fwd/d2": (1e-4, 1e-5), "swa_packed_bwd/d2": (1e-4, 1e-5),
       "tcn_stack_fwd/tecno": (1e-4, 1e-4), "tcn_stack_bwd/tecno": (1e-4, 1e-5),
       **{f"swa_packed_{way}/{shape}": (1e-4, 1e-5) for way in ("fwd", "bwd")
          for shape in ("m45", "m8", "heads16")}}
# MiMo-V2-Flash's windowed layers: the sink instance's one shape, timed at
# the main path's 1,536-frame bucket and a long trial (the JSON line uses
# the last); float32 summed in another order, as K1/K3's
SINK = dict(H=8, dk=192, dv=128, m=8, W=128)
SINK_FRAMES = (1536, 4096)
TOL.update({"swa_sink_fwd": (1e-4, 1e-5), "swa_sink_bwd": (1e-4, 1e-5)})
# a TeCNo stack in training at a dropout rate other than 0.5 (the keep scale
# 1 / (1 - rate)): phase 3's K2b/K5 cases at the rate-0.5 cases' tolerance
# and phase 13's second pipeline step
KEEP_RATE = 0.3
TOL.update({f"{k}_rate{KEEP_RATE}": TOL[k] for k in ("tcn_stack_fwd/tecno",
                                                     "tcn_stack_bwd/tecno")})
# the driver phase: 6 trials, the first 4 train fold 1Out and the last 2 test
# it; fold 2Out tests trials 0 and 3 and trains on the rest
DRIVER_FRAMES = (300, 1000, 2000, 4096, 500, 1500)
DRIVER_TEST = {"1Out": (4, 5), "2Out": (0, 3)}
# card vs CPU train step: loss rtol; per gradient leaf rtol, and atol as a
# fraction of that leaf's own largest |value|. float32 summed in another
# order flips a few relu derivatives of the encoder FFNs (pre-activations
# within rounding of 0), and each flip moves one token's term of Dense_0's
# weight gradient and of every gradient upstream of it; the same happens
# in the TCN stacks' relus (a flip in a slow stage moves that layer's
# weight gradients and everything upstream). So the leaves are held to
# this tolerance with the card's FFN and TCN relu patterns pinned to the
# CPU's; the run without the pins is printed beside it, with the flips and
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


def _device_events(fn, calls: int):
    """The device kernels, copies and fills of ``calls`` calls of ``fn``
    (after a warm call), by the profiler. A session whose trace holds no
    device event at all recorded nothing (seen once in four runs, right
    after another session): it is taken again, at most three sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            break
    return events


def _device_launches(fn, kernel: str, calls: int = 20) -> dict:
    """Raise unless each of ``calls`` calls of ``fn`` ran exactly one device
    kernel, named ``kernel``, by the profiler: no copy, fill or other pass
    beside it. Returns the kernel's own device time a launch (median) as
    ``device_ms`` and, for the log, ``phase_note``. A session that recorded
    fewer events than calls, all of the kernel, is taken again (at most
    three sessions): the profiler has dropped a few of twenty ~30 µs
    launches."""
    for _ in range(3):
        events = _device_events(fn, calls)
        names = sorted({e.name for e in events})
        if len(events) >= calls or any(kernel not in n for n in names):
            break
    if len(events) != calls or any(kernel not in n for n in names):
        raise RuntimeError(f"{kernel}: {len(events)} device kernels in {calls} calls "
                           f"({names}), expected the one kernel a call")
    ms = statistics.median(e.time_range.elapsed_us() for e in events) / 1e3
    return dict(device_ms=ms, phase_note=f"1 launch a call, device {ms:.4f} ms a launch "
                                         f"(profiler, median of {calls})")


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


def _head_major_instances(wrapper, before: dict) -> str:
    """The launches by instance since ``before``, for the log: COG's
    operands are 16-byte aligned, so every launch takes the 16-byte one."""
    now = {k: n - before.get(k, 0) for k, n in wrapper.instances.items()
           if n - before.get(k, 0)}
    if set(now) != {"16-byte"}:
        raise RuntimeError(f"{wrapper.__name__}: launches by instance {now}, expected "
                           f"the 16-byte instance only")
    return f"{now['16-byte']} launches of the 16-byte instance"


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
    fwd = att.sliding_window_attention_pallas
    before = dict(fwd.instances)
    device = _device_launches(run, "swa_headmajor_fwd")
    device["phase_note"] += f"; {_head_major_instances(fwd, before)}"
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1), **device)


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
    _same_bits(f"head-major attention bwd T={T}", run)
    bwd = att.sliding_window_attention_bwd_pallas
    before = dict(bwd.instances)
    device = _device_launches(run, "swa_headmajor_bwd")
    device["phase_note"] += f"; {_head_major_instances(bwd, before)}; two runs equal bit for bit"
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1), **device)


# one TeCNo stage's stack: 8 layers at C=64 over the whole trial
TECNO_STACK = dict(L=8, C=64)


def _tecno_stack_case(T: int, gen: torch.Generator):
    """K2b at one TeCNo stage's shape: one stack of 8 layers at C=64 over
    the whole T-frame trial, one launch; the saving forward with a dropout
    mask (a train step's) beside it."""
    from med_tpu_torch.ops import tcn_fused as tcn

    L, C = TECNO_STACK["L"], TECNO_STACK["C"]
    (w,) = _stage_weights(gen, (L,), C)
    x = torch.randn((T, C), generator=gen).cuda()
    mask = torch.randint(0, 2, (L, T, C), generator=gen, dtype=torch.uint8).cuda()
    run = lambda: tcn.dilated_residual_stack(x, *w)  # noqa: E731
    plain = lambda: tcn.dilated_stack_xla(x, *w)  # noqa: E731
    err = check_close(f"TeCNo stack T={T}", run(), plain(), *TOL["tcn_stack_fwd/tecno"])
    saving = lambda: tcn._stages_fwd(x, [w], [mask], True,  # noqa: E731
                                     tcn.dilated_residual_stack, save=True)
    nbytes, flops = _tcn_flops_bytes(T, C, (L,), 1, 1)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, saving_ms=cuda_ms(saving, 20),
                **_barrier_floor(tcn.dilated_residual_stack, (L,)),
                **_device_launches(run, "tcn_stack_kernel"))


def _tecno_stack_bwd_case(T: int, gen: torch.Generator):
    """K5 at one TeCNo stage's shape (TECNO_STACK over T frames), with a
    dropout mask; two runs equal bit for bit."""
    from med_tpu_torch.ops import tcn_fused as tcn

    L, C = TECNO_STACK["L"], TECNO_STACK["C"]
    (w,) = _stage_weights(gen, (L,), C)
    mask = torch.randint(0, 2, (L, T, C), generator=gen, dtype=torch.uint8).cuda()
    x = torch.randn((T, C), generator=gen).cuda()
    g = torch.randn((T, C), generator=gen).cuda()
    _, h, y = tcn._stages_fwd(x, [w], [mask], True, tcn.dilated_residual_stack, save=True)
    run = lambda: tcn.dilated_residual_stack_bwd(g, h, y, w[0], w[2], mask=mask)  # noqa: E731
    plain = lambda: tcn._stages_bwd_plain(g[None], h, y, [(w[0], w[2])], [mask], True)  # noqa: E731
    rtol, atol = TOL["tcn_stack_bwd/tecno"]
    got, (p_dx, (p_dw,)) = run(), plain()
    err = max(check_grads(f"TeCNo stack bwd T={T} {n}", [a], [b], rtol, atol)
              for n, a, b in zip(("dx", "dw3", "db3", "dw1", "db1"), got, (p_dx, *p_dw)))
    _same_bits(f"TeCNo stack bwd T={T}", run)
    nbytes, flops = _tcn_bwd_flops_bytes(T, C, (L,), 1, 1)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **_bwd_barrier_floor(tcn.dilated_residual_stack_bwd, [(L, T)]),
                **_device_launches(run, "tcn_bwd_kernel"))


def _keep_scale_inputs(T: int):
    """TECNO_STACK's weights, x, a cotangent and a Bernoulli(1 - KEEP_RATE)
    keep-mask over T frames, from a generator of their own (the cases
    before and after them draw what they drew before), and the scale."""
    from med_tpu_torch.models.layers import keep_scale

    gen = torch.Generator().manual_seed(SEED + T)
    L, C = TECNO_STACK["L"], TECNO_STACK["C"]
    (w,) = _stage_weights(gen, (L,), C)
    x, g = (torch.randn((T, C), generator=gen).cuda() for _ in range(2))
    mask = (torch.rand((L, T, C), generator=gen) < 1 - KEEP_RATE).to(torch.uint8).cuda()
    return w, x, g, mask, keep_scale(KEEP_RATE)


def _in_turns(run, at_2, iters: int) -> tuple:
    """ms of ``run`` and of ``at_2`` timed in turns (run, at_2, run, at_2):
    each the mean of its two timings."""
    ms = [cuda_ms(f, iters) for f in (run, at_2, run, at_2)]
    return (ms[0] + ms[2]) / 2, (ms[1] + ms[3]) / 2


def _tecno_stack_scale_case(T: int, gen: torch.Generator):
    """K2b at TECNO_STACK in a training forward at dropout rate KEEP_RATE:
    the keep-mask and the keep scale 1 / (1 - rate), against its plain
    version; the same call at scale 2 on the same mask timed in turns."""
    from med_tpu_torch.ops import tcn_fused as tcn

    w, x, _, mask, scale = _keep_scale_inputs(T)
    L, C = TECNO_STACK["L"], TECNO_STACK["C"]
    run = lambda: tcn.dilated_residual_stack(x, *w, mask=mask, scale=scale)  # noqa: E731
    plain = lambda: tcn.dilated_stack_xla(x, *w, mask=mask, scale=scale)  # noqa: E731
    at_2 = lambda: tcn.dilated_residual_stack(x, *w, mask=mask)  # noqa: E731
    err = check_close(f"TeCNo stack at scale {scale:.7f} T={T}", run(), plain(),
                      *TOL[f"tcn_stack_fwd/tecno_rate{KEEP_RATE}"])
    ms, ms_2 = _in_turns(run, at_2, 20)
    nbytes, flops = _tcn_flops_bytes(T, C, (L,), 1, 1)
    b_ms, b_by = bound(nbytes + L * T * C, flops)       # the uint8 mask read once
    device = _device_launches(run, "tcn_stack_kernel")
    device_2 = _device_launches(at_2, "tcn_stack_kernel")["device_ms"]
    device["phase_note"] += (f"; scale {scale:.7f} (rate {KEEP_RATE}); the same call at "
                             f"scale 2 on the same mask {ms_2:.4f} ms, timed in turns, "
                             f"device {device_2:.4f} ms a launch")
    return dict(run=run, max_abs_err=err, ms=ms, ms_scale_2=ms_2,
                device_ms_scale_2=device_2, plain_ms=cuda_ms(plain, 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, **device)


def _tecno_stack_bwd_scale_case(T: int, gen: torch.Generator):
    """K5 at TECNO_STACK behind a training forward at dropout rate
    KEEP_RATE (keep-mask, scale 1 / (1 - rate)), against its plain
    version; two runs equal bit for bit; the same call at scale 2 on the
    same saved activations timed in turns."""
    from med_tpu_torch.ops import tcn_fused as tcn

    w, x, g, mask, scale = _keep_scale_inputs(T)
    L, C = TECNO_STACK["L"], TECNO_STACK["C"]
    _, h, y = tcn._stages_fwd(x, [w], [mask], True, tcn.dilated_residual_stack, save=True,
                              scale=scale)
    run = lambda: tcn.dilated_residual_stack_bwd(  # noqa: E731
        g, h, y, w[0], w[2], mask=mask, scale=scale)
    plain = lambda: tcn._stages_bwd_plain(  # noqa: E731
        g[None], h, y, [(w[0], w[2])], [mask], True, scale)
    at_2 = lambda: tcn.dilated_residual_stack_bwd(g, h, y, w[0], w[2], mask=mask)  # noqa: E731
    rtol, atol = TOL[f"tcn_stack_bwd/tecno_rate{KEEP_RATE}"]
    got, (p_dx, (p_dw,)) = run(), plain()
    err = max(check_grads(f"TeCNo stack bwd at scale {scale:.7f} T={T} {n}", [a], [b],
                          rtol, atol)
              for n, a, b in zip(("dx", "dw3", "db3", "dw1", "db1"), got, (p_dx, *p_dw)))
    _same_bits(f"TeCNo stack bwd at scale {scale:.7f} T={T}", run)
    ms, ms_2 = _in_turns(run, at_2, 10)
    nbytes, flops = _tcn_bwd_flops_bytes(T, C, (L,), 1, 1)
    b_ms, b_by = bound(nbytes, flops)
    device = _device_launches(run, "tcn_bwd_kernel")
    device_2 = _device_launches(at_2, "tcn_bwd_kernel")["device_ms"]
    device["phase_note"] += (f"; scale {scale:.7f} (rate {KEEP_RATE}); two runs equal bit "
                             f"for bit; the same call at scale 2 {ms_2:.4f} ms, timed in "
                             f"turns, device {device_2:.4f} ms a launch")
    return dict(run=run, max_abs_err=err, ms=ms, ms_scale_2=ms_2,
                device_ms_scale_2=device_2, plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, **device)


# K1 and K3's cases: heads, head width, queries a frame and window; the
# key frames (COG's visual sequence has W - 1 pad frames before the T of
# the trial, TransSVNet's keys are the T frames); the library yardstick:
# one scaled_dot_product_attention call with a band mask over all frames,
# or over the frames' windows as its batch where the band mask's scores
# would not fit (TransSVNet's at T=4096: 16 GB; m = 45: 25 GB). Beside
# COG's own shape: TransSVNet's encoder (8 heads of its 2 classes, each of
# a frame's m = 30 window positions attending the W = 30 frames of its
# window), COG's skill-prompt (m = 45) and observed-gesture (m = 8) tables
# and a trial group of two on the head axis (16 heads)
PACKED = {"cog": dict(H=8, d=8, m=15, W=30, pad=True, library="band"),
          "d2": dict(H=8, d=2, m=30, W=30, pad=False, library="windows"),
          "m45": dict(H=8, d=8, m=45, W=30, pad=True, library="windows"),
          "m8": dict(H=8, d=8, m=8, W=30, pad=True, library="windows"),
          "heads16": dict(H=16, d=8, m=15, W=30, pad=True, library="windows")}
ES_ATTENTION = ("m45", "m8", "heads16")


def _windowed_sdpa(q, k, v, W: int, m: int):
    """The frames' windows as the library call's batch: (F, H, m, d) queries
    against (F, H, W, d) keys and values (the windows of the zero-padded
    key frames, as views), no mask."""
    H, d, Fk = k.shape
    q4 = q.reshape(H, d, Fk, m).permute(2, 0, 3, 1)
    kw, vw = (F.pad(x, (W - 1, 0)).unfold(2, W, 1).permute(2, 0, 3, 1) for x in (k, v))
    return q4, kw, vw


def _yardstick(q, k, v, shape: str):
    """PACKED[shape]'s library call: (its leaves, the call, its output in
    the packed (H, d, N) layout, a packed cotangent in its output's)."""
    s = PACKED[shape]
    H, d, Fk = k.shape
    W, m = s["W"], s["m"]
    if s["library"] == "windows":
        return (_windowed_sdpa(q, k, v, W, m), F.scaled_dot_product_attention,
                lambda o: o.permute(1, 3, 0, 2).reshape(H, d, Fk * m),
                lambda g: g.reshape(H, d, Fk, m).permute(2, 0, 3, 1))
    leaves = (q.permute(0, 2, 1)[None], F.pad(k, (W - 1, 0)).permute(0, 2, 1)[None],
              F.pad(v, (W - 1, 0)).permute(0, 2, 1)[None])
    frame = torch.arange(Fk * m, device="cuda")[:, None] // m
    col = torch.arange(Fk + W - 1, device="cuda")[None, :]
    band = (col >= frame) & (col < frame + W)
    return (leaves, lambda *x: F.scaled_dot_product_attention(*x, attn_mask=band),
            lambda o: o[0].permute(0, 2, 1), lambda g: g.permute(0, 2, 1)[None])


def _packed_inputs(shape: str, T: int, gen: torch.Generator, grad: bool = False):
    s = PACKED[shape]
    H, d = s["H"], s["d"]
    Fk = T + s["W"] - 1 if s["pad"] else T
    N = Fk * s["m"]
    shapes = [(H, d, N), (H, d, Fk), (H, d, Fk)] + ([(H, d, N)] if grad else [])
    return [torch.randn(sh, generator=gen).cuda() for sh in shapes]


def _attention_case(shape: str, T: int, gen: torch.Generator):
    """K1 at PACKED[shape] over a T-frame trial, one launch a call, against
    its plain version and the library yardstick."""
    from med_tpu_torch.ops.attention import (
        sliding_window_attention_packed, sliding_window_attention_packed_plain)

    s = PACKED[shape]
    H, d, m, W = s["H"], s["d"], s["m"], s["W"]
    q, k, v = _packed_inputs(shape, T, gen)
    Fk, N = k.shape[2], q.shape[2]
    out, stats = sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    p_out, p_stats = sliding_window_attention_packed_plain(q, k, v, W, m)
    tol = TOL["swa_packed_fwd"]
    err = max(check_close(f"attention {shape} T={T} out", out, p_out, *tol),
              check_close(f"attention {shape} T={T} stats", stats, p_stats, *tol))
    leaves, call, packed, _ = _yardstick(q, k, v, shape)
    lib = lambda: call(*leaves)  # noqa: E731
    # sanity only: the library may take other summation paths
    check_close(f"attention {shape} T={T} library yardstick", packed(lib()), out, 5e-3, 5e-3)
    # bytes: q read, out and stats written per query; k, v read per key
    # frame. Operations per (query, key) pair: score and values 2d each, ~4
    # for the exp and the sums
    nbytes = 4 * (2 * H * d * N + 2 * H * d * Fk + 2 * H * N)
    flops = H * N * W * (4 * d + 4)
    b_ms, b_by = bound(nbytes, flops)
    run = lambda: sliding_window_attention_packed(q, k, v, W, m)  # noqa: E731
    return dict(
        run=run, max_abs_err=err, ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: sliding_window_attention_packed_plain(q, k, v, W, m), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1),
        **_device_launches(run, "swa_packed_fwd"))


def _attention_bwd_case(shape: str, T: int, gen: torch.Generator):
    """K3 at PACKED[shape], a cotangent on every query, against its plain
    version and the library call's autograd backward (to its leaves: the
    windowed keys' gradients stay per window slot); two runs equal bit for
    bit."""
    from med_tpu_torch.ops.attention import (
        sliding_window_attention_packed, sliding_window_attention_packed_bwd,
        sliding_window_attention_packed_bwd_plain)

    s = PACKED[shape]
    H, d, m, W = s["H"], s["d"], s["m"], s["W"]
    q, k, v, g = _packed_inputs(shape, T, gen, grad=True)
    Fk, N = k.shape[2], q.shape[2]
    out, stats = sliding_window_attention_packed(q, k, v, W, m, return_stats=True)
    run = lambda: sliding_window_attention_packed_bwd(q, k, v, g, out, stats, W, m)  # noqa: E731
    plain = lambda: sliding_window_attention_packed_bwd_plain(  # noqa: E731
        q, k, v, g, out, stats, W, m)
    rtol, atol = TOL["swa_packed_bwd"]
    err = max(check_grads(f"attention {shape} bwd T={T} {n}", [a], [b], rtol, atol)
              for n, a, b in zip(("dq", "dk", "dv"), run(), plain()))
    leaves, call, packed, cotangent = _yardstick(q, k, v, shape)
    leaves = [t.detach().requires_grad_() for t in leaves]
    lib_out = call(*leaves)
    lib = lambda: torch.autograd.grad(lib_out, leaves, cotangent(g),  # noqa: E731
                                      retain_graph=True)
    check_close(f"attention {shape} bwd T={T} library yardstick dq",
                packed(lib()[0]), run()[0], 5e-3, 5e-3)
    # bytes: q, g and out read, the lse row of stats read, dq written (per
    # query; delta = out.g is formed from out, so stats' second row is not
    # read); k, v read, dk, dv written (per key frame). Operations per
    # (query, key) pair: score, g.v, dq, dk, dv (2d each) and ~4 for a, ds
    nbytes = 4 * (4 * H * d * N + H * N + 4 * H * d * Fk)
    flops = H * N * W * (10 * d + 4) + 2 * H * d * N
    b_ms, b_by = bound(nbytes, flops)
    _same_bits(f"attention {shape} bwd T={T}", run)
    device = _device_launches(run, "swa_packed_bwd")
    device["phase_note"] += "; two runs equal bit for bit"
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 3, warmup=1), **device)


KERNEL_CASES = (("swa_packed_fwd", functools.partial(_attention_case, "cog")),
                ("tcn_stack_fwd/multistack", _multistack_case),
                ("tcn_stack_fwd/stack", _fast_stacks_case),
                ("swa_packed_bwd", functools.partial(_attention_bwd_case, "cog")),
                ("tcn_stack_bwd/multistack", _multistack_bwd_case),
                ("tcn_stack_bwd/stack", _fast_stacks_bwd_case),
                ("tcn_stack_fwd/concatenated", _concat_multistack_case),
                ("tcn_stack_bwd/concatenated", _concat_multistack_bwd_case),
                ("swa_headmajor_fwd", _head_major_case),
                ("swa_headmajor_bwd", _head_major_bwd_case),
                *((f"swa_packed_{way}/{shape}", functools.partial(case, shape))
                  for shape in ("d2",)
                  for way, case in (("fwd", _attention_case), ("bwd", _attention_bwd_case))),
                ("tcn_stack_fwd/tecno", _tecno_stack_case),
                ("tcn_stack_bwd/tecno", _tecno_stack_bwd_case),
                (f"tcn_stack_fwd/tecno_rate{KEEP_RATE}", _tecno_stack_scale_case),
                (f"tcn_stack_bwd/tecno_rate{KEEP_RATE}", _tecno_stack_bwd_scale_case),
                *((f"swa_packed_{way}/{shape}", functools.partial(case, shape))
                  for way, case in (("fwd", _attention_case), ("bwd", _attention_bwd_case))
                  for shape in ES_ATTENTION))


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


def _sink_inputs(T: int, gen: torch.Generator):
    """q (H, dk, T*m), k (H, dk, T), v (H, dv, T), a cotangent (H, dv, T*m)
    and sinks (H, m) at twice the scores' scale, so that they weigh in."""
    H, dk, dv, m = SINK["H"], SINK["dk"], SINK["dv"], SINK["m"]
    shapes = ((H, dk, T * m), (H, dk, T), (H, dv, T), (H, dv, T * m))
    return ([torch.randn(sh, generator=gen).cuda() for sh in shapes]
            + [(2.0 * torch.randn((H, m), generator=gen)).cuda()])


def _sink_pairs(T: int) -> int:
    """(query, key) pairs the sink instance scores: each of the H*m query
    slots of frame t over min(t + 1, W) keys (those before frame 0 left
    out)."""
    W = SINK["W"]
    return SINK["H"] * SINK["m"] * sum(min(t + 1, W) for t in range(T))


def _kernels_a_call(fn, kernel: str, per_call: int, calls: int = 20) -> dict:
    """Raise unless each of ``calls`` calls of ``fn`` ran exactly
    ``per_call`` device kernels, all named ``kernel``, by the profiler: no
    copy, fill or other pass beside them. Returns their summed device time a
    call (median over the calls of each launch in turn)."""
    for _ in range(3):
        events = _device_events(fn, calls)
        names = sorted({e.name for e in events})
        if len(events) >= calls * per_call or any(kernel not in n for n in names):
            break
    if len(events) != calls * per_call or any(kernel not in n for n in names):
        raise RuntimeError(f"{kernel}: {len(events)} device kernels in {calls} calls "
                           f"({names}), expected {per_call} a call")
    events = sorted(events, key=lambda e: e.time_range.start)
    ms = sum(statistics.median(e.time_range.elapsed_us() for e in events[i::per_call])
             for i in range(per_call)) / 1e3
    return dict(device_ms=ms, phase_note=f"{per_call} launch(es) a call, device {ms:.4f} ms "
                                         f"a call (profiler, median of {calls})")


def _sink_case(T: int, gen: torch.Generator):
    """The sink instance's forward against its plain version on the card."""
    from med_tpu_torch.ops.attention import (
        sliding_window_attention_packed_plain, sliding_window_attention_sink)

    H, dk, dv, m, W = (SINK[k] for k in ("H", "dk", "dv", "m", "W"))
    q, k, v, _, b = _sink_inputs(T, gen)
    N = q.shape[2]
    run = lambda: sliding_window_attention_sink(q, k, v, b, W, m, True)  # noqa: E731
    plain = lambda: sliding_window_attention_packed_plain(q, k, v, W, m, True, b)  # noqa: E731
    tol = TOL["swa_sink_fwd"]
    (out, stats), (p_out, p_stats) = run(), plain()
    err = max(check_close(f"sink T={T} out", out, p_out, *tol),
              check_close(f"sink T={T} stats", stats, p_stats, *tol))
    # bytes: q read, out and stats written per query; k, v read per frame.
    # Operations a scored pair: the score 2dk, the value 2dv, ~4 for the
    # exp and the sums
    nbytes = 4 * (H * (dk + dv + 2) * N + H * (dk + dv) * T)
    flops = _sink_pairs(T) * (2 * dk + 2 * dv + 4)
    b_ms, b_by = bound(nbytes, flops)
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **_kernels_a_call(run, "swa_sink_fwd", 1))


def _sink_bwd_case(T: int, gen: torch.Generator):
    """The sink instance's backward (dq, dk, dv and the sinks' gradient)
    against its plain version on the card, from the kernel's own forward;
    two runs equal bit for bit."""
    from med_tpu_torch.ops.attention import (
        sliding_window_attention_packed_bwd_plain, sliding_window_attention_sink,
        sliding_window_attention_sink_bwd)

    H, dk, dv, m, W = (SINK[k] for k in ("H", "dk", "dv", "m", "W"))
    q, k, v, g, b = _sink_inputs(T, gen)
    N = q.shape[2]
    out, stats = sliding_window_attention_sink(q, k, v, b, W, m, True)
    run = lambda: sliding_window_attention_sink_bwd(  # noqa: E731
        q, k, v, g, out, stats, b, W, m, True)
    plain = lambda: sliding_window_attention_packed_bwd_plain(  # noqa: E731
        q, k, v, g, out, stats, W, m, True, b)
    rtol, atol = TOL["swa_sink_bwd"]
    err = max(check_grads(f"sink bwd T={T} {n}", [a], [c], rtol, atol)
              for n, a, c in zip(("dq", "dk", "dv", "dsinks"), run(), plain()))
    # bytes: q, g, out and the stats read, dq written (per query); k, v
    # read, dk, dv written (per frame). Operations a pair: the score 2dk,
    # g.v 2dv, dv 2dv, dq 2dk, dk 2dk, ~4 for the probability and dS
    nbytes = 4 * (H * (2 * dk + 2 * dv + 2) * N + 2 * H * (dk + dv) * T)
    flops = _sink_pairs(T) * (6 * dk + 4 * dv + 4)
    b_ms, b_by = bound(nbytes, flops)
    _same_bits(f"sink bwd T={T}", run)
    device = _kernels_a_call(run, "swa_sink_bwd", 2)
    device["phase_note"] += "; two runs equal bit for bit"
    return dict(run=run, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, **device)


SINK_CASES = (("swa_sink_fwd", _sink_case), ("swa_sink_bwd", _sink_bwd_case))


def _sink_launches() -> dict:
    from med_tpu_torch.ops import attention as att

    return {"swa_sink_fwd": att.sliding_window_attention_sink.launches,
            "swa_sink_bwd": att.sliding_window_attention_sink_bwd.launches}


def _reset_sink_launches() -> None:
    from med_tpu_torch.ops import attention as att

    att.sliding_window_attention_sink.launches = 0
    att.sliding_window_attention_sink_bwd.launches = 0


def _mimo_launches(profile: bool) -> dict:
    """MiMoV2Flash at the published cut, one train step and one served
    pass on a 1,200-frame trial in the 1,536 bucket, the sink kernels'
    launches counted from 0 before each: one forward a windowed layer, two
    backward launches a windowed layer in the step."""
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.data.datasets import FrameTrial, frame_batch
    from med_tpu_torch.models.mimo import MiMoArch
    from med_tpu_torch.train.engine import Experiment

    cfg = ExperimentConfig(model_name="MiMoV2Flash", dataset_type="frame",
                           data_type="multimodal", video_dims=2048, out_features=2,
                           batch_size=1, lr=1e-5, weight_decay=0.0, lr_scheduler=False)
    torch.cuda.reset_peak_memory_stats()
    exp = Experiment(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():                  # seeded weights drawn on the card
        for name, p in exp.net.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                bound_ = 1.0 / math.sqrt(p.shape[-1]) if p.dim() > 1 else 0.1
                p.uniform_(-bound_, bound_, generator=gen)
    rng = np.random.default_rng(SEED)
    T = 1200
    labels = (np.arange(T) // 40) % 2
    trial = FrameTrial(name="Suturing_B001",
                       images=rng.normal(size=(T, 2048)).astype(np.float32),
                       kinematics=rng.normal(size=(T, 26)).astype(np.float32),
                       g_labels=np.zeros(T, np.int64),
                       e_powerset=np.concatenate([np.zeros((T, 6), np.int32),
                                                  labels[:, None].astype(np.int32)], 1),
                       skill=np.zeros((T, 3), np.float32))
    batch = frame_batch(trial, cfg, bucket=1536)
    windowed = MiMoArch().pattern.count("W")
    exp.train_step(batch)                   # warm: cuBLAS's plans, the allocator
    torch.cuda.synchronize()
    _reset_sink_launches()
    t0 = time.perf_counter()
    m = exp.train_step(batch)
    loss = float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    step = _sink_launches()
    _reset_sink_launches()
    out = exp.eval_step({k: batch[k] for k in ("images", "kinematics")})
    probs = out["probs"].cpu()
    request = _sink_launches()
    if profile:
        _profile("MiMoV2Flash train step T=1536", lambda: exp.train_step(batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del exp, out
    torch.cuda.empty_cache()
    want_step = {"swa_sink_fwd": windowed, "swa_sink_bwd": 2 * windowed}
    want_request = {"swa_sink_fwd": windowed, "swa_sink_bwd": 0}
    log(f"[mimo] MiMoV2Flash at the published cut ({windowed} windowed layers): sink launches "
        f"a train step {step} (expected {want_step}), a served pass {request} (expected "
        f"{want_request}); loss {loss:.6f}, step {step_ms:.1f} ms (host clock, the step "
        f"returns after its loss is read), peak {peak:.2f} GB")
    if step != want_step or request != want_request:
        raise RuntimeError(f"sink launches {step}, {request} != {want_step}, {want_request}")
    if not (math.isfinite(loss) and torch.isfinite(probs).all()):
        raise RuntimeError("non-finite MiMo loss or probabilities on the card")
    return {"step": step, "request": request}


def phase_mimo(profile: bool):
    """MiMo-V2-Flash's sink instance and its launches (phase 14 of the
    module docstring)."""
    gen = torch.Generator().manual_seed(SEED + 3)
    results = {}
    for T in SINK_FRAMES:
        for name, case in SINK_CASES:
            r = case(T, gen)
            if profile and T == SINK_FRAMES[-1]:
                _profile(f"{name} T={T}", r.pop("run"))
            r.pop("run", None)
            phase_note = r.pop("phase_note")
            results[name] = r
            rtol, atol = TOL[name]
            atol_txt = f"{atol} x max|want|" if "bwd" in name else f"{atol}"
            log(f"[mimo] {name} at T={T}: max_abs_err {r['max_abs_err']:.3e} "
                f"(tol rtol {rtol}, atol {atol_txt}), kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library null ms; {phase_note}")
    torch.cuda.empty_cache()
    return results, _mimo_launches(profile)


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


def _check_served(name: str, preds, probs, T: int, classes: int = 2, first: int = 0) -> None:
    """Raise unless T predictions and probabilities agree: binary, the class-1
    probability (T,) and predictions 0/1; else every class's (T, classes),
    rows summing to 1, and predictions ``first`` + their argmax (the
    sequential stage predicts error classes 1..5)."""
    want = (T,) if classes == 2 else (T, classes)
    if preds.shape != (T,) or probs.shape != want:
        raise RuntimeError(f"{name}: shapes {preds.shape}, {probs.shape} != ({T},), {want}")
    if not np.isfinite(probs).all() or probs.min() < 0 or probs.max() > 1:
        raise RuntimeError(f"{name}: probabilities outside [0, 1]")
    if not set(np.unique(preds)) <= set(range(first, first + classes)):
        raise RuntimeError(f"{name}: predictions outside {first}..{first + classes - 1}")
    if classes == 2:
        disagree = preds != (probs > 0.5)
        sure = np.abs(probs - 0.5) > 1e-6
    else:
        if np.abs(probs.sum(axis=1) - 1).max() > 1e-4:
            raise RuntimeError(f"{name}: class probabilities do not sum to 1")
        top = np.sort(probs, axis=1)
        disagree = preds - first != probs.argmax(axis=1)
        sure = top[:, -1] - top[:, -2] > 1e-6
    if bool((disagree & sure).any()):
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
    """Backward launches of n COG train steps: one K3 per attention layer
    (one cooperative launch that also forms delta = out.g);
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


def _step_gradients(cfg, batch, masks, device: str, frozen=None):
    """Loss and every gradient leaf (JAX tree paths) of one train step, from
    seeded weights (``masks`` None: TransSVNet, which has no dropout)."""
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    exp = Experiment(cfg, device=device)
    exp.init_weights(SEED)
    if frozen is not None:
        exp.load_frozen(frozen)
    dev_masks = None if masks is None else {
        n: {k: v.to(exp.device) for k, v in d.items()} for n, d in masks.items()}
    loss, _ = exp.compute_gradients(batch, masks=dev_masks)
    tree = export_jax_params(exp.net, grads=True)["params"]
    return loss.item(), {k: torch.from_numpy(v) for k, v in _flat(tree).items()}


def _step_gradients64(cfg, batch, masks):
    """:func:`_step_gradients` on the CPU in float64, from the same seeded
    weights: the model built at compute type float64 (its TCN stacks as
    plain ops), the net, the batch and the masks in float64; the stages
    hand their logits to the loss in float32, as they do at every compute
    type. Leaves whose gradient is 0 (the slow stages' dead class convs)
    are left out."""
    from med_tpu_torch import models
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    plain = models.compute_dtype
    models.compute_dtype = lambda _: torch.float64
    try:
        exp = Experiment(cfg, device="cpu")
    finally:
        models.compute_dtype = plain
    exp.init_weights(SEED)
    exp.net.double()
    tensors = exp._tensors
    wide = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    exp._tensors = lambda b: {k: wide(v) for k, v in tensors(b).items()}
    loss, _ = exp.compute_gradients(
        batch, masks={n: {k: wide(v) for k, v in d.items()} for n, d in masks.items()})
    tree = export_jax_params(exp.net, grads=True)["params"]
    return loss.item(), {k: torch.from_numpy(np.asarray(v, np.float64))
                         for k, v in _flat(tree).items() if np.abs(v).max() > 0}


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


@contextlib.contextmanager
def _tcn_relu(record=None, pin=None, flips=None):
    """The TCN stacks' counterpart of :func:`_ffn_relu`: within the block,
    every saving TCN forward (one a slow path, one a fast stack, in call
    order) appends its saved post-relu activations y to ``record``, or,
    given ``pin``, hands the backward its y with the relu pattern of the
    same call in another run (where that run's y is 0, 0; where it is
    positive and this one's is not, that run's value) and appends (flipped
    entries, their largest |y| over the call's largest) to ``flips``. The
    forward's own outputs are untouched: only the derivative the backward
    reads from y is pinned."""
    from med_tpu_torch.ops import tcn_fused

    plain = tcn_fused._stages_fwd
    calls = iter(range(1 << 30))

    def stages_fwd(x, stage_weights, masks, causal, counter, save, scale=2.0):
        out = plain(x, stage_weights, masks, causal, counter, save, scale)
        if not save:
            return out
        hs, h_saved, y_saved = out
        if pin is None:
            record.append(y_saved.cpu())
            return out
        other = pin[next(calls)].to(y_saved.device)
        flip = (other > 0) != (y_saved > 0)
        near = (torch.maximum(other.abs(), y_saved.abs())[flip].max().item()
                if bool(flip.any()) else 0.0)
        flips.append((int(flip.sum()), near / y_saved.abs().max().item()))
        pinned = torch.where(other > 0, torch.where(y_saved > 0, y_saved, other),
                             torch.zeros_like(y_saved))
        return hs, h_saved, pinned.contiguous()

    tcn_fused._stages_fwd = stages_fwd
    try:
        yield
    finally:
        tcn_fused._stages_fwd = plain


def _step_inputs(cfg, trials):
    """A train step's batch and dropout masks (drawn on the CPU from SEED):
    one trial's, or with ``trial_batch`` > 1 the group of ``trials`` padded
    to one 256-frame bucket."""
    from med_tpu_torch.data.datasets import bucket_length, frame_batch
    from med_tpu_torch.train.engine import Experiment

    model = Experiment(cfg, device="cpu").net.model
    if cfg.trial_batch <= 1:
        batch = frame_batch(trials[0], cfg)
        return batch, model.dropout_masks(batch["images"].shape[1],
                                          torch.Generator().manual_seed(SEED))
    bucket = bucket_length(max(t.n_frames for t in trials))
    batches = [frame_batch(t, cfg, bucket=bucket) for t in trials]
    group = {k: np.stack([b[k] for b in batches]) for k in batches[0] if not k.startswith("_")}
    group["trial_weight"] = np.ones(len(trials), np.float32)
    return group, model.dropout_masks(bucket, torch.Generator().manual_seed(SEED),
                                      B=len(trials))


def _card_vs_cpu_step(cfg, trials, tag: str = "[training]") -> None:
    """One train step at full width on the card and on the CPU, same weights
    and dropout masks (one trial, or a group of ``trials``): the loss must
    agree, and every gradient leaf once the card's encoder FFN and TCN relu
    patterns are pinned to the CPU's (TRAIN_TOL)."""
    batch, masks = _step_inputs(cfg, trials)
    patterns, flips, tcn_patterns, tcn_flips = [], [], [], []
    with _ffn_relu(record=patterns), _tcn_relu(record=tcn_patterns):
        cpu_loss, cpu = _step_gradients(cfg, batch, masks, "cpu")
    card_loss, card = _step_gradients(cfg, batch, masks, "cuda")
    with _ffn_relu(pin=patterns, flips=flips), _tcn_relu(pin=tcn_patterns, flips=tcn_flips):
        _, pinned = _step_gradients(cfg, batch, masks, "cuda")

    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    frames = "+".join(str(t.n_frames) for t in trials)
    log(f"{tag} card vs CPU train step at T={frames}: loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {rel:.2e}, tol {TRAIN_TOL['loss']}); "
        f"encoder FFN relu flips per call {[n for n, _ in flips]} of "
        f"{patterns[0].numel()}, at |pre-activation| up to "
        f"{max(r for _, r in flips):.2e} of the call's largest (tol {FLIP_PRE}); "
        f"TCN relu flips per saving forward {[n for n, _ in tcn_flips]}, at |y| up to "
        f"{max(r for _, r in tcn_flips):.2e} of the call's largest")
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
        log(f"{tag}   {n}: {free:.2e} free, {pin_rel:.2e} pinned")
    log(f"{tag} {len(rows)} gradient leaves: {sum(r[0] > TRAIN_TOL['grad_atol'] for r in rows)}"
        f" off the CPU by more than {TRAIN_TOL['grad_atol']} of their max with the relu "
        f"pattern free, largest pinned {max(r[1] for r in rows):.2e} (tol rtol "
        f"{TRAIN_TOL['grad_rtol']}, atol {TRAIN_TOL['grad_atol']} x leaf max, every leaf)")
    if rel > TRAIN_TOL["loss"]:
        raise RuntimeError(f"card vs CPU loss {card_loss} vs {cpu_loss}: "
                           f"relative difference {rel:.3e} > {TRAIN_TOL['loss']}")
    if max(r for _, r in flips + tcn_flips) > FLIP_PRE:
        raise RuntimeError(f"relu flips away from 0: FFN {flips}, TCN {tcn_flips}")
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

    _card_vs_cpu_step(cfg, [_trial(rng, CPU_TRAIN_FRAMES, "Needle_Passing_G001")])
    if profile:
        for trial in (train[1], train[3]):
            batch = frame_batch(trial, cfg)
            _profile(f"train step T={trial.n_frames}", lambda: exp.train_step(batch))
    return launches


FAMILIES = ("TeCNo", "TransSVNet")
# TransSVNet's gradients, card against CPU. Its LayerNorms act over its 2
# classes, so a frame's gradient carries the factor eps / (a - b)^2 of each:
# frames whose two LN inputs nearly coincide dominate the sum, and float32
# inputs (the kernels', the features') fix those differences only to ~1e-3.
# Measured on the CPU at this test's config, the port's float32 gradients
# sit up to 6e-3 of a leaf's largest |value| from its float64 ones, and the
# two packages' all-float32 gradients stood ~1e-2 apart before the port took
# the model's tail in float64 (models/transsvnet.py). So each leaf is held
# to TSVN_GRAD_ATOL of its largest |value|; the decoder's W_Q and W_K
# (NULL_LEAVES: keys driven to +-r(1, -1), r within ~1e-5 of 1, make its
# scores over a window nearly equal and these gradients ~1e-17 of the
# tree's largest) to that of the tree's largest.
TSVN_GRAD_ATOL = 2e-2
NULL_LEAVES = ("dec_attn/W_Q/kernel", "dec_attn/W_K/kernel")


def _family_config(model_name: str):
    """TeCNo or TransSVNet as med_tpu.cli.train_frame configures and trains
    them: 2048-d video features, 2 classes; TeCNo 2 stages of 8 layers at 64
    maps, TransSVNet f_maps 64, 8 heads, len_q 30 over a frozen TeCNo of the
    same config; lr 5e-4, no weight decay, no schedule; each trial in its own
    256-frame bucket (fused_epoch off), so step times follow T."""
    from med_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(model_name=model_name, dataset_type="frame", data_type="video",
                            video_dims=2048, out_features=2, error_type="global",
                            lr=5e-4, weight_decay=0.0, lr_scheduler=False, seed=42,
                            n_epochs=2, fused_epoch=False)


def _family_checkpoints(directory: str):
    """Seeded weights of both families, written with the port's
    save_checkpoint in the JAX package's layout and loaded back as a served
    run would be; the frozen stage is the TeCNo checkpoint's model tree, as
    med_tpu.cli.train_frame hands it over. Returns ({name: checkpoint},
    frozen)."""
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.train.checkpoint import load_best_checkpoint, save_checkpoint
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    ckpts = {}
    for i, name in enumerate(FAMILIES):
        exp = Experiment(_family_config(name), device="cpu")
        tree = export_jax_params(init_weights(exp.net,
                                              torch.Generator().manual_seed(SEED + i)))
        save_checkpoint(str(Path(directory) / f"best_model_{name}_1Out.npz"), tree["params"])
        ckpts[name] = load_best_checkpoint(directory, name, "1Out")
    return ckpts, {"tecno_params": ckpts["TeCNo"]["params"]["model"]}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def family_launches(model_name: str, passes: int = 0, steps: int = 0) -> dict:
    """Launches of ``passes`` served requests or eval passes and ``steps``
    train steps of a family (zero for every other wrapper): TeCNo, one K2b
    a stage (2), and in a train step the saving forward and one K5 a stage;
    TransSVNet, the frozen TeCNo's 2 K2b (the forward that saves nothing,
    in training too) and one K1, and in a train step one K3."""
    from med_tpu_torch import ops

    counts = dict.fromkeys(ops.launch_counts(), 0)
    counts["dilated_residual_stack"] = 2 * (passes + steps)
    if model_name == "TeCNo":
        counts["dilated_residual_stack_bwd"] = 2 * steps
    else:
        counts["sliding_window_attention_packed"] = passes + steps
        counts["sliding_window_attention_packed_bwd"] = steps
    return counts


def _family_card_vs_cpu_step(name: str, cfg, trial, frozen) -> None:
    """One full-width train step on the card and on the CPU, same weights
    (and TeCNo's dropout masks): the loss within TRAIN_TOL, and every
    gradient leaf within rtol and an atol of TRAIN_TOL['grad_atol'] times
    the leaf's own largest |value| (TransSVNet: TSVN_GRAD_ATOL times it, and
    times the tree's for NULL_LEAVES)."""
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.train.engine import Experiment

    batch = frame_batch(trial, cfg)
    masks = None
    if name == "TeCNo":
        masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
            batch["images"].shape[1], torch.Generator().manual_seed(SEED))
    cpu_loss, cpu = _step_gradients(cfg, batch, masks, "cpu", frozen)
    card_loss, card = _step_gradients(cfg, batch, masks, "cuda", frozen)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    tree_max = max(g.abs().max().item() for g in cpu.values())
    atol = TRAIN_TOL["grad_atol"] if name == "TeCNo" else TSVN_GRAD_ATOL
    rows, failed = [], []
    for n in sorted(cpu):
        leaf_max = max(cpu[n].abs().max().item(), 1e-30)
        scale = tree_max if n.endswith(NULL_LEAVES) else leaf_max
        err = (card[n] - cpu[n]).abs()
        rows.append((err.max().item() / leaf_max, err.max().item() / tree_max, n))
        if (err - TRAIN_TOL["grad_rtol"] * cpu[n].abs()).max().item() > atol * scale:
            failed.append(n)
    log(f"[families] {name} card vs CPU train step at T={trial.n_frames}: loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {rel:.2e}, tol {TRAIN_TOL['loss']}); "
        f"{len(rows)} gradient leaves, largest |card - CPU| over the leaf's max "
        f"{max(r[0] for r in rows):.2e} ({max(rows)[2]}), over the tree's max "
        f"{max(r[1] for r in rows):.2e} (tol rtol {TRAIN_TOL['grad_rtol']}, atol "
        f"{atol} x the leaf max; x the tree max for "
        f"{[n for n in sorted(cpu) if n.endswith(NULL_LEAVES)]})")
    for leaf_rel, _, n in sorted(rows, reverse=True):
        log(f"[families]   {name} {n}: |card - CPU| {leaf_rel:.2e} of the leaf's max")
    if rel > TRAIN_TOL["loss"]:
        raise RuntimeError(f"{name} card vs CPU loss {card_loss} vs {cpu_loss}")
    if failed:
        raise RuntimeError(f"{name} card vs CPU gradients out of tolerance: {failed}")


def phase_families(profile: bool):
    """TeCNo and TransSVNet at full width (phase 6 of the module docstring).
    Returns, per family, the launch counts of its train_frame_fold run."""
    from med_tpu_torch import ops
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.train.loop import train_frame_fold

    rng = np.random.default_rng(SEED + 4)
    stats = {"kinematics": {"mean": rng.standard_normal(26, dtype=np.float32),
                            "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}}
    with tempfile.TemporaryDirectory() as tmp:
        ckpts, frozen_tree = _family_checkpoints(tmp)
    requests = {T: _request(rng, T) for T in REQUEST_FRAMES}
    train = [_trial(rng, T, f"Needle_Passing_{'BCDE'[i]}00{i + 1}")
             for i, T in enumerate(TRAIN_FRAMES)]
    test = [_trial(rng, T, f"Needle_Passing_F00{i + 1}") for i, T in enumerate(TEST_FRAMES)]
    fold_launches = {}
    for name in FAMILIES:
        cfg = _family_config(name)
        frozen = frozen_tree if name == "TransSVNet" else None
        server = FrameModelServer(cfg, ckpts[name], stats=stats, frozen=frozen)
        if server.exp.device.type != "cuda":
            raise RuntimeError(f"{name} server runs on {server.exp.device}, not the card")
        server.predict_trial(*_request(rng, 256))          # warm-up, not counted
        ops.reset_launch_counts()
        served = {}
        for T, req in requests.items():
            t0 = time.perf_counter()
            served[T] = server.predict_trial(*req)
            ms = (time.perf_counter() - t0) * 1e3
            _check_served(f"{name} request T={T}", *served[T], T)
            log(f"[families] {name} request T={T}: {ms:.2f} ms (first pass)")
        launches = ops.launch_counts()
        want = family_launches(name, passes=len(requests))
        log(f"[families] {name} launches over {len(requests)} requests: "
            f"{_nonzero(launches)} (expected {_nonzero(want)}, no other)")
        if launches != want:
            raise RuntimeError(f"{name} kernel launches {launches} != {want}")
        for T, req in requests.items():
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                server.predict_trial(*req)
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            log(f"[families] {name} request T={T}: median {med:.2f} ms of 5 "
                f"(min {min(times):.2f}, max {max(times):.2f}), {T / med * 1e3:.0f} frames/s")
        cpu = FrameModelServer(cfg, ckpts[name], stats=stats, frozen=frozen, device="cpu")
        for T, req in requests.items():
            c_preds, c_probs = cpu.predict_trial(*req)
            g_preds, g_probs = served[T]
            err = float(np.abs(g_probs - c_probs).max())
            flips = g_preds != c_preds
            if err > 1e-4 or bool((flips & (np.abs(c_probs - 0.5) > 1e-4)).any()):
                raise RuntimeError(f"{name} card vs CPU at T={T}: probabilities differ by "
                                   f"{err:.3e} (tol 1e-4), or predictions away from 0.5")
            log(f"[families] {name} card vs CPU at T={T}: max prob diff {err:.3e} "
                f"(tol 1e-4), {int(flips.sum())} of {T} predictions differ")

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_frame_fold(cfg, train, test, frozen=frozen)     # on the card
        wall = time.perf_counter() - t0
        fold_launches[name] = launches = ops.launch_counts()
        exp = res["exp"]
        if exp.device.type != "cuda":
            raise RuntimeError(f"{name} training ran on {exp.device}, not the card")
        steps = cfg.n_epochs * len(train)
        want = family_launches(name, passes=cfg.n_epochs * len(test), steps=steps)
        log(f"[families] {name} launches over {steps} train steps and "
            f"{cfg.n_epochs * len(test)} eval passes: {_nonzero(launches)} (expected "
            f"{_nonzero(want)}, no other)")
        if launches != want:
            raise RuntimeError(f"{name} kernel launches {launches} != {want}")
        for row in res["history"]:
            if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
                raise RuntimeError(f"{name}: non-finite loss in epoch {row['epoch']}: {row}")
            log(f"[families] {name} epoch {row['epoch']}: train_loss "
                f"{row['train_loss']:.6f}, test_loss {row['test_loss']:.6f}, test_f1 "
                f"{row['test_f1']:.4f}, train {row['train_time']:.2f} s")
        log(f"[families] {name} train_frame_fold: {cfg.n_epochs} epochs x {len(train)} "
            f"trials in {wall:.2f} s (first steps included)")
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
            log(f"[families] {name} step T={trial.n_frames} (bucket "
                f"{batch['labels'].shape[0]}): median {med:.2f} ms of 5 (min "
                f"{min(times):.2f}, max {max(times):.2f}), "
                f"{trial.n_frames / med * 1e3:.0f} frames/s")
        ops.reset_launch_counts()
        exp.train_step(frame_batch(train[0], cfg))
        one = ops.launch_counts()
        log(f"[families] {name} launches per train step: {_nonzero(one)}")
        if one != family_launches(name, steps=1):
            raise RuntimeError(f"{name} launches per train step {one} differ from the design")
        _family_card_vs_cpu_step(name, cfg, _trial(rng, CPU_TRAIN_FRAMES,
                                                   "Needle_Passing_G001"), frozen)
        if profile:
            req = requests[REQUEST_FRAMES[-1]]
            _profile(f"{name} request T={len(req[0])}", lambda: server.predict_trial(*req))
            batch = frame_batch(train[3], cfg)
            _profile(f"{name} train step T={train[3].n_frames}", lambda: exp.train_step(batch))
    return fold_launches


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


def phase_driver(root: Path):
    """The fold driver's command line on the card (phase 8 of the module
    docstring), its folds and runs under ``root``. Returns the launch
    counts of COG's first run and, per family, of the TeCNo and TransSVNet
    runs; the folds' splits; and the id of COG's run."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import train_frame

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
    _check_driver_run(run, "COG_5Hz_multimodal", splits, results, wall, {
        "model_name": "COG", "data_type": "multimodal", "video_dims": 2048,
        "d_model": 64, "d_q": 8, "sequence_length": 30, "num_layers_Basic": 11,
        "num_layers_R": 10, "num_R": 3, "mstcn_f_maps": 64, "n_epochs": 2})

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

    # the frame CLI's default (TeCNo), then TransSVNet on that run
    family_runs, tecno_id = {}, None
    for name in FAMILIES:
        extra = ([] if name == "TeCNo"
                 else ["--model-name", "TransSVNet", "--run-id", tecno_id])
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results, tracker = train_frame.main(
            ["--data-root", str(root / "data"), "--runs-root", str(root / "runs"),
             "--folds", ",".join(splits), "--n-epochs", "2", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        family_runs[name] = ops.launch_counts()
        want = family_launches(name, passes=2 * n_test, steps=2 * n_train)
        log(f"[driver] {name}: launches over {2 * n_train} train steps and "
            f"{2 * n_test} eval passes: {_nonzero(family_runs[name])} (expected "
            f"{_nonzero(want)}, no other)")
        if family_runs[name] != want:
            raise RuntimeError(f"{name} kernel launches {family_runs[name]} != {want}")
        tecno_id = tecno_id or tracker.run_id
        _check_driver_run(Path(tracker.dir), f"{name}_5Hz_video", splits, results, wall, {
            "model_name": name, "data_type": "video", "video_dims": 2048,
            "mstcn_stages": 2, "mstcn_layers": 8, "mstcn_f_maps": 64,
            "sequence_length": 30, "n_epochs": 2,
            "run_id": None if name == "TeCNo" else tecno_id})
    return launches, family_runs, splits, run.name


def _image_files(splits, classes: int) -> set:
    """The plots a driver writes into a run's images/ (med_tpu's names):
    each fold's curves and the best epoch's test confusion matrix; none
    where matplotlib is not installed (the driver prints `plotting
    skipped`)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return set()
    cm = "LOSO_Test_Confusion_Matrix" + ("_global.png" if classes == 2 else ".png")
    return {f"images/LOSO_fold_{fold}_results.png" for fold in splits} | {f"images/{cm}"}


def _check_driver_run(run: Path, experiment: str, splits, results, wall: float,
                      width: dict, classes: int = 2, first: int = 0, tag: str = None,
                      test_frames=None) -> None:
    """Raise unless a driver run's directory is whole, its config has
    ``width``, its summaries are finite and its best predictions served
    numbers (``classes`` and ``first`` as :func:`_check_served` takes them,
    the windowed confusion matrix over 2 or 6 classes); log the run's wall
    split (train steps, eval passes and the rest from its own
    metrics.jsonl). ``test_frames``: each fold's test frames, where the run
    dropped some (Needle-Drop); by default all of DRIVER_FRAMES'."""
    tag = tag or f"[driver] {width['model_name']}"
    if test_frames is None:
        test_frames = {fold: sum(DRIVER_FRAMES[int(t[-1]) - 1] for t in test)
                       for fold, (_, test) in splits.items()}
    if run.parent.name != experiment:
        raise RuntimeError(f"run directory {run} is not under {experiment}")
    want_files = {"params.json", "metrics.jsonl", "artifacts/summary.json",
                  "artifacts/windowed_metrics.json"} | _image_files(splits, classes)
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
    got = {k: params[k] for k in width}
    if got != width:
        raise RuntimeError(f"the driver did not run {width}: {got}")
    counted = {name: _finite_numbers(json.loads((run / "artifacts" / name).read_text()))
               for name in ("summary.json", "windowed_metrics.json")}
    windowed = json.loads((run / "artifacts" / "windowed_metrics.json").read_text())
    if np.asarray(windowed["cm"]).shape != ((2, 2) if classes == 2 else (6, 6)):
        raise RuntimeError(f"{tag}: windowed confusion matrix {np.shape(windowed['cm'])}")
    for fold in splits:
        best = results[fold]
        _check_served(f"driver fold {fold}", best["preds"], best["probs"], test_frames[fold],
                      classes, first)
        if not (math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])):
            raise RuntimeError(f"driver fold {fold}: non-finite loss {best}")
    log(f"{tag} run layout ok ({len(files)} files); summary.json holds "
        f"{counted['summary.json']} finite numbers, windowed_metrics.json "
        f"{counted['windowed_metrics.json']}; best test F1 "
        f"{ {f: round(results[f]['test_f1'], 4) for f in splits} }")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train_s = sum(r["value"] for r in rows if r["key"] == "train_time")
    # the eval rows come fold by fold, 2 epochs each, as ms per test frame
    frames = [test_frames[fold] for fold in splits]
    per_frame = [r["value"] for r in rows if r["key"] == "test_inference_ms_per_frame"]
    eval_s = sum(v * frames[j // 2] for j, v in enumerate(per_frame)) / 1e3
    log(f"{tag} {run.parent.name} run, {len(splits)} folds x 2 epochs: {wall:.2f} s of "
        f"wall, {wall / len(splits):.2f} s a fold: train steps {train_s:.2f} s, eval "
        f"passes {eval_s:.2f} s, the rest (loading the folds, snapshots, checkpoints "
        f"and artifacts) {wall - train_s - eval_s:.2f} s")


# the error-specific frame regime (phase 9): COG's prompt variants, served
# and stepped at full width; which K1/K3 entry of the kernels line each
# variant's path feeds (ES_ATTENTION's shapes)
ES_VARIANTS = {"observed": dict(use_all_gestures=False),
               "skill_prompt": dict(use_skill_prompt=True), "srm": dict(SRM=True)}
ES_VARIANT_SHAPE = {"m8": "observed", "m45": "skill_prompt"}
BF16_BOUND = 0.1          # bf16 logits within 0.1 of the fp32 logits' largest |value|


def variant_launches(chains: int, passes: int = 0, steps: int = 0, trials: int = 1):
    """Launches of ``passes`` COG forward passes and ``steps`` train steps,
    each of ``trials`` trials (a group's, padding repeats included): the
    attention's ``chains`` chains (2 with SRM) of 2 layers take one K1 (and
    K3) a layer for the whole pass; the TCN kernels run as
    forward_launches and backward_launches, once a trial."""
    counts = {**forward_launches(trials * passes), **backward_launches(trials * steps)}
    counts["sliding_window_attention_packed"] = 2 * chains * passes
    counts["sliding_window_attention_packed_bwd"] = 2 * chains * steps
    return counts


def _es_variants(stats) -> dict:
    """COG's observed-gesture, skill-prompt and SRM variants at full width:
    served at REQUEST_FRAMES (latency, launches), card against CPU
    probabilities at CPU_CHECK_FRAMES, one train step counted on the card
    and one card against CPU. Returns {variant: {"serving", "step"}}."""
    from med_tpu_torch import ops
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.train.engine import Experiment

    rng = np.random.default_rng(SEED + 11)
    out = {}
    for name, variant in ES_VARIANTS.items():
        cfg = _serving_config(2048).replace(**variant)
        chains = 2 if cfg.SRM else 1
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = _seeded_checkpoint(cfg, tmp)
        server = FrameModelServer(cfg, ckpt, stats=stats)
        M = server.exp.net.model.gest_embed.shape[0]
        server.predict_trial(*_request(rng, 256))              # warm-up
        requests = {T: _request(rng, T) for T in REQUEST_FRAMES}
        ops.reset_launch_counts()
        served, first = {}, {}
        for T, req in requests.items():
            t0 = time.perf_counter()
            served[T] = server.predict_trial(*req)
            first[T] = (time.perf_counter() - t0) * 1e3
            _check_served(f"{name} request T={T}", *served[T], T)
        serving = ops.launch_counts()
        want = variant_launches(chains, passes=len(requests))
        if serving != want:
            raise RuntimeError(f"{name}: serving launches {serving} != {want}")
        for T, req in requests.items():
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                server.predict_trial(*req)
                times.append((time.perf_counter() - t0) * 1e3)
            log(f"[es] {name} (M={M} prompts, {chains} chain(s)) request T={T}: "
                f"median {statistics.median(times):.2f} ms of 3 (first {first[T]:.2f} ms)")
        log(f"[es] {name}: launches over {len(requests)} requests {_nonzero(serving)} "
            f"(as designed)")
        cpu = FrameModelServer(cfg, ckpt, stats=stats, device="cpu")
        c_preds, c_probs = cpu.predict_trial(*requests[CPU_CHECK_FRAMES])
        g_preds, g_probs = served[CPU_CHECK_FRAMES]
        err = float(np.abs(g_probs - c_probs).max())
        flips = g_preds != c_preds
        if err > 1e-4 or bool((flips & (np.abs(c_probs - 0.5) > 1e-4)).any()):
            raise RuntimeError(f"{name}: card vs CPU probabilities differ by {err:.3e}")
        log(f"[es] {name} card vs CPU at T={CPU_CHECK_FRAMES}: max prob diff {err:.3e} "
            f"(tol 1e-4), {int(flips.sum())} predictions differ")

        train_cfg = _train_config().replace(**variant)
        trial = _trial(rng, CPU_TRAIN_FRAMES, "Needle_Passing_H001")
        exp = Experiment(train_cfg)
        exp.init_weights(SEED)
        exp.train_step(frame_batch(trial, train_cfg))          # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        exp.train_step(frame_batch(trial, train_cfg))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        step = ops.launch_counts()
        if step != variant_launches(chains, passes=1, steps=1):
            raise RuntimeError(f"{name}: train step launches {step}")
        log(f"[es] {name} train step T={CPU_TRAIN_FRAMES}: {step_ms:.2f} ms, launches "
            f"{_nonzero(step)}")
        _card_vs_cpu_step(train_cfg, [trial], tag=f"[es] {name}")
        out[name] = {"serving": serving, "step": step}
    return out


def _es_clis(root: Path, splits, cog_run: str) -> dict:
    """``train_frame_es.main`` and ``train_frame_es_sequential.main --run-id``
    phase 8's COG run, each 2 epochs on phase 8's folds at full width on
    the card: launches as designed (the sequential stage adds the binary
    stage's eval pass over each test trial, its gates), the run layout,
    finite summaries, 6-class windowed metrics. Returns each run's launch
    counts."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import train_frame_es, train_frame_es_sequential
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.data.datasets import build_frame_fold

    argv = ["--data-root", str(root / "data"), "--runs-root", str(root / "runs"),
            "--folds", ",".join(splits), "--n-epochs", "2"]
    es_cfg = ExperimentConfig(dataset_type="frame", error_type="all_errors", delete_ND=True)
    trials = {fold: (build_frame_fold(str(root / "data" / fold), es_cfg, "train.csv"),
                     build_frame_fold(str(root / "data" / fold), es_cfg, "test.csv"))
              for fold in splits}
    n_train = sum(len(tr) for tr, _ in trials.values())
    n_test = sum(len(te) for _, te in trials.values())
    test_frames = {fold: sum(t.n_frames for t in te) for fold, (_, te) in trials.items()}
    runs, ids = {}, {}
    for name, main, extra, fixed, classes, first in (
            ("train_frame_es", train_frame_es.main, [],
             {"error_type": "all_errors", "out_features": 6, "smooth_lambda": 0.15}, 6, 0),
            ("train_frame_es_sequential", train_frame_es_sequential.main,
             ["--run-id", cog_run],
             {"error_type": "sequential", "out_features": 5, "smooth_lambda": 0.0,
              "run_id": cog_run}, 5, 1)):
        gates = n_test if extra else 0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results, tracker = main([*argv, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name], ids[name] = ops.launch_counts(), tracker.run_id
        want = {**forward_launches(2 * n_train + 2 * n_test + gates),
                **backward_launches(2 * n_train)}
        log(f"[es] {name}: launches over {2 * n_train} train steps, {2 * n_test} eval "
            f"passes and {gates} gate passes of the binary stage: {_nonzero(runs[name])}")
        if runs[name] != want:
            raise RuntimeError(f"{name} kernel launches {runs[name]} != {want}")
        _check_driver_run(Path(tracker.dir), "COG_5Hz_multimodal", splits, results, wall, {
            # the ES command lines keep the config's video_dims (32: the
            # FeatureExtractor), as med_tpu's do
            "model_name": "COG", "data_type": "multimodal", "video_dims": 32,
            "d_model": 64, "num_R": 3, "delete_ND": True, "mstcn_stages": 8,
            "n_epochs": 2, **fixed}, classes=classes, first=first, tag=f"[es] {name}",
            test_frames=test_frames)
    return runs, ids


def _es_bf16(train, test) -> dict:
    """COG and TeCNo with compute_dtype="bfloat16" on the card: served at
    T = 4096 (latency, launches: no TCN kernel), their logits within
    BF16_BOUND of the fp32 model's on the same weights and input, and a
    2-epoch fold on phase 5's trials (launches, finite losses, wall).
    Returns the fold runs' launch counts by model."""
    from med_tpu_torch import ops
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.train.loop import train_frame_fold

    rng = np.random.default_rng(SEED + 12)
    T = REQUEST_FRAMES[-1]
    out = {}
    for name in ("COG", "TeCNo"):
        cfg = _serving_config(2048) if name == "COG" else _family_config("TeCNo")
        bf16 = cfg.replace(compute_dtype="bfloat16")
        with tempfile.TemporaryDirectory() as tmp:
            if name == "COG":
                ckpt = _seeded_checkpoint(cfg, tmp)
            else:
                ckpt = _family_checkpoints(tmp)[0]["TeCNo"]
        servers = {dt: FrameModelServer(c, ckpt) for dt, c in (("fp32", cfg), ("bf16", bf16))}
        req = _request(rng, T)
        servers["bf16"].predict_trial(*req)                     # warm-up
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        preds, probs = servers["bf16"].predict_trial(*req)
        ms = (time.perf_counter() - t0) * 1e3
        served = ops.launch_counts()
        _check_served(f"bf16 {name} request", preds, probs, T)
        attention = 2 if name == "COG" else 0
        want = {**dict.fromkeys(served, 0), "sliding_window_attention_packed": attention}
        if served != want:
            raise RuntimeError(f"bf16 {name} request launches {served} != {want}")
        x = torch.randn(1, T, cfg.in_features(), generator=torch.Generator().manual_seed(SEED)
                        ).cuda()
        with torch.no_grad():
            logits = {dt: s.exp.net.model(x) for dt, s in servers.items()}
        tracks = {dt: (o[0] if name == "COG" else list(o)) for dt, o in logits.items()}
        worst = 0.0
        for lo, hi in zip(tracks["bf16"], tracks["fp32"]):
            if lo.dtype != torch.float32:
                raise RuntimeError(f"bf16 {name}: logits in {lo.dtype}")
            worst = max(worst, ((lo - hi).abs().max() / hi.abs().max()).item())
        log(f"[es] bf16 {name} request T={T}: {ms:.2f} ms, launches {_nonzero(served)}; "
            f"logits within {worst:.3e} of the fp32 logits' largest (bound {BF16_BOUND})")
        if worst > BF16_BOUND:
            raise RuntimeError(f"bf16 {name} logits {worst:.3e} from fp32 > {BF16_BOUND}")

        fold_cfg = (_train_config() if name == "COG" else _family_config("TeCNo")).replace(
            compute_dtype="bfloat16")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_frame_fold(fold_cfg, train, test)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = ops.launch_counts()
        steps = fold_cfg.n_epochs * len(train)
        passes = steps + fold_cfg.n_epochs * len(test)
        want = {**dict.fromkeys(out[name], 0),
                "sliding_window_attention_packed": attention * passes,
                "sliding_window_attention_packed_bwd": attention * steps}
        if out[name] != want:
            raise RuntimeError(f"bf16 {name} fold launches {out[name]} != {want}")
        for row in res["history"]:
            if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
                raise RuntimeError(f"bf16 {name}: non-finite loss in {row}")
        log(f"[es] bf16 {name} fold: {fold_cfg.n_epochs} epochs x {len(train)} trials in "
            f"{wall:.2f} s, train losses {[round(r['train_loss'], 5) for r in res['history']]}"
            f", launches {_nonzero(out[name])}; step T={train[-1].n_frames}: "
            f"{_step_ms(res['exp'], frame_batch(train[-1], fold_cfg)):.2f} ms (median of 3)")
    return out


def _step_ms(exp, batch, runs: int = 3) -> float:
    """Median host milliseconds of ``runs`` train steps on ``batch``, each
    ending in a device sync, after one warm step."""
    times = []
    for _ in range(runs + 1):
        t0 = time.perf_counter()
        exp.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def _es_groups(train, test) -> dict:
    """COG with trial_batch = 2: a 2-epoch fold on phase 5's trials (every
    trial padded to the fold's 4096-frame bucket), K1 and K3 once a group
    and encoder layer, the TCN kernels once a trial; one grouped step card
    against CPU. Returns the fold's launch counts."""
    from med_tpu_torch import ops
    from med_tpu_torch.data.datasets import bucket_length, frame_batch
    from med_tpu_torch.train.loop import train_frame_fold

    cfg = _train_config().replace(trial_batch=2)
    G = cfg.trial_batch
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_frame_fold(cfg, train, test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    train_groups, test_groups = -(-len(train) // G), -(-len(test) // G)
    steps = cfg.n_epochs * train_groups
    passes = steps + cfg.n_epochs * test_groups
    want = variant_launches(1, passes=passes, steps=steps, trials=G)
    log(f"[es] trial_batch={G} fold: {steps} group steps and {passes - steps} group eval "
        f"passes, launches {_nonzero(launches)} (expected {_nonzero(want)})")
    if launches != want:
        raise RuntimeError(f"grouped fold launches {launches} != {want}")
    for row in res["history"]:
        if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
            raise RuntimeError(f"grouped fold: non-finite loss in {row}")
        log(f"[es] trial_batch={G} epoch {row['epoch']}: train_loss {row['train_loss']:.6f},"
            f" test_loss {row['test_loss']:.6f}, train {row['train_time']:.2f} s")
    # a group of the two longest trials, at the fold's bucket
    bucket = bucket_length(max(t.n_frames for t in train + test), cap=cfg.max_frames)
    batches = [frame_batch(t, cfg, bucket=bucket) for t in train[-G:]]
    group = {k: np.stack([b[k] for b in batches]) for k in batches[0] if not k.startswith("_")}
    group["trial_weight"] = np.ones(G, np.float32)
    log(f"[es] trial_batch={G} fold: {wall:.2f} s of wall; best epoch {res['best']['epoch']}; "
        f"group step of T={'+'.join(str(t.n_frames) for t in train[-G:])} at bucket {bucket}: "
        f"{_step_ms(res['exp'], group):.2f} ms (median of 3)")
    rng = np.random.default_rng(SEED + 13)
    _card_vs_cpu_step(cfg, [_trial(rng, T, f"Needle_Passing_{c}002")
                            for T, c in ((200, "B"), (250, "C"))], tag="[es] group")
    return launches


def phase_es(root: Path, splits, cog_run: str):
    """The error-specific frame regime on the card (phase 9 of the module
    docstring). Returns (variants' launches, the ES CLIs', bf16 folds',
    the grouped fold's, the ES run's id)."""
    rng = np.random.default_rng(SEED)
    stats = {"kinematics": {"mean": rng.standard_normal(26, dtype=np.float32),
                            "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}}
    variants = _es_variants(stats)
    clis, ids = _es_clis(root, splits, cog_run)
    rng = np.random.default_rng(SEED)
    train = [_trial(rng, T, f"Needle_Passing_{'BCDE'[i]}00{i + 1}")
             for i, T in enumerate(TRAIN_FRAMES)]
    test = [_trial(rng, T, f"Needle_Passing_F00{i + 1}") for i, T in enumerate(TEST_FRAMES)]
    return (variants, clis, _es_bf16(train, test), _es_groups(train, test),
            ids["train_frame_es"])


# the window families (phase 10): the smoke's configurations, the CLI
# defaults at full width (FeatureExtractor 2048 -> 512 -> 256 -> 32 and 26
# kinematics, B = 512); SimpleCNN also at 15 Hz, whose 30-frame windows take
# a third conv block
WINDOW_MODELS = (("SimpleCNN", 5), ("SimpleLSTM", 5), ("Siamese_CNN", 5),
                 ("Siamese_LSTM", 5), ("SimpleCNN", 15))
WINDOW_BATCH = 512
WINDOW_TOL = {"loss": 1e-5, "grad_atol": 1e-5, "stats": 1e-5}


def _window_config(model_name: str, frequency: int = 5, error_type: str = "global"):
    """A window model as its CLI configures it (``train_window``, or the ES
    and sequential CLIs' 6- and 5-class heads over the Needle-Drop filtered
    windows), 2 epochs."""
    from med_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(model_name=model_name, frequency=frequency, error_type=error_type,
                            out_features={"global": 1, "all_errors": 6, "sequential": 5}[
                                error_type],
                            siamese=model_name.startswith("Siamese"),
                            delete_ND=error_type != "global", n_epochs=2)


def _window_label(cfg) -> str:
    return (f"{cfg.model_name} W={cfg.window_size}"
            + ("" if cfg.error_type == "global" else f" {cfg.error_type}"))


def _window_batch(cfg, rng: np.random.Generator) -> dict:
    """A full-width batch of B windows (or pairs), its last 12 rows padding
    (window 0 repeated, masked out), labels of the config's classes and,
    in the sequential regime, a gate that is not the true errors."""
    B = WINDOW_BATCH
    shape = (B, 2, cfg.window_size) if cfg.siamese else (B, cfg.window_size)
    n_classes = 2 if cfg.error_type == "global" else 6
    batch = {"images": rng.standard_normal(shape + (2048,), dtype=np.float32),
             "kinematics": rng.standard_normal(shape + (26,), dtype=np.float32),
             "labels": rng.integers(0, n_classes, B),
             "mask": (np.arange(B) < B - 12).astype(np.float32)}
    for k in ("images", "kinematics", "labels"):
        batch[k][B - 12:] = batch[k][0]
    if cfg.error_type == "sequential":
        batch["gate"] = (rng.random(B) > 0.5).astype(np.float32)
    return batch


@contextlib.contextmanager
def _window_pins(record=None, pin=None, flips=None, view=None):
    """The window path's counterpart of :func:`_ffn_relu`: within the block,
    each call of ``torch.relu`` (the FeatureExtractor, the heads, the
    LSTM's output), ``F.max_pool1d`` (the CNN blocks) and ``torch.abs`` (a
    twin's |f1 - f2|) appends its choice to ``record`` (the relu pattern,
    the pool's argmax, the sign), or, given ``pin``, takes the choice of
    the same call in another run and appends (entries chosen otherwise,
    the largest gap at them over the call's largest value) to ``flips``.
    Only which entry the derivative follows is pinned: the values stay
    this run's wherever the two runs choose alike. ``view(call, choice)``:
    the part of another run's choice this run's call makes (a rank's rows
    or columns)."""
    plain = (torch.relu, F.max_pool1d, torch.abs)
    calls = iter(range(1 << 30))

    def chosen(mine, gap, scale):
        i = next(calls)
        other = (pin[i] if view is None else view(i, pin[i])).to(mine.device)
        flip = other != mine
        flips.append((int(flip.sum()), (gap[flip].max().item() if bool(flip.any()) else 0.0)
                      / max(scale, 1e-30)))
        return other

    def relu(x):
        mine = x > 0
        if pin is None:
            record.append(mine.cpu())
            return plain[0](x)
        keep = chosen(mine, x.abs(), x.abs().max().item())
        return x * keep.to(x.dtype)

    def max_pool1d(x, kernel, stride):
        y, idx = plain[1](x, kernel, stride, return_indices=True)
        if pin is None:
            record.append(idx.cpu())
            return y
        pairs = x[..., :2 * y.shape[-1]].reshape(*x.shape[:-1], -1, 2)
        other = chosen(idx, (pairs[..., 0] - pairs[..., 1]).abs(), x.abs().max().item())
        return x.gather(-1, other)

    def abs_(x):
        mine = x >= 0
        if pin is None:
            record.append(mine.cpu())
            return plain[2](x)
        sign = chosen(mine, x.abs(), x.abs().max().item())
        return x * (2.0 * sign.to(x.dtype) - 1.0)

    torch.relu, F.max_pool1d, torch.abs = relu, max_pool1d, abs_
    try:
        yield
    finally:
        torch.relu, F.max_pool1d, torch.abs = plain


def _window_step(cfg, batch, masks, device: str, dtype=torch.float32):
    """Loss, every gradient leaf and every running statistic (JAX tree
    paths) after one train step from seeded weights on ``device``, in
    ``dtype`` (float64: the net, the batch and the step)."""
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    exp = Experiment(cfg, device=device)
    exp.init_weights(SEED)
    exp.net.to(dtype)
    data = {k: torch.as_tensor(v, device=exp.device,
                               dtype=dtype if v.dtype == np.float32 else None)
            for k, v in batch.items()}
    exp._tensors = dict             # the batch as made here, in ``dtype``
    moved = (tuple([m.to(exp.device) for m in ms] for ms in masks) if cfg.siamese
             else [m.to(exp.device) for m in masks])
    loss, _ = exp.compute_gradients(data, masks=moved)
    grads = _flat(export_jax_params(exp.net, grads=True)["params"])
    stats = _flat(export_jax_params(exp.net)["batch_stats"])
    return loss.item(), *({k: torch.from_numpy(v).double() for k, v in t.items()}
                          for t in (grads, stats))


@contextlib.contextmanager
def _cudnn_paths():
    """Within the block the window models' convs run on cuDNN's
    ``F.conv1d`` and their LSTMs on cuDNN's RNN: a yardstick, since the
    port computes the convs as tap-form matmuls and the LSTMs on PyTorch's
    own CUDA LSTM, for their precision."""
    from med_tpu_torch.models import window_models

    plain = window_models.WindowConv.forward, window_models.LSTMLayer.forward

    def conv(self, x):
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias).transpose(1, 2)

    def lstm(self, x):
        h0 = torch.zeros(1, x.shape[0], self.w_hh.shape[1], dtype=x.dtype, device=x.device)
        out, _, _ = torch.lstm(x, (h0, h0), [self.w_ih, self.w_hh, torch.zeros_like(self.b),
                                             self.b], True, 1, 0.0, torch.is_grad_enabled(),
                               False, True)
        return out

    window_models.WindowConv.forward, window_models.LSTMLayer.forward = conv, lstm
    try:
        yield
    finally:
        window_models.WindowConv.forward, window_models.LSTMLayer.forward = plain


def _leaf_errors(got: dict, want: dict) -> list:
    """(max |got - want| over the leaf's largest |want|, leaf), worst first."""
    return sorted(((got[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-300), n)
                  for n, w in want.items())[::-1]


def _window_card_vs_cpu(cfg) -> None:
    """One train step at full width on the card in float32 against the same
    step on the CPU in float64 (same weights, batch and dropout masks): the
    loss and the running statistics (WINDOW_TOL), and every gradient leaf
    once the card's relu, max-pool and |f1 - f2| choices are pinned to the
    CPU's (:func:`_window_pins`): within 1e-5 of its largest value, or
    within twice the CPU's float32 error on that leaf where float32 itself
    does no better. The CPU's float32 step (its choices pinned too) is
    logged beside it, as is the step on cuDNN's convs and RNN
    (:func:`_cudnn_paths`). The reference
    is float64 because the CPU's float32 gradients sit up to ~2e-5 of a
    leaf's largest from it (a twin's FE, the LSTMs)."""
    from med_tpu_torch.train.engine import Experiment

    tag = f"[window] {_window_label(cfg)}"
    batch = _window_batch(cfg, np.random.default_rng(SEED))
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        WINDOW_BATCH, torch.Generator().manual_seed(SEED))
    record, flips = [], []
    with _window_pins(record=record):
        ref_loss, ref, ref_stats = _window_step(cfg, batch, masks, "cpu", torch.float64)
    with _window_pins(pin=record, flips=[]):
        cpu_loss, cpu, _ = _window_step(cfg, batch, masks, "cpu")
    card_loss, card, card_stats = _window_step(cfg, batch, masks, "cuda")
    with _window_pins(pin=record, flips=flips):
        _, pinned, _ = _window_step(cfg, batch, masks, "cuda")
    with _cudnn_paths(), _window_pins(pin=record, flips=[]):
        _, on_cudnn, _ = _window_step(cfg, batch, masks, "cuda")
    worst = _leaf_errors(on_cudnn, ref)[0]
    yardstick = f"; on cuDNN's convs and RNN instead {worst[0]:.2e} ({worst[1]})"
    rel = abs(card_loss - ref_loss) / abs(ref_loss)
    stats_err = _leaf_errors(card_stats, ref_stats)[0][0]
    free, pin, own = (_leaf_errors(g, ref) for g in (card, pinned, cpu))
    # a leaf passes within grad_atol of its largest value, or within twice
    # the CPU's own fp32 error on it where fp32 does no better (a twin's FE
    # gradient sums the two branches' nearly cancelling terms)
    own_err = {n: e for e, n in own}
    failed = [n for e, n in pin if e > max(WINDOW_TOL["grad_atol"], 2 * own_err[n])]
    flipped = [n for n, _ in flips if n]
    log(f"{tag} train step, B={WINDOW_BATCH}, card (fp32) vs CPU (float64): loss "
        f"{card_loss:.9f} vs {ref_loss:.9f} (rel {rel:.2e}, tol {WINDOW_TOL['loss']}); "
        f"running statistics {stats_err:.2e} of each one's largest (tol "
        f"{WINDOW_TOL['stats']}); {len(flips)} relu/pool/abs calls, {sum(flipped)} entries "
        f"chosen otherwise in {len(flipped)} of them, at a gap up to "
        f"{max(r for _, r in flips):.2e} of the call's largest (tol {FLIP_PRE}); "
        f"{len(ref)} gradient leaves, the largest error of a leaf over its largest value "
        f"{free[0][0]:.2e} free ({free[0][1]}), {pin[0][0]:.2e} pinned ({pin[0][1]}; tol "
        f"{WINDOW_TOL['grad_atol']}, or twice the CPU's fp32 error on the leaf); the "
        f"CPU's fp32 step {own[0][0]:.2e} ({own[0][1]}), loss rel "
        f"{abs(cpu_loss - ref_loss) / abs(ref_loss):.2e}{yardstick}")
    if rel > WINDOW_TOL["loss"]:
        raise RuntimeError(f"{tag}: card vs CPU loss {card_loss} vs {ref_loss}")
    if stats_err > WINDOW_TOL["stats"]:
        raise RuntimeError(f"{tag}: card vs CPU running statistics off by {stats_err:.3e}")
    if max(r for _, r in flips) > FLIP_PRE:
        raise RuntimeError(f"{tag}: choices flipped away from a tie: {flips}")
    if failed:
        raise RuntimeError(f"{tag}: card vs CPU gradients (choices pinned) out of "
                           f"tolerance: {failed}")


def _window_timing(cfg, profile: bool) -> dict:
    """Train-step ms at B = 512 (median of 5, host clock ending in a sync,
    after a warm step) with the batch on the device (``fused_epoch``'s
    path) and from the host (its upload in the step), windows trained a
    second, and eval ms a window (the eval step's median of 5 over B, batch
    on the device); under ``--profile`` the device busy share of a train
    step, both ways."""
    from med_tpu_torch.train.engine import Experiment

    exp = Experiment(cfg)
    exp.init_weights(SEED)
    batch = _window_batch(cfg, np.random.default_rng(SEED + 1))
    resident = exp._tensors(batch)
    step = _step_ms(exp, resident, runs=5)
    host_step = _step_ms(exp, batch, runs=5)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        exp.eval_step(resident)["preds"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    eval_ms = statistics.median(times[1:]) / WINDOW_BATCH
    unit = "pairs" if cfg.siamese else "windows"
    with _cudnn_paths():
        yardstick = f"; on cuDNN's convs and RNN {_step_ms(exp, resident, runs=5):.3f} ms"
    log(f"[window] {_window_label(cfg)}: train step {step:.3f} ms at B={WINDOW_BATCH} "
        f"with the batch on the card ({WINDOW_BATCH / step * 1e3:.0f} {unit} trained a "
        f"second), {host_step:.3f} ms from the host "
        f"({sum(v.nbytes for v in batch.values()) / 1e6:.0f} MB uploaded){yardstick}; eval "
        f"{eval_ms * 1e3:.3f} us a {unit[:-1]} ({eval_ms * WINDOW_BATCH:.3f} ms a batch)")
    if profile:
        _profile(f"[window] {_window_label(cfg)} train step, batch on the card",
                 lambda: exp.train_step(resident))
        _profile(f"[window] {_window_label(cfg)} train step, batch from the host",
                 lambda: exp.train_step(batch))
    return {"step_ms": step, "host_step_ms": host_step, "eval_ms_per_window": eval_ms}


def _window_folds(root: Path, splits, profile: bool) -> None:
    """Each model 2 epochs by ``train_window_fold`` on the card, on the
    first fold of phase 8 (the twins on its default 20,000 pairs):
    finite history rows, and no kernel launch (the window path reaches
    none of the eleven); SimpleLSTM with ``fused_epoch`` on and off."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli.train_window import _siamese_data_fn
    from med_tpu_torch.data.datasets import build_window_fold
    from med_tpu_torch.train.loop import train_window_fold

    fold = next(iter(splits))
    for name, freq in WINDOW_MODELS:
        cfg = _window_config(name, freq)
        train, test = build_window_fold(str(root / "data" / fold), cfg)
        runs = [cfg, cfg.replace(fused_epoch=False)] if name == "SimpleLSTM" else [cfg]
        t0 = time.perf_counter()
        data = _siamese_data_fn(cfg)(fold, train, test) if cfg.siamese else None
        made = time.perf_counter() - t0
        for run in runs:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = train_window_fold(run, train, test, siamese_data=data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if any(ops.launch_counts().values()):
                raise RuntimeError(f"the window path launched {ops.launch_counts()}")
            for row in res["history"]:
                bad = [k for k, v in row.items() if np.isscalar(v) and not math.isfinite(v)]
                if bad:
                    raise RuntimeError(f"[window] {name}: non-finite {bad} in {row}")
            hist = res["history"]
            n = (f"{len(data['train'][2])} train and {len(data['test'][2])} test pairs "
                 f"(made in {made:.2f} s)" if cfg.siamese
                 else f"{len(train)} train and {len(test)} test windows")
            log(f"[window] {_window_label(run)} fold {fold}, {n}, fused_epoch "
                f"{run.fused_epoch}: {wall:.2f} s for 2 epochs (train "
                f"{sum(r['train_time'] for r in hist):.2f} s); losses "
                f"{[round(r['train_loss'], 4) for r in hist]} / "
                f"{[round(r['test_loss'], 4) for r in hist]}, best epoch "
                f"{res['best']['epoch']}, no kernel launched")
            if profile and name == "SimpleLSTM" and run.fused_epoch:
                _profile(f"[window] {_window_label(run)} 2-epoch fold",
                         lambda: train_window_fold(run, train, test))


def _check_window_run(run: Path, experiment: str, splits, results, wall: float,
                      width: dict, classes: int, tag: str) -> None:
    """Raise unless a window run's directory is whole (med_tpu's layout:
    no windowed metrics), its config has ``width``, its summary is finite
    and its best rows carry finite losses and a ``classes`` confusion
    matrix; log its wall split."""
    if run.parent.name != experiment:
        raise RuntimeError(f"run directory {run} is not under {experiment}")
    want_files = {"params.json", "metrics.jsonl",
                  "artifacts/summary.json"} | _image_files(splits, classes)
    for fold in splits:
        want_files |= {f"artifacts/best_model_LOSO_{fold}.json",
                       f"checkpoints/best_model_LOSO_{fold}.npz",
                       f"checkpoints/best_model_LOSO_{fold}.npz.json",
                       f"checkpoints/last_state_LOSO_{fold}.npz"}
    files = {str(f.relative_to(run)) for f in run.rglob("*") if f.is_file()}
    if files != want_files:
        raise RuntimeError(f"{tag} run layout: missing {sorted(want_files - files)}, "
                           f"unexpected {sorted(files - want_files)}")
    params = json.loads((run / "params.json").read_text())
    got = {k: params[k] for k in width}
    if got != width:
        raise RuntimeError(f"{tag}: the CLI did not run {width}: {got}")
    counted = _finite_numbers(json.loads((run / "artifacts" / "summary.json").read_text()))
    for fold in splits:
        best = results[fold]
        if not (math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])):
            raise RuntimeError(f"{tag} fold {fold}: non-finite loss {best}")
        if np.asarray(best["cm"]).shape != (classes, classes):
            raise RuntimeError(f"{tag} fold {fold}: confusion matrix {np.shape(best['cm'])}")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train_s = sum(r["value"] for r in rows if r["key"] == "train_time")
    units = [len(results[fold]["preds"]) for fold in splits]
    per_unit = [r["value"] for r in rows if r["key"] == "test_inference_ms_per_window"]
    eval_s = sum(v * units[j // 2] for j, v in enumerate(per_unit)) / 1e3
    log(f"{tag} run layout ok ({len(files)} files), summary.json holds {counted} finite "
        f"numbers, best test F1 { {f: round(results[f]['test_f1'], 4) for f in splits} }; "
        f"{len(splits)} folds x 2 epochs: {wall:.2f} s of wall, {wall / len(splits):.2f} s "
        f"a fold: train steps {train_s:.2f} s, eval passes {eval_s:.2f} s, the rest "
        f"(loading and windowing the folds, pairs, snapshots, checkpoints and "
        f"artifacts) {wall - train_s - eval_s:.2f} s")


def _window_clis(root: Path, splits) -> None:
    """``train_window.main`` for SimpleLSTM and Siamese_CNN (its default
    20,000 pairs), ``train_window_es.main`` and
    ``train_window_es_sequential.main --run-id`` the SimpleLSTM run, 2
    epochs on phase 8's folds on the card: the run layout, finite
    summaries, no kernel launch."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import train_window, train_window_es, train_window_es_sequential

    argv = ["--data-root", str(root / "data"), "--runs-root", str(root / "runs"),
            "--folds", ",".join(splits), "--n-epochs", "2"]
    binary = None
    for name, main, extra, width, classes in (
            ("train_window SimpleLSTM", train_window.main, ["--model-name", "SimpleLSTM"],
             {"model_name": "SimpleLSTM", "error_type": "global", "siamese": False}, 2),
            ("train_window Siamese_CNN", train_window.main, ["--model-name", "Siamese_CNN"],
             {"model_name": "Siamese_CNN", "siamese": True, "n_pairs": 20000}, 2),
            ("train_window_es", train_window_es.main, [],
             {"model_name": "SimpleLSTM", "error_type": "all_errors", "out_features": 6,
              "delete_ND": True}, 6),
            ("train_window_es_sequential", train_window_es_sequential.main, None,
             {"model_name": "SimpleLSTM", "error_type": "sequential", "out_features": 5,
              "delete_ND": True}, 6)):
        if extra is None:           # gated by the SimpleLSTM run
            extra, width["run_id"] = ["--run-id", binary], binary
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results, tracker = main([*argv, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(ops.launch_counts().values()):
            raise RuntimeError(f"{name} launched {ops.launch_counts()}")
        binary = binary or tracker.run_id
        _check_window_run(Path(tracker.dir), f"{width['model_name']}_5Hz_multimodal", splits,
                          results, wall, {"video_dims": 32, "batch_size": 512,
                                          "n_epochs": 2, **width}, classes, f"[window] {name}")


def phase_window(root: Path, splits, profile: bool) -> dict:
    """The window families on the card (phase 10 of the module docstring).
    Returns the kernel launches of the whole phase: none."""
    from med_tpu_torch import ops

    ops.reset_launch_counts()
    for name, freq in WINDOW_MODELS:
        _window_card_vs_cpu(_window_config(name, freq))
    for error_type in ("all_errors", "sequential"):
        _window_card_vs_cpu(_window_config("SimpleLSTM", error_type=error_type))
    for name, freq in WINDOW_MODELS:
        _window_timing(_window_config(name, freq), profile)
    _window_folds(root, splits, profile)
    _window_clis(root, splits)
    launches = ops.launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"the window phase launched {launches}")
    log(f"[window] kernel launches over the phase: {launches} (the window path reaches "
        "none of the eleven)")
    return launches


# the ensembles (phase 11): the window CLIs' batch a served request, raw-frame
# trials (T frames each) and which of them each pixel fold trains and tests
# on, the int8 tensor cores' dense peak, and the tolerances
ENSEMBLE_BATCH = 512
PIXEL_TRIALS = (120, 200, 300)
PIXEL_SPLITS = {"1Out": ((0, 1), (2,)), "2Out": ((1, 2), (0,))}
PEAK_INT8_OPS = 1.979e15
CARD = "cuda"
SERVE_TOL = {"offline": 1e-4, "int8_fe": 3e-2}


def _cli_lines(main, argv, tag: str) -> list:
    """Run a command line's ``main``, log its printed lines and return them;
    raise unless every F1 it prints is a finite number."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"{tag}   {line}")
    f1s = [float(v) for line in lines
           for v in re.findall(r"(?:f1=|F1: )(\S+)", line)]
    if not f1s or not all(math.isfinite(v) for v in f1s):
        raise RuntimeError(f"{tag}: F1 not finite or not printed: {lines}")
    return lines


def _int8_conv_work(x, w, out, residual=None) -> tuple:
    """(operations, bytes) of one int8 conv launch: 2 M N K, and each operand
    read once (x, w, the scales and biases, the residual) and the output
    written once."""
    M = out[..., 0].numel()
    N, K = w.shape[0], w[0].numel()
    nbytes = x.numel() + w.numel() + 8 * N + out.numel() * out.element_size()
    if residual is not None:
        nbytes += residual.numel() * residual.element_size()
    return 2 * M * N * K, nbytes


class _Int8Check:
    """While it is entered, every launch of ``ops.quant.int8_conv`` (the int8
    trunk's and FE's forwards call it by module attribute) is checked
    against the plain version on the same inputs: int32 accumulators equal,
    the epilogue's codes within one step (flips counted) or its fp32
    equal; each launch's arguments are kept for timing."""

    def __init__(self):
        from med_tpu_torch.ops import quant

        self.tq, self.calls, self.flips, self.codes, self.err = quant, [], 0, 0, 0.0
        self.classes = {}

    def __enter__(self):
        self.kernel = self.tq.int8_conv
        self.tq.int8_conv = self._checked
        return self

    def __exit__(self, *exc):
        self.tq.int8_conv = self.kernel

    def _checked(self, x, w, wscale, bias, **kw):
        kh, stride = w.shape[1], kw.get("stride", 1)
        if x.shape[1] == x.shape[2] == 1 and kh == 1:
            cls = f"dense {w.shape[-1]}->{w.shape[0]}"
        elif kh == 1 and kw.get("out_scale") is None:
            cls = f"down 1x1/{stride}"
        else:
            cls = {7: "conv1 7x7/2", 3: f"3x3/{stride}", 1: "1x1"}[kh]
        args = (x, w, wscale, bias)
        geometry = {k: v for k, v in kw.items() if k in ("s_in", "stride", "pad")}
        acc = self.kernel(*args, accumulators=True, **geometry)
        want = self.tq.int8_conv_plain(*args, accumulators=True, **geometry)
        if not torch.equal(acc, want):
            raise RuntimeError(f"int8_conv {cls}: int32 accumulators differ from the plain "
                               f"version's in {(acc != want).sum().item()} places")
        out = self.kernel(*args, **kw)
        ref = self.tq.int8_conv_plain(*args, **kw)
        if out.dtype == torch.int8:
            diff = (out.to(torch.int32) - ref.to(torch.int32)).abs()
            if int(diff.max()) > 1:
                raise RuntimeError(f"int8_conv {cls}: codes differ by {int(diff.max())}")
            self.flips += int((diff > 0).sum())
            self.codes += diff.numel()
        else:
            diff = (out - ref).abs()
            if not torch.equal(out, ref):
                raise RuntimeError(f"int8_conv {cls}: fp32 epilogue differs by "
                                   f"{diff.max().item():.3e}")
        self.err = max(self.err, float((acc - want).abs().max()), float(diff.max()))
        self.classes[cls] = self.classes.get(cls, 0) + 1
        self.calls.append((cls, args, kw, _int8_conv_work(x, w, out, kw.get("residual"))))
        return out

    def timing(self, iters: int = 5) -> dict:
        """Each kept launch timed alone (CUDA events), its plain version once;
        sums, by shape class too, with the bound of the launches' work."""
        tq = self.tq
        by_class = {}
        for cls, a, k, _ in self.calls:
            t = cuda_ms(lambda a=a, k=k: tq.int8_conv(*a, **k), iters)
            by_class[cls] = by_class.get(cls, 0.0) + t
        plain = sum(cuda_ms(lambda a=a, k=k: tq.int8_conv_plain(*a, **k), 1, warmup=1)
                    for _, a, k, _ in self.calls)
        ops = sum(w[0] for *_, w in self.calls)
        nbytes = sum(w[1] for *_, w in self.calls)
        b_ms, by = bound(nbytes, ops, PEAK_INT8_OPS)
        return {"ms": sum(by_class.values()), "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": by, "ops": ops, "bytes": nbytes, "by_class": by_class}


def _int_mm_fe(qfe, xq):
    """The FE's three layers through ``torch._int_mm`` (cuBLASLt int8) and the
    epilogue in PyTorch ops: the library yardstick of the FE's launches."""
    from med_tpu_torch.ops.quant import _f32, quantize_tensor

    layers = qfe["layers"]
    x = xq.reshape(-1, xq.shape[-1])
    for i, qd in enumerate(layers):
        acc = torch._int_mm(x, qd["wq"].t())
        y = acc.to(torch.float32) * (_f32(qd["in_scale"]) * qd["wscale"]) + qd["bias"]
        if i + 1 == len(layers):
            return y
        x = quantize_tensor(torch.relu(y), layers[i + 1]["in_scale"])


def _write_pixel_folds(root: Path, mean_std_ckpt: str) -> dict:
    """Raw-frame trials (PIXEL_TRIALS, 224x224 uint8 under image_feats,
    kinematics, 40-frame gesture runs, errors) in load_fold_trials' layout,
    two folds listing them (PIXEL_SPLITS), and each fold's fine-tune
    checkpoint: phase 7's seeded trunk with its mean/std meta. Returns the
    checkpoint pattern."""
    rng = np.random.default_rng(SEED + 5)
    shared = root / "trials"
    shared.mkdir(parents=True)
    names = [f"Needle_Passing_{'BCD'[i]}00{i + 1}" for i in range(len(PIXEL_TRIALS))]
    for name, T in zip(names, PIXEL_TRIALS):
        e = np.zeros((T, 5), np.int64)
        e[:, 4] = np.repeat(rng.integers(0, 2, T // 20 + 1), 20)[:T]
        e[np.arange(T), rng.integers(0, 4, T)] = e[:, 4]
        np.savez(shared / f"{name}.npz",
                 image_feats=rng.integers(0, 256, (T, TRUNK["frame"], TRUNK["frame"], 3),
                                          dtype=np.uint8),
                 kinematics_feats=rng.standard_normal((T, 26), dtype=np.float32),
                 g_labels=np.repeat(rng.integers(1, 9, T // 40 + 1), 40)[:T], e_labels=e)
    for fold, (train, test) in PIXEL_SPLITS.items():
        (root / fold).mkdir()
        for csv, idx in (("train.csv", train), ("test.csv", test)):
            (root / fold / csv).write_text("\n".join(f"../trials/{names[i]}.npz"
                                                     for i in idx))
        for ext in ("", ".json"):
            shutil.copy(mean_std_ckpt + ext, root / f"resnet50_{fold}.npz{ext}")
    return str(root / "resnet50_{fold}.npz")


def _ensemble_serving(root: Path, splits, runs: dict) -> dict:
    """The two window runs served live by ``load_ensemble`` on each fold's
    test windows: decisions against the offline soft vote of their stored
    dumps, the int8 FE (and the int8 feature store) against fp32, launches,
    and a B = ENSEMBLE_BATCH request's time each way. Returns the FE's
    tensors for the kernel check."""
    from med_tpu_torch.cli.ensemble import _feature_store
    from med_tpu_torch.data.datasets import build_window_fold
    from med_tpu_torch.eval.ensemble import soft_vote
    from med_tpu_torch.eval.results import load_run_dumps
    from med_tpu_torch.config import run_config
    from med_tpu_torch.eval.serving import load_ensemble
    from med_tpu_torch.ops.quant import int8_conv
    from med_tpu_torch.tracking import RunTracker

    runs_root = str(root / "runs")
    ids = [runs["video"], runs["kinematics"]]
    cfg = run_config(RunTracker.find_run(runs_root, ids[0]))
    dumps = [load_run_dumps(runs_root, r, "LOSO", list(splits)) for r in ids]
    out = {}
    for fold in splits:
        train, test = build_window_fold(str(root / "data" / fold), cfg)
        server = load_ensemble(runs_root, ids, "LOSO", fold)
        preds, probs = server.predict(test.images, test.kinematics)
        off_preds, off_p = soft_vote(dumps[0][fold]["probs"], dumps[1][fold]["probs"])
        clear = np.abs(off_p - 0.5) > SERVE_TOL["offline"]
        if not np.array_equal(preds[clear], off_preds[clear]):
            raise RuntimeError(f"[ensemble] {fold}: served decisions differ from the offline "
                               f"soft vote at {(preds[clear] != off_preds[clear]).sum()}")
        server8 = load_ensemble(runs_root, ids, "LOSO", fold,
                                int8_fe_calib=np.asarray(train.images[:64], np.float32))
        store = _feature_store(server8, np.asarray(test.images, np.float32))
        int8_conv.launches = 0
        preds8, probs8 = server8.predict(store, test.kinematics)
        launches = int8_conv.launches
        if store.dtype != np.int8 or launches != 3:
            raise RuntimeError(f"[ensemble] {fold}: int8 store {store.dtype}, {launches} "
                               "int8 launches a request (3 designed)")
        drift = float(np.abs(probs8 - probs).max())
        clear8 = np.abs(probs - 0.5) > SERVE_TOL["int8_fe"]
        if drift > SERVE_TOL["int8_fe"] or not np.array_equal(preds8[clear8], preds[clear8]):
            raise RuntimeError(f"[ensemble] {fold}: the int8 FE moves probabilities by "
                               f"{drift:.3e}")
        log(f"[ensemble] {fold}: {len(test)} test windows served: decisions equal the offline "
            f"soft vote at the {int(clear.sum())} clear of 0.5 by {SERVE_TOL['offline']} "
            f"(probabilities {np.abs(probs - off_p).max():.3e} apart); --int8-fe: 3 int8 "
            f"launches a request, probabilities within {drift:.3e} of fp32")
        out[fold] = (server, server8, test)
    server, server8, test = out[next(iter(splits))]
    reps = -(-ENSEMBLE_BATCH // len(test))
    images = np.concatenate([test.images] * reps)[:ENSEMBLE_BATCH].astype(np.float32)
    kin = np.concatenate([test.kinematics] * reps)[:ENSEMBLE_BATCH].astype(np.float32)
    store = _feature_store(server8, images)
    dev = server.device
    x, k = (torch.from_numpy(a).to(dev) for a in (images, kin))
    xq = torch.from_numpy(store).to(dev)
    times = {"fp32": cuda_ms(lambda: server.predict_tensors(x, k), 10),
             "int8 FE": cuda_ms(lambda: server8.predict_tensors(x, k), 10),
             "int8 store": cuda_ms(lambda: server8.predict_tensors(xq, k), 10)}
    host = {}
    for name, srv, imgs in (("fp32", server, images), ("int8 store", server8, store)):
        t = []
        for _ in range(6):
            t0 = time.perf_counter()
            srv.predict(imgs, kin)
            t.append((time.perf_counter() - t0) * 1e3)
        host[name] = statistics.median(t[1:])
    log(f"[ensemble] soft-vote request at B={ENSEMBLE_BATCH}, W={cfg.window_size}, windows on "
        f"the card: " + ", ".join(f"{n} {v:.3f} ms" for n, v in times.items())
        + "; numpy in and out (the pageable upload of "
        f"{images.nbytes / 1e6:.1f} MB fp32 or {store.nbytes / 1e6:.1f} MB int8): "
        + ", ".join(f"{n} {v:.3f} ms" for n, v in host.items()))
    return {"qfe": server8.members[0].qfe, "store": xq, "images": x}


def _int8_kernel_checks(pixel_ckpt: str, serving: dict) -> dict:
    """The int8 kernel against its plain version on the card at the full-width
    trunk (B = TRUNK_BATCH) and at the FE (B = ENSEMBLE_BATCH windows): every
    conv of a trunk forward and each FE layer (accumulators equal, codes
    within +-1, counted), the int8 features against the fp32 trunk (per-row
    cosine, beside the CPU's for the same frames), times against the bound
    and the yardsticks. Returns the kernels line's two entries."""
    from med_tpu_torch.eval.serving import PixelFrontEnd
    from med_tpu_torch.ops import quant as tq

    geometry = dict(stage_sizes=TRUNK["stage_sizes"], width=TRUNK["width"])
    rng = np.random.default_rng(SEED + 6)
    frames = rng.integers(0, 256, (TRUNK_BATCH, TRUNK["frame"], TRUNK["frame"], 3), np.uint8)
    calib = frames[:CALIB_FRAMES]
    int8 = PixelFrontEnd.from_checkpoint(pixel_ckpt, int8=True, calib_frames=calib,
                                         batch_size=TRUNK_BATCH, **geometry)
    fp32 = PixelFrontEnd.from_checkpoint(pixel_ckpt, dtype=torch.float32,
                                         batch_size=TRUNK_BATCH, **geometry)
    bf16 = PixelFrontEnd.from_checkpoint(pixel_ckpt, batch_size=TRUNK_BATCH, **geometry)
    x = int8._preprocess(torch.from_numpy(frames).to(CARD))
    with torch.no_grad(), _Int8Check() as walk:
        feats = tq.resnet50_int8_apply(int8.qt, x, TRUNK["stage_sizes"])
    with torch.no_grad():
        ref = fp32.net(x)
    want = {"conv1 7x7/2": 1, "1x1": 32, "3x3/1": 13, "3x3/2": 3, "down 1x1/1": 1,
            "down 1x1/2": 3}
    if TRUNK == {"stage_sizes": (3, 4, 6, 3), "width": 64, "frame": 224} and \
            walk.classes != want:
        raise RuntimeError(f"int8 trunk conv classes {walk.classes} != {want}")
    if walk.flips > 1e-4 * walk.codes:
        raise RuntimeError(f"int8 trunk: {walk.flips} of {walk.codes} codes flipped")

    def cosine(a, b):
        a, b = a.double(), b.double()
        return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))

    cos = cosine(feats, ref)
    # the CPU's figure: the same tree and frames through the plain version
    n_cpu = FP32_BATCH
    cpu_x = x[:n_cpu].cpu()
    cpu_fp32 = PixelFrontEnd.from_checkpoint(pixel_ckpt, dtype=torch.float32, device="cpu",
                                             **geometry)
    with torch.no_grad():
        cpu_feats = tq.resnet50_int8_apply(tq.tree_to(int8.qt, "cpu"), cpu_x,
                                           TRUNK["stage_sizes"])
        cpu_cos = cosine(cpu_feats, cpu_fp32.net(cpu_x))
    if not torch.equal(feats[:n_cpu].cpu(), cpu_feats):
        raise RuntimeError("int8 trunk features differ between the card and the CPU")
    trunk = walk.timing()
    with torch.no_grad():
        trunk["apply_ms"] = cuda_ms(lambda: tq.resnet50_int8_apply(int8.qt, x,
                                                                   TRUNK["stage_sizes"]), 5)
        trunk["yardstick_ms"] = cuda_ms(lambda: bf16.net(x), 5)
    log(f"[ensemble] int8 trunk B={TRUNK_BATCH}: accumulators equal the plain version's on "
        f"every conv ({walk.classes}); codes: {walk.flips} of {walk.codes} flipped at ties; "
        f"features vs the fp32 trunk: per-row cosine min {cos.min().item():.6f}, mean "
        f"{cos.mean().item():.6f} (the CPU on the same first {n_cpu} frames: min "
        f"{cpu_cos.min().item():.6f}, the card's equal bit for bit)")
    log(f"[ensemble] int8 trunk: {len(walk.calls)} launches {trunk['ms']:.4f} ms (each timed "
        f"alone), {trunk['ops'] / 1e12:.3f} TOP, {trunk['bytes'] / 1e9:.3f} GB: bound "
        f"{trunk['bound_ms']:.4f} ms ({trunk['bound_by']}); the plain version "
        f"{trunk['plain_ms']:.1f} ms; resnet50_int8_apply {trunk['apply_ms']:.4f} ms; the "
        f"cuDNN bf16 module trunk {trunk['yardstick_ms']:.4f} ms; instances "
        f"{tq.int8_conv.instances}; ms by class "
        + ", ".join(f"{c} {t:.4f}" for c, t in trunk["by_class"].items()))

    qfe, store = serving["qfe"], serving["store"]
    with torch.no_grad(), _Int8Check() as fe_walk:
        got = tq.fe_int8_apply(qfe, store)
    with torch.no_grad():
        fe = fe_walk.timing(iters=20)
        fe["yardstick_ms"] = cuda_ms(lambda: _int_mm_fe(qfe, store), 20)
        fe["fp32_store_ms"] = cuda_ms(lambda: tq.fe_int8_apply(qfe, serving["images"]), 20)
    fe_bytes = store.numel() + sum(q["wq"].numel() + 8 * q["wq"].shape[0]
                                   for q in qfe["layers"]) + got.numel() * 4
    fe["bound_ms"], fe["bound_by"] = bound(fe_bytes, fe["ops"], PEAK_INT8_OPS)
    log(f"[ensemble] int8 FE B={ENSEMBLE_BATCH} windows (M={store.shape[0] * store.shape[1]}): "
        f"accumulators equal on each layer; {fe_walk.flips} of {fe_walk.codes} codes flipped; "
        f"3 launches {fe['ms']:.4f} ms, {fe['ops'] / 1e9:.2f} GOP, bound {fe['bound_ms']:.4f} "
        f"ms ({fe['bound_by']}; the int8 store's {store.numel() / 1e6:.1f} MB read once); "
        f"plain {fe['plain_ms']:.3f} ms; torch._int_mm and the epilogue in PyTorch ops "
        f"{fe['yardstick_ms']:.4f} ms; fe_int8_apply from fp32 windows "
        f"{fe['fp32_store_ms']:.4f} ms")
    entry = {"route": "cuda", "source": "med_tpu_torch/csrc/int8_conv.cu",
             "replaces": "med_tpu/ops/quant.py:77 _conv_i8, :218 _dense_i8 (XLA)"}
    return {"int8_conv/trunk": {**entry, "ms": trunk["ms"], "plain_ms": trunk["plain_ms"],
                                "bound_ms": trunk["bound_ms"], "bound_by": trunk["bound_by"],
                                "library_ms": None, "yardstick_ms": trunk["yardstick_ms"],
                                "yardstick": "cuDNN bf16 ResNet50 module trunk",
                                "max_abs_err": walk.err, "code_flips": walk.flips},
            "int8_conv/fe": {**entry, "ms": fe["ms"], "plain_ms": fe["plain_ms"],
                             "bound_ms": fe["bound_ms"], "bound_by": fe["bound_by"],
                             "library_ms": fe["yardstick_ms"],
                             "library": "torch._int_mm + epilogue",
                             "max_abs_err": fe_walk.err, "code_flips": fe_walk.flips}}


def _pixel_serving(root: Path, ckpt: str, runs: dict) -> dict:
    """``cli.ensemble.main --serve --pixels-root`` over the raw-frame folds in
    bf16, ``--fp32-trunk`` and ``--int8-trunk --int8-fe``: per-fold F1 and
    wall, int8 launches against the design (53 a trunk batch, 3 a test
    trial's request); then the T = 300 request's latency through each
    trunk. Returns the int8 run's launches of the int8 kernel."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import ensemble
    from med_tpu_torch.data.trials import compute_fold_stats, load_fold_trials
    from med_tpu_torch.config import run_config
    from med_tpu_torch.eval.serving import (PixelFrontEnd, load_ensemble,
                                            predict_trial_from_pixels)
    from med_tpu_torch.ops.quant import int8_conv
    from med_tpu_torch.tracking import RunTracker

    runs_root = str(root / "runs")
    argv = ["--runs-root", runs_root, "--folds", ",".join(PIXEL_SPLITS), "--mode",
            "soft_vote", "--run-a", runs["video"], "--run-b", runs["kinematics"], "--serve",
            "--pixels-root", str(root / "pixels"), "--resnet-ckpt", ckpt,
            "--serve-batch-size", str(TRUNK_BATCH)]
    chunks = sum(-(-PIXEL_TRIALS[i] // TRUNK_BATCH) for tr, te in PIXEL_SPLITS.values()
                 for i in (*tr, *te))
    counts = {}
    for name, extra in (("bf16", []), ("fp32", ["--fp32-trunk"]),
                        ("int8", ["--int8-trunk", "--int8-fe"])):
        ops.reset_launch_counts()
        int8_conv.launches = 0
        t0 = time.perf_counter()
        lines = _cli_lines(ensemble.main, argv + extra, f"[ensemble] pixels {name}:")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = int8_conv.launches
        design = 53 * chunks + 3 * len(PIXEL_SPLITS) if name == "int8" else 0
        if counts[name] != design or any(ops.launch_counts().values()) or not any(
                f"trunk={name}" in ln for ln in lines):
            raise RuntimeError(f"pixel serving {name}: {counts[name]} int8 launches != "
                               f"{design} ({chunks} trunk batches); the eleven: "
                               f"{_nonzero(ops.launch_counts())}")
        log(f"[ensemble] pixels {name}: {wall:.2f} s for {len(PIXEL_SPLITS)} folds "
            f"({wall / len(PIXEL_SPLITS):.2f} s a fold: trunk features of the train split, "
            f"fold statistics, the test trials); int8 launches {counts[name]}")
    fold = next(iter(PIXEL_SPLITS))
    trials = load_fold_trials(str(root / "pixels" / fold), "train.csv")
    test = load_fold_trials(str(root / "pixels" / fold), "test.csv")[0]
    cfg = run_config(RunTracker.find_run(runs_root, runs["video"]))
    geometry = dict(stage_sizes=TRUNK["stage_sizes"], width=TRUNK["width"])
    latency = {}
    # the frames as load_fold_trials gives them (float32, as med_tpu's loader
    # does) and as a camera gives them (uint8, a quarter of the bytes)
    frames = {"float32": test.image_feats, "uint8": test.image_feats.astype(np.uint8)}
    for name, kw in (("bf16", {}), ("fp32", {"dtype": torch.float32}),
                     ("int8", {"int8": True, "calib_frames": trials[0].image_feats[:32]})):
        fe = PixelFrontEnd.from_checkpoint(ckpt.format(fold=fold), batch_size=TRUNK_BATCH,
                                           **geometry, **kw)
        feats = np.concatenate([fe.features(t.image_feats) for t in trials])
        stats = compute_fold_stats(feats, np.concatenate([t.kinematics for t in trials]))
        server = load_ensemble(runs_root, [runs["video"], runs["kinematics"]], "LOSO", fold)
        for kind, pixels in frames.items():
            t = []
            for _ in range(4):
                t0 = time.perf_counter()
                starts, preds, _ = predict_trial_from_pixels(fe, server, pixels,
                                                             test.kinematics, test.g_labels,
                                                             cfg, stats)
                t.append((time.perf_counter() - t0) * 1e3)
            latency[f"{name} trunk, {kind} frames"] = statistics.median(t[1:])
        if not len(starts):
            raise RuntimeError("the pixel request emitted no window")
    log(f"[ensemble] T={test.n_frames} raw-frame request ({len(starts)} windows, the "
        f"soft vote of both runs), median of 3: "
        + ", ".join(f"{n} {v:.2f} ms" for n, v in latency.items()))
    return counts["int8"]


def phase_ensemble(root: Path, splits, cog_run: str, es_run: str) -> dict:
    """Window ensembles, results and the int8 path on the card (phase 11 of
    the module docstring). Returns the int8 kernel's entries of the
    kernels line, each with its launches on its own path."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import ensemble, results, train_window
    from med_tpu_torch.ops.quant import int8_conv

    argv = ["--data-root", str(root / "data"), "--runs-root", str(root / "runs"),
            "--folds", ",".join(splits), "--n-epochs", "2", "--model-name", "SimpleCNN"]
    runs = {}
    for data_type in ("video", "kinematics"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, tracker = train_window.main([*argv, "--data-type", data_type])
        torch.cuda.synchronize()
        _check_window_run(Path(tracker.dir), f"SimpleCNN_5Hz_{data_type}", splits, res,
                          time.perf_counter() - t0,
                          {"model_name": "SimpleCNN", "data_type": data_type, "video_dims": 32,
                           "batch_size": 512, "n_epochs": 2}, 2,
                          f"[ensemble] train_window SimpleCNN {data_type}")
        runs[data_type] = tracker.run_id
    pair = ["--runs-root", str(root / "runs"), "--folds", ",".join(splits)]
    lines = _cli_lines(ensemble.main, [*pair, "--mode", "soft_vote", "--run-a", runs["video"],
                                       "--run-b", runs["kinematics"]],
                       "[ensemble] offline soft vote:")
    if not lines[0].startswith("overlap:"):
        raise RuntimeError("the offline soft vote printed no overlap line")
    lines = _cli_lines(ensemble.main, [*pair, "--mode", "cascade", "--run-a", cog_run,
                                       "--run-b", es_run], "[ensemble] offline cascade:")
    if not any("reconciled ND rows" in line for line in lines):
        raise RuntimeError("the cascade reconciled no Needle-Drop rows")
    serve = [*pair, "--mode", "soft_vote", "--run-a", runs["video"], "--run-b",
             runs["kinematics"], "--serve", "--data-root", str(root / "data")]
    _cli_lines(ensemble.main, serve, "[ensemble] --serve:")
    int8_conv.launches = 0
    _cli_lines(ensemble.main, [*serve, "--int8-fe"], "[ensemble] --serve --int8-fe:")
    fe_path = int8_conv.launches
    if fe_path != 3 * len(splits):
        raise RuntimeError(f"--serve --int8-fe: {fe_path} int8 launches != "
                           f"{3 * len(splits)} (3 a fold's request)")
    serving = _ensemble_serving(root, splits, runs)

    with tempfile.TemporaryDirectory() as tmp:
        trunk_ckpt, _, _ = _seeded_trunk(tmp, device=CARD)
        pixel_ckpt = _write_pixel_folds(root / "pixels", trunk_ckpt)
    trunk_path = _pixel_serving(root, pixel_ckpt, runs)
    entries = _int8_kernel_checks(pixel_ckpt.format(fold="1Out"), serving)
    entries["int8_conv/trunk"]["launches"] = trunk_path
    entries["int8_conv/fe"]["launches"] = fe_path

    for argv_r in (["table", "--run", f"video={runs['video']}", "--run",
                    f"kinematics={runs['kinematics']}"], ["errors", "--run-id", runs["video"]],
                   ["majority", "--run-id", runs["video"]],
                   ["ttest", "--run-a", runs["video"], "--run-b", runs["kinematics"]],
                   ["overlap", "--run-a", runs["video"], "--run-b", runs["kinematics"]]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results.main([*argv_r, *pair])
        for line in buf.getvalue().splitlines():
            log(f"[ensemble] results {argv_r[0]}:   {line}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log("[ensemble] matplotlib is not installed: no `results hist`, and the drivers "
            "printed `plotting skipped` in place of their images/")
    else:
        image = root / "prob_hist.png"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results.main(["hist", "--run-id", runs["video"], "--out-image", str(image), *pair])
        if not image.is_file():
            raise RuntimeError("results hist wrote no image")
        log(f"[ensemble] results hist: {buf.getvalue().strip()} ({image.stat().st_size} "
            "bytes); the drivers' images/ checked with each run's layout")
    return entries

# the fine-tune phase (12): the CLI's batch at full width and 224x224
# frames, phase 11's raw-frame trials; the CLIP text tower at ViT-B/32's
# geometry with seeded weights
FINETUNE_BATCH, FINETUNE_IMAGES, FINETUNE_EPOCHS = 32, 60, 2
# card fp32 step against the CPU's float64 one, the relu pattern and the
# max pool's choices pinned: loss rtol; each gradient leaf rtol, and atol
# as a fraction of the leaf's largest |value| (TRAIN_TOL's), or twice the
# CPU's fp32 error on the leaf; running statistics. cuDNN's fp32 weight
# gradients of the convolutions (TF32 off, deterministic algorithms) land
# up to 1.81e-4 of a leaf's largest from float64 on an H100 (the 3x3
# convs of stages 1-3; the CPU's fp32 within 1.3e-5): those leaves are
# held to cudnn_conv_grad. Augmented 0-255 pixels, card vs CPU: float32 tan and sin of
# one angle may differ by an ulp, which moves a shear's shift by ~1e-6
# pixel at the frame's edge (|dx| <= 111.5 at 224) and a pixel between
# neighbours 255 apart by up to ~6e-4 over the three passes (2.4e-4 seen)
FINETUNE_TOL = {"loss": 1e-5, "grad_rtol": 1e-4, "grad_atol": 1e-5, "stats": 1e-5,
                "augment": 1e-3, "cudnn_conv_grad": 5e-4}
# the fine-tune step's device time by kind of kernel (first matching
# substring of the kernel's name, in this order)
STEP_KINDS = (("convolutions (cuDNN)", ("cudnn", "conv", "xmma", "gemm", "wgrad", "dgrad",
                                        "implicit", "winograd", "fft")),
              ("reductions", ("reduce",)), ("Adam", ("multi_tensor", "adam")),
              ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "gather",
                               "where", "clamp", "copy")))
CLIP_B32 = {"vocab": 49408, "ctx": 77, "width": 512, "heads": 8, "layers": 12}
CLIP_TOL = (1e-4, 1e-5)      # rtol, atol as a fraction of the table's largest |value|


class _ChoicePins:
    """``models.resnet.relu`` and ``models.resnet.max_pool`` while entered:
    the first run records the relus' derivative patterns and the pool's
    choices (the CPU's float64 step), later runs (``start_pinned``) take
    them, counting the relu pre-activations whose sign differs (and the
    largest of them over its layer's largest |value|) and the pool windows
    whose choice differs (and their largest gap over the largest |value|):
    a value within rounding of 0, or of its window's runner-up, routes one
    pixel's gradient term elsewhere."""

    def __enter__(self):
        from med_tpu_torch.models import resnet

        self.resnet, self.masks, self.choices, self.pin = resnet, [], [], False
        self.saved = resnet.relu, resnet.max_pool
        resnet.relu, resnet.max_pool = self.relu, self.max_pool
        return self

    def __exit__(self, *exc):
        self.resnet.relu, self.resnet.max_pool = self.saved

    def start_pinned(self):
        self.pin, self.i, self.j = True, 0, 0
        self.flips, self.largest, self.pool_flips, self.pool_gap = 0, 0.0, 0, 0.0

    def relu(self, x):
        if not self.pin:
            self.masks.append((x > 0).cpu())
            return torch.relu(x)
        m = self.masks[self.i].to(x.device)
        self.i += 1
        flipped = (x > 0) != m
        n = int(flipped.sum())
        if n:
            self.flips += n
            a = x.detach().abs()
            self.largest = max(self.largest, float(a[flipped].max() / a.max().clamp_min(1e-30)))
        return x * m.to(x.dtype)

    def max_pool(self, x):
        y, idx = F.max_pool2d(x, 3, stride=2, padding=1, return_indices=True)
        if not self.pin:
            self.choices.append(idx.cpu())
            return y
        want = self.choices[self.j].to(x.device)
        self.j += 1
        differ = idx != want
        n = int(differ.sum())
        pinned = x.flatten(2).gather(2, want.flatten(2)).view(y.shape)
        if n:
            self.pool_flips += n
            gap = (y - pinned).detach().abs()
            self.pool_gap = max(self.pool_gap, float(gap[differ].max() / y.detach().abs().max()))
        return pinned


def _finetune_net(ckpt: str, stride: int, dtype, device):
    """The fine-tune classifier at full width: phase 7's seeded trunk from
    its checkpoint, the head drawn from SEED."""
    from med_tpu_torch.models import init_weights
    from med_tpu_torch.models.resnet import ResNetClassifier
    from med_tpu_torch.train.checkpoint import load_checkpoint
    from med_tpu_torch.utils.jax_params import load_jax_params

    net = init_weights(ResNetClassifier(TRUNK["stage_sizes"], TRUNK["width"], dtype=dtype,
                                        bn_stat_stride=stride),
                       torch.Generator().manual_seed(SEED))
    tree = load_checkpoint(ckpt)
    state, _ = load_jax_params({"params": tree["params"]["trunk"],
                                "batch_stats": tree["batch_stats"]["trunk"]}, net.trunk)
    net.trunk.load_state_dict(state)
    return net.to(device, dtype)


def _finetune_step(net, batch, pixel_stats, freeze: bool, draws=None):
    """One ``cli.resnet_finetune.train_step`` on the net's device and dtype;
    returns the loss, the gradients and the running statistics (float64 on
    the CPU)."""
    from med_tpu_torch.cli.resnet_finetune import train_step

    p = next(net.parameters())
    opt = torch.optim.Adam(net.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    stats = tuple(torch.tensor(a, dtype=p.dtype, device=p.device) for a in pixel_stats)
    loss = train_step(net, opt, *batch, stats, freeze, draws)
    grads = {n: q.grad.detach().to("cpu", torch.float64) for n, q in net.named_parameters()}
    bufs = {n: b.detach().to("cpu", torch.float64) for n, b in net.named_buffers()}
    return float(loss), grads, bufs


def _finetune_card_vs_cpu(ckpt: str, batch, pixel_stats) -> None:
    """The card's float32 step against the CPU's float64 step, the card's
    relu patterns and max-pool choices pinned to the CPU's, for train-mode
    BN, --freeze-bn and bn_stat_stride 4; the CPU's float32 step (pinned
    too) logged beside."""
    for case, stride, freeze in (("exact", 1, False), ("--freeze-bn", 1, True),
                                 ("bn_stat_stride 4", 4, False)):
        with _ChoicePins() as pins:
            want = _finetune_step(_finetune_net(ckpt, stride, torch.float64, "cpu"), batch,
                                  pixel_stats, freeze)
            res = {}
            for dev in (CARD, "cpu"):
                pins.start_pinned()
                res[dev] = (_finetune_step(_finetune_net(ckpt, stride, torch.float32, dev),
                                           batch, pixel_stats, freeze),
                            (pins.flips, pins.largest, pins.pool_flips, pins.pool_gap))
        errs = {dev: (abs(loss - want[0]) / abs(want[0]), _leaf_errors(grads, want[1]),
                      _leaf_errors(bufs, want[2]), choices)
                for dev, ((loss, grads, bufs), choices) in res.items()}
        rel, leaves, stats, (flips, largest, pool, gap) = errs[CARD]
        cpu_rel, cpu_leaves, _, cpu_choices = errs["cpu"]
        # a leaf passes within grad_atol of its largest value, or within
        # twice the CPU's own fp32 error on it where fp32 does no better
        # (cuDNN's fp32 weight gradients sum ~1e5 terms that largely cancel)
        own = {n: e for e, n in cpu_leaves}
        conv = ("conv1.weight", "conv2.weight", "conv3.weight", "down_conv.weight")
        failed = [n for e, n in leaves if e > max(
            FINETUNE_TOL["grad_atol"], 2 * own[n],
            FINETUNE_TOL["cudnn_conv_grad"] if n.endswith(conv) else 0.0)]
        other = next((e, n) for e, n in leaves if not n.endswith(conv))
        log(f"[finetune] step card fp32 vs CPU float64 ({case}, B={len(batch[0])}, "
            f"{TRUNK['frame']}x{TRUNK['frame']}): loss {rel:.2e} relative (tol "
            f"{FINETUNE_TOL['loss']}), running statistics {stats[0][0]:.2e} of each one's "
            f"largest (tol {FINETUNE_TOL['stats']}), worst gradient leaf {leaves[0][0]:.2e} "
            f"of its largest ({leaves[0][1]}; tol {FINETUNE_TOL['grad_atol']}, or twice the "
            f"CPU's fp32 error on the leaf, a conv weight "
            f"{FINETUNE_TOL['cudnn_conv_grad']}), the worst other than a conv weight "
            f"{other[0]:.2e} ({other[1]}); pinned: {flips} relu flips (|pre-activation| <= "
            f"{largest:.1e} of the layer's largest), {pool} max-pool choices (gap <= "
            f"{gap:.1e}); the CPU's fp32 step: loss {cpu_rel:.2e}, worst leaf "
            f"{cpu_leaves[0][0]:.2e} ({cpu_leaves[0][1]}), {cpu_choices[0]} relu flips, "
            f"{cpu_choices[2]} pool choices")
        if rel > FINETUNE_TOL["loss"] or stats[0][0] > FINETUNE_TOL["stats"] or failed:
            raise RuntimeError(f"fine-tune step ({case}) card vs CPU: loss {rel:.2e}, "
                               f"statistics {stats[0]}, leaves over tolerance {failed}")


def _finetune_timing(ckpt: str, batch, pixel_stats, profile: bool) -> None:
    """Step time (median of 5), frames/s, peak memory and the device's busy
    share of a step, with and without augmentation, at FINETUNE_BATCH."""
    from med_tpu_torch.cli.resnet_finetune import train_step
    from med_tpu_torch.data.augment import draw_augment

    net = _finetune_net(ckpt, 1, torch.float32, CARD)
    opt = torch.optim.Adam(net.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    stats = tuple(torch.tensor(a, device=CARD) for a in pixel_stats)
    gen = torch.Generator().manual_seed(SEED)
    for augment in (False, True):
        def step():
            draws = draw_augment(len(batch[0]), gen) if augment else None
            train_step(net, opt, *batch, stats, False, draws)
            torch.cuda.synchronize()

        step()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        events = _device_events(step, 3)
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / 3
        kinds = {}
        for e in events:
            name = e.name.lower()
            kind = next((k for k, keys in STEP_KINDS if any(w in name for w in keys)), "other")
            kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
        log(f"[finetune] train step B={len(batch[0])} {TRUNK['frame']}x{TRUNK['frame']} "
            f"{'with' if augment else 'without'} augmentation: {ms:.3f} ms (median of 5; "
            f"{min(times):.3f}-{max(times):.3f}), {len(batch[0]) / ms * 1e3:.1f} frames/s, "
            f"peak {peak:.2f} GiB, device busy {busy:.3f} ms a step "
            f"({busy / ms:.1%} of it, profiler, 3 steps): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f"; {len(events) // 3} device kernels a step")
        if profile:
            _profile(f"fine-tune step {'augmented' if augment else 'plain'}", step)


def _finetune_folds(root: Path, trials: Path) -> dict:
    """Phase 11's raw-frame trials (``trials``) in folds whose csv files list
    them by name (the fine-tune CLI copies the csv files beside its
    exported trials), linked from ``root``; returns {fold: (train names,
    test names)}."""
    names = sorted(p.stem for p in trials.glob("*.npz"))
    splits = {fold: ([names[i] for i in tr], [names[i] for i in te])
              for fold, (tr, te) in PIXEL_SPLITS.items()}
    for fold, (train, test) in splits.items():
        (root / fold).mkdir(parents=True)
        for name in train + test:
            (root / fold / f"{name}.npz").symlink_to(trials / f"{name}.npz")
        for csv, group in (("train.csv", train), ("test.csv", test)):
            (root / fold / csv).write_text("\n".join(f"{n}.npz" for n in group))
    return splits


def _finetune_cli(root: Path, splits, int8: bool) -> tuple:
    """``cli.resnet_finetune.main`` on the raw-frame folds for
    FINETUNE_EPOCHS epochs: the run layout, the checkpoints (loaded back by
    ``PixelFrontEnd.from_checkpoint``, whose fp32 features must be the
    exported ones), the exported 2048-d folds with each trial's length; no
    TPU kernel launched; with ``int8`` 53 int8 launches an export batch.
    Returns the output root and the int8 launches."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import resnet_finetune
    from med_tpu_torch.data.trials import load_fold, load_trial
    from med_tpu_torch.eval.serving import PixelFrontEnd
    from med_tpu_torch.ops.quant import int8_conv

    tag = "[finetune] cli" + (" --int8-trunk" if int8 else "")
    out = root / ("features_int8" if int8 else "features")
    runs = root / "runs"
    before = set(runs.glob("ResNet50_finetune/*")) if runs.exists() else set()
    ops.reset_launch_counts()
    int8_conv.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        resnet_finetune.main(["--data-root", str(root / "raw"), "--output-root", str(out),
                              "--folds", ",".join(splits), "--runs-root", str(runs),
                              "--n-epochs", str(FINETUNE_EPOCHS), "--seed", str(SEED),
                              "--batch-size", str(FINETUNE_BATCH),
                              *(["--int8-trunk"] if int8 else [])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"{tag}   {line}")
    if any(ops.launch_counts().values()):
        raise RuntimeError(f"{tag}: TPU kernels launched {_nonzero(ops.launch_counts())}")
    (run,) = set(runs.glob("ResNet50_finetune/*")) - before
    want = {"params.json", "metrics.jsonl"} | {
        f"checkpoints/resnet50_{fold}.npz{ext}" for fold in splits for ext in ("", ".json")}
    files = {str(f.relative_to(run)) for f in run.rglob("*") if f.is_file()}
    if files != want:
        raise RuntimeError(f"{tag}: run layout {sorted(files)} != {sorted(want)}")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != 2 * FINETUNE_EPOCHS * len(splits):
        raise RuntimeError(f"{tag}: {len(rows)} metric rows")
    lengths = {p.stem: len(np.load(p)["e_labels"])
               for p in (root.parent / "pixels" / "trials").glob("*.npz")}
    batches = 0
    for fold, (train, test) in splits.items():
        for csv, group in (("train.csv", train), ("test.csv", test)):
            img, kin, g, e, _ = load_fold(str(out / fold), csv)
            n = sum(lengths[t] for t in group)
            if img.shape != (n, 2048) or kin.shape != (n, 26) or not np.isfinite(img).all():
                raise RuntimeError(f"{tag} {fold} {csv}: features {img.shape}, not ({n}, 2048)")
            batches += sum(-(-lengths[t] // FINETUNE_BATCH) for t in group)
        if not int8:
            ckpt = str(run / "checkpoints" / f"resnet50_{fold}.npz")
            fe = PixelFrontEnd.from_checkpoint(ckpt, dtype=torch.float32)
            trial = load_trial(str(root / "raw" / fold / f"{test[0]}.npz"))
            got = fe.features(trial.image_feats)
            exported = load_trial(str(out / fold / f"{test[0]}.npz")).image_feats
            rel = np.linalg.norm(got - exported) / np.linalg.norm(exported)
            if rel > TRUNK_TOL["card_vs_cpu_fp32"]:
                raise RuntimeError(f"{tag} {fold}: PixelFrontEnd features {rel:.2e} from "
                                   "the exported ones")
            log(f"{tag} {fold}: PixelFrontEnd.from_checkpoint serves the checkpoint, "
                f"fp32 features {rel:.2e} (relative L2) from the exported {test[0]}")
    launches = int8_conv.launches
    if int8 and launches != 53 * batches:
        raise RuntimeError(f"{tag}: {launches} int8 launches != 53 x {batches} export batches")
    log(f"{tag}: {len(splits)} folds x {FINETUNE_EPOCHS} epochs, {wall:.2f} s of wall, run "
        f"layout ok, exported 2048-d folds whole ({batches} export batches"
        + (f", {launches} int8 launches: 53 a batch)" if int8 else ")"))
    return out, launches


def _seeded_clip(path: Path) -> tuple:
    """A CLIP ViT-B/32 text tower's state dict (CLIP_B32) with weights from
    SEED, saved as a torch ``.pt``, and a merges file of the real count
    (48,894 pairs of byte symbols, so that the vocabulary is 49,408 and EOT
    its largest id)."""
    from med_tpu_torch.models.clip_tokenizer import _byte_encoder

    g = torch.Generator().manual_seed(SEED)
    d, L = CLIP_B32["width"], CLIP_B32["layers"]

    def draw(*shape, scale=0.02):
        return torch.randn(shape, generator=g) * scale

    sd = {"token_embedding.weight": draw(CLIP_B32["vocab"], d),
          "positional_embedding": draw(CLIP_B32["ctx"], d, scale=0.01),
          "ln_final.weight": 1 + draw(d, scale=0.1), "ln_final.bias": draw(d),
          "text_projection": draw(d, d, scale=d ** -0.5)}
    for i in range(L):
        p = f"transformer.resblocks.{i}"
        sd.update({f"{p}.attn.in_proj_weight": draw(3 * d, d), f"{p}.attn.in_proj_bias": draw(3 * d),
                   f"{p}.attn.out_proj.weight": draw(d, d), f"{p}.attn.out_proj.bias": draw(d),
                   f"{p}.ln_1.weight": 1 + draw(d, scale=0.1), f"{p}.ln_1.bias": draw(d),
                   f"{p}.ln_2.weight": 1 + draw(d, scale=0.1), f"{p}.ln_2.bias": draw(d),
                   f"{p}.mlp.c_fc.weight": draw(4 * d, d), f"{p}.mlp.c_fc.bias": draw(4 * d),
                   f"{p}.mlp.c_proj.weight": draw(d, 4 * d), f"{p}.mlp.c_proj.bias": draw(d)})
    torch.save(sd, path / "clip_vitb32_text.pt")
    syms = list(_byte_encoder().values())
    pairs = [f"{a} {b}" for a in syms for b in syms][:48894]
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(pairs) + "\n",
                                     encoding="utf-8")
    return str(path / "clip_vitb32_text.pt"), str(path / "merges.txt")


def _clip_tower(root: Path) -> None:
    """The CLIP text tower at ViT-B/32's geometry, card against CPU on COG's
    15 gesture, 45 skill and 15 skill-statement prompts; then a COG built
    with MED_TPU_CLIP_CKPT / MED_TPU_CLIP_BPE set (its tables the CLIP
    encodings, not the surrogate), saved and served at T = 300."""
    import os

    from med_tpu_torch.eval.serving import FrameModelServer
    from med_tpu_torch.models.clip_text import encode_text, load_clip_text_params, params_to
    from med_tpu_torch.models.clip_tokenizer import ClipTokenizer
    from med_tpu_torch.models.cog import prompt_texts
    from med_tpu_torch.models.prompts import (SKILL_STATEMENTS, _surrogate_table,
                                              encode_prompt_strings)

    ckpt, bpe = _seeded_clip(root)
    params = load_clip_text_params(ckpt)
    tok = ClipTokenizer(bpe)
    if len(tok.encoder) != CLIP_B32["vocab"]:
        raise RuntimeError(f"tokenizer vocabulary {len(tok.encoder)}")
    tables = {"gestures": prompt_texts(), "skill prompts": prompt_texts(True, True),
              "skill statements": SKILL_STATEMENTS}
    on = {dev: params_to(params, dev) for dev in ("cpu", CARD)}
    for name, texts in tables.items():
        ids = torch.from_numpy(tok.tokenize(list(texts), CLIP_B32["ctx"]))
        want = encode_text(on["cpu"], ids, n_heads=CLIP_B32["heads"])
        got = encode_text(on[CARD], ids.to(CARD), n_heads=CLIP_B32["heads"]).cpu()
        err = check_close(f"CLIP {name}", got, want, CLIP_TOL[0],
                          CLIP_TOL[1] * want.abs().max().item())
        ms = cuda_ms(lambda: encode_text(on[CARD], ids.to(CARD), n_heads=CLIP_B32["heads"]), 5)
        log(f"[finetune] CLIP text tower (12 x 512, 8 heads, vocab 49,408, context 77) "
            f"{name}: {len(texts)} x 512 card vs CPU max abs error {err:.2e} "
            f"(largest |value| {want.abs().max().item():.2f}), {ms:.3f} ms on the card")

    saved = {k: os.environ.get(k) for k in ("MED_TPU_CLIP_CKPT", "MED_TPU_CLIP_BPE")}
    os.environ.update(MED_TPU_CLIP_CKPT=ckpt, MED_TPU_CLIP_BPE=bpe)
    try:
        cfg = _serving_config(2048)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_cog = _seeded_checkpoint(cfg, tmp)
        built = time.perf_counter() - t0
        server = FrameModelServer(cfg, ckpt_cog)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    table = server.exp.net.model.gest_embed.cpu().numpy()
    want = encode_prompt_strings(ckpt, prompt_texts(), bpe)
    if not np.array_equal(table, want) or np.array_equal(table, _surrogate_table(prompt_texts())):
        raise RuntimeError("COG's gesture table is not the CLIP encoding of its prompts")
    rng = np.random.default_rng(SEED + 7)
    req = _request(rng, 300)
    server.predict_trial(*req)
    t0 = time.perf_counter()
    preds, probs = server.predict_trial(*req)
    ms = (time.perf_counter() - t0) * 1e3
    _check_served("CLIP-prompted COG T=300", preds, probs, 300)
    log(f"[finetune] COG with MED_TPU_CLIP_CKPT: gest_embed (15 x 512) is the tower's "
        f"encoding (built with its checkpoint in {built:.1f} s), served at T=300 in "
        f"{ms:.2f} ms")


def phase_finetune(root: Path, profile: bool) -> int:
    """Backbone fine-tuning, raw-data folds and the CLIP tower on the card
    (phase 12 of the module docstring), under ``root`` beside phase 11's
    ``pixels``. Returns the int8 launches of the --int8-trunk export."""
    from med_tpu_torch import ops
    from med_tpu_torch.cli import resnet_finetune, train_frame
    from med_tpu_torch.data.augment import augment_batch, draw_augment
    from med_tpu_torch.data.trials import load_trial

    # the fine-tune CLI's cuDNN settings (it sets them itself): TF32 off, and
    # the deterministic algorithms
    torch.backends.cudnn.deterministic = True
    ft = root / "finetune"
    splits = _finetune_folds(ft / "raw", root / "pixels" / "trials")
    # phase 7's seeded trunk, as phase 11 wrote it for its folds
    ckpt = str(root / "pixels" / "resnet50_1Out.npz")
    trials = [load_trial(str(p)) for p in sorted((root / "pixels" / "trials").glob("*.npz"))]
    images = np.concatenate([t.image_feats for t in trials])[:FINETUNE_IMAGES]
    labels = np.concatenate([t.e_labels[:, 4] for t in trials])[:FINETUNE_IMAGES]
    # the CLI's second batch of FINETUNE_IMAGES frames: padded with frame 0
    batch = list(resnet_finetune._batches(images, labels, FINETUNE_BATCH, True, SEED))[1]
    pixel_stats = ((images.reshape(-1, 3).mean(0) / 255.0).astype(np.float32),
                   (images.reshape(-1, 3).std(0) / 255.0 + 1e-6).astype(np.float32))
    log(f"[finetune] batch of {FINETUNE_BATCH} ({int(batch[2].sum())} frames, "
        f"{FINETUNE_BATCH - int(batch[2].sum())} padding rows), labels {np.bincount(batch[1])}")
    _finetune_card_vs_cpu(ckpt, batch, pixel_stats)

    draws = draw_augment(FINETUNE_BATCH, torch.Generator().manual_seed(SEED))
    x = torch.from_numpy(batch[0])
    x_card = x.to(CARD)
    err = check_close("augment_batch card vs CPU", augment_batch(x_card, draws).cpu(),
                      augment_batch(x, draws), 0, FINETUNE_TOL["augment"])
    ms = cuda_ms(lambda: augment_batch(x_card, draws), 5)
    log(f"[finetune] augment_batch card vs CPU, the same draws: max abs error {err:.2e} "
        f"on 0-255 pixels; {ms:.3f} ms a batch of {FINETUNE_BATCH} on the card")
    _finetune_timing(ckpt, batch, pixel_stats, profile)

    out, _ = _finetune_cli(ft, splits, int8=False)
    _, int8_launches = _finetune_cli(ft, splits, int8=True)

    # the reference's chain from pixels to a frame model: COG on the exported folds
    lengths = {t.name: t.n_frames for t in trials}
    n_train = sum(len(tr) for tr, _ in splits.values())
    n_test = sum(len(te) for _, te in splits.values())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results, tracker = train_frame.main(
        ["--model-name", "COG", "--data-type", "multimodal", "--data-root", str(out),
         "--runs-root", str(ft / "runs"), "--folds", ",".join(splits), "--n-epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = {**forward_launches(n_train + n_test), **backward_launches(n_train)}
    if launches != want:
        raise RuntimeError(f"train_frame on the exported folds: launches {launches} != {want}")
    for fold, (_, test) in splits.items():
        _check_served(f"train_frame on exported fold {fold}", results[fold]["preds"],
                      results[fold]["probs"], sum(lengths[t] for t in test))
    log(f"[finetune] cli.train_frame COG, 1 epoch on the exported folds: {wall:.2f} s, "
        f"launches as designed, best test F1 "
        f"{ {f: round(results[f]['test_f1'], 4) for f in splits} } (run {tracker.run_id})")
    _clip_tower(ft)
    return int8_launches

PARALLEL_FRAMES = 4096          # the SP trial: two shards of 2048 frames
GROUP_FRAMES = (1000, 1500)     # the trial-DP group
PIPELINE = dict(M=4, T=1000)    # microbatches of the pipeline check


@contextlib.contextmanager
def _sp_relu(pin, flips):
    """SP's plain stacks (``parallel/seqpar.py``'s ``relu``) take each
    layer's relu pattern, in call order, from ``pin`` (this rank's rows of
    the single-rank run's), and append (flipped entries, their largest
    |pre-activation| over the call's largest) to ``flips``."""
    from med_tpu_torch.parallel import seqpar

    plain = seqpar.relu
    calls = iter(pin)

    def relu(x):
        keep = next(calls).to(x.device)
        flip = keep != (x > 0)
        near = x[flip].abs().max().item() if bool(flip.any()) else 0.0
        flips.append((int(flip.sum()), near / max(x.abs().max().item(), 1e-30)))
        return x * keep.to(x.dtype)

    seqpar.relu = relu
    try:
        yield
    finally:
        seqpar.relu = plain


def _grads_within(tag: str, got: dict, want: dict) -> float:
    """Raise unless every leaf of ``got`` lies within TRAIN_TOL of ``want``'s
    (rtol, and atol of the leaf's largest |value|); the largest error of a
    leaf over its largest |value|."""
    worst, failed = 0.0, []
    for n, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        err = (got[n].to(w.device) - w).abs()
        worst = max(worst, err.max().item() / scale)
        if (err - TRAIN_TOL["grad_rtol"] * w.abs()).max().item() > TRAIN_TOL["grad_atol"] * scale:
            failed.append(n)
    if failed:
        raise RuntimeError(f"{tag}: gradients out of tolerance against one rank: {failed}")
    return worst


def _loss_within(tag: str, got: float, want: float) -> float:
    rel = abs(got - want) / abs(want)
    if rel > TRAIN_TOL["loss"]:
        raise RuntimeError(f"{tag}: loss {got} against one rank's {want} (rel {rel:.2e})")
    return rel


def _flips_within(tag: str, flips) -> int:
    if flips and max(r for _, r in flips) > FLIP_PRE:
        raise RuntimeError(f"{tag}: relu flips away from 0: {flips}")
    return sum(n for n, _ in flips)


def _synced_ms(fn, runs: int = 3) -> float:
    """Median host ms of ``fn`` ending in a device sync and a barrier of the
    ranks, after a warm call."""
    from med_tpu_torch.parallel import launch

    times = []
    for _ in range(runs + 1):
        launch.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        launch.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def _sp_rank_check(model_name: str) -> dict:
    """One SP train step of COG (full width, multimodal) or TeCNo (the CLI's
    defaults) on this rank's shard of a T = PARALLEL_FRAMES trial, against
    the single-rank engine step on the card with the same weights and
    dropout masks, relu patterns pinned (the encoder FFN's columns and the
    stacks' rows of this rank). Returns its numbers and launches."""
    from med_tpu_torch import ops
    from med_tpu_torch.data.datasets import frame_batch
    from med_tpu_torch.parallel import comm, launch
    from med_tpu_torch.parallel.mesh import make_mesh
    from med_tpu_torch.parallel.seqpar import shard_sequence
    from med_tpu_torch.parallel.sp_train import SPFrameTrainer
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    tag = f"[parallel] SP {model_name}"
    cfg = _train_config() if model_name == "COG" else _family_config(model_name)
    T = PARALLEL_FRAMES
    trial = _trial(np.random.default_rng(SEED + 7), T, "Needle_Passing_B001")
    batch = frame_batch(trial, cfg)
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        T, torch.Generator().manual_seed(SEED), 1)
    ffn, tcn = [], []
    ops.reset_launch_counts()
    with _ffn_relu(record=ffn), _tcn_relu(record=tcn):
        want_loss, want = _step_gradients(cfg, batch, masks, CARD)
    single = ops.launch_counts()

    mesh = make_mesh((launch.world_size(), 1))
    n, r = mesh.shape["data"], mesh.coord("data")
    trainer = SPFrameTrainer(cfg, mesh, device=CARD)
    trainer.exp.init_weights(SEED)
    local = trainer.shard(trainer.make_batch(trial, T))
    g = trainer.group
    dp = {name: {"stack": shard_sequence(st["stack"][:, 0], g, axis=1).to(CARD),
                 **({"channel": st["channel"].reshape(-1).to(CARD)} if "channel" in st else {})}
          for name, st in masks.items()}
    if model_name == "TeCNo":
        dp = {name: st["stack"] for name, st in dp.items()}
    N = local["labels"].shape[0] * (ffn[0].shape[-1] // T if ffn else 0)
    ffn_pins = [p[..., r * N:(r + 1) * N] for p in ffn]
    layer_pins = [(y[l] > 0)[r * (y.shape[1] // n):(r + 1) * (y.shape[1] // n)]
                  for y in tcn for l in range(y.shape[0])]

    def step():
        trainer.exp.optimizer.zero_grad(set_to_none=False)
        loss, _ = trainer._forward_loss(local, dp)
        loss.backward()
        comm.all_reduce_grads(trainer.exp.net.parameters(), g)
        return loss

    ffn_flips, tcn_flips = [], []
    ops.reset_launch_counts()
    with _ffn_relu(pin=ffn_pins, flips=ffn_flips), _sp_relu(layer_pins, tcn_flips):
        loss = step().item()
    launches = ops.launch_counts()
    got = {k: torch.from_numpy(v) for k, v in
           _flat(export_jax_params(trainer.exp.net, grads=True)["params"]).items()}
    out = dict(loss=loss, loss_rel=_loss_within(tag, loss, want_loss),
               grad_err=_grads_within(tag, got, want),
               flips=(_flips_within(tag, ffn_flips), _flips_within(tag, tcn_flips)),
               launches=launches, single_launches=single,
               step_ms=_synced_ms(step), rank=r, shards=n)
    if model_name == "COG":
        for k in ("sliding_window_attention_packed", "sliding_window_attention_packed_bwd"):
            if launches[k] != single[k] or launches[k] < 1:
                raise RuntimeError(f"{tag}: {k} launched {launches[k]} times on rank {r}, "
                                   f"the single-rank step {single[k]}")
    return out


def _group_inputs():
    """The trial group of the trial-DP checks: COG (full width, multimodal)
    with trial_batch 2 on two trials of GROUP_FRAMES, its batch and masks."""
    cfg = _train_config().replace(trial_batch=2, fused_run=False)
    rng = np.random.default_rng(SEED + 8)
    trials = [_trial(rng, T, f"Needle_Passing_{c}001") for T, c in zip(GROUP_FRAMES, "CD")]
    return (cfg, *_step_inputs(cfg, trials))


def _trial_dp_rank_check() -> dict:
    """One trial-parallel COG step (:func:`_group_inputs`, one trial a rank)
    on the card: its loss and every gradient leaf, for the parent to hold
    against the grouped step in float64 (:func:`_group_step_check`)."""
    from med_tpu_torch.parallel import launch
    from med_tpu_torch.parallel.mesh import make_mesh, shard_state
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    cfg, batch, masks = _group_inputs()
    exp = Experiment(cfg, device=CARD)
    exp.init_weights(SEED)
    shard_state(exp, make_mesh((launch.world_size(), 1)))
    loss, _ = exp.compute_gradients(batch, masks={
        k: {kk: vv.to(CARD) for kk, vv in d.items()} for k, d in masks.items()})
    return dict(loss=loss.item(), grads={
        k: np.asarray(v, np.float64)
        for k, v in _flat(export_jax_params(exp.net, grads=True)["params"]).items()})


def _group_step_check(ranks) -> None:
    """The grouped COG step (trial_batch 2 at T = GROUP_FRAMES) and the
    trial-parallel ranks' step against the CPU's float64 grouped step. In
    float64 the grouped step must equal the mean of its trials' one-trial
    steps to 1e-9 of each leaf's largest (the grouped program is its
    trials' programs). Gradients of the refinement stacks at these lengths
    are sums over ~3,000 frames that mostly cancel, so a float32 step lies
    up to a few 1e-3 of a leaf's largest from float64 whatever runs it,
    relu patterns pinned or not: the CPU's float32 grouped step measures
    that floor in this run, and the card's grouped step and each rank's
    step must lie within twice it (every leaf; losses within TRAIN_TOL)."""
    cfg, batch, masks = _group_inputs()
    ref_loss, ref = _step_gradients64(cfg, batch, masks)
    per = []
    for b in range(cfg.trial_batch):
        one = {k: v[b] for k, v in batch.items() if k != "trial_weight"}
        mk = {n: {k: v[:, b:b + 1] if k == "stack" else v[b:b + 1] for k, v in d.items()}
              for n, d in masks.items()}
        per.append(_step_gradients64(cfg.replace(trial_batch=1), one, mk)[1])

    def errors(got):
        return {k: (got[k].double().cpu() - w).abs().max().item() / w.abs().max().item()
                for k, w in ref.items()}

    exact = max(errors({k: sum(p[k] for p in per) / len(per) for k in ref}).values())
    if exact > 1e-9:
        raise RuntimeError(f"[parallel] group: the float64 grouped step is {exact:.2e} of a "
                           f"leaf's largest from its one-trial steps")
    runs = {"CPU fp32 grouped": _step_gradients(cfg, batch, masks, "cpu"),
            "card grouped": _step_gradients(cfg, batch, masks, CARD)}
    for r, out in enumerate(ranks):
        runs[f"card trial-DP rank {r}"] = (out["loss"], {k: torch.from_numpy(v) for k, v
                                                         in out["grads"].items()})
    errs = {name: errors(g) for name, (_, g) in runs.items()}
    floor = max(errs["CPU fp32 grouped"].values())
    frames = "+".join(map(str, GROUP_FRAMES))
    log(f"[parallel] group: COG trial_batch 2 at T={frames}, float64 grouped step against "
        f"the mean of its one-trial steps: {exact:.2e} of a leaf's largest")
    for name, (loss, _) in runs.items():
        e = errs[name]
        worst = sorted(e, key=e.get, reverse=True)[:4]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        log(f"[parallel] group: {name} against float64 at T={frames}: loss rel {rel:.2e}, "
            f"largest leaf error {max(e.values()):.2e} (tol {2 * floor:.2e}: twice the CPU "
            f"fp32 step's), worst leaves {[(k, f'{e[k]:.2e}') for k in worst]}")
        if rel > TRAIN_TOL["loss"] or max(e.values()) > 2 * floor:
            raise RuntimeError(f"[parallel] group: {name} off the float64 step: loss rel "
                               f"{rel:.2e}, leaf error {max(e.values()):.2e}")


def _window_dp_rank_check(shape) -> dict:
    """The SimpleCNN window step (the CLI's defaults, B = WINDOW_BATCH) on a
    (data, model) mesh against the single-rank step on the card: loss,
    running statistics, every gradient leaf, relu and max-pool choices
    pinned to the single-rank run's (this rank's rows, or the
    FeatureExtractor's first layer's columns of this model rank)."""
    from med_tpu_torch.parallel.mesh import _gather, make_mesh, shard_state
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.utils.jax_params import export_jax_params

    tag = f"[parallel] window step on mesh {shape}"
    cfg = _window_config("SimpleCNN")
    batch = _window_batch(cfg, np.random.default_rng(SEED))
    masks = Experiment(cfg, device="cpu").net.model.dropout_masks(
        WINDOW_BATCH, torch.Generator().manual_seed(SEED))
    record = []
    with _window_pins(record=record):
        want_loss, want, want_stats = _window_step(cfg, batch, masks, CARD)
    mesh = make_mesh(shape)
    exp = Experiment(cfg, device=CARD)
    exp.init_weights(SEED)
    shard_state(exp, mesh)
    per = WINDOW_BATCH // mesh.shape["data"]
    rows = slice(mesh.coord("data") * per, (mesh.coord("data") + 1) * per)
    cols = mesh.coord("model")

    def view(i, choice):
        if mesh.shape["model"] > 1:
            return choice.chunk(mesh.shape["model"], dim=-1)[cols] if i == 0 else choice
        return choice[rows]

    flips = []
    with _window_pins(pin=record, flips=flips, view=view):
        loss, _ = exp.compute_gradients(batch, masks=[m.to(CARD) for m in masks])
    whole = Experiment(cfg, device=CARD)
    for name, p in whole.net.named_parameters():
        grad = dict(exp.net.named_parameters())[name].grad
        p.grad = _gather(grad, exp.tp[name], mesh.group("model")) if name in exp.tp else grad
    got = {k: torch.from_numpy(v).double() for k, v in
           _flat(export_jax_params(whole.net, grads=True)["params"]).items()}
    stats = {k: torch.from_numpy(v).double() for k, v in
             _flat(export_jax_params(exp.net)["batch_stats"]).items()}
    stats_err = _leaf_errors(stats, want_stats)[0][0]
    if stats_err > WINDOW_TOL["stats"]:
        raise RuntimeError(f"{tag}: running statistics off by {stats_err:.3e}")
    return dict(loss_rel=_loss_within(tag, loss.item(), want_loss),
                grad_err=_grads_within(tag, got, want), stats_err=stats_err,
                flips=_flips_within(tag, flips), tp=sorted(exp.tp))


def _pipeline_rank_check(rate: float) -> dict:
    """Two pipelined TeCNo train steps (the CLI's TeCNo with 3 stages: stage 0
    on every rank, refinement stage r + 1 on rank r; PIPELINE microbatches;
    SGD) at dropout ``rate`` against the sequential chain's two steps on the
    card, with the same per-(stage, microbatch) keep-masks: losses and every
    stage's weights; the kernels the two pipelined steps launched."""
    from med_tpu_torch import ops
    from med_tpu_torch.parallel import launch
    from med_tpu_torch.parallel.mesh import make_mesh
    from med_tpu_torch.parallel.pipeline import make_pp_tecno_train_step
    from med_tpu_torch.train import losses
    from med_tpu_torch.train.engine import Experiment

    tag = "[parallel] pipeline"
    cfg = _family_config("TeCNo").replace(mstcn_stages=3)
    M, T, lr = PIPELINE["M"], PIPELINE["T"], 1e-2
    rng = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(rng.standard_normal((M, T, 2048), dtype=np.float32)).to(CARD)
    labels = torch.from_numpy(rng.integers(0, 2, (M, T))).to(CARD)
    mask = torch.ones(M, T, device=CARD)
    shape = (cfg.mstcn_layers, T, cfg.mstcn_f_maps)
    if rate == 0.5:
        draws = [rng.integers(0, 2, shape) for _ in range(3 * M)]
    else:
        draws = [rng.random(shape) < 1 - rate for _ in range(3 * M)]
    masks = {(s, m): torch.from_numpy(draws[s * M + m].astype(np.uint8)).to(CARD)
             for s in range(3) for m in range(M)}
    seq = Experiment(cfg, device=CARD)
    seq.init_weights(SEED)
    model = seq.net.model
    for st in model.stages():
        st.stack.dropout_rate = rate       # the chain's stacks drop at the step's rate
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    stage_masks = {f"stage{s}": {"stack": torch.stack([masks[(s, m)] for m in range(M)], 1)}
                   for s in range(3)}
    want = []
    for _ in range(2):
        opt.zero_grad()
        loss = losses.tecno_stage_loss(model(x, train=True, masks=stage_masks), labels, mask)
        loss.backward()
        opt.step()
        want.append(loss.item())
    pp = Experiment(cfg, device=CARD)
    pp.init_weights(SEED)
    mesh = make_mesh((launch.world_size(), 1))
    d = mesh.coord("data")
    stage0, stage = pp.net.model.stage0, pp.net.model.stages()[d + 1]
    step = make_pp_tecno_train_step(stage0, stage, torch.optim.SGD(stage0.parameters(), lr=lr),
                                    torch.optim.SGD(stage.parameters(), lr=lr),
                                    mesh.group("data"), dropout_rate=rate)
    ops.reset_launch_counts()
    got = [step(x, labels, mask, masks).item() for _ in range(2)]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # stage 0 on M microbatches and this rank's stage on M + R - 1 steps, a step
    fwd = 2 * (2 * M + launch.world_size() - 1)
    if launches["dilated_residual_stack"] != fwd or launches["dilated_residual_stack_bwd"] < 1:
        raise RuntimeError(f"{tag} at rate {rate}: stack launches {launches}, expected {fwd} "
                           f"forward and some backward")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if rel > TRAIN_TOL["loss"]:
        raise RuntimeError(f"{tag}: losses {got} against the chain's {want}")
    err = 0.0
    for mine, ref in ((stage0, model.stage0), (stage, model.stages()[d + 1])):
        for (k, a), b in zip(mine.state_dict().items(), ref.state_dict().values()):
            e = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            err = max(err, e)
            if e > TRAIN_TOL["grad_atol"]:
                raise RuntimeError(f"{tag}: {k} off the chain's by {e:.2e} of its largest")
    return dict(loss_rel=rel, weight_err=err, losses=got, launches=launches)


def _parallel_rank() -> dict:
    """What each of the two ranks sharing the card runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"sp": {name: _sp_rank_check(name) for name in ("COG", "TeCNo")},
            "trial_dp": _trial_dp_rank_check(),
            "window": {str(shape): _window_dp_rank_check(shape) for shape in ((2, 1), (1, 2))},
            "pipeline": {rate: _pipeline_rank_check(rate) for rate in (0.5, KEEP_RATE)}}


def _vmap_fallbacks(caught) -> list:
    return [str(w.message) for w in caught if "batching rule" in str(w.message)
            or "performance drop" in str(w.message)]


def _fold_parallel_cli(root: Path, splits) -> None:
    """``train_window --fold-parallel`` (SimpleCNN, the CLI's defaults, 2
    epochs on phase 8's folds) against the sequential CLI: each fold's
    history, best epoch and predictions (99%); both wall times; no vmap
    fallback. Batched and unbatched matmuls round apart, and Adam, whose
    first steps move a weight with a float32-noise gradient by a whole
    learning rate either way, lifts that over the steps: the losses of the
    first epoch to 5e-4 (an H100 read 1.06e-4; the CPU's folds of
    tests/test_torch_folds.py 1.1e-5), later epochs' to 2e-3 (med_tpu's
    tolerance after the first epoch). That the batched program computes the
    sequential one's numbers is held tighter by :func:`_fold_step_check`
    (one step's gradients) and :func:`_fold_parallel_at_lr_0` (whole runs
    where nothing lifts the rounding)."""
    import warnings

    from med_tpu_torch.cli import train_window

    argv = ["--data-root", str(root / "data"), "--runs-root", str(root / "runs_parallel"),
            "--folds", ",".join(splits), "--n-epochs", "2", "--model-name", "SimpleCNN"]
    walls = {}
    out = {}
    for label, extra in (("sequential", []), ("fold-parallel", ["--fold-parallel"])):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                results, tracker = train_window.main([*argv, *extra])
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
        fallbacks = _vmap_fallbacks(caught)
        if fallbacks:
            raise RuntimeError(f"[parallel] {label}: vmap fell back to a loop: {fallbacks}")
        history = [json.loads(line) for line in
                   (Path(tracker.dir) / "metrics.jsonl").read_text().splitlines()]
        out[label] = (results, history)
    seq, par = out["sequential"][0], out["fold-parallel"][0]
    # metrics.jsonl: each fold's epochs in turn, one row a column, both runs
    # in the same order
    rows = [(a, b) for a, b in zip(out["sequential"][1], out["fold-parallel"][1])
            if a["key"].endswith("_loss")]
    if len(rows) != 2 * 2 * len(splits) or any(
            (a["key"], a["step"]) != (b["key"], b["step"]) for a, b in rows):
        raise RuntimeError("[parallel] the fold-parallel run's metrics rows differ in layout")
    worst = {0: 0.0, 1: 0.0}
    for a, b in rows:
        first = 0 if a["step"] == 0 else 1
        worst[first] = max(worst[first], abs(b["value"] - a["value"]))
        if abs(b["value"] - a["value"]) > (5e-4 if first == 0 else 2e-3):
            raise RuntimeError(f"[parallel] fold-parallel {a['key']} at epoch {a['step']}: "
                               f"{b['value']} against the sequential {a['value']}")
    for fold in splits:
        a, b = np.asarray(seq[fold]["preds"]), np.asarray(par[fold]["preds"])
        if a.shape != b.shape or np.mean(a == b) < 0.99 or \
                seq[fold]["epoch"] != par[fold]["epoch"]:
            raise RuntimeError(f"[parallel] fold-parallel fold {fold}: best epoch "
                               f"{par[fold]['epoch']} vs {seq[fold]['epoch']}, predictions "
                               f"agree on {np.mean(a == b):.4f}")
    log(f"[parallel] train_window SimpleCNN, {len(splits)} folds x 2 epochs: sequential "
        f"{walls['sequential']:.2f} s, --fold-parallel {walls['fold-parallel']:.2f} s; "
        f"histories' losses within {worst[0]:.2e} in the first epoch (tol 5e-4), "
        f"{worst[1]:.2e} after it (tol 2e-3), best epochs and predictions the same, no vmap "
        f"fallback")


def _fold_step_check() -> None:
    """One batched step of two folds (SimpleCNN, the CLI's defaults, B =
    WINDOW_BATCH, the folds' own batches, one draw of dropout masks) against
    each fold's engine step on the card with the same masks: each fold's
    loss (TRAIN_TOL) and every gradient leaf (rtol 1e-4, 2e-5 of the leaf's
    largest, as tests/test_torch_folds.py holds it on the CPU); then the
    device kernels of the batched step against one fold's step, by the
    profiler: a batched program, not a loop over the folds."""
    import warnings

    from med_tpu_torch.parallel.folds import FoldParallel
    from med_tpu_torch.train.engine import Experiment

    cfg = _window_config("SimpleCNN")
    rng = np.random.default_rng(SEED + 2)
    exp = Experiment(cfg, device=CARD)
    fp = FoldParallel(Experiment(cfg, device=CARD))
    state = fp.init_states([SEED, SEED])
    batches = [_window_batch(cfg, rng) for _ in range(2)]
    stacked = {k: torch.as_tensor(np.stack([b[k] for b in batches]), device=CARD)
               for k in batches[0]}
    masks = fp.draw_masks(state, np.ones(2, bool), WINDOW_BATCH)
    train = fp._train if state["class_counts"] is not None else torch.func.vmap(
        fp._train_one, in_dims=(0, 0, 0, 0, None))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        grads, loss, _, _ = train(state["params"], state["buffers"], stacked, masks,
                                  state["class_counts"])
    if _vmap_fallbacks(caught):
        raise RuntimeError(f"[parallel] fold step: vmap fell back: {_vmap_fallbacks(caught)}")
    worst, rel = 0.0, 0.0
    for f, batch in enumerate(batches):
        exp.init_weights(SEED)
        one, _ = exp.compute_gradients(batch, masks=[m[f] for m in masks])
        rel = max(rel, _loss_within("[parallel] fold step", float(loss[f]), one.item()))
        for k, p in exp.net.named_parameters():
            w, g = p.grad, grads[f"net.{k}"][f]
            scale = max(w.abs().max().item(), 1e-30)
            err = (g - w).abs()
            worst = max(worst, err.max().item() / scale)
            if (err - 1e-4 * w.abs()).max().item() > 2e-5 * scale:
                raise RuntimeError(f"[parallel] fold step: fold {f} {k} off its engine step "
                                   f"by {err.max().item() / scale:.2e} of its largest")
    log(f"[parallel] one fold-parallel step of 2 folds against each fold's engine step, "
        f"B={WINDOW_BATCH}: loss rel {rel:.2e}, largest leaf error {worst:.2e} of its largest "
        f"(tol 2e-5)")
    one = exp._tensors(_window_batch(cfg, rng))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        folds = len(_device_events(lambda: fp.train_step(state, stacked, cfg.lr), 1))
    if _vmap_fallbacks(caught):
        raise RuntimeError(f"[parallel] fold step: vmap fell back: {_vmap_fallbacks(caught)}")
    single = len(_device_events(lambda: exp.train_step(one), 1))
    log(f"[parallel] one fold-parallel step of 2 folds: {folds} device kernels and copies; "
        f"one fold's engine step: {single}")
    if folds >= 1.5 * single:
        raise RuntimeError(f"[parallel] a fold-parallel step of 2 folds ran {folds} device "
                           f"events against one fold's {single}: a loop over the folds")


def _fold_parallel_at_lr_0(root: Path, splits) -> None:
    """``FoldParallelWindowRun`` against ``train_window_fold`` on phase 8's
    folds (SimpleCNN, the CLI's defaults, 2 epochs) at a learning rate of
    0: the weights stay and only the running statistics move, so Adam lifts
    no rounding, and every epoch's train and test losses must agree to
    TRAIN_TOL["loss"] (the CPU's runs: 3e-6, tests/test_torch_folds.py)."""
    from med_tpu_torch.data.datasets import build_window_fold
    from med_tpu_torch.parallel.folds import FoldParallelWindowRun
    from med_tpu_torch.train.engine import Experiment
    from med_tpu_torch.train.loop import train_window_fold

    cfg = _window_config("SimpleCNN").replace(lr=0.0)
    folds = [build_window_fold(str(root / "data" / fold), cfg) for fold in splits]
    exp = Experiment(cfg, device=CARD)
    seq = [train_window_fold(cfg, tf, ef, exp=exp) for tf, ef in folds]
    par = FoldParallelWindowRun(exp, cfg, folds).run()
    worst = 0.0
    for fold, a, b in zip(splits, seq, par):
        for x, y in zip(a["history"], b["history"]):
            for k in ("train_loss", "test_loss"):
                rel = abs(y[k] - x[k]) / abs(x[k])
                worst = max(worst, rel)
                if rel > TRAIN_TOL["loss"]:
                    raise RuntimeError(f"[parallel] fold-parallel at lr 0, fold {fold} epoch "
                                       f"{x['epoch']}: {k} {y[k]} against {x[k]}")
    log(f"[parallel] FoldParallelWindowRun against train_window_fold at lr 0, SimpleCNN, "
        f"{len(splits)} folds x 2 epochs: losses within {worst:.2e} (rel; tol "
        f"{TRAIN_TOL['loss']})")


def _prefetch_check() -> None:
    """A TeCNo fold epoch (the CLI's defaults) over 4 trials of T = 4096 with
    prefetch depth 2 against 0 (equal losses; both train times), and one
    trial's features to the card from pinned and from pageable memory."""
    from med_tpu_torch.train.loop import train_frame_fold

    rng = np.random.default_rng(SEED + 4)
    train = [_trial(rng, PARALLEL_FRAMES, f"Needle_Passing_{c}001") for c in "BCDE"]
    test = [_trial(rng, PARALLEL_FRAMES, "Needle_Passing_F001")]
    times, losses = {}, {}
    for depth in (0, 2, 0, 2):
        cfg = _family_config("TeCNo").replace(n_epochs=1, prefetch_depth=depth)
        res = train_frame_fold(cfg, train, test)
        times.setdefault(depth, []).append(res["history"][0]["train_time"] * 1e3)
        losses[depth] = res["history"][0]["train_loss"]
    if abs(losses[0] - losses[2]) > 1e-6 * abs(losses[0]):
        raise RuntimeError(f"[parallel] prefetch changed the train loss: {losses}")
    x = np.ascontiguousarray(train[0].images)
    pinned = torch.from_numpy(x).pin_memory()
    page = cuda_ms(lambda: torch.from_numpy(x).to(CARD), 5)
    pin = cuda_ms(lambda: pinned.to(CARD, non_blocking=True), 5)
    log(f"[parallel] TeCNo fold epoch, 4 trials at T={PARALLEL_FRAMES}: train time "
        f"{min(times[2]):.1f} ms with prefetch depth 2, {min(times[0]):.1f} ms with 0 (best of "
        f"2 each; losses {losses[2]:.9f} and {losses[0]:.9f}); one trial's {x.nbytes / 1e6:.1f} MB features to the card "
        f"{pin:.3f} ms from pinned memory, {page:.3f} ms from pageable")


def _nccl_group_of_one(root: Path, splits) -> None:
    """The CLIs in an NCCL group of one rank: ``train_frame
    --sequence-parallel`` and ``--trial-dp --trial-batch 2`` (COG at full
    width, multimodal, 1 epoch, phase 8's folds: whole runs, finite F1),
    the fold-parallel window CLI, ``resnet_finetune --mesh 1`` on phase
    12's raw-frame folds."""
    import torch.distributed as dist

    from med_tpu_torch.cli import resnet_finetune, train_frame

    dist.init_process_group("nccl", store=dist.FileStore(str(root / "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        argv = ["--model-name", "COG", "--data-type", "multimodal", "--data-root",
                str(root / "data"), "--runs-root", str(root / "runs_parallel"),
                "--folds", ",".join(splits), "--n-epochs", "1"]
        for flags in (["--sequence-parallel"], ["--trial-dp", "--trial-batch", "2"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                results, tracker = train_frame.main([*argv, *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mesh_line = next(line for line in buf.getvalue().splitlines() if "mesh" in line)
            for fold in splits:
                if not np.isfinite(results[fold]["test_f1"]):
                    raise RuntimeError(f"[parallel] train_frame {flags}: fold {fold} F1 "
                                       f"{results[fold]['test_f1']}")
            for name in ("summary.json", "windowed_metrics.json"):
                _finite_numbers(json.loads((Path(tracker.dir) / "artifacts" / name).read_text()))
            log(f"[parallel] train_frame COG {' '.join(flags)} (NCCL group of one; "
                f"{mesh_line.strip()}): 1 epoch on {len(splits)} folds in {wall:.2f} s, best "
                f"test F1 { {f: round(results[f]['test_f1'], 4) for f in splits} }")
        _fold_parallel_cli(root, splits)
        ft = root / "finetune"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            resnet_finetune.main(["--data-root", str(ft / "raw"), "--output-root",
                                  str(ft / "features_mesh"), "--folds", "1Out",
                                  "--runs-root", str(ft / "runs_mesh"), "--n-epochs", "1",
                                  "--seed", str(SEED), "--batch-size", str(FINETUNE_BATCH),
                                  "--mesh", "1"])
        torch.cuda.synchronize()
        last = buf.getvalue().strip().splitlines()[-1]
        exported = sorted((ft / "features_mesh" / "1Out").glob("*.npz"))
        if not exported:
            raise RuntimeError("[parallel] resnet_finetune --mesh 1 exported no features")
        log(f"[parallel] resnet_finetune --mesh 1 (NCCL group of one), 1 epoch of fold "
            f"1Out: {time.perf_counter() - t0:.2f} s, {last.strip()}, {len(exported)} trials "
            f"exported")
    finally:
        dist.destroy_process_group()


def phase_parallel(root: Path, splits) -> tuple:
    """Parallelism on the card (phase 13 of the module docstring). Returns
    rank 0's SP COG launches and its pipeline steps' launches by rate."""
    from med_tpu_torch.entry import dryrun_multichip
    from med_tpu_torch.parallel import launch
    from med_tpu_torch.parallel.mesh import make_mesh
    from med_tpu_torch.parallel.sp_train import SPFrameTrainer

    note = "(two ranks share one card: a correctness check, not a scaling measurement)"
    t0 = time.perf_counter()
    ranks = launch.spawn(_parallel_rank, 2, str(root / "ranks"), backend="gloo", device=CARD)
    log(f"[parallel] 2 ranks on cuda:0 over gloo {note}: {time.perf_counter() - t0:.1f} s")
    for name in ("COG", "TeCNo"):
        for r in ranks:
            sp = r["sp"][name]
            log(f"[parallel] SP {name} train step, T={PARALLEL_FRAMES} in {sp['shards']} shards, "
                f"rank {sp['rank']}: loss rel {sp['loss_rel']:.2e} of one rank's (tol "
                f"{TRAIN_TOL['loss']}), largest leaf error {sp['grad_err']:.2e} of its "
                f"largest (tol {TRAIN_TOL['grad_atol']}) with the relu patterns pinned (FFN, "
                f"TCN flips {sp['flips']}); K1/K3 launches "
                f"{sp['launches']['sliding_window_attention_packed']}/"
                f"{sp['launches']['sliding_window_attention_packed_bwd']} (one rank's step "
                f"{sp['single_launches']['sliding_window_attention_packed']}/"
                f"{sp['single_launches']['sliding_window_attention_packed_bwd']}); step "
                f"{sp['step_ms']:.1f} ms {note}")
    for r, out in enumerate(ranks):
        for shape, w in out["window"].items():
            log(f"[parallel] SimpleCNN window step B={WINDOW_BATCH} on mesh {shape}, rank {r}: "
                f"loss rel {w['loss_rel']:.2e}, running statistics {w['stats_err']:.2e}, "
                f"largest leaf error {w['grad_err']:.2e} (choices flipped {w['flips']}); "
                f"split {w['tp'] or 'nothing'}")
        for rate, pp in out["pipeline"].items():
            log(f"[parallel] pipeline, TeCNo 2 refinement stages x {PIPELINE['M']} "
                f"microbatches of T={PIPELINE['T']}, dropout rate {rate}, rank {r}: 2 SGD "
                f"steps, losses {pp['losses']} (rel {pp['loss_rel']:.2e} of the sequential "
                f"chain's), weights within {pp['weight_err']:.2e} of their largest; K2b/K5 "
                f"launches {pp['launches']['dilated_residual_stack']}/"
                f"{pp['launches']['dilated_residual_stack_bwd']}")

    _group_step_check([r["trial_dp"] for r in ranks])

    # the SP step on one rank (plain stacks, the attention kernels)
    cfg = _train_config()
    trainer = SPFrameTrainer(cfg, make_mesh(), device=CARD)
    trainer.exp.init_weights(SEED)
    trial = _trial(np.random.default_rng(SEED + 7), PARALLEL_FRAMES, "Needle_Passing_B001")
    local = trainer.shard(trainer.make_batch(trial, PARALLEL_FRAMES))

    def one_rank_step():
        trainer.exp.optimizer.zero_grad(set_to_none=False)
        trainer._forward_loss(local, trainer.dropout(0, PARALLEL_FRAMES))[0].backward()

    log(f"[parallel] SP COG train step at one rank, T={PARALLEL_FRAMES}: "
        f"{_synced_ms(one_rank_step):.1f} ms")
    gen = torch.Generator().manual_seed(SEED)
    k1 = _attention_case("cog", PARALLEL_FRAMES // 2, gen)
    k3 = _attention_bwd_case("cog", PARALLEL_FRAMES // 2, gen)
    log(f"[parallel] K1 at the SP shard's T={PARALLEL_FRAMES // 2}: {k1['device_ms']:.4f} ms a "
        f"launch (bound {k1['bound_ms']:.4f}); K3: {k3['device_ms']:.4f} ms (bound "
        f"{k3['bound_ms']:.4f})")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(2, device=CARD, backend="gloo")
    for line in buf.getvalue().splitlines():
        log(f"[parallel] {line}")
    log(f"[parallel] entry dry run, 2 ranks on cuda:0: {time.perf_counter() - t0:.1f} s")
    _nccl_group_of_one(root, splits)
    _fold_step_check()
    _fold_parallel_at_lr_0(root, splits)
    _prefetch_check()
    return (ranks[0]["sp"]["COG"]["launches"],
            {rate: pp["launches"] for rate, pp in ranks[0]["pipeline"].items()})


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

    profile = "--profile" in argv

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, profile)
    op_api = timed("ops", phase_op_api)
    serving = timed("serving", phase_serving, profile)
    training = timed("training", phase_training, profile)
    families = timed("families", phase_families, profile)
    fused_trunk, pixels, stage_kernel = timed("pixels", phase_pixels, profile)
    kernels["resnet_stage"] = stage_kernel
    with tempfile.TemporaryDirectory() as tmp:
        driver, driver_families, splits, cog_run = timed("driver", phase_driver, Path(tmp))
        variants, es_clis, bf16_folds, group_fold, es_run = timed(
            "es", phase_es, Path(tmp), splits, cog_run)
        window = timed("window", phase_window, Path(tmp), splits, profile)
        int8_entries = timed("ensemble", phase_ensemble, Path(tmp), splits, cog_run, es_run)
        int8_entries["int8_conv/trunk"]["launches_finetune_export"] = timed(
            "finetune", phase_finetune, Path(tmp), profile)
        sp_launches, pp_launches = timed("parallel", phase_parallel, Path(tmp), splits)
    sink_kernels, mimo_launches = timed("mimo", phase_mimo, profile)

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
                                     "sliding_window_attention_bwd_pallas"),
               "swa_packed_fwd/d2": ("med_tpu_torch/csrc/swa_packed_fwd.cu",
                                     "med_tpu/ops/attention.py:390",
                                     "sliding_window_attention_packed"),
               "swa_packed_bwd/d2": ("med_tpu_torch/csrc/swa_packed_bwd.cu",
                                     "med_tpu/ops/attention.py:506",
                                     "sliding_window_attention_packed_bwd"),
               "tcn_stack_fwd/tecno": ("med_tpu_torch/csrc/tcn_stack_fwd.cu",
                                       "med_tpu/ops/tcn_fused.py:91",
                                       "dilated_residual_stack"),
               "tcn_stack_bwd/tecno": ("med_tpu_torch/csrc/tcn_stack_bwd.cu",
                                       "med_tpu/ops/tcn_fused.py:193",
                                       "dilated_residual_stack_bwd"),
               f"tcn_stack_fwd/tecno_rate{KEEP_RATE}": ("med_tpu_torch/csrc/tcn_stack_fwd.cu",
                                                       "med_tpu/ops/tcn_fused.py:91",
                                                       "dilated_residual_stack"),
               f"tcn_stack_bwd/tecno_rate{KEEP_RATE}": ("med_tpu_torch/csrc/tcn_stack_bwd.cu",
                                                       "med_tpu/ops/tcn_fused.py:193",
                                                       "dilated_residual_stack_bwd"),
               **{f"swa_packed_fwd/{shape}": ("med_tpu_torch/csrc/swa_packed_fwd.cu",
                                              "med_tpu/ops/attention.py:390",
                                              "sliding_window_attention_packed")
                  for shape in ES_ATTENTION},
               **{f"swa_packed_bwd/{shape}": ("med_tpu_torch/csrc/swa_packed_bwd.cu",
                                              "med_tpu/ops/attention.py:506",
                                              "sliding_window_attention_packed_bwd")
                  for shape in ES_ATTENTION}}
    # launches: each kernel's own path: one 128-frame batch of
    # resnet50_fused_apply for K10, one forward and backward through the
    # public op entry points for K6-K9, the TransSVNet and TeCNo fold runs
    # for the D=2 attention and the TeCNo stacks, the skill-prompt (m = 45)
    # and observed-gesture (m = 8) variants' served requests (K1) and train
    # step (K3), the trial_batch = 2 fold for 16 heads, and COG's training
    # run for the others; every phase's count beside it (the pixel request's
    # trunk is ResNet50; the driver's COG count is its first run, 2 folds x 2
    # epochs); the TeCNo stacks at KEEP_RATE's scale the rate-KEEP_RATE
    # pipeline's two steps
    own_path = {"resnet_stage": fused_trunk, "tcn_stack_fwd/concatenated": op_api,
                "tcn_stack_bwd/concatenated": op_api, "swa_headmajor_fwd": op_api,
                "swa_headmajor_bwd": op_api, "swa_packed_fwd/d2": families["TransSVNet"],
                "swa_packed_bwd/d2": families["TransSVNet"],
                "tcn_stack_fwd/tecno": families["TeCNo"],
                "tcn_stack_bwd/tecno": families["TeCNo"],
                f"tcn_stack_fwd/tecno_rate{KEEP_RATE}": pp_launches[KEEP_RATE],
                f"tcn_stack_bwd/tecno_rate{KEEP_RATE}": pp_launches[KEEP_RATE],
                **{f"swa_packed_fwd/{shape}": variants[v]["serving"]
                   for shape, v in ES_VARIANT_SHAPE.items()},
                **{f"swa_packed_bwd/{shape}": variants[v]["step"]
                   for shape, v in ES_VARIANT_SHAPE.items()},
                "swa_packed_fwd/heads16": group_fold, "swa_packed_bwd/heads16": group_fold}
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": own_path.get(name, training)[wrapper],
             "launches_serving": serving[wrapper], "launches_training": training[wrapper],
             "launches_fused_trunk": fused_trunk[wrapper],
             "launches_pixel_request": pixels[wrapper],
             "launches_op_api": op_api[wrapper], "launches_driver": driver[wrapper],
             "launches_tecno_fold": families["TeCNo"][wrapper],
             "launches_tsvn_fold": families["TransSVNet"][wrapper],
             "launches_driver_tecno": driver_families["TeCNo"][wrapper],
             "launches_driver_tsvn": driver_families["TransSVNet"][wrapper],
             **{f"launches_{v}_serving": variants[v]["serving"][wrapper] for v in ES_VARIANTS},
             **{f"launches_{v}_step": variants[v]["step"][wrapper] for v in ES_VARIANTS},
             "launches_es_cli": es_clis["train_frame_es"][wrapper],
             "launches_es_sequential_cli": es_clis["train_frame_es_sequential"][wrapper],
             "launches_bf16_cog_fold": bf16_folds["COG"][wrapper],
             "launches_bf16_tecno_fold": bf16_folds["TeCNo"][wrapper],
             "launches_group_fold": group_fold[wrapper],
             "launches_window": window[wrapper],
             "launches_sp_rank": sp_launches[wrapper],
             **{f"launches_pipeline_rate{rate}": pp[wrapper]
                for rate, pp in pp_launches.items()},
             **kernels[name]}
            for name, (src, rep, wrapper) in sources.items()]
    # the int8 kernel is no TPU kernel (it replaces XLA's int8 conv and dot)
    # and counts apart from the eleven (ops.launch_counts); its launches are
    # the --int8-trunk pixel run's and the --int8-fe run's
    line += [{"name": name, **entry} for name, entry in int8_entries.items()]
    # the sink instance is no TPU kernel either (MiMo-V2-Flash has no JAX
    # counterpart): its launches are the MiMo train step's and served pass's
    line += [{"name": name, "route": "cuda", "source": f"med_tpu_torch/csrc/{name}.cu",
              "replaces": "none", "launches": mimo_launches["step"][name],
              "launches_mimo_step": mimo_launches["step"][name],
              "launches_mimo_request": mimo_launches["request"][name], **sink_kernels[name]}
             for name in ("swa_sink_fwd", "swa_sink_bwd")]
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
