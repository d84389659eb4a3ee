"""Profiling helpers (port of ``med_tpu.utils.profiling``): a device-trace
context over ``torch.profiler``, the busy span of a captured trace, and a
step timer that waits for the card where ``med_tpu`` calls
``block_until_ready``."""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where there is a
    device) around a block; the chrome trace lands in
    ``logdir/trace.json`` (Perfetto or chrome://tracing read it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _events(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace.get("traceEvents", trace) if isinstance(trace, dict) else trace


def trace_device_span_s(trace_dir: str) -> float:
    """First-event start to last-event end, in seconds, of the busiest CUDA
    stream (the most kernel time) in the chrome traces under ``trace_dir``;
    -1.0 where no trace holds a kernel. A device span of a fixed program is
    steadier than host wall-clock pairs."""
    best_busy, best_span = 0.0, -1.0
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    for path in paths:
        streams = {}
        for ev in _events(path):
            if ev.get("cat") != "kernel" or "dur" not in ev:
                continue
            key = (ev.get("pid"), ev.get("tid"))
            t0, t1, busy = streams.get(key, (float("inf"), float("-inf"), 0.0))
            ts, dur = float(ev["ts"]), float(ev["dur"])
            streams[key] = (min(t0, ts), max(t1, ts + dur), busy + dur)
        for t0, t1, busy in streams.values():
            if busy > best_busy:
                best_busy, best_span = busy, (t1 - t0) * 1e-6   # chrome traces: us
    return best_span


class StepTimer:
    """Accumulates step times that include the device's work: :meth:`stop`
    waits for the card before it reads the clock."""

    def __init__(self):
        self.total = 0.0
        self.units = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None, units: int = 1) -> None:
        """``result``: what the step returned (unused beyond marking the
        step's end; PyTorch's queue is in order, so one synchronize waits
        for it)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.total += time.perf_counter() - self._t0
        self.units += units

    @property
    def units_per_sec(self) -> float:
        return self.units / self.total if self.total else 0.0

    @property
    def ms_per_unit(self) -> float:
        return self.total / self.units * 1e3 if self.units else 0.0
