"""Profiling (port of ``med_tpu.utils.profiling``): the program's spans and
their host-time aggregates, and a device-trace context over
``torch.profiler``.

Spans mark the layer boundaries of the paths the port runs: a train step
(``med.train.step`` and its phases ``inputs``, ``forward``, ``loss``,
``backward``, ``optimizer``) and a served trial (``med.serve.request`` and
its ``upload``, ``trunk``, ``to_host`` and ``model``). They record exactly
while a ``torch.profiler`` records (``device_trace``, any
``torch.profiler.profile``): each is then a ``record_function`` range, on
the same timeline as the device's kernels, and adds its host duration to a
per-name aggregate that :func:`snapshot` reads. Otherwise a span is one
check of the profiler's flag and a shared object that does nothing."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch

# whether a profiler records (the autograd profiler's C flag: set by
# ``torch.profiler.profile`` and the legacy ``torch.autograd.profiler``)
_recording = torch._C._autograd._profiler_enabled

# name -> [calls, total ns, self ns], while a profiler records
_totals: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])
_lock = threading.Lock()
_local = threading.local()       # .stack: this thread's open spans


class _Off:
    """The span that records nothing: no profiler records, a root inside
    another span, or a caller's span it turns off (an eval step's forward)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _Off()


class _Span:
    __slots__ = ("name", "_range", "_t0", "_children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self._children = 0
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._children += ns
        with _lock:
            t = _totals[self.name]
            t[0] += 1
            t[1] += ns
            t[2] += ns - self._children
        self._range.__exit__(*exc)
        return False


def span(name: str, root: bool = False):
    """A context manager around one layer's work. A ``root`` span (a step,
    a request) opens only as its thread's outermost span: one reached
    inside another span (``predict_trial`` under
    ``predict_trial_from_pixels``) adds nothing, and the outer root stays
    the trial's one."""
    if not _recording():
        return NO_SPAN
    if root and getattr(_local, "stack", None):
        return NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records (a train
    step's ``med.train.graph_capture`` and ``med.train.graph_step``,
    ``train/graphs.py``; a MiMo MoE layer's ``med.moe.assignments`` and
    ``med.moe.held``, and its backward's ``med.moe.grad_slices`` and
    ``med.moe.grad_zeroed``, ``models/mimo.py``); :func:`snapshot` gives it
    as a span of no time, its count under "calls"."""
    if _recording():
        with _lock:
            _totals[name][0] += int(n)


def snapshot() -> Dict[str, Dict[str, float]]:
    """{name: {"calls", "total_ms", "self_ms"}} of the spans and counters
    recorded since the last :func:`reset`; self time is the duration less
    the time the span's children (on its thread) cover."""
    with _lock:
        return {name: {"calls": c, "total_ms": total * 1e-6, "self_ms": own * 1e-6}
                for name, (c, total, own) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where there is a
    device) around a block; the chrome trace lands in
    ``logdir/trace.json`` (Perfetto or chrome://tracing read it). The span
    aggregates restart with it, so a :func:`snapshot` after the block
    covers exactly its trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    reset()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
