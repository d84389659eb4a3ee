"""The traced run: spans from the benchmark's own files, the profiler over
the measured window, and the trace read in memory into a small summary.

Spans: each per-layer metric file lists, in ``SPANS``, the program
functions whose calls make its layer, with a function that counts each
call's work from its shapes. In a traced run every listed function is
wrapped in a ``torch.profiler.record_function`` span named after the
metric's layer, and its work is added up. A device operation belongs to a
span when the host call that launched it (its runtime event, linked by the
profiler's correlation id) fell inside one of the span's intervals, on any
thread: backward passes launch from autograd's thread while the caller
waits. The device's busy time is the union of its kernels, copies and
fills over all streams, clipped to the window."""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from work.peaks import PEAKS, least_seconds

WINDOW = "bench.window"


class Span:
    """A program function to wrap: ``module`` and ``attr`` ("name" or
    "Class.name"), the span's name, and ``work(args, kwargs) -> (bytes,
    flops, precision)`` or None (a span that only attributes time)."""

    def __init__(self, module: str, attr: str, name: str,
                 work: Optional[Callable] = None):
        self.module, self.attr, self.name, self.work = module, attr, name, work


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.least_s: Dict[str, float] = defaultdict(float)
        self._patched: List[Tuple[object, str, object]] = []
        self._prof = None
        self._window = None
        self.summary: Optional[dict] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:          # outside the traced window: no cost
            yield
            return
        with torch.profiler.record_function(name):
            yield

    def install(self, spans: List[Span]) -> None:
        """Wrap every listed function (a no-op without tracing)."""
        if not self.enabled:
            return
        for s in spans:
            owner = importlib.import_module(s.module)
            *path, leaf = s.attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            original = getattr(owner, leaf)
            setattr(owner, leaf, self._wrap(original, s))
            self._patched.append((owner, leaf, original))

    def _wrap(self, fn, s: Span):
        tracer = self

        def wrapped(*args, **kwargs):
            if s.work is not None:
                nbytes, flops, precision = s.work(args, kwargs)
                tracer.least_s[s.name] += least_seconds(nbytes, flops, PEAKS[precision])[0]
            with torch.profiler.record_function(s.name):
                return fn(*args, **kwargs)

        # the program may count its calls on the function's attributes
        # (``.launches``): the wrapper carries them while it stands in
        return functools.update_wrapper(wrapped, fn)

    def uninstall(self) -> None:
        for owner, leaf, original in reversed(self._patched):
            setattr(owner, leaf, original)
        self._patched = []

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self, device) -> None:
        """Close the window after the device's last work and read the trace."""
        if not self.enabled:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.summary = summarize(self._prof.profiler.kineto_results.events())
        self._prof = None


_SHORT = re.compile(r"^(?:void\s+)?([^<(]*)")


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    m = _SHORT.match(name)
    out = (m.group(1) if m else name).strip() or name
    return out[:120]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events) -> dict:
    """The trace's summary: window and busy seconds, device seconds by span
    name (operations launched inside the span's intervals), the top device
    operations and the idle gaps by the innermost span the host was in when
    the device went idle."""
    from torch.autograd import DeviceType

    runtime: Dict[int, int] = {}
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    device: List[Tuple[int, int, str, int]] = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("bench.") or _user_annotation(e):
                continue
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), name, e.correlation_id()))
        elif name.startswith("bench."):
            start = e.start_ns()
            spans[name].append((start, start + e.duration_ns()))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
    if not spans.get(WINDOW):
        raise RuntimeError("the trace holds no window span")
    w0, w1 = spans.pop(WINDOW)[0]
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _, _ in inside])
    busy_ns = sum(b - a for a, b in busy)

    by_op: Dict[str, float] = defaultdict(float)
    for a, b, n, _ in inside:
        by_op[short_name(n)] += (b - a) * 1e-9

    merged = {name: _union(iv) for name, iv in spans.items()}
    starts = {name: [a for a, _ in iv] for name, iv in merged.items()}
    span_device: Dict[str, float] = defaultdict(float)
    for a, b, _, corr in inside:
        t = runtime.get(corr)
        if t is None:
            continue
        for name, iv in merged.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and iv[i][1] >= t:
                span_device[name] += (b - a) * 1e-9

    # idle gaps: between merged busy intervals (and the window's ends),
    # named by the innermost span open on the host when the device ran dry
    flat = sorted((a, b, name) for name, iv in spans.items() for a, b in iv)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, end), (nxt, _) in zip(edges, edges[1:]):
        if nxt > end:
            gaps[_innermost(flat, end)] += (nxt - end) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "device_events": len(inside), "span_device_s": dict(span_device),
            "device_ops": top(by_op), "idle_gaps": top(gaps)}


def _user_annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return False


def _innermost(flat: List[Tuple[int, int, str]], t: int) -> str:
    """The latest-starting span open at host time t, or "outside spans"."""
    best = None
    i = bisect.bisect_right(flat, (t, float("inf"), "")) - 1
    # spans are short beside the window: look back a bounded number
    for a, b, name in reversed(flat[max(0, i - 512):i + 1]):
        if a <= t <= b:
            best = name
            break
    return best or "outside spans"
