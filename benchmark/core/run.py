"""One run of one cell: set-up, the measured window, the trace, the check.

A traced run (``--trace 1``) measures the same untraced window first: the
per-layer metrics that come from counters and the host's clock (MFU, the
padding share, the median latency) are read there, where the profiler does
not slow the host. A traced window of at most ``TRACED_SECONDS`` follows,
and the metrics that need the device's trace (idle shares, rooflines) are
read from it."""

from __future__ import annotations

import gc
import json
import math
import time

import torch

from core import device as devinfo
from core import spec as specs
from core.compare import judge
from core.trace import Tracer
from drivers.common import Context

# the longest traced window: the trace is read in memory, and its events
# grow with the window
TRACED_SECONDS = 15.0


class Run:
    def __init__(self, spec: dict, cell: dict, seed: int, device: torch.device,
                 trace: bool, control: bool = False, start: float = None,
                 log=print, config: dict = None, traffic: dict = None):
        self.spec, self.cell, self.seed, self.device = spec, cell, seed, device
        self.trace, self.control, self.log = trace, control, log
        self.start = time.time() if start is None else start
        self.config = config or specs.load_config(spec, cell["config"])
        self.traffic = traffic or specs.load_traffic(cell["traffic"])
        self.metrics = specs.cell_metrics(spec, cell["name"], trace)
        self.readers = {m["name"]: specs.load_module("metrics", m["name"])
                        for m in specs.cell_metrics(spec, cell["name"], True)}
        self.tracer = Tracer(trace)
        limits_path = specs.BENCH_DIR / "limits" / f"{cell['name']}.json"
        limits = json.loads(limits_path.read_text())["limits"] if limits_path.exists() else {}
        driver = specs.load_module("drivers", self.traffic["driver"])
        specs.check_traffic(self.traffic, driver.TRAFFIC)
        self.ctx = Context(cell=cell, config=self.config, traffic=self.traffic, seed=seed,
                           device=device, tracer=self.tracer, limits=limits,
                           reference=specs.load_module("reference", cell["config"]),
                           log=log, control=control)
        self.driver = driver.Driver(self.ctx)

    def execute(self, seconds: float) -> dict:
        self.ctx.seconds = seconds
        if self.control and hasattr(self.driver, "control"):
            return self._control()
        d = self.driver
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.cuda.set_device(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        d.setup()
        setup_s = time.time() - self.start
        d.window(seconds)
        e2e = dict(d.end_to_end())
        e2e["setup_s"] = setup_s
        counters = d.counters()
        attempted, failed = d.attempted, d.failed
        if self.trace:
            self.tracer.install([s for r in self.readers.values() for s in getattr(r, "SPANS", [])])
            self.tracer.start()
            try:
                d.window(min(seconds, TRACED_SECONDS))
            finally:
                self.tracer.stop(self.device)
                self.tracer.uninstall()
            attempted, failed = attempted + d.attempted, failed + d.failed
            self._log_profiler_cost(counters, d.counters())
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        d.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = self.numbers = d.check()
        checks = judge(numbers, self.ctx.limits)
        correct = bool(checks) and all(c["ok"] for c in checks.values()) and failed == 0
        return self._result(correct, e2e, counters, peak, checks, attempted, failed)

    def _control(self) -> dict:
        numbers = self.numbers = self.driver.control()
        checks = judge(numbers, self.ctx.limits)
        correct = bool(checks) and all(c["ok"] for c in checks.values())
        return {"correct": correct, "attempted": 0, "failed": 0, "metrics": {},
                "device": self._device(0), "checks": _plain(checks)}

    def _device(self, peak: int) -> dict:
        if self.device.type == "cuda":
            return devinfo.describe(self.device, self.cell["chips"], peak)
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    def _log_profiler_cost(self, untraced: dict, traced: dict) -> None:
        """How far the profiler slows the host: frames a second in the
        traced window against the untraced one, and the idle share the
        traced window's device time a frame would give at the untraced
        pace."""
        s = self.tracer.summary
        if not (s and untraced.get("frames") and traced.get("frames")):
            return
        pace_u = untraced["frames"] / untraced["window_s"]
        pace_t = traced["frames"] / traced["window_s"]
        busy = s["busy_s"] / traced["frames"] * pace_u
        self.log(f"profiler: {pace_t:.1f} frames/s traced against {pace_u:.1f} untraced; "
                 f"idle {100 * (1 - s['busy_s'] / s['window_s']):.2f}% traced, "
                 f"{100 * (1 - busy):.2f}% at the untraced pace")

    def _result(self, correct, e2e, counters, peak, checks, attempted, failed) -> dict:
        metrics = {}
        read = _Reading(self, counters)
        for m in self.metrics:
            if self.trace:
                value = self.readers[m["name"]].read(read)
            else:
                value = e2e.get(m["name"])
            if value is None or not math.isfinite(value):
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device = self._device(peak)
        out = {"correct": correct, "attempted": attempted, "failed": failed,
               "metrics": metrics, "device": device}
        s = self.tracer.summary
        if s is not None:
            device["busy_s"] = s["busy_s"]
            device["window_s"] = s["window_s"]
            out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
        out["checks"] = _plain(checks)
        return out


class _Reading:
    """What a per-layer metric's ``read`` sees: the trace's summary, the
    work its spans counted, the driver's counters, the configuration."""

    def __init__(self, run: Run, counters: dict):
        self.summary = run.tracer.summary
        self.least_s = dict(run.tracer.least_s)
        self.counters = counters
        self.config = run.config

    def span_device_s(self, name: str):
        if self.summary is None:
            return None
        return self.summary["span_device_s"].get(name)


def _plain(checks: dict) -> dict:
    """Each compared number beside its limit (a non-finite number as null,
    so that the line stays JSON)."""
    return {k: {"value": v["value"] if math.isfinite(v["value"]) else None,
                "limit": v["limit"]} for k, v in checks.items()}
