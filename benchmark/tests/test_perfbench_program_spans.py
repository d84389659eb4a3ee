"""The per-layer metrics that read the program's own spans
(``core/program_spans.py``, ``metrics/launches.*``, ``step_ms.*``,
``request_ms.*``): on a synthetic summary and snapshot, None where the
program recorded no span or has no ``snapshot``, and a tiny traced run of
each cell on the CPU, where the host times read and the launch counts,
with no device event in the trace, read None."""

import math

import pytest
import torch

from conftest import SEED, tiny
from core import spec as specs
from med_tpu_torch.utils import profiling

STEP = ["step_ms.inputs", "step_ms.forward", "step_ms.loss", "step_ms.backward",
        "step_ms.optimizer"]
REQUEST = ["request_ms.upload", "request_ms.trunk", "request_ms.model", "request_ms.to_host"]
LAUNCHES = ["launches.train", "launches.serve"]
SNAP = {"med.train.step": {"calls": 4, "total_ms": 400.0, "self_ms": 4.0},
        "med.train.inputs": {"calls": 4, "total_ms": 8.0, "self_ms": 8.0},
        "med.train.forward": {"calls": 4, "total_ms": 200.0, "self_ms": 200.0},
        "med.train.loss": {"calls": 4, "total_ms": 40.0, "self_ms": 40.0},
        "med.train.backward": {"calls": 4, "total_ms": 120.0, "self_ms": 120.0},
        "med.train.optimizer": {"calls": 4, "total_ms": 28.0, "self_ms": 28.0},
        "med.serve.request": {"calls": 2, "total_ms": 300.0, "self_ms": 3.0},
        "med.serve.upload": {"calls": 12, "total_ms": 60.0, "self_ms": 60.0},
        "med.serve.trunk": {"calls": 12, "total_ms": 150.0, "self_ms": 150.0},
        "med.serve.model": {"calls": 2, "total_ms": 50.0, "self_ms": 50.0},
        "med.serve.to_host": {"calls": 14, "total_ms": 37.0, "self_ms": 37.0}}


class _Run:
    def __init__(self, device_events):
        self.summary = {"device_events": device_events, "busy_s": 1.0, "window_s": 2.0}


def _read(name, run):
    return specs.load_module("metrics", name).read(run)


def test_each_reader_on_a_synthetic_summary_and_snapshot(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)
    run = _Run(4000)
    assert [_read(n, run) for n in STEP] == [2.0, 50.0, 10.0, 30.0, 7.0]
    assert [_read(n, run) for n in REQUEST] == [30.0, 75.0, 25.0, 18.5]
    assert _read("launches.train", run) == 1000.0
    assert _read("launches.serve", run) == 2000.0
    # the phases and the roots' own time make up the roots
    assert sum(_read(n, run) for n in STEP) + 1.0 == 100.0
    assert sum(_read(n, run) for n in REQUEST) + 1.5 == 150.0


def test_no_snapshot_no_roots_and_no_device_events_read_none(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)
    assert _read("launches.train", _Run(0)) is None
    assert _read("launches.train", type("NoTrace", (), {"summary": None})()) is None
    roots_gone = {k: v for k, v in SNAP.items() if not k.endswith((".step", ".request"))}
    monkeypatch.setattr(profiling, "snapshot", lambda: roots_gone)
    for name in STEP + REQUEST + LAUNCHES:
        assert _read(name, _Run(4000)) is None, name
    # a program that has no spans: an older one
    monkeypatch.delattr(profiling, "snapshot")
    for name in STEP + REQUEST + LAUNCHES:
        assert _read(name, _Run(4000)) is None, name


@pytest.mark.parametrize("cell", ["cog.train", "resnet50.finetune", "cog.pixels"])
def test_a_tiny_traced_run_reads_the_spans(cell):
    from core.run import Run

    torch.set_num_threads(4)
    s, w, cfg, tr = tiny(cell)
    run = Run(s, w, SEED, torch.device("cpu"), True, config=cfg, traffic=tr,
              log=lambda m: None)
    result = run.execute(0.5)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    names = STEP if cell != "cog.pixels" else REQUEST
    for name in names:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] >= 0, name
    assert metrics[names[1]]["value"] > 0
    # a CPU trace holds no device event: the launch counts read nothing,
    # as the idle shares do
    assert not set(metrics) & set(LAUNCHES)
    assert not any(k.startswith("device_idle") for k in metrics)
    # the program's spans reach neither the device operations nor the gaps
    names = [n for n, _ in result["breakdown"]["device_ops"] + result["breakdown"]["idle_gaps"]]
    assert not [n for n in names if n.startswith("med.")]
    profiling.reset()
