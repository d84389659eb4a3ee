"""``metrics/graph_share.train``: the graphed steps over the train step
root's calls, from the program's snapshot; None without a root or without
the counter (a program that has no step graphs)."""

from core import spec as specs
from med_tpu_torch.utils import profiling

STEP = {"calls": 8, "total_ms": 80.0, "self_ms": 2.0}


def _read(monkeypatch, snap):
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return specs.load_module("metrics", "graph_share.train").read(None)


def test_the_share_of_graphed_steps(monkeypatch):
    graphed = {"calls": 6, "total_ms": 0.0, "self_ms": 0.0}
    assert _read(monkeypatch, {"med.train.step": STEP, "med.train.graph_step": graphed}) == 75.0
    every = {"calls": 8, "total_ms": 0.0, "self_ms": 0.0}
    assert _read(monkeypatch, {"med.train.step": STEP, "med.train.graph_step": every}) == 100.0


def test_no_root_or_no_counter_reads_none(monkeypatch):
    graphed = {"calls": 6, "total_ms": 0.0, "self_ms": 0.0}
    assert _read(monkeypatch, {"med.train.graph_step": graphed}) is None
    assert _read(monkeypatch, {"med.train.step": STEP}) is None
    assert _read(monkeypatch, {}) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert specs.load_module("metrics", "graph_share.train").read(None) is None
