"""The port's spans (med_tpu_torch/utils/profiling.py) on the CPU: off, a
span is one check of the profiler's flag and never enters
``record_function``; on, each is a ``record_function`` range in the trace
with its host time in ``snapshot()``. The three paths the benchmark's cells
run put their phases inside their root: a COG ``Experiment.train_step``,
the fine-tune ``train_step`` and ``FrameModelServer.predict_trial_from_pixels``
on a ``PixelFrontEnd``."""

import json
import statistics
import time

import numpy as np
import pytest
import torch

from med_tpu_torch.cli import resnet_finetune
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data.augment import draw_augment
from med_tpu_torch.data.datasets import FrameTrial, frame_batch
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.eval.serving import FrameModelServer, PixelFrontEnd
from med_tpu_torch.models import init_weights
from med_tpu_torch.models.resnet import ResNet50, ResNetClassifier
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.utils import profiling
from med_tpu_torch.utils.jax_params import export_jax_params
from med_tpu_torch.utils.profiling import device_trace, snapshot, span

PHASES = ("inputs", "forward", "loss", "backward", "optimizer")
COG = dict(model_name="COG", dataset_type="frame", data_type="multimodal",
           video_dims=2048, out_features=2, num_layers_Basic=3, num_layers_R=2,
           num_R=1, mstcn_f_maps=8, d_model=16, d_q=2, sequence_length=5,
           lr=1e-3, weight_decay=5e-3, lr_scheduler=False, seed=0)


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _trial(rng, T):
    name = "Needle_Passing_C002"
    e = np.zeros((T, 7), np.int32)
    e[:, -1] = rng.integers(0, 2, T)
    return FrameTrial(name=name, images=rng.normal(size=(T, 2048)).astype(np.float32),
                      kinematics=rng.normal(size=(T, 26)).astype(np.float32),
                      g_labels=rng.integers(0, 15, T), e_powerset=e,
                      skill=skill_one_hot(name, T))


def _spans(path):
    """The trace's complete events by name: [(start, end, thread)]."""
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid")))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner[2] == outer[2]


def test_off_a_span_records_nothing_and_never_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset()
    with span("med.test.root", root=True):
        with span("med.test.child"):
            pass
    assert span("med.a") is span("med.b", root=True) is profiling.NO_SPAN
    assert snapshot() == {}


def test_the_flag_follows_the_profilers_start_and_stop():
    assert type(span("med.test")).__name__ == "_Off"
    prof = _profiler()
    prof.start()
    try:
        assert type(span("med.test")).__name__ == "_Span"
    finally:
        prof.stop()
    assert type(span("med.test")).__name__ == "_Off"


def test_on_the_aggregates_give_calls_total_and_self_time():
    profiling.reset()
    prof = _profiler()
    prof.start()
    try:
        for _ in range(2):
            with span("med.test.root", root=True):
                time.sleep(0.004)
                with span("med.test.child"):
                    time.sleep(0.006)
                with span("med.test.child"):
                    time.sleep(0.002)
                # a root inside another span opens nothing
                with span("med.test.root", root=True):
                    pass
    finally:
        prof.stop()
    snap = snapshot()
    root, child = snap["med.test.root"], snap["med.test.child"]
    assert root["calls"] == 2 and child["calls"] == 4
    assert child["self_ms"] == child["total_ms"] >= 16.0
    assert root["total_ms"] >= child["total_ms"] + 8.0
    assert root["self_ms"] == pytest.approx(root["total_ms"] - child["total_ms"], abs=1e-6)
    # spans out of a profiler add nothing
    with span("med.test.root", root=True):
        pass
    assert snapshot()["med.test.root"]["calls"] == 2
    profiling.reset()
    assert snapshot() == {}


def test_a_cog_train_step_nests_its_phases_in_the_trace(rng, tmp_path):
    cfg = ExperimentConfig(**COG)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(3)
    batch = frame_batch(_trial(rng, 40), cfg, bucket=64)
    exp.train_step(batch)                 # outside the trace: not in the snapshot
    with device_trace(str(tmp_path)):
        exp.train_step(batch)
    snap = snapshot()
    assert snap["med.train.step"]["calls"] == 1
    assert {f"med.train.{p}" for p in PHASES} <= set(snap)
    phases = sum(snap[f"med.train.{p}"]["total_ms"] for p in PHASES)
    assert phases + snap["med.train.step"]["self_ms"] == pytest.approx(
        snap["med.train.step"]["total_ms"], rel=1e-6)

    spans = _spans(tmp_path / "trace.json")
    (step,) = spans["med.train.step"]
    for p in PHASES:
        assert spans[f"med.train.{p}"] and all(
            _inside(s, step) for s in spans[f"med.train.{p}"]), p
    (forward,) = spans["med.train.forward"]
    ops = [s for name, ss in spans.items() if name.startswith("aten::")
           for s in ss if s[2] == forward[2]]
    # the model's own ops run inside the forward's interval: its products
    # (the loss, backward and Adam call none) and dozens more
    assert sum(_inside(s, forward) for s in ops) >= 20
    linear = [s for s in spans["aten::linear"] if _inside(s, step)]
    assert linear and all(_inside(s, forward) for s in linear)


def test_a_finetune_step_gives_the_same_five_phases():
    net = init_weights(ResNetClassifier(stage_sizes=(1, 1, 1, 1), width=8),
                       torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    g = np.random.default_rng(1)
    imgs = g.integers(0, 256, size=(8, 32, 32, 3)).astype(np.float32)
    labels = g.integers(0, 2, 8).astype(np.float32)
    mask = np.ones(8, np.float32)
    stats = (torch.full((3,), 0.45), torch.full((3,), 0.22))
    draws = draw_augment(8, torch.Generator().manual_seed(2))
    profiling.reset()
    with _profiler():
        for _ in range(2):
            loss = resnet_finetune.train_step(net, opt, imgs, labels, mask, stats,
                                              False, draws)
    assert np.isfinite(float(loss))
    snap = snapshot()
    assert snap["med.train.step"]["calls"] == 2
    for p in PHASES:
        assert snap[f"med.train.{p}"]["calls"] >= 2, p
    phases = sum(snap[f"med.train.{p}"]["total_ms"] for p in PHASES)
    assert phases + snap["med.train.step"]["self_ms"] == pytest.approx(
        snap["med.train.step"]["total_ms"], rel=1e-6)
    assert phases >= 0.9 * snap["med.train.step"]["total_ms"]


def test_a_served_trial_from_pixels_is_one_request_with_its_chunks(rng):
    cfg = ExperimentConfig(**COG)
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(4)
    server = FrameModelServer(cfg, exp.checkpoint(), device="cpu")
    trunk = export_jax_params(init_weights(ResNet50((1, 1, 1, 1), 64),
                                           torch.Generator().manual_seed(5)))
    fe = PixelFrontEnd(trunk["params"], trunk["batch_stats"], mean=np.full(3, 0.45),
                       std=np.full(3, 0.22), dtype=torch.float32, stage_sizes=(1, 1, 1, 1),
                       width=64, batch_size=16, device="cpu")
    T, chunks = 40, 3
    frames = rng.integers(0, 256, size=(T, 32, 32, 3)).astype(np.uint8)
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    profiling.reset()
    with _profiler():
        preds, probs = server.predict_trial_from_pixels(fe, frames, kin)
    assert preds.shape == probs.shape == (T,)
    snap = snapshot()
    calls = {name: v["calls"] for name, v in snap.items()}
    # the chunks' uploads, trunk calls and features back; the answer back too
    assert calls == {"med.serve.request": 1, "med.serve.upload": chunks,
                     "med.serve.trunk": chunks, "med.serve.to_host": chunks + 1,
                     "med.serve.model": 1}
    # predict_trial alone is a request of its own
    profiling.reset()
    with _profiler():
        server.predict_trial(fe.features(frames), kin)
        server.predict_trial(fe.features(frames), kin)
    snap = snapshot()
    assert snap["med.serve.request"]["calls"] == snap["med.serve.model"]["calls"] == 2


def test_a_span_off_costs_at_most_two_microseconds():
    """Median over 100 rounds of 1,000 calls (100,000 in all) of one span
    entered and left with no profiler."""
    rounds = []
    for _ in range(100):
        t0 = time.perf_counter_ns()
        for _ in range(1000):
            with span("med.train.forward"):
                pass
        rounds.append((time.perf_counter_ns() - t0) / 1000)
    cost = statistics.median(rounds)
    print(f"a span off: {cost:.1f} ns (median of 100 rounds of 1,000 calls)")
    assert cost <= 2000.0
