"""The port's prefetch and profiling helpers (med_tpu_torch/utils/prefetch.py,
utils/profiling.py) and the double-buffered raw-frame path that uses them
(data/preprocessing.py::decode_preprocess_batches), on the CPU (med_tpu's
tests/test_parallel.py::test_prefetch_roundtrip). On the CPU a batch passes
through unchanged; the pinned side-stream copy runs on the card
(tests/test_torch_cuda.py, chip_smoke.py's parallel phase)."""

import json

import numpy as np
import torch

from med_tpu.data.preprocessing import decode_preprocess_batches as jax_decode
from med_tpu_torch.data.preprocessing import decode_preprocess_batches
from med_tpu_torch.parallel.mesh import make_mesh
from med_tpu_torch.utils import profiling
from med_tpu_torch.utils.prefetch import prefetch_to_device
from med_tpu_torch.utils.profiling import device_trace, snapshot, span


def test_prefetch_roundtrip(rng):
    batches = [{"x": rng.normal(size=(4, 3)).astype(np.float32), "_name": f"t{i}"}
               for i in range(5)]
    for depth in (0, 1, 2, 8):
        out = list(prefetch_to_device(iter(batches), depth=depth, device="cpu"))
        assert len(out) == 5
        for a, b in zip(out, batches):
            np.testing.assert_array_equal(np.asarray(a["x"]), b["x"])
            assert a["_name"] == b["_name"]
    # a mesh of one rank takes every row
    out = list(prefetch_to_device(batches, depth=2, device="cpu", mesh=make_mesh()))
    np.testing.assert_array_equal(out[3]["x"], batches[3]["x"])


def test_decode_preprocess_batches_matches_med_tpu(rng):
    frames = rng.integers(0, 256, size=(13, 48, 64, 3), dtype=np.uint8)
    got = list(decode_preprocess_batches("", batch=5, depth=2, frames_iter=iter(frames),
                                         device="cpu"))
    want = list(jax_decode("", batch=5, depth=2, frames_iter=iter(frames)))
    assert [g.shape for g in got] == [w.shape for w in want] == [(5, 224, 224, 3)] * 2 + \
        [(3, 224, 224, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_device_trace_and_step_timer(tmp_path):
    """``device_trace`` writes a chrome trace of its block and restarts the
    span aggregates, so a snapshot after it covers that trace alone (the
    step timer it once sat beside is gone: a root span times a step)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("med.test.before"):
            pass
    assert "med.test.before" in snapshot()
    with device_trace(str(tmp_path)):
        with span("med.test.step", root=True):
            torch.ones(8).sum()
    assert set(snapshot()) == {"med.test.step"}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [e["name"] for e in events if e.get("name", "").startswith("med.")] == [
        "med.test.step"]
    profiling.reset()
