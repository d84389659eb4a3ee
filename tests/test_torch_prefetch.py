"""The port's prefetch and profiling helpers (med_tpu_torch/utils/prefetch.py,
utils/profiling.py) and the double-buffered raw-frame path that uses them
(data/preprocessing.py::decode_preprocess_batches), on the CPU (med_tpu's
tests/test_parallel.py::test_prefetch_roundtrip). On the CPU a batch passes
through unchanged; the pinned side-stream copy runs on the card
(tests/test_torch_cuda.py, chip_smoke.py's parallel phase)."""

import json

import numpy as np
import pytest
import torch

from med_tpu.data.preprocessing import decode_preprocess_batches as jax_decode
from med_tpu_torch.data.preprocessing import decode_preprocess_batches
from med_tpu_torch.parallel.mesh import make_mesh
from med_tpu_torch.utils.prefetch import prefetch_to_device
from med_tpu_torch.utils.profiling import StepTimer, device_trace, trace_device_span_s


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


def test_trace_device_span_reads_the_busiest_stream(tmp_path):
    assert trace_device_span_s(str(tmp_path)) == -1.0
    events = [{"cat": "kernel", "pid": 0, "tid": 7, "ts": 100.0, "dur": 50.0},
              {"cat": "kernel", "pid": 0, "tid": 7, "ts": 400.0, "dur": 100.0},
              {"cat": "kernel", "pid": 0, "tid": 8, "ts": 0.0, "dur": 20.0},
              {"cat": "cpu_op", "pid": 1, "tid": 1, "ts": 0.0, "dur": 9000.0}]
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "trace.json").write_text(json.dumps({"traceEvents": events}))
    assert trace_device_span_s(str(tmp_path)) == pytest.approx(400e-6)


def test_device_trace_and_step_timer(tmp_path):
    with device_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    # a CPU trace holds no kernel
    assert trace_device_span_s(str(tmp_path)) == -1.0
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(4), units=2)
    assert timer.units == 6 and timer.total > 0
    assert timer.units_per_sec == pytest.approx(6 / timer.total)
    assert timer.ms_per_unit == pytest.approx(timer.total / 6 * 1e3)
