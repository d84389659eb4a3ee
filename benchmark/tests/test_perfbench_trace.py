"""The trace reader on a synthetic event list: the busy share is the union
of device intervals over all streams, a device operation belongs to the
span its launch fell in (on any thread), idle gaps are named by the span
the host was in."""

import pytest
from torch.autograd import DeviceType

from core.trace import WINDOW, summarize


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, user=False):
        self._n, self._d, self._s, self._u, self._c, self._user = name, dev, start, dur, corr, user

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._user


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_busy_is_the_union_and_time_follows_the_launch():
    events = [
        Ev(WINDOW, CPU, 0, 1000, user=True),
        Ev("bench.step", CPU, 100, 500, user=True),
        Ev("bench.tcn_stack", CPU, 150, 50, user=True),
        Ev("cudaLaunchKernel", CPU, 160, 5, corr=7),
        Ev("cudaLaunchKernel", CPU, 250, 5, corr=8),
        Ev("cudaMemcpyAsync", CPU, 650, 5, corr=9),
        # two streams overlapping: 200-400 and 300-500 are 300 busy, not 400
        Ev("void tcn_stack_fwd<64>(Params)", GPU, 200, 200, corr=7),
        Ev("ampere_sgemm_128x64", GPU, 300, 200, corr=8),
        Ev("Memcpy HtoD (Pinned -> Device)", GPU, 700, 100, corr=9),
        Ev("bench.tcn_stack", GPU, 200, 200, user=True),      # a GPU annotation
        Ev("outside", GPU, 1500, 100, corr=99),               # after the window
    ]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(400e-9)
    # the kernel launched in the tcn span, and both kernels and not the
    # copy (launched at 600, after its end) in the step's
    assert s["span_device_s"]["bench.tcn_stack"] == pytest.approx(200e-9)
    assert s["span_device_s"]["bench.step"] == pytest.approx(400e-9)
    assert s["device_events"] == 3
    assert s["device_ops"][0][0] == "tcn_stack_fwd"
    gaps = dict(s["idle_gaps"])
    # 500-700 idle while the host was in the step; 0-200 and 800-1000 outside
    assert gaps["bench.step"] == pytest.approx(200e-9)
    assert gaps["outside spans"] == pytest.approx(400e-9)
