"""The packed attention's sink instance's share of its roofline: the least
time for the work of every call into it (``ops/attention.py``:
``sliding_window_attention_sink``, the forward, and
``sliding_window_attention_sink_bwd``, the backward autograd runs; MiMo's
windowed layers), counted from the call's shapes as inputs read once,
outputs written once and the (query, key) pairs' operations at the float32
peak (``work/mimo_v2_flash.py``), over the device time of everything those
calls launched. Bound by operations at MiMo's widths. A program without the
instance wraps nothing, and the metric reads None."""

import importlib

from core.trace import Span
from work.mimo_v2_flash import sink_backward, sink_forward

NAME = "bench.swa_sink"
MODULE = "med_tpu_torch.ops.attention"


def _shape(q, k, v, window, m):
    H, dk, _ = (int(n) for n in q.shape)
    return H, dk, int(v.shape[1]), int(k.shape[2]), int(m), int(window)


def _forward(args, kwargs):
    q, k, v, _, window, m = args[:6]
    nbytes, flops = sink_forward(*_shape(q, k, v, window, m))
    return nbytes, flops, "float32"


def _backward(args, kwargs):
    q, k, v = args[:3]
    window, m = args[7], args[8]
    nbytes, flops = sink_backward(*_shape(q, k, v, window, m))
    return nbytes, flops, "float32"


def _spans():
    owner = importlib.import_module(MODULE)
    wanted = (("sliding_window_attention_sink", _forward),
              ("sliding_window_attention_sink_bwd", _backward))
    return [Span(MODULE, name, NAME, work) for name, work in wanted if hasattr(owner, name)]


SPANS = _spans()


def read(run):
    device_s = run.span_device_s(NAME)
    if not device_s:
        return None
    return 100.0 * run.least_s.get(NAME, 0.0) / device_s
