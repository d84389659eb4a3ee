"""The banded attention kernels' share of their roofline: the least time
for the work of every call into the packed attention (``ops/attention.py``:
the forward, and the backward autograd runs), counted from the call's
shapes as inputs read once, outputs written once and operations at the
float32 peak, over the device time of everything those calls launched.
Bound by bytes at COG's widths."""

from core.trace import Span
from work.kernels import attention_backward, attention_forward

NAME = "bench.swa_packed"


def _shape(q, k, window):
    H, d, N = (int(n) for n in q.shape)
    return H, d, N, int(k.shape[2]), int(window)


def _forward(args, kwargs):
    nbytes, flops = attention_forward(*_shape(args[0], args[1], args[3]))
    return nbytes, flops, "float32"


def _backward(args, kwargs):
    nbytes, flops = attention_backward(*_shape(args[0], args[1], args[6]))
    return nbytes, flops, "float32"


SPANS = [Span("med_tpu_torch.ops.attention", "_packed_fwd", NAME, _forward),
         Span("med_tpu_torch.ops.attention", "sliding_window_attention_packed_bwd", NAME,
              _backward)]


def read(run):
    device_s = run.span_device_s(NAME)
    if not device_s:
        return None
    return 100.0 * run.least_s.get(NAME, 0.0) / device_s
