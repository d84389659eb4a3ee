"""The held experts' share of their roofline: the least time for the work
of every call into one held expert's SwiGLU (``models/mimo.py``:
``expert_swiglu``, the forward, and ``expert_swiglu_bwd``, the backward
autograd runs), counted from the call's shapes as the expert's three
weight matrices read once, the frames routed to it read and its output
written, and its products at the float32 peak (``work/mimo_v2_flash.py``),
over the device time of everything those calls launched. With ~48 frames
an expert a step its weights' bytes and its products weigh about alike. A
program without the MoE layer wraps nothing, and the metric reads None."""

import importlib

from core.trace import Span
from work.mimo_v2_flash import expert_backward, expert_forward

NAME = "bench.moe_experts"
MODULE = "med_tpu_torch.models.mimo"


def _forward(args, kwargs):
    x, w1 = args[0], args[1]
    nbytes, flops = expert_forward(int(x.shape[0]), int(w1.shape[1]), int(w1.shape[0]))
    return nbytes, flops, "float32"


def _backward(args, kwargs):
    x, w1 = args[1], args[2]
    nbytes, flops = expert_backward(int(x.shape[0]), int(w1.shape[1]), int(w1.shape[0]))
    return nbytes, flops, "float32"


def _spans():
    try:
        owner = importlib.import_module(MODULE)
    except ImportError:
        return []
    wanted = (("expert_swiglu", _forward), ("expert_swiglu_bwd", _backward))
    return [Span(MODULE, name, NAME, work) for name, work in wanted if hasattr(owner, name)]


SPANS = _spans()


def read(run):
    device_s = run.span_device_s(NAME)
    if not device_s:
        return None
    return 100.0 * run.least_s.get(NAME, 0.0) / device_s
