"""The TCN kernels' share of their roofline: the least time for the work of
every call into the TCN stacks (``ops/tcn_fused.py``: the slow stages'
forward and backward in one call each, the fast stacks one call a stack),
counted from the call's shapes as inputs read once, outputs written once
and operations at the float32 peak, over the device time of everything
those calls launched. Bound by operations at COG's widths."""

from core.trace import Span
from work.kernels import tcn_backward, tcn_forward

NAME = "bench.tcn_stack"


def _forward(args, kwargs):
    x, stage_weights, masks = args[0], args[1], args[2]
    save = args[5] if len(args) > 5 else kwargs.get("save", False)
    layers = [int(w[0].shape[0]) for w in stage_weights]
    T, C = int(x.shape[-2]), int(x.shape[-1])
    nbytes, flops = tcn_forward(T, C, layers, 1, len(layers), saved=bool(save),
                                masked=masks is not None)
    return nbytes, flops, "float32"


def _backward(args, kwargs):
    g, stage_weights = args[0], args[3]
    layers = [int(w[0].shape[0]) for w in stage_weights]
    T, C = int(g.shape[-2]), int(g.shape[-1])
    nbytes, flops = tcn_backward(T, C, layers, len(layers), 1)
    return nbytes, flops, "float32"


SPANS = [Span("med_tpu_torch.ops.tcn_fused", "_stages_fwd", NAME, _forward),
         Span("med_tpu_torch.ops.tcn_fused", "_stages_bwd", NAME, _backward)]


def read(run):
    device_s = run.span_device_s(NAME)
    if not device_s:
        return None
    return 100.0 * run.least_s.get(NAME, 0.0) / device_s
