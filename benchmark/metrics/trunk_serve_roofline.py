"""The pixel front end's share of its roofline: the least time for the work
of every call into ``PixelFrontEnd._features`` (preprocessing and the
ResNet-50 trunk on a chunk of frames, padding included: the call's
shapes), counted as the trunk's FLOPs at the bfloat16 peak and the chunk,
the parameters and the features moved once, over the device time of
everything those calls launched. Bound by operations."""

from core.trace import Span
from work.resnet50 import trunk_forward_flops, trunk_parameters

NAME = "bench.trunk_serve"


def _work(args, kwargs):
    frontend, x = args[0], args[1]
    B, H, _, C = (int(n) for n in x.shape)
    width = frontend.net.conv1.weight.shape[0] if frontend.net is not None else 64
    flops = B * trunk_forward_flops(frontend.stage_sizes, width, H)
    nbytes = (x.numel() * x.element_size() + 4 * trunk_parameters(frontend.stage_sizes, width)
              + 4 * B * 32 * width)
    return nbytes, flops, "bfloat16"


SPANS = [Span("med_tpu_torch.eval.serving", "PixelFrontEnd._features", NAME, _work)]


def read(run):
    device_s = run.span_device_s(NAME)
    if not device_s:
        return None
    return 100.0 * run.least_s.get(NAME, 0.0) / device_s
