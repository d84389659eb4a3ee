"""The fine-tune classifier's share of its roofline: the least time for the
forward and backward of every call into ``ResNetClassifier.forward``
(the trunk and head at the batch's shapes, each product three times less
the first conv's input gradient, at the float32 peak; pixels, parameters
and their gradients moved once) over the device time of everything
launched inside the forward and the backward (``torch.autograd.backward``,
which the step calls once, on the loss). Bound by operations."""

from core.trace import Span
from work.resnet50 import train_flops

NAME = "bench.trunk_train"


def _work(args, kwargs):
    model, x = args[0], args[1]
    B, H = int(x.shape[0]), int(x.shape[1])
    trunk = model.trunk
    width = trunk.conv1.weight.shape[0]
    flops = B * train_flops(trunk.stage_sizes, width, H, model.fc1.weight.shape[0],
                            model.fc2.weight.shape[0])
    params = sum(p.numel() for p in model.parameters())
    nbytes = 4 * (x.numel() + 2 * params + B)
    return nbytes, flops, "float32"


SPANS = [Span("med_tpu_torch.models.resnet", "ResNetClassifier.forward", NAME, _work),
         Span("torch.autograd", "backward", NAME)]


def read(run):
    device_s = run.span_device_s(NAME)
    if not device_s:
        return None
    return 100.0 * run.least_s.get(NAME, 0.0) / device_s
