"""ResNet-50's FLOPs from its shapes (torchvision's v1.5: stride 2 in the
3x3 conv of a downsampling block): every convolution and the head's dense
layers, counted 2 per multiply-add. BatchNorm, relu, pooling and the
augmentation are elementwise and not counted."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def conv_shapes(stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                frame: int = 224) -> List[Tuple[int, int, int, int, int]]:
    """(cin, cout, k, h_out, w_out) of every convolution, in forward order."""
    convs = []
    h = (frame + 2 * 3 - 7) // 2 + 1              # conv1: 7x7, stride 2, pad 3
    convs.append((3, width, 7, h, h))
    h = (h + 2 - 3) // 2 + 1                      # max pool 3x3, stride 2, pad 1
    cin = width
    for stage, n in enumerate(stage_sizes):
        f = width * 2 ** stage
        for block in range(n):
            stride = 2 if (stage > 0 and block == 0) else 1
            ho = (h - 1) // stride + 1
            convs.append((cin, f, 1, h, h))
            convs.append((f, f, 3, ho, ho))
            convs.append((f, 4 * f, 1, ho, ho))
            if block == 0:
                convs.append((cin, 4 * f, 1, ho, ho))
            cin, h = 4 * f, ho
    return convs


def _conv_flops(c) -> float:
    cin, cout, k, ho, wo = c
    return 2.0 * cin * cout * k * k * ho * wo


def trunk_forward_flops(stage_sizes=(3, 4, 6, 3), width: int = 64, frame: int = 224) -> float:
    """One frame through the trunk to its pooled features."""
    return sum(_conv_flops(c) for c in conv_shapes(stage_sizes, width, frame))


def head_forward_flops(features: int = 2048, hidden: int = 512, classes: int = 1) -> float:
    return 2.0 * (features * hidden + hidden * classes)


def train_flops(stage_sizes=(3, 4, 6, 3), width: int = 64, frame: int = 224,
                hidden: int = 512, classes: int = 1) -> float:
    """Forward and backward of the classifier for one frame: each product
    three times, less the first conv's input gradient (the pixels take
    none)."""
    convs = conv_shapes(stage_sizes, width, frame)
    forward = sum(_conv_flops(c) for c in convs) + head_forward_flops(
        4 * width * 8, hidden, classes)
    return 3 * forward - _conv_flops(convs[0])


def trunk_parameters(stage_sizes=(3, 4, 6, 3), width: int = 64) -> int:
    """Conv weights and BatchNorm scales and biases of the trunk."""
    n = 0
    for cin, cout, k, _, _ in conv_shapes(stage_sizes, width):
        n += cin * cout * k * k + 2 * cout
    return n
