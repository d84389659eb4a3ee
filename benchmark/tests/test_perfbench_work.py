"""The work counts reproduce PERF.md's bound column (the smoke test's
arithmetic) and ResNet-50's published size."""

import pytest

from work import kernels, resnet50
from work.peaks import least_seconds

T = 4096
COG = dict(H=8, d=8, m=15, W=30)
N, FK = (T + COG["W"] - 1) * COG["m"], T + COG["W"] - 1
STAGES = (11, 10, 10, 10)


@pytest.mark.parametrize("name,work,ms,by", [
    ("K1", kernels.attention_forward(8, 8, N, FK, 30), 0.0113, "bytes"),
    ("K3", kernels.attention_backward(8, 8, N, FK, 30), 0.0208, "bytes"),
    ("K2a", kernels.tcn_forward(T, 64, STAGES, 1, 4), 0.0828, "operations"),
    ("K2b", kernels.tcn_forward(T // 16, 64, STAGES, 4, 4), 0.0052, "operations"),
    ("K4", kernels.tcn_backward(T, 64, STAGES, 4, 1), 0.1655, "operations"),
    ("K5", kernels.tcn_backward(T // 16, 64, STAGES, 4, 4), 0.0103, "operations"),
])
def test_bound_column(name, work, ms, by):
    seconds, side = least_seconds(*work)
    assert round(seconds * 1e3, 4) == ms, name
    assert side == by


def test_resnet50_forward():
    # torchvision's v1.5 ResNet-50 at 224x224: 4.09 GMACs, 25.6 M parameters
    # of which the trunk's convs and BatchNorms hold 23.5 M
    assert resnet50.trunk_forward_flops() / 2 == pytest.approx(4.087e9, rel=1e-3)
    assert resnet50.trunk_parameters() == pytest.approx(23.5e6, rel=1e-2)
    fwd = resnet50.trunk_forward_flops() + resnet50.head_forward_flops()
    first = 2 * 3 * 64 * 49 * 112 * 112
    assert resnet50.train_flops() == pytest.approx(3 * fwd - first)
