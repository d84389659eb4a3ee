"""The control comes out not correct: the reference in the precision below
the configuration's (TF32 for the training cells' float32), or the
program's own lower path (the int8 front end for the served bfloat16
trunk), judged by each cell's limits. On the card only (TF32 and the int8
kernel exist there), at a size a test run holds: the tiny cells' files,
cut in depth, trials and pool; the widths the limits were set at stay."""

import pytest
import torch

from conftest import SEED
from core import spec as specs
from core.run import Run


def _small(cell):
    s = specs.load_spec()
    w = specs.workload(s, cell)
    cfg = specs.load_config(s, w["config"])
    tr = specs.load_traffic(w["traffic"])
    if tr["driver"] == "frame_train":
        tr.update(trials=6)
    elif tr["driver"] == "finetune":
        tr.update(frames=96)
    else:
        tr.update(pool_frames=2000, check_requests=3)
    return s, w, cfg, tr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cog.train", "resnet50.finetune", "cog.pixels"])
def test_the_control_is_not_correct(cell, cuda):
    s, w, cfg, tr = _small(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        result = Run(s, w, seed, cuda, False, True, config=cfg, traffic=tr,
                     log=lambda m: None).execute(3.0)
        assert not result["correct"], (seed, result["checks"])
        torch.cuda.empty_cache()
