"""The harness's packages (``core``, ``work``, ``reference``, ``drivers``)
and the checkout's program on the path, as ``benchmark/run.py`` puts them."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]


@pytest.fixture
def cuda():
    """Skip unless an NVIDIA GPU is there (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


SEED = 2 ** 31 + 12345      # drivers take seeds past 32 signed bits


def tiny(cell: str):
    """(spec, cell entry, configuration, traffic) of ``cell`` cut to a size
    the CPU runs in seconds: the same files, fewer layers, narrower TCN and
    chain (the front end keeps 2048 features), shorter trials, a smaller
    pool. The program runs its kernels' plain versions there."""
    from core import spec as specs

    s = specs.load_spec()
    w = specs.workload(s, cell)
    cfg = specs.load_config(s, w["config"])
    tr = specs.load_traffic(w["traffic"])
    if w["config"] == "cog":
        cfg["experiment"].update(d_model=16, d_q=2, sequence_length=6, num_layers_Basic=3,
                                 num_R=1, num_layers_R=2, mstcn_f_maps=8)
        cfg["front_end"].update(stage_sizes=[1, 1, 1, 1], width=64, frame=32, chunk=16)
    else:
        cfg.update(stage_sizes=[1, 1, 1, 1], width=8, frame=32, batch_size=8)
    if tr["driver"] == "frame_train":
        tr.update(trials=4, frames={"min": 40, "max": 100})
    elif tr["driver"] == "finetune":
        tr.update(frames=20)
    else:
        tr.update(pool_frames=200, frames={"min": 20, "max": 60}, cycle=8, check_requests=3)
    return s, w, cfg, tr


def tiny_run(cell: str, seed: int = SEED, control: bool = False):
    import torch

    from core.run import Run

    torch.set_num_threads(4)
    s, w, cfg, tr = tiny(cell)
    return Run(s, w, seed, torch.device("cpu"), False, control, config=cfg, traffic=tr,
               log=lambda m: None)
