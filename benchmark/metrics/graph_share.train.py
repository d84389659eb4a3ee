"""The share of the traced window's training steps that ran from CUDA
graphs (``train/graphs.py``): the program's ``med.train.graph_step``
counter over the calls of its ``med.train.step`` root, both from
``med_tpu_torch/utils/profiling.py::snapshot()``. A step that captures
counts too: it runs from the graphs it has just captured. None where the
program counts no graphed step (a program without the graphs) or the
window holds no root."""

from core.program_spans import TRAIN_STEP, snapshot

COUNTER = "med.train.graph_step"


def read(run):
    snap = snapshot()
    steps = snap.get(TRAIN_STEP, {}).get("calls", 0)
    if not steps or COUNTER not in snap:
        return None
    return 100.0 * snap[COUNTER]["calls"] / steps
