"""Device operations a training step runs: every kernel, copy and fill
the traced window ran on the card (the trace summary's count) over the
calls of the program's ``med.train.step`` span in that window. The feed's
uploads between steps count with the steps.

These are device operations, not the host's launch calls: a CUDA graph's
replay runs the same operations from one launch, so this count cannot show
a step captured in a graph (a count of the runtime's ``cudaLaunchKernel``
and ``cudaGraphLaunch`` events inside the root span would)."""

from core.program_spans import TRAIN_STEP, launches


def read(run):
    return launches(run, TRAIN_STEP)
