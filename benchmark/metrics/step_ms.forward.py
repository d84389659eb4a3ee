"""Host milliseconds a training step spends in ``med.train.forward``: the
model's forward launches, the dropout mask draws inside it. The phase's
total over the calls of ``med.train.step`` (the program's spans,
``med_tpu_torch/utils/profiling.py``).

The host times come from the traced window, where the profiler slows the
host: they compare a parent with its change, not with the untraced pace."""

from core.program_spans import TRAIN_STEP, per_root_ms


def read(run):
    return per_root_ms("med.train.forward", TRAIN_STEP)
