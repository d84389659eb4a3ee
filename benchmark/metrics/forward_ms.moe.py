"""Host milliseconds a training step spends in ``med.model.moe``: the MoE
layers' forward (router, selection, the dispatch's wait on the card for the
held experts' frames, the held experts' launches, the combine), all its
calls over the calls of ``med.train.step`` (the program's spans,
``med_tpu_torch/utils/profiling.py``). None where the program has no such
span.

The host times come from the traced window, where the profiler slows the
host: they compare a parent with its change, not with the untraced pace."""

from core.program_spans import TRAIN_STEP, per_root_ms, snapshot

PHASE = "med.model.moe"


def read(run):
    if PHASE not in snapshot():
        return None
    return per_root_ms(PHASE, TRAIN_STEP)
