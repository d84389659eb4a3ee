"""Host milliseconds a served trial spends in ``med.serve.to_host``: the host
blocked on the card: each chunk's features and the answer copied back. The
phase's total over the calls of ``med.serve.request`` (the program's spans,
``med_tpu_torch/utils/profiling.py``).

The host times come from the traced window, where the profiler slows the
host: they compare a parent with its change, not with the untraced pace."""

from core.program_spans import REQUEST, per_root_ms


def read(run):
    return per_root_ms("med.serve.to_host", REQUEST)
