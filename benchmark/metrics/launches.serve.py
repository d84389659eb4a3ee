"""Device operations a served trial runs: every kernel, copy and fill
the traced window ran on the card (the trace summary's count) over the
calls of the program's ``med.serve.request`` span in that window.

These are device operations, not the host's launch calls: a CUDA graph's
replay runs the same operations from one launch, so this count cannot show
a request served through a graph (a count of the runtime's
``cudaLaunchKernel`` and ``cudaGraphLaunch`` events inside the root span
would)."""

from core.program_spans import REQUEST, launches


def read(run):
    return launches(run, REQUEST)
