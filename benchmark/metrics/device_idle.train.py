"""The share of the traced window in which no kernel, copy or fill ran on
the card: one minus the union of the device's intervals over all streams,
over the window. Training cells.

It comes from the traced window (at most ``TRACED_SECONDS``, after the
untraced one), where the profiler slows the host: where the host sets the
pace, it reads higher than an untraced run would. The run logs on stderr
the frames a second of both windows and the idle share the traced device
time a frame gives at the untraced pace (``profiler:``); PERF.md keeps
both readings."""


def read(run):
    s = run.summary
    if s is None or s["window_s"] <= 0 or s["device_events"] == 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
