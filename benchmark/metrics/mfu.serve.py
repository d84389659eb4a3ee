"""The whole request's share of the card's peak: the least time for the
model FLOPs of the real frames of the requests completed in the window
(the trunk's forward at the bfloat16 peak, the frame model's at the
float32 peak, counted from shapes by ``benchmark/work``) over the
window's wall time, both from the untraced window, which a traced run
measures before its traced one."""


def read(run):
    c = run.counters
    if not c.get("window_s"):
        return None
    return 100.0 * c["model_seconds_at_peak"] / c["window_s"]
