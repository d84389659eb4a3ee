"""The whole training step's share of the card's peak: the least time the
chip could take for the model FLOPs of the window's real frames (counted
from shapes by ``benchmark/work``, forward and backward, nothing
recomputed, at the float32 peak: TF32 is off) over the window's wall time,
both from the untraced window, which a traced run measures before its
traced one.
The card's power limit stands beside it in the result's ``device``."""


def read(run):
    c = run.counters
    if not c.get("window_s"):
        return None
    return 100.0 * c["model_seconds_at_peak"] / c["window_s"]
