"""What the per-layer metrics of the program's own spans read: the host
times that ``med_tpu_torch.utils.profiling.snapshot()`` aggregates for each
``med.`` span, and the traced window's count of device operations.

The program's spans record exactly while a profiler records, so in a run
the snapshot covers the traced window alone. Its host times come from that
window, where the profiler slows the host: they compare a parent with its
change, not with the untraced pace. A program without the spans (or
without ``snapshot``) gives None, and so does a window with no root span."""

from __future__ import annotations

from typing import Dict, Optional

from med_tpu_torch.utils import profiling

TRAIN_STEP = "med.train.step"
REQUEST = "med.serve.request"


def snapshot() -> Dict[str, dict]:
    read = getattr(profiling, "snapshot", None)
    return read() if callable(read) else {}


def _roots(snap: Dict[str, dict], root: str) -> int:
    return int(snap.get(root, {}).get("calls", 0))


def per_root_ms(phase: str, root: str) -> Optional[float]:
    """The phase's host milliseconds (all its calls) over the root's calls."""
    snap = snapshot()
    roots = _roots(snap, root)
    if not roots:
        return None
    return snap.get(phase, {}).get("total_ms", 0.0) / roots


def launches(run, root: str) -> Optional[float]:
    """The traced window's device operations (kernels, copies, fills) over
    the root's calls: what the card ran, not the host's launch calls."""
    s = run.summary
    if s is None or s["device_events"] == 0:
        return None
    roots = _roots(snapshot(), root)
    if not roots:
        return None
    return s["device_events"] / roots
