"""The card a run used, as the result line reports it."""

from __future__ import annotations

import subprocess
from typing import Optional


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, or None where it cannot be
    read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def describe(device, chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_limit_w()}
