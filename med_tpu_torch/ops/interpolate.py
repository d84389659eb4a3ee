"""1-D resampling with torch ``F.interpolate`` index semantics (port of
``med_tpu.ops.interpolate``), computed as explicit gathers and lerps so the
indices are those of the JAX package."""

from __future__ import annotations

import numpy as np
import torch


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # torch 'nearest': src = floor(i * in/out)
    return np.minimum(
        (np.arange(out_size) * (in_size / out_size)).astype(np.int64),
        in_size - 1,
    )


def interp1d_nearest(x: torch.Tensor, out_size: int, axis: int = -1) -> torch.Tensor:
    """Nearest-neighbour resample along ``axis`` to ``out_size``."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx = torch.as_tensor(_nearest_indices(in_size, out_size), device=x.device)
    return torch.index_select(x, axis, idx)


def interp1d_linear(x: torch.Tensor, out_size: int, axis: int = -1) -> torch.Tensor:
    """Linear resample along ``axis`` (align_corners=False, torch default)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)

    x_lo = torch.index_select(x, axis, torch.as_tensor(lo, device=x.device))
    x_hi = torch.index_select(x, axis, torch.as_tensor(hi, device=x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = torch.as_tensor(w, device=x.device).reshape(shape)
    return x_lo * (1.0 - w) + x_hi * w
