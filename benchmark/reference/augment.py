"""Plain fine-tuning augmentation (reference resnet_finetuning.ipynb cell 4's
RandomCrop / RandomHorizontalFlip / RandomRotation / ColorJitter, in the
JAX package's batched form), applied to (B, H, W, 3) float pixels 0..255
with given per-image draws:

1. jitter: (x - m) * c + m * b, m the image's mean over all its values;
2. clip to 0..255;
3. rotation by the angle a as three shears, y by -tan(a/2) * (x - cx),
   x by sin(a) * (y - cy), y by -tan(a/2) * (x - cx) again, each a linear
   interpolation at the shifted position with zero outside the image;
4. a reflect-padded (8 pixels, the edge not repeated) crop at the draw's
   offsets; 5. a horizontal flip where drawn;
6. /255, then the fold's channel mean and std.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift(x: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    """out[..., i, ...] = x[..., i + t, ...] along ``axis`` (2 = H, 3 = W) of
    (B, C, H, W), linearly interpolated, zero outside; ``t`` varies along the
    other spatial axis: (B, W) for axis 2, (B, H) for axis 3."""
    n = x.shape[axis]
    lo = torch.floor(t)
    f = t - lo
    i = torch.arange(n, device=x.device, dtype=t.dtype)
    if axis == 2:
        pos = i[None, :, None] + lo[:, None, :]                 # (B, H, W)
        frac = f[:, None, :]
    else:
        pos = i[None, None, :] + lo[:, :, None]                 # (B, H, W)
        frac = f[:, :, None]

    def take(p):
        inside = (p >= 0) & (p <= n - 1)
        idx = torch.clamp(p, 0, n - 1).to(torch.int64)
        idx = idx[:, None].expand(-1, x.shape[1], -1, -1)
        return torch.where(inside[:, None], torch.gather(x, axis, idx), torch.zeros_like(x))

    w_hi = frac[:, None]
    return (1.0 - w_hi) * take(pos) + w_hi * take(pos + 1)


def rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    _, _, H, W = x.shape
    a = angles.to(device=x.device, dtype=torch.float32)
    alpha, beta = -torch.tan(a / 2.0), torch.sin(a)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    t_a = alpha[:, None] * (torch.arange(W, device=x.device, dtype=torch.float32) - cx)[None]
    t_b = beta[:, None] * (torch.arange(H, device=x.device, dtype=torch.float32) - cy)[None]
    return _shift(_shift(_shift(x, t_a, 2), t_b, 3), t_a, 2)


def augment(images: torch.Tensor, draws: dict, mean: torch.Tensor, std: torch.Tensor,
            pad: int = 8) -> torch.Tensor:
    """(B, H, W, 3) float 0..255 -> (B, H, W, 3) normalised, augmented."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    dev = x.device
    b, c = (v.to(dev, torch.float32).reshape(-1, 1, 1, 1) for v in draws["jitter"])
    m = x.mean(dim=(1, 2, 3), keepdim=True)
    x = torch.clamp((x - m) * c + m * b, 0.0, 255.0)
    x = rotate(x, draws["angles"])
    B, C, H, W = x.shape
    padded = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    oy, ox = (v.to(dev).to(torch.int64) for v in draws["crop"])
    rows = oy[:, None] + torch.arange(H, device=dev)
    cols = ox[:, None] + torch.arange(W, device=dev)
    x = padded[torch.arange(B, device=dev)[:, None, None, None],
               torch.arange(C, device=dev)[None, :, None, None],
               rows[:, None, :, None], cols[:, None, None, :]]
    flip = draws["flip"].to(dev).reshape(-1, 1, 1, 1)
    x = torch.where(flip, x.flip(3), x)
    x = (x / 255.0 - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)
    return x.permute(0, 2, 3, 1)

