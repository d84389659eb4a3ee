"""Image augmentations for ResNet fine-tuning (port of
``med_tpu.data.augment``).

The reference defines seeded RandomCrop / RandomHorizontalFlip /
RandomRotation / ColorJitter transforms for the backbone fine-tune
(resnet_finetuning.ipynb cell 4, ``image_train_transform``). Here the same
family runs batched on the images' device: per-image reflect-pad crop,
horizontal flip, small-angle rotation (three shears, as ``med_tpu``), and
brightness/contrast jitter.

Each random op comes in two parts: ``draw_*`` draws its per-image
parameters from an explicit ``torch.Generator`` (on the CPU, so a run draws
the same numbers on the card and on the CPU), and the op applies given
draws. The two packages cannot share random streams, so tests feed the
draws ``med_tpu`` makes from its key into the ops here.

:func:`augment_batch` transposes the NHWC input to channel-first
(B, C, H, W) once at entry and back once at exit, as ``med_tpu`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ draws
def draw_flip(n: int, generator: torch.Generator, p: float = 0.5) -> torch.Tensor:
    """(n,) bool: flip image i with probability p."""
    return torch.rand(n, generator=generator) < p


def draw_crop(n: int, generator: torch.Generator,
              pad: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(off_y, off_x), each (n,) int64 in [0, 2 * pad]: the crop's corner
    in the padded image."""
    off_y = torch.randint(0, 2 * pad + 1, (n,), generator=generator)
    off_x = torch.randint(0, 2 * pad + 1, (n,), generator=generator)
    return off_y, off_x


def draw_angles(n: int, generator: torch.Generator,
                max_degrees: float = 10.0) -> torch.Tensor:
    """(n,) float32 radians, U(±max_degrees)."""
    deg = (torch.rand(n, generator=generator) * 2.0 - 1.0) * max_degrees
    return deg * (np.pi / 180.0)


def draw_jitter(n: int, generator: torch.Generator, brightness: float = 0.2,
                contrast: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, c), each (n,) float32: U(1 ± brightness) and U(1 ± contrast)."""
    b = 1 - brightness + 2 * brightness * torch.rand(n, generator=generator)
    c = 1 - contrast + 2 * contrast * torch.rand(n, generator=generator)
    return b, c


def draw_augment(n: int, generator: torch.Generator, crop_pad: int = 8,
                 max_degrees: float = 10.0, brightness: float = 0.2,
                 contrast: float = 0.2) -> Dict[str, object]:
    """Every draw :func:`augment_batch` takes, for a batch of n images."""
    return {"jitter": draw_jitter(n, generator, brightness, contrast),
            "angles": draw_angles(n, generator, max_degrees),
            "crop": draw_crop(n, generator, crop_pad),
            "flip": draw_flip(n, generator)}


def _per_image(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(device=x.device, dtype=x.dtype).reshape(-1, 1, 1, 1)


# --------------------------------------------------------------- public NHWC
def random_horizontal_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C); image i mirrored where ``flip[i]``."""
    return torch.where(flip.to(images.device).reshape(-1, 1, 1, 1),
                       images.flip(2), images)


def random_crop(images: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor,
                pad: int = 8) -> torch.Tensor:
    """Reflection-pad by ``pad``, then each image's crop of the original size
    at its offsets (torch RandomCrop(size, padding=pad))."""
    x = _crop_cf(images.permute(0, 3, 1, 2), off_y, off_x, pad)
    return x.permute(0, 2, 3, 1)


def random_rotation(images: torch.Tensor, angles: torch.Tensor,
                    max_degrees: float = 10.0) -> torch.Tensor:
    """Per-image rotation by ``angles`` (radians, |angle| <= max_degrees)
    with linear resampling around the image centre (zero fill outside):
    :func:`rotate_batch_cf`. images (B, H, W, C)."""
    x = rotate_batch_cf(images.permute(0, 3, 1, 2), angles,
                        float(max_degrees) * np.pi / 180.0)
    return x.permute(0, 2, 3, 1)


def color_jitter(images: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-image multiplicative brightness ``b`` and contrast ``c`` (the
    0-255/0-1 range is preserved by the caller's clipping)."""
    return _jitter_cf(images, b, c)


# ------------------------------------------------ channel-first (B, C, H, W)
def _shift_lerp(x: torch.Tensor, t: torch.Tensor, k_max: int, axis: int) -> torch.Tensor:
    """Fractional shift with zero fill along ``axis`` (2 = H, 3 = W) of a
    channel-first (B, C, H, W) tensor: ``out[..., i, ...] = x[..., i + t,
    ...]`` with linear interpolation. The shift varies along the *other*
    spatial axis: for axis=2, ``t`` is (B, W); for axis=3, (B, H).

    The sum over the 2*k_max+1 integer shifts of tent(t - k) times the
    shifted slice, as ``med_tpu`` forms it (per row only the two tent
    weights bracketing t are nonzero, so the sum is the lerp), added in the
    same order."""
    pad = [0, 0, 0, 0]
    pad[(3 - axis) * 2:(3 - axis) * 2 + 2] = [k_max, k_max]
    xpad = F.pad(x, pad)
    n = x.shape[axis]
    acc = torch.zeros_like(x)
    for k in range(-k_max, k_max + 1):
        w = torch.clamp(1.0 - torch.abs(t - k), min=0.0)
        sl = xpad.narrow(axis, k_max + k, n)
        if axis == 2:
            acc = acc + w[:, None, None, :] * sl
        else:
            acc = acc + w[:, None, :, None] * sl
    return acc


def rotate_batch_cf(x: torch.Tensor, angles_rad: torch.Tensor,
                    max_radians: float) -> torch.Tensor:
    """Rotate a channel-first batch (B, C, H, W) by per-image ``angles_rad``
    via the Paeth 3-shear decomposition
    ``R(a) = A(-tan(a/2)) . B(sin a) . A(-tan(a/2))``: A is a per-column
    shift along y, B a per-row shift along x — three :func:`_shift_lerp`
    passes. ``max_radians`` bounds |angle| and sizes the shear windows.

    ``med_tpu``'s documented deviation from torchvision's single-pass
    bilinear RandomRotation holds here too: the three 1-D lerps smooth a
    touch more (tests/test_augment.py pins its bound)."""
    _, _, H, W = x.shape
    angles = angles_rad.to(device=x.device, dtype=torch.float32)
    alpha = -torch.tan(angles / 2.0)   # y-shift per column, passes 1 and 3
    beta = torch.sin(angles)           # x-shift per row, pass 2
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    dxs = torch.arange(W, dtype=torch.float32, device=x.device) - cx
    dys = torch.arange(H, dtype=torch.float32, device=x.device) - cy
    rad = float(max_radians)
    k_a = int(np.ceil(np.tan(rad / 2.0) * max(cx, 1.0))) + 1
    k_b = int(np.ceil(np.sin(rad) * max(cy, 1.0))) + 1

    t_a = alpha[:, None] * dxs[None]  # (B, W): y-source shift for column x
    t_b = beta[:, None] * dys[None]   # (B, H): x-source shift for row y

    x = _shift_lerp(x, t_a, k_a, axis=2)
    x = _shift_lerp(x, t_b, k_b, axis=3)
    return _shift_lerp(x, t_a, k_a, axis=2)


def _crop_cf(x: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor,
             pad: int) -> torch.Tensor:
    """Reflect-pad (the edge excluded, as ``jnp.pad(mode="reflect")``), then
    each image's H x W window at its offsets: two gathers with per-image
    row and column indices."""
    B, C, H, W = x.shape
    padded = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    dev = x.device
    rows = off_y.to(dev)[:, None] + torch.arange(H, device=dev)
    cols = off_x.to(dev)[:, None] + torch.arange(W, device=dev)
    y = padded.gather(2, rows.reshape(B, 1, H, 1).expand(B, C, H, W + 2 * pad))
    return y.gather(3, cols.reshape(B, 1, 1, W).expand(B, C, H, W))


def _flip_cf(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip.to(x.device).reshape(-1, 1, 1, 1), x.flip(3), x)


def _jitter_cf(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * _per_image(c, x) + mean * _per_image(b, x)


def augment_batch(
    images: torch.Tensor,
    draws: Dict[str, object],
    crop_pad: int = 8,
    max_degrees: float = 10.0,
    value_range: Tuple[float, float] = (0.0, 255.0),
    normalize: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Full fine-tuning augmentation of (B, H, W, C) float images with the
    draws of :func:`draw_augment`: jitter -> clip -> rotate -> crop -> flip,
    computed channel-first, as ``med_tpu`` orders them.

    ``normalize=(mean, std)`` fuses the fine-tune CLI's ``/255`` + per-channel
    standardization (reference image_transform,
    preprocessing_utils.py:697-705) into the channel-first domain."""
    x = images.permute(0, 3, 1, 2)
    x = _jitter_cf(x, *draws["jitter"])
    x = torch.clamp(x, *value_range)
    x = rotate_batch_cf(x, draws["angles"], float(max_degrees) * np.pi / 180.0)
    x = _crop_cf(x, *draws["crop"], crop_pad)
    x = _flip_cf(x, draws["flip"])
    if normalize is not None:
        mean, std = normalize
        x = (x / value_range[1] - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)
    return x.permute(0, 2, 3, 1)
