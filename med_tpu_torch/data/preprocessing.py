"""Frame pixels for the ResNet-50 trunk (port of the pixel part of
``med_tpu.data.preprocessing``): bilinear resize to 240, centre crop to 224,
/255, ImageNet normalisation, as the reference's frame pipeline does.

The resize is a linear map per axis, so it runs as two fp32 matmuls against
exact resize matrices; the crop is folded into the matrices and /255 plus
the normalisation into one affine. A 240-long axis resizes to itself, so it
is a plain crop. The kinematics and transcript parts of the JAX module are
not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=None)
def _resize_crop_matrix(n_in: int, n_out: int, lo: int, hi: int) -> np.ndarray:
    """(n_in, hi-lo) matrix M with M[i, k] = weight of input pixel i in
    output pixel lo+k of a bilinear resize from n_in to n_out pixels, as
    ``jax.image.resize(..., "bilinear")`` computes it (its
    ``compute_weight_mat``, in float32): a triangle kernel, widened by
    1/scale when downsampling (antialiasing), normalised per output pixel,
    zero where the sample point falls outside the input. An axis whose
    length does not change is the identity, as jax skips it."""
    if n_in == n_out:
        out = np.eye(n_in, dtype=np.float32)[:, lo:hi]
    else:
        scale = np.float32(n_out / n_in)
        inv_scale = np.float32(1.0) / scale
        kernel_scale = max(inv_scale, np.float32(1.0))
        sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                  - np.float32(0.5))
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
        w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
        total = w.sum(axis=0, keepdims=True, dtype=np.float32)
        w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                     w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        out = np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)[:, lo:hi]
        out = np.ascontiguousarray(out)
    # the cache hands the same array to every caller: freeze it
    out.flags.writeable = False
    return out


def preprocess_frames(frames: torch.Tensor, mean=IMAGENET_MEAN,
                      std=IMAGENET_STD) -> torch.Tensor:
    """(N, H, W, 3) raw frames (uint8 or float) -> (N, 224, 224, 3) fp32:
    bilinear resize to 240, centre crop 224, /255, normalise; on the
    frames' device."""
    x = frames.to(torch.float32)
    _, h, w, _ = x.shape
    dev = x.device
    if h == 240:
        x = x[:, 8:232]
    else:
        rh = torch.from_numpy(np.array(_resize_crop_matrix(h, 240, 8, 232))).to(dev)
        x = torch.einsum("nhwc,hp->npwc", x, rh)
    if w == 240:
        x = x[:, :, 8:232]
    else:
        rw = torch.from_numpy(np.array(_resize_crop_matrix(w, 240, 8, 232))).to(dev)
        x = torch.einsum("nhwc,wq->nhqc", x, rw)
    std = np.asarray(std, np.float32)
    scale = torch.from_numpy((1.0 / (255.0 * std)).astype(np.float32)).to(dev)
    shift = torch.from_numpy((-np.asarray(mean, np.float32) / std).astype(np.float32)).to(dev)
    return x * scale + shift
