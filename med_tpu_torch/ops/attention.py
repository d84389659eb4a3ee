"""Sliding-window local attention (PyTorch port of ``med_tpu.ops.attention``).

COG attends, for every frame ``t``, over the ``window`` most recent frames
(len_q=30). The reference zero-pads the windows of the first frames and takes
the softmax over the full window, zero slots included: zero keys score 0 and
zero values add nothing, so prepending ``window-1`` zero rows to K/V and
taking a plain softmax reproduces it exactly.

The packed layout keeps the JAX package's contract, so the two are compared
like with like:

    q: (H, dk, N)  N = T*m, token n = t*m + j of frame t
    k: (H, dk, T)  v: (H, dv, T)  out: (H, dv, N)  stats: (H, 2, N)

:func:`sliding_window_attention_packed` runs the hand-written CUDA kernel
``csrc/swa_packed_fwd.cu`` on a CUDA tensor and its plain PyTorch version
:func:`sliding_window_attention_packed_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free layer norm over the last axis (the reference's per-forward
    ``nn.LayerNorm``, whose affine parameters are never trained)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over the second-to-last axis of k/v:
    q (..., Lq, dk), k (..., Lk, dk), v (..., Lk, dv) -> (..., Lq, dv)."""
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(scores, dim=-1) @ v


def sliding_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """(T, ...) -> (T, window, ...): the window ending at t, zero-padded at
    the left."""
    T = x.shape[0]
    xp = torch.cat([x.new_zeros((window - 1,) + x.shape[1:]), x], dim=0)
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(window, device=x.device)[None, :])
    return xp[idx]


def sliding_window_attention_xla(q, k, v, window: int) -> torch.Tensor:
    """Gather form, head-major: q (H, T, M, dk), k (H, T, dk), v (H, T, dv)
    -> (H, T, M, dv). Named after its JAX counterpart."""
    kwin = torch.stack([sliding_windows(x, window) for x in k])  # (H, T, W, dk)
    vwin = torch.stack([sliding_windows(x, window) for x in v])
    scores = torch.einsum("htmd,htwd->htmw", q, kwin) / math.sqrt(q.shape[-1])
    return torch.einsum("htmw,htwd->htmd", torch.softmax(scores, dim=-1), vwin)


def sliding_window_attention_packed_plain(q, k, v, window: int, m: int):
    """Plain PyTorch version of the kernel, packed layout -> (out, stats).

    Same arithmetic as the TPU kernel: q pre-scaled by 1/sqrt(dk), the
    banded max, exp, sum; out scaled by the reciprocal sum; stats row 0 the
    logsumexp, row 1 the reciprocal sum."""
    H, dk, N = q.shape
    T = N // m
    q4 = (q * (1.0 / math.sqrt(dk))).permute(0, 2, 1).reshape(H, T, m, dk)
    kwin = torch.stack([sliding_windows(x, window) for x in k.transpose(1, 2)])
    vwin = torch.stack([sliding_windows(x, window) for x in v.transpose(1, 2)])
    scores = torch.einsum("htmd,htwd->htmw", q4, kwin)
    smax = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - smax)
    psum = p.sum(dim=-1, keepdim=True)
    rsum = 1.0 / psum
    out = torch.einsum("htmw,htwd->htmd", p, vwin) * rsum        # (H, T, m, dv)
    lse = smax + torch.log(psum)
    stats = torch.cat([lse, rsum], dim=-1)                         # (H, T, m, 2)
    return (out.reshape(H, N, -1).permute(0, 2, 1),
            stats.reshape(H, N, 2).permute(0, 2, 1))


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _packed_fwd_cuda(q, k, v, window: int, m: int):
    H, dk, N = q.shape
    T = k.shape[2]
    if N != T * m or k.shape != (H, dk, T) or v.shape != (H, dk, T):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} with m={m}: "
                         f"the kernel takes q (H, d, T*m), k and v (H, d, T)")
    if dk not in (4, 8, 16, 32):
        raise ValueError(f"the CUDA kernel takes head widths 4, 8, 16, 32; got {dk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_build.check_operand(name, t, q.device, torch.float32)
    out = torch.empty_like(q)
    stats = torch.empty((H, 2, N), dtype=torch.float32, device=q.device)
    fn = cuda_build.kernel_function("swa_packed_fwd", "swa_packed_fwd", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              stats.data_ptr(), H, dk, T, m, window,
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_packed_fwd", "swa_packed_fwd", code)
    sliding_window_attention_packed.launches += 1
    return out, stats


def sliding_window_attention_packed(q, k, v, window: int, m: int,
                                    return_stats: bool = False):
    """Banded local attention in the packed layout (module docstring).

    A CUDA tensor goes to the CUDA kernel (replacing
    med_tpu/ops/attention.py::_swa_packed_fwd_kernel) and a CPU tensor to
    the plain version; any other device raises. ``return_stats`` also
    returns the (H, 2, N) per-query (logsumexp, 1/sum)."""
    if q.is_cuda:
        out, stats = _packed_fwd_cuda(q, k, v, window, m)
    elif q.device.type == "cpu":
        out, stats = sliding_window_attention_packed_plain(q, k, v, window, m)
    else:
        raise ValueError(f"no packed attention for device {q.device}")
    return (out, stats) if return_stats else out


sliding_window_attention_packed.launches = 0
