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
:func:`sliding_window_attention_packed_plain` on a CPU tensor. Where autograd
needs a gradient it runs through :class:`_PackedAttention`, whose backward
:func:`sliding_window_attention_packed_bwd` is the CUDA kernel
``csrc/swa_packed_bwd.cu`` on the card and
:func:`sliding_window_attention_packed_bwd_plain` on the CPU.

The head-major layout, q (H, T, M, dk), k (H, T, dk), v (H, T, dv) -> out
(H, T, M, dv), is the public op :func:`sliding_window_attention`:
:func:`sliding_window_attention_pallas` runs ``csrc/swa_headmajor_fwd.cu``
and :func:`sliding_window_attention_bwd_pallas` runs
``csrc/swa_headmajor_bwd.cu``, which recomputes the softmax from q, k and v;
their plain versions are :func:`sliding_window_attention_xla` and
:func:`sliding_window_attention_bwd_plain`. (The names are the JAX package's,
whose counterparts these are.)
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


def _packed_fwd(q, k, v, window: int, m: int):
    if q.is_cuda:
        return _packed_fwd_cuda(q, k, v, window, m)
    if q.device.type == "cpu":
        return sliding_window_attention_packed_plain(q, k, v, window, m)
    raise ValueError(f"no packed attention for device {q.device}")


class _PackedAttention(torch.autograd.Function):
    """Forward kernel K1 saving (q, k, v, out, stats), backward kernel K3 (as
    med_tpu's _swa_packed_fwd_rule / _swa_packed_bwd_rule)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, m: int):
        out, stats = _packed_fwd(q, k, v, window, m)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.window, ctx.m = window, m
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = sliding_window_attention_packed_bwd(
            q, k, v, g.contiguous(), out, stats, ctx.window, ctx.m)
        return dq, dk, dv, None, None


def sliding_window_attention_packed(q, k, v, window: int, m: int,
                                    return_stats: bool = False):
    """Banded local attention in the packed layout (module docstring).

    A CUDA tensor goes to the CUDA kernel (replacing
    med_tpu/ops/attention.py::_swa_packed_fwd_kernel) and a CPU tensor to
    the plain version; any other device raises. ``return_stats`` also
    returns the (H, 2, N) per-query (logsumexp, 1/sum). When autograd needs
    a gradient of q, k or v, the call saves what the backward reads; under
    ``no_grad`` it saves nothing."""
    if (not return_stats and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _PackedAttention.apply(q, k, v, window, m)
    out, stats = _packed_fwd(q, k, v, window, m)
    return (out, stats) if return_stats else out


sliding_window_attention_packed.launches = 0


def sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats,
                                              window: int, m: int):
    """Plain PyTorch version of the backward kernel -> (dq, dk, dv), same
    shapes as (q, k, v). The arithmetic of the TPU kernel: q pre-scaled by
    1/sqrt(dk), a = exp(scores - lse) from the saved stats, delta = out.g
    (the flash-attention identity), ds = a * (g.v - delta); the keys'
    gradients scatter back from the windows, and the zero halo's drop."""
    H, dk, N = q.shape
    T = N // m
    W = window
    scale = 1.0 / math.sqrt(dk)
    q4 = (q * scale).permute(0, 2, 1).reshape(H, T, m, dk)
    g4 = g.permute(0, 2, 1).reshape(H, T, m, -1)
    lse = stats[:, 0].reshape(H, T, m, 1)
    delta = (out * g).sum(dim=1).reshape(H, T, m, 1)
    kwin = torch.stack([sliding_windows(x, W) for x in k.transpose(1, 2)])
    vwin = torch.stack([sliding_windows(x, W) for x in v.transpose(1, 2)])
    a = torch.exp(torch.einsum("htmd,htwd->htmw", q4, kwin) - lse)
    ds = a * (torch.einsum("htmd,htwd->htmw", g4, vwin) - delta)
    dq = torch.einsum("htmw,htwd->htmd", ds, kwin) * scale
    dkwin = torch.einsum("htmw,htmd->htwd", ds, q4)
    dvwin = torch.einsum("htmw,htmd->htwd", a, g4)
    # slot w of frame t's window is row t + w of the left-padded keys
    dk_p = q.new_zeros((H, T + W - 1, dk))
    dv_p = q.new_zeros((H, T + W - 1, dvwin.shape[-1]))
    for w in range(W):
        dk_p[:, w:w + T] += dkwin[:, :, w]
        dv_p[:, w:w + T] += dvwin[:, :, w]
    return (dq.reshape(H, N, dk).permute(0, 2, 1),
            dk_p[:, W - 1:].transpose(1, 2), dv_p[:, W - 1:].transpose(1, 2))


_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _packed_bwd_cuda(q, k, v, g, out, stats, window: int, m: int):
    H, dk, N = q.shape
    T = k.shape[2]
    if N != T * m or k.shape != (H, dk, T) or v.shape != (H, dk, T):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} with m={m}: "
                         f"the kernel takes q (H, d, T*m), k and v (H, d, T)")
    if dk not in (4, 8, 16, 32):
        raise ValueError(f"the CUDA kernel takes head widths 4, 8, 16, 32; got {dk}")
    if m > 512:
        raise ValueError(f"the backward kernel takes at most 512 queries a frame; got {m}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g), ("out", out),
                    ("stats", stats)):
        cuda_build.check_operand(name, t, q.device, torch.float32)
    if g.shape != q.shape or out.shape != q.shape or stats.shape != (H, 2, N):
        raise ValueError(f"g {tuple(g.shape)}, out {tuple(out.shape)} and stats "
                         f"{tuple(stats.shape)} do not match q {tuple(q.shape)}")
    # delta = out.g per query, one elementwise product and one reduction (an
    # einsum here becomes H*N batched 1x1 products)
    delta = (out * g).sum(dim=1)
    dq = torch.empty_like(q)
    dkk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    fn = cuda_build.kernel_function("swa_packed_bwd", "swa_packed_bwd", _BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              stats.data_ptr(), delta.data_ptr(), dq.data_ptr(), dkk.data_ptr(),
              dvv.data_ptr(), H, dk, T, m, window,
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_packed_bwd", "swa_packed_bwd", code)
    sliding_window_attention_packed_bwd.launches += 1
    return dq, dkk, dvv


def sliding_window_attention_packed_bwd(q, k, v, g, out, stats, window: int,
                                        m: int):
    """Backward of :func:`sliding_window_attention_packed` from the
    forward's ``out`` and (H, 2, N) ``stats`` and the output cotangent g ->
    (dq (H, dk, N), dk (H, dk, T), dv (H, dv, T)). A CUDA tensor runs the
    CUDA kernel, one launch (replacing
    med_tpu/ops/attention.py::_swa_packed_bwd_kernel); a CPU tensor the
    plain version; any other device raises."""
    if q.is_cuda:
        return _packed_bwd_cuda(q, k, v, g, out, stats, window, m)
    if q.device.type == "cpu":
        return sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats,
                                                         window, m)
    raise ValueError(f"no packed attention backward for device {q.device}")


sliding_window_attention_packed_bwd.launches = 0


# --- head-major layout ---------------------------------------------------

def sliding_window_attention_bwd_plain(q, k, v, g, window: int):
    """Plain PyTorch version of the head-major backward -> (dq, dk, dv), the
    arithmetic of the TPU kernel: the banded softmax a is recomputed from q,
    k, v; da = g.v over the window, ds = a * (da - sum(da * a)) / sqrt(dk);
    the keys' gradients scatter back from the windows and the zero halo's
    drop."""
    H, T, M, dk = q.shape
    W = window
    scale = 1.0 / math.sqrt(dk)
    kwin = torch.stack([sliding_windows(x, W) for x in k])        # (H, T, W, dk)
    vwin = torch.stack([sliding_windows(x, W) for x in v])
    a = torch.softmax(torch.einsum("htmd,htwd->htmw", q, kwin) * scale, dim=-1)
    da = torch.einsum("htmd,htwd->htmw", g, vwin)
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("htmw,htwd->htmd", ds, kwin)
    dkwin = torch.einsum("htmw,htmd->htwd", ds, q)
    dvwin = torch.einsum("htmw,htmd->htwd", a, g)
    # slot w of frame t's window is row t + w of the left-padded keys
    dk_p = q.new_zeros((H, T + W - 1, dk))
    dv_p = q.new_zeros((H, T + W - 1, v.shape[-1]))
    for w in range(W):
        dk_p[:, w:w + T] += dkwin[:, :, w]
        dv_p[:, w:w + T] += dvwin[:, :, w]
    return dq, dk_p[:, W - 1:], dv_p[:, W - 1:]


def _check_head_major(q, k, v, g=None) -> None:
    """Raise unless the tensors have the head-major kernels' shapes, type and
    layout: the kernels read them where they lie."""
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"head-major attention takes q (H, T, M, d), k and v "
                         f"(H, T, d); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    H, T, M, d = q.shape
    if k.shape != (H, T, d) or v.shape != (H, T, d):
        raise ValueError(f"head-major attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}: the kernel "
                         f"takes k and v (H, T, d) with q's head width")
    if d not in (4, 8, 16, 32):
        raise ValueError(f"the CUDA kernel takes head widths 4, 8, 16, 32; got {d}")
    if M > 512:
        raise ValueError(f"the kernel takes at most 512 queries a frame; got {M}")
    named = [("q", q), ("k", k), ("v", v)] + ([] if g is None else [("g", g)])
    for name, t in named:
        cuda_build.check_operand(name, t, q.device, torch.float32)
    if g is not None and g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match q {tuple(q.shape)}")


_HM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_HM_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def sliding_window_attention_pallas(q, k, v, window: int) -> torch.Tensor:
    """Banded local attention in the head-major layout, no gradient. A CUDA
    tensor goes to the CUDA kernel, one launch that reads q, k, v where they
    lie (replacing med_tpu/ops/attention.py::_swa_kernel); a CPU tensor to
    :func:`sliding_window_attention_xla`; any other device raises."""
    if q.device.type == "cpu":
        return sliding_window_attention_xla(q, k, v, window)
    if not q.is_cuda:
        raise ValueError(f"no head-major attention for device {q.device}")
    _check_head_major(q, k, v)
    H, T, M, d = q.shape
    out = torch.empty_like(q)
    fn = cuda_build.kernel_function("swa_headmajor_fwd", "swa_headmajor_fwd",
                                    _HM_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), H, d, T,
              M, window, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_headmajor_fwd", "swa_headmajor_fwd", code)
    sliding_window_attention_pallas.launches += 1
    return out


sliding_window_attention_pallas.launches = 0


def sliding_window_attention_bwd_pallas(q, k, v, g, window: int):
    """Backward of :func:`sliding_window_attention_pallas` from q, k, v and
    the output cotangent g alone -> (dq, dk, dv), head-major. A CUDA tensor
    runs the CUDA kernel, one launch, which recomputes the banded softmax
    (replacing med_tpu/ops/attention.py::_swa_bwd_kernel); a CPU tensor
    :func:`sliding_window_attention_bwd_plain`; any other device raises."""
    if q.device.type == "cpu":
        return sliding_window_attention_bwd_plain(q, k, v, g, window)
    if not q.is_cuda:
        raise ValueError(f"no head-major attention backward for device {q.device}")
    _check_head_major(q, k, v, g)
    H, T, M, d = q.shape
    dq, dkk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = cuda_build.kernel_function("swa_headmajor_bwd", "swa_headmajor_bwd",
                                    _HM_BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              dq.data_ptr(), dkk.data_ptr(), dvv.data_ptr(), H, d, T, M, window,
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_headmajor_bwd", "swa_headmajor_bwd", code)
    sliding_window_attention_bwd_pallas.launches += 1
    return dq, dkk, dvv


sliding_window_attention_bwd_pallas.launches = 0


class _HeadMajorAttention(torch.autograd.Function):
    """Forward kernel K8 saving (q, k, v), backward kernel K9 (as med_tpu's
    _swa_pallas_ad)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return sliding_window_attention_pallas(q, k, v, window)

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = sliding_window_attention_bwd_pallas(
            *ctx.saved_tensors, g.contiguous(), ctx.window)
        return dq, dk, dv, None


def sliding_window_attention(q, k, v, window: int, use_pallas: bool = True):
    """The differentiable head-major op: with ``use_pallas`` the hand-written
    kernels, forward and backward (their plain versions for CPU tensors);
    without, the gather form under PyTorch's own autograd."""
    if use_pallas:
        return _HeadMajorAttention.apply(q, k, v, window)
    return sliding_window_attention_xla(q, k, v, window)
