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
:func:`sliding_window_attention_packed_plain` on a CPU tensor. The kernel
makes one pass over each query's keys: a thread holds the scores of R query
slots of one frame for a chunk of 16 keys in registers (an online max and
sum across chunks), so each score is computed once. Where autograd
needs a gradient it runs through :class:`_PackedAttention`, whose backward
:func:`sliding_window_attention_packed_bwd` is the CUDA kernel
``csrc/swa_packed_bwd.cu`` on the card and
:func:`sliding_window_attention_packed_bwd_plain` on the CPU. That kernel is
one cooperative launch that computes each (query, key) pair once: it forms
delta = out.g itself, gathers dq per query from a shared band of ds, and
sums dk and dv per key from per-tile partials in a fixed order (a scratch
buffer the wrapper allocates, no atomics), so its runs give the same bits.
Its tiles take fewer frames, then fewer query slots, where shared memory
asks for it, and walk a window too large for any tile in chunks, so it
takes any window.

The packed op's sink instance takes what COG's windows do not: v narrower
than q and k, the keys before frame 0 left out of the softmax
(``exclude_start``) and a learnable logit a query slot in its denominator
(``sinks``), with the sinks' gradient. MiMo-V2-Flash's windowed layers run
it (8 KV heads, q and k of width 192, v of 128, 8 query heads a KV head as
the layout's m = 8 slots, a 128-frame window):
:func:`sliding_window_attention_sink` runs ``csrc/swa_sink_fwd.cu`` and
:func:`sliding_window_attention_sink_bwd` ``csrc/swa_sink_bwd.cu``, CUDA-core
products over a tile's band of 128 queries by 144 keys (the backward in two
launches: the tiles, then their dk, dv and sink partials summed in a fixed
order). Their plain versions are the packed plain functions with the two
options.

The head-major layout, q (H, T, M, dk), k (H, T, dk), v (H, T, dv) -> out
(H, T, M, dv), is the public op :func:`sliding_window_attention`:
:func:`sliding_window_attention_pallas` runs ``csrc/swa_headmajor_fwd.cu``,
the packed forward's one-pass design in this layout, and
:func:`sliding_window_attention_bwd_pallas` runs ``csrc/swa_headmajor_bwd.cu``,
one cooperative launch that recomputes the softmax from q, k and v and
computes each (query, key) pair's score and g.v once: per tile, lanes of a
query write them to shared bands, then threads (frame, window position)
sum dk and dv into per-tile partials that a scratch buffer holds until
they are summed in a fixed order (a window too large for a tile goes in
chunks, with a first walk for the softmax statistics). Both read their
operands 16 bytes at a time where every pointer is 16-byte aligned and 4
where one is not, and count their launches by instance in ``.instances``.
Their plain versions are :func:`sliding_window_attention_xla` and
:func:`sliding_window_attention_bwd_plain`. (The names are the JAX
package's, whose counterparts these are.)
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


def multi_head_attention(q, k, v):
    """Alias of :func:`attend` for (B, H, L, d) layouts."""
    return attend(q, k, v)


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


def _start_mask(T: int, window: int, device) -> torch.Tensor:
    """(T, window) True where slot w of frame t's window lies before frame 0
    (slot w is frame t - window + 1 + w)."""
    first = (torch.arange(T, device=device)[:, None]
             + torch.arange(window, device=device)[None, :])
    return first < window - 1


def sliding_window_attention_packed_plain(q, k, v, window: int, m: int,
                                          exclude_start: bool = False, sinks=None):
    """Plain PyTorch version of the kernels, packed layout -> (out, stats).

    Same arithmetic as the TPU kernel: q pre-scaled by 1/sqrt(dk), the
    banded max, exp, sum; out scaled by the reciprocal sum; stats row 0 the
    logsumexp, row 1 the reciprocal sum. ``exclude_start`` leaves the slots
    before frame 0 out of the softmax (without it they are zero keys, scored
    0); ``sinks`` (H, m), one logit a query slot, joins the max and adds
    exp(sink) to the sum (and to the logsumexp) and nothing to out."""
    H, dk, N = q.shape
    T = N // m
    q4 = (q * (1.0 / math.sqrt(dk))).permute(0, 2, 1).reshape(H, T, m, dk)
    kwin = torch.stack([sliding_windows(x, window) for x in k.transpose(1, 2)])
    vwin = torch.stack([sliding_windows(x, window) for x in v.transpose(1, 2)])
    scores = torch.einsum("htmd,htwd->htmw", q4, kwin)
    if exclude_start:
        scores = scores.masked_fill(_start_mask(T, window, q.device)[None, :, None, :],
                                    float("-inf"))
    smax = scores.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sink = sinks.reshape(H, 1, m, 1).to(scores.dtype)
        smax = torch.maximum(smax, sink)
    p = torch.exp(scores - smax)
    psum = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        psum = psum + torch.exp(sink - smax)
    rsum = 1.0 / psum
    out = torch.einsum("htmw,htwd->htmd", p, vwin) * rsum        # (H, T, m, dv)
    lse = smax + torch.log(psum)
    stats = torch.cat([lse, rsum], dim=-1)                         # (H, T, m, 2)
    return (out.reshape(H, N, -1).permute(0, 2, 1),
            stats.reshape(H, N, 2).permute(0, 2, 1))


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# K1 and K3 have an instance for each of these; 2 is TransSVNet's (its model
# width is the class count)
PACKED_HEAD_WIDTHS = (2, 4, 8, 16, 32)


def _packed_fwd_cuda(q, k, v, window: int, m: int):
    H, dk, N = q.shape
    T = k.shape[2]
    if N != T * m or k.shape != (H, dk, T) or v.shape != (H, dk, T):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} with m={m}: "
                         f"the kernel takes q (H, d, T*m), k and v (H, d, T)")
    if dk not in PACKED_HEAD_WIDTHS:
        raise ValueError(f"the CUDA kernel takes head widths 2, 4, 8, 16, 32; got {dk}")
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
                                    return_stats: bool = False,
                                    exclude_start: bool = False, sinks=None):
    """Banded local attention in the packed layout (module docstring).

    A CUDA tensor goes to the CUDA kernel, one launch (replacing
    med_tpu/ops/attention.py::_swa_packed_fwd_kernel), and a CPU tensor to
    the plain version; any other device raises. ``return_stats`` also
    returns the (H, 2, N) per-query (logsumexp, 1/sum). When autograd needs
    a gradient of q, k or v, the call saves what the backward reads; under
    ``no_grad`` it saves nothing.

    ``exclude_start`` leaves the keys before frame 0 out of the softmax
    (COG's windows score them as zero keys); ``sinks`` (H, m) gives each
    query slot a learnable logit in its softmax's denominator; v may be
    narrower than q and k. Any of these takes the sink instance
    (:func:`sliding_window_attention_sink`, ``csrc/swa_sink_{fwd,bwd}.cu``),
    whose backward also gives the sinks' gradient."""
    if exclude_start or sinks is not None or v.shape[1] != q.shape[1]:
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, sinks))
        if not return_stats and grad:
            return _SinkAttention.apply(q, k, v, sinks, window, m, exclude_start)
        out, stats = sliding_window_attention_sink(q, k, v, sinks, window, m, exclude_start)
        return (out, stats) if return_stats else out
    if (not return_stats and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _PackedAttention.apply(q, k, v, window, m)
    out, stats = _packed_fwd(q, k, v, window, m)
    return (out, stats) if return_stats else out


sliding_window_attention_packed.launches = 0


def sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats,
                                              window: int, m: int,
                                              exclude_start: bool = False, sinks=None):
    """Plain PyTorch version of the backward kernels -> (dq, dk, dv), same
    shapes as (q, k, v), and with ``sinks`` their (H, m) gradient as a
    fourth. The arithmetic of the TPU kernel: q pre-scaled by 1/sqrt(dk),
    a = exp(scores - lse) from the saved stats, delta = out.g (the
    flash-attention identity), ds = a * (g.v - delta); the keys' gradients
    scatter back from the windows, and the zero halo's drop. With
    ``exclude_start`` the slots before frame 0 take no share; a sink's
    gradient is -sum over its slot's queries of exp(sink - lse) * delta (its
    value is zero)."""
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
    if exclude_start:
        a = a.masked_fill(_start_mask(T, W, q.device)[None, :, None, :], 0.0)
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
    grads = (dq.reshape(H, N, dk).permute(0, 2, 1),
             dk_p[:, W - 1:].transpose(1, 2), dv_p[:, W - 1:].transpose(1, 2))
    if sinks is None:
        return grads
    p_sink = torch.exp(sinks.reshape(H, 1, m).to(lse.dtype) - lse[..., 0])
    return grads + (-(p_sink * delta[..., 0]).sum(dim=1),)


_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _packed_bwd_cuda(q, k, v, g, out, stats, window: int, m: int):
    H, dk, N = q.shape
    T = k.shape[2]
    if N != T * m or k.shape != (H, dk, T) or v.shape != (H, dk, T):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} with m={m}: "
                         f"the kernel takes q (H, d, T*m), k and v (H, d, T)")
    if dk not in PACKED_HEAD_WIDTHS:
        raise ValueError(f"the CUDA kernel takes head widths 2, 4, 8, 16, 32; got {dk}")
    if m > 512:
        raise ValueError(f"the backward kernel takes at most 512 queries a frame; got {m}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g), ("out", out),
                    ("stats", stats)):
        cuda_build.check_operand(name, t, q.device, torch.float32)
    if g.shape != q.shape or out.shape != q.shape or stats.shape != (H, 2, N):
        raise ValueError(f"g {tuple(g.shape)}, out {tuple(out.shape)} and stats "
                         f"{tuple(stats.shape)} do not match q {tuple(q.shape)}")
    # the kernel's per-tile dk/dv partials: their size follows from the shapes
    floats = ctypes.c_longlong(0)
    plan = cuda_build.kernel_function("swa_packed_bwd", "swa_packed_bwd_scratch",
                                      _SCRATCH_ARGTYPES)
    if plan(H, dk, T, m, window, ctypes.addressof(floats)) != 0:
        raise ValueError(f"the backward kernel takes window >= 1 and fewer than "
                         f"2**31 queries in all (H*T*m); got window={window}, "
                         f"H={H}, T={T}, m={m}")
    scratch = torch.empty(floats.value, dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dkk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    fn = cuda_build.kernel_function("swa_packed_bwd", "swa_packed_bwd", _BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
              stats.data_ptr(), dq.data_ptr(), dkk.data_ptr(), dvv.data_ptr(),
              scratch.data_ptr(), H, dk, T, m, window,
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_packed_bwd", "swa_packed_bwd", code)
    sliding_window_attention_packed_bwd.launches += 1
    return dq, dkk, dvv


def sliding_window_attention_packed_bwd(q, k, v, g, out, stats, window: int,
                                        m: int):
    """Backward of :func:`sliding_window_attention_packed` from the
    forward's ``out`` and (H, 2, N) ``stats`` and the output cotangent g ->
    (dq (H, dk, N), dk (H, dk, T), dv (H, dv, T)). A CUDA tensor runs the
    CUDA kernel, one cooperative launch that also forms delta = out.g
    (replacing med_tpu/ops/attention.py::_swa_packed_bwd_kernel and the
    delta pass before it); a CPU tensor the plain version; any other device
    raises."""
    if q.is_cuda:
        return _packed_bwd_cuda(q, k, v, g, out, stats, window, m)
    if q.device.type == "cpu":
        return sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats,
                                                         window, m)
    raise ValueError(f"no packed attention backward for device {q.device}")


sliding_window_attention_packed_bwd.launches = 0


# --- the sink instance: wide heads, a start mask, sinks -------------------

# (dk, dv, m, window) of the sink instance's kernels: MiMo-V2-Flash's
# windowed layers (64 query heads of width 192 over 8 KV heads, values of
# width 128, a 128-frame window)
SINK_INSTANCES = ((192, 128, 8, 128),)
_SINK_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SINK_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SINK_SCRATCH_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_sink(q, k, v, sinks, window: int, m: int, more=()) -> None:
    """Raise unless the operands have a sink instance's shapes, type and
    layout: the kernels read them where they lie."""
    H, dk, N = q.shape
    T = k.shape[2]
    dv = v.shape[1]
    if N != T * m or k.shape != (H, dk, T) or v.shape != (H, dv, T):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} with m={m}: the kernel takes q (H, dk, T*m), "
                         f"k (H, dk, T) and v (H, dv, T)")
    if (dk, dv, m, window) not in SINK_INSTANCES:
        raise ValueError(f"the sink instance's CUDA kernels take (dk, dv, m, window) in "
                         f"{SINK_INSTANCES}; got {(dk, dv, m, window)}")
    if sinks is not None and tuple(sinks.shape) != (H, m):
        raise ValueError(f"sinks {tuple(sinks.shape)} must be (H, m) = {(H, m)}")
    named = [("q", q), ("k", k), ("v", v)] + list(more)
    if sinks is not None:
        named.append(("sinks", sinks))
    for name, t in named:
        cuda_build.check_operand(name, t, q.device, torch.float32)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def sliding_window_attention_sink(q, k, v, sinks, window: int, m: int,
                                  exclude_start: bool = True):
    """The sink instance's forward, no gradient -> (out (H, dv, N), stats
    (H, 2, N)): q (H, dk, T*m), k (H, dk, T), v (H, dv, T), ``sinks`` (H, m)
    or None. A CUDA tensor runs ``csrc/swa_sink_fwd.cu``, one launch; a CPU
    tensor :func:`sliding_window_attention_packed_plain`; any other device
    raises."""
    if q.device.type == "cpu":
        return sliding_window_attention_packed_plain(q, k, v, window, m, exclude_start, sinks)
    if not q.is_cuda:
        raise ValueError(f"no packed attention for device {q.device}")
    _check_sink(q, k, v, sinks, window, m)
    H, dk, N = q.shape
    T, dv = k.shape[2], v.shape[1]
    out = torch.empty((H, dv, N), dtype=torch.float32, device=q.device)
    stats = torch.empty((H, 2, N), dtype=torch.float32, device=q.device)
    fn = cuda_build.kernel_function("swa_sink_fwd", "swa_sink_fwd", _SINK_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(sinks), out.data_ptr(),
              stats.data_ptr(), H, dk, dv, T, m, window, int(exclude_start),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_sink_fwd", "swa_sink_fwd", code)
    sliding_window_attention_sink.launches += 1
    return out, stats


sliding_window_attention_sink.launches = 0


def sliding_window_attention_sink_bwd(q, k, v, g, out, stats, sinks, window: int,
                                      m: int, exclude_start: bool = True):
    """Backward of :func:`sliding_window_attention_sink` -> (dq, dk, dv,
    dsinks), dsinks None without sinks. A CUDA tensor runs
    ``csrc/swa_sink_bwd.cu``: two launches, the tiles' products with their
    dk/dv and sink partials in a scratch buffer allocated here, then their
    sums in a fixed order (the same bits every run); a CPU tensor
    :func:`sliding_window_attention_packed_bwd_plain`; any other device
    raises."""
    if q.device.type == "cpu":
        grads = sliding_window_attention_packed_bwd_plain(q, k, v, g, out, stats, window, m,
                                                          exclude_start, sinks)
        return grads if sinks is not None else grads + (None,)
    if not q.is_cuda:
        raise ValueError(f"no packed attention backward for device {q.device}")
    _check_sink(q, k, v, sinks, window, m, (("g", g), ("out", out), ("stats", stats)))
    H, dk, N = q.shape
    T, dv = k.shape[2], v.shape[1]
    if g.shape != out.shape or out.shape != (H, dv, N) or stats.shape != (H, 2, N):
        raise ValueError(f"g {tuple(g.shape)}, out {tuple(out.shape)} and stats "
                         f"{tuple(stats.shape)} do not match q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    floats = ctypes.c_longlong(0)
    plan = cuda_build.kernel_function("swa_sink_bwd", "swa_sink_bwd_scratch",
                                      _SINK_SCRATCH_ARGTYPES)
    if plan(H, dk, dv, T, m, window, ctypes.addressof(floats)) != 0:
        raise ValueError(f"no sink instance for H={H}, T={T}, {(dk, dv, m, window)}")
    scratch = torch.empty(floats.value, dtype=torch.float32, device=q.device)
    dq, dkk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsinks = None if sinks is None else torch.empty_like(sinks)
    fn = cuda_build.kernel_function("swa_sink_bwd", "swa_sink_bwd", _SINK_BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
              stats.data_ptr(), _ptr(sinks), dq.data_ptr(), dkk.data_ptr(), dvv.data_ptr(),
              _ptr(dsinks), scratch.data_ptr(), H, dk, dv, T, m, window, int(exclude_start),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_sink_bwd", "swa_sink_bwd", code)
    sliding_window_attention_sink_bwd.launches += 2
    return dq, dkk, dvv, dsinks


sliding_window_attention_sink_bwd.launches = 0


class _SinkAttention(torch.autograd.Function):
    """The sink instance's forward saving (q, k, v, sinks, out, stats), its
    backward giving the sinks' gradient too."""

    @staticmethod
    def forward(ctx, q, k, v, sinks, window: int, m: int, exclude_start: bool):
        out, stats = sliding_window_attention_sink(q, k, v, sinks, window, m, exclude_start)
        ctx.save_for_backward(q, k, v, sinks, out, stats)
        ctx.window, ctx.m, ctx.exclude_start = window, m, exclude_start
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, sinks, out, stats = ctx.saved_tensors
        dq, dk, dv, dsinks = sliding_window_attention_sink_bwd(
            q, k, v, g.contiguous(), out, stats, sinks, ctx.window, ctx.m, ctx.exclude_start)
        return dq, dk, dv, dsinks, None, None, None


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


_HM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
_HM_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
# the head-major kernels' instances, by the code their C entries report: 16-byte
# copies and loads where every pointer is 16-byte aligned, 4-byte ones where not
HEAD_MAJOR_INSTANCES = ("16-byte", "4-byte")


def _count_instance(counter, code: int) -> None:
    counter.launches += 1
    name = HEAD_MAJOR_INSTANCES[code]
    counter.instances[name] = counter.instances.get(name, 0) + 1


def sliding_window_attention_pallas(q, k, v, window: int) -> torch.Tensor:
    """Banded local attention in the head-major layout, no gradient. A CUDA
    tensor goes to the CUDA kernel, one launch that reads q, k, v where they
    lie, 16 bytes at a time where they are 16-byte aligned and 4 where not
    (counted by instance in ``.instances``; replacing
    med_tpu/ops/attention.py::_swa_kernel); a CPU tensor to
    :func:`sliding_window_attention_xla`; any other device raises."""
    if q.device.type == "cpu":
        return sliding_window_attention_xla(q, k, v, window)
    if not q.is_cuda:
        raise ValueError(f"no head-major attention for device {q.device}")
    _check_head_major(q, k, v)
    H, T, M, d = q.shape
    out = torch.empty_like(q)
    taken = ctypes.c_int(-1)
    fn = cuda_build.kernel_function("swa_headmajor_fwd", "swa_headmajor_fwd",
                                    _HM_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), H, d, T,
              M, window, ctypes.byref(taken),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_headmajor_fwd", "swa_headmajor_fwd", code)
    _count_instance(sliding_window_attention_pallas, taken.value)
    return out


sliding_window_attention_pallas.launches = 0
sliding_window_attention_pallas.instances = {}   # launches by instance; read as a difference


def sliding_window_attention_bwd_pallas(q, k, v, g, window: int):
    """Backward of :func:`sliding_window_attention_pallas` from q, k, v and
    the output cotangent g alone -> (dq, dk, dv), head-major. A CUDA tensor
    runs the CUDA kernel, one cooperative launch that recomputes the banded
    softmax and sums dk and dv from per-tile partials in a scratch buffer
    allocated here (replacing med_tpu/ops/attention.py::_swa_bwd_kernel;
    instances as the forward's); a CPU tensor
    :func:`sliding_window_attention_bwd_plain`; any other device raises."""
    if q.device.type == "cpu":
        return sliding_window_attention_bwd_plain(q, k, v, g, window)
    if not q.is_cuda:
        raise ValueError(f"no head-major attention backward for device {q.device}")
    _check_head_major(q, k, v, g)
    H, T, M, d = q.shape
    # the kernel's per-tile dk/dv partials: their size follows from the shapes
    floats = ctypes.c_longlong(0)
    plan = cuda_build.kernel_function("swa_headmajor_bwd", "swa_headmajor_bwd_scratch",
                                      _SCRATCH_ARGTYPES)
    if plan(H, d, T, M, window, ctypes.addressof(floats)) != 0:
        raise ValueError(f"the backward kernel takes window >= 1 and fewer than "
                         f"2**31 queries in all (H*T*M); got window={window}, "
                         f"H={H}, T={T}, M={M}")
    scratch = torch.empty(floats.value, dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dkk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    taken = ctypes.c_int(-1)
    fn = cuda_build.kernel_function("swa_headmajor_bwd", "swa_headmajor_bwd",
                                    _HM_BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              dq.data_ptr(), dkk.data_ptr(), dvv.data_ptr(), scratch.data_ptr(), H, d,
              T, M, window, ctypes.byref(taken),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("swa_headmajor_bwd", "swa_headmajor_bwd", code)
    _count_instance(sliding_window_attention_bwd_pallas, taken.value)
    return dq, dkk, dvv


sliding_window_attention_bwd_pallas.launches = 0
sliding_window_attention_bwd_pallas.instances = {}


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
