"""TransSVNet: a transformer refining frozen TeCNo logits at frame level
(port of ``med_tpu.models.transsvnet``; reference ``Transformer``,
models_TCN.py:176-385).

Per frame t the encoder self-attends the zero-padded window of the last
len_q = 30 TeCNo class-logit vectors (one layer, 8 heads, d_k = d_v = f_maps),
then one decoder token, tanh(fc(the frame's long feature)), cross-attends the
encoded window. Every LayerNorm of the reference is made inside forward and
is never trained: all are affine-free here.

Over d = 2 features a LayerNorm's output is +-r(1, -1), r within
eps / (a - b)^2 ~ 1e-5 of 1: what it passes on lies in r's last five
digits, which float32 holds to ~1%. Its backward subtracts two numbers that
agree to ~1e-5, and the decoder's scores over a window of such rows differ
by ~1e-5. So the encoder's closing LN and everything after it (the encoder
FFN and the whole decoder: tiny tensors) run in float64, and the output
comes back in float32; in float32 two runs whose inputs differ by one
rounding part by ~1% in every gradient (both packages alike).

The model width is the class count (2), far below d_k, so each head's
projections collapse into (d, d) matrices (:meth:`MHA._mix`): scores =
x A_h y^T and out = sum_h P_h y M_h. The encoder runs packed, one trial at a
time: the windows' self-attention is the banded kernel K1 over the frames
(head width d = 2, m = W = len_q), its backward K3, and the FFN runs
feature-major, so no (T, H, 30, 30) score tensor exists.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.attention import layer_norm, sliding_window_attention_packed, sliding_windows
from .layers import Dense, ln0


class MHA(nn.Module):
    """Projections W_Q, W_K, W_V, fc (bias-free, the flax tree's names),
    scaled dot-product attention and the unlearned closing LN (reference
    MultiHeadAttention, models_TCN.py:196-232), in the collapsed form."""

    def __init__(self, d_model: int, d_k: int, d_v: int, n_heads: int):
        super().__init__()
        self.d_model, self.d_k, self.d_v, self.n_heads = d_model, d_k, d_v, n_heads
        self.W_Q = Dense(d_model, d_k * n_heads, bias=False)
        self.W_K = Dense(d_model, d_k * n_heads, bias=False)
        self.W_V = Dense(d_model, d_v * n_heads, bias=False)
        self.fc = Dense(n_heads * d_v, d_model, bias=False)

    def _mix(self):
        """A (H, d, d) = W_Qh W_Kh^T / sqrt(d_k) and M (H, d, d) = W_Vh fc_h."""
        H, dk, dv, d = self.n_heads, self.d_k, self.d_v, self.d_model
        wq = self.W_Q.weight.T.reshape(d, H, dk)
        wk = self.W_K.weight.T.reshape(d, H, dk)
        wv = self.W_V.weight.T.reshape(d, H, dv)
        fc = self.fc.weight.T.reshape(H, dv, d)
        A = torch.einsum("dhk,ehk->hde", wq, wk) / math.sqrt(dk)
        M = torch.einsum("ehv,hvm->hem", wv, fc)
        return A, M

    def forward(self, q_in, k_in, v_in):
        """q_in (B, Lq, d), k_in and v_in (B, Lk, d) -> (B, Lq, d), in the
        inputs' type."""
        A, M = (t.to(q_in.dtype) for t in self._mix())
        scores = torch.einsum("bld,hde,bme->bhlm", q_in, A, k_in)
        p = torch.softmax(scores, dim=-1)
        w = torch.einsum("bhlm,bme->bhle", p, v_in)
        return layer_norm(torch.einsum("bhle,hem->blm", w, M) + q_in)

    def self_window_packed(self, x, window: int):
        """``self(win, win, win)`` with ``win = sliding_windows(x, window)``,
        over a (T, d) sequence, through the banded kernel: query token
        n = t*window + i is position i of frame t's window, its keys the
        frames t-window+1 .. t (zero before 0, as the windows' zero pad).
        Returns the encoded windows feature-major, (d, T*window), in
        float64 (module docstring): the kernel and the projections before it
        run in ``x``'s type."""
        T, C = x.shape
        H = self.n_heads
        A, M = self._mix()
        # the kernel scales scores by 1/sqrt(its head width C); A already
        # carries the reference's 1/sqrt(d_k)
        A = A * math.sqrt(C)
        qa = torch.einsum("tc,hce->the", x, A).reshape(T, H * C)
        # each frame's window of (A-transformed queries, raw rows), windowed
        # together: row t + i of the left-padded sequence is position i
        xp = torch.cat([qa, x], dim=1)
        xp = torch.cat([xp.new_zeros((window - 1, xp.shape[1])), xp])
        packed = xp.unfold(0, window, 1).permute(1, 0, 2).reshape((H + 1) * C, T * window)
        qp = packed[:H * C].reshape(H, C, T * window)
        resid = packed[H * C:]
        # one key tensor for all heads, made contiguous for the kernel;
        # autograd sums its gradient over the heads
        kp = x.T[None].expand(H, C, T).contiguous()
        vp = torch.einsum("tc,hce->het", x, M).contiguous()
        ctx = sliding_window_attention_packed(qp, kp, vp, window, window)
        return ln0(ctx.sum(dim=0).double() + resid.double())


class PoswiseFFN(nn.Module):
    """Linear, relu, linear (bias-free; flax ``Dense_0``, ``Dense_1``) and
    the unlearned LN (reference models_TCN.py:235-251)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.Dense_0 = Dense(d_model, d_ff, bias=False)
        self.Dense_1 = Dense(d_ff, d_model, bias=False)

    def forward(self, x):
        """x (..., d) -> (..., d), in x's type."""
        w0, w1 = self.Dense_0.weight.to(x.dtype), self.Dense_1.weight.to(x.dtype)
        return layer_norm(torch.relu(x @ w0.T) @ w1.T + x)

    def packed(self, x):
        """x (d, N) feature-major -> (d, N), in x's type."""
        w0, w1 = self.Dense_0.weight.to(x.dtype), self.Dense_1.weight.to(x.dtype)
        return ln0(w1 @ torch.relu(w0 @ x) + x)


class TransSVNet(nn.Module):
    """One encoder layer ``enc_attn0``/``enc_ffn0``, decoder ``fc``,
    ``dec_attn``, ``dec_ffn``: the flax module's names (med_tpu's default
    n_enc_layers=1, the only one its configs build)."""

    def __init__(self, f_maps: int = 64, out_classes: int = 2, len_q: int = 30,
                 in_dim: int = 2048, n_heads: int = 8):
        super().__init__()
        self.len_q = len_q
        C = out_classes
        self.enc_attn0 = MHA(C, f_maps, f_maps, n_heads)
        self.enc_ffn0 = PoswiseFFN(C, f_maps)
        self.fc = Dense(in_dim, C, bias=False)
        self.dec_attn = MHA(C, f_maps, f_maps, n_heads)
        self.dec_ffn = PoswiseFFN(C, f_maps)

    def encode(self, x):
        """One trial's (T, C) logits -> its encoded windows (T, len_q, C) in
        float64, the windows' self-attention through the banded kernel."""
        T, C = x.shape
        encp = self.enc_attn0.self_window_packed(x, self.len_q)
        return self.enc_ffn0.packed(encp).T.reshape(T, self.len_q, C)

    def encode_windows(self, x):
        """:meth:`encode` as the reference computes it, each window's own
        attention (``MHA(win, win, win)``): the plain form tests hold the
        packed one against."""
        enc = sliding_windows(x, self.len_q).double()
        return self.enc_ffn0(self.enc_attn0(enc, enc, enc))

    def forward(self, tecno_logits, long_features):
        """One trial (B=1): tecno_logits (1, T, C), long_features (1, T,
        in_dim) -> (1, T, C)."""
        B, T, C = tecno_logits.shape
        if B != 1:
            raise ValueError("TransSVNet processes one trial at a time (B=1)")
        enc = self.encode(tecno_logits[0])
        q = torch.tanh(self.fc(long_features)).reshape(T, 1, C).to(enc.dtype)
        dec = self.dec_ffn(self.dec_attn(q, enc, enc))
        return dec.reshape(B, T, C).to(long_features.dtype)
