"""CLIP ViT-B/32 text encoder (port of ``med_tpu.models.clip_text``): plain
functions on tensors over the same numpy parameter tree, and the importer of
the official state_dict.

The reference encodes prompt *strings* with ``clip.load('ViT-B/32')`` at COG
construction (models_COG.py:408-445), including runtime-built
skill-conditioned prompts (models_COG.py:404-406). Given the official CLIP
checkpoint, :func:`encode_text` reproduces its text tower.

Architecture (github.com/openai/CLIP model.py, text branch only):
- token embedding (vocab 49408, width 512) + learned positional embedding
  (context length 77);
- 12 pre-LN residual attention blocks, width 512, 8 heads, CAUSAL mask,
  MLP 512->2048->512 with QuickGELU ``x * sigmoid(1.702 x)``;
- final LayerNorm (biased variance, eps 1e-5), then the embedding is read
  at each sequence's end-of-text position (argmax of token ids — EOT is the
  largest id) and projected by the bias-free ``text_projection``.

Attention at L = 77 is a plain einsum and softmax, as in ``med_tpu``: there
is no Pallas kernel on this path, and prompt encoding is a one-off step at
construction. fp32 throughout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

N_HEADS_VIT_B32 = 8


def _np(t) -> np.ndarray:
    """A state-dict entry (tensor or array) as a float32 numpy array."""
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float32)


def import_clip_text(sd: Dict[str, Any]) -> dict:
    """Map a CLIP state_dict (the full model's or a text-only subset) onto
    the numpy tree :func:`encode_text` consumes (``med_tpu``'s tree).

    Accepted key layout is the official one: ``token_embedding.weight``,
    ``positional_embedding``, ``transformer.resblocks.{i}.{ln_1,attn,ln_2,
    mlp}...``, ``ln_final.*``, ``text_projection``. Linear weights
    transpose (O, I) -> (I, O); the fused ``attn.in_proj_weight`` splits
    into q/k/v."""
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks.")
    )
    blocks = []
    for i in range(n_layers):
        p = f"transformer.resblocks.{i}"
        w_in = _np(sd[f"{p}.attn.in_proj_weight"])
        b_in = _np(sd[f"{p}.attn.in_proj_bias"])
        d = w_in.shape[1]
        blocks.append({
            "ln_1": {"scale": _np(sd[f"{p}.ln_1.weight"]),
                     "bias": _np(sd[f"{p}.ln_1.bias"])},
            # torch in_proj rows are [q; k; v] blocks of (d, d) each
            "wq": w_in[:d].T, "wk": w_in[d:2 * d].T, "wv": w_in[2 * d:].T,
            "bq": b_in[:d], "bk": b_in[d:2 * d], "bv": b_in[2 * d:],
            "wo": _np(sd[f"{p}.attn.out_proj.weight"]).T,
            "bo": _np(sd[f"{p}.attn.out_proj.bias"]),
            "ln_2": {"scale": _np(sd[f"{p}.ln_2.weight"]),
                     "bias": _np(sd[f"{p}.ln_2.bias"])},
            "w_fc": _np(sd[f"{p}.mlp.c_fc.weight"]).T,
            "b_fc": _np(sd[f"{p}.mlp.c_fc.bias"]),
            "w_proj": _np(sd[f"{p}.mlp.c_proj.weight"]).T,
            "b_proj": _np(sd[f"{p}.mlp.c_proj.bias"]),
        })
    return {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "blocks": blocks,
        "ln_final": {"scale": _np(sd["ln_final.weight"]),
                     "bias": _np(sd["ln_final.bias"])},
        "text_projection": _np(sd["text_projection"]),
    }


def load_clip_text_params(path: str) -> dict:
    """Load the text-tower params from a checkpoint file: a torch
    state_dict or jit archive ``.pt`` (the official distribution) or an
    ``.npz`` with the same key names."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return import_clip_text({k: z[k] for k in z.files})
    # torch.load hands a TorchScript archive (the official ViT-B-32.pt) to
    # torch.jit.load, whose module gives its state_dict
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_clip_text(sd)


def _layer_norm(x, p, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def _quick_gelu(x):
    """CLIP's QuickGELU (model.py): x * sigmoid(1.702 x) — NOT exact GELU."""
    return x * torch.sigmoid(1.702 * x)


def _block(x, p, n_heads: int):
    """Pre-LN residual attention block with the causal mask."""
    B, L, D = x.shape
    h = _layer_norm(x, p["ln_1"])
    q = (h @ p["wq"] + p["bq"]).reshape(B, L, n_heads, D // n_heads)
    k = (h @ p["wk"] + p["bk"]).reshape(B, L, n_heads, D // n_heads)
    v = (h @ p["wv"] + p["bv"]).reshape(B, L, n_heads, D // n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D // n_heads)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, D)
    x = x + ctx @ p["wo"] + p["bo"]
    h = _layer_norm(x, p["ln_2"])
    return x + _quick_gelu(h @ p["w_fc"] + p["b_fc"]) @ p["w_proj"] + p["b_proj"]


def params_to(params, device) -> dict:
    """The numpy tree of :func:`import_clip_text` as fp32 tensors on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return torch.as_tensor(np.asarray(params, np.float32), device=device)


@torch.no_grad()
def encode_text(params: dict, token_ids: torch.Tensor,
                n_heads: int = N_HEADS_VIT_B32) -> torch.Tensor:
    """(B, L) int token ids -> (B, embed_dim) text embeddings, on the ids'
    device (``params``: :func:`params_to` of the tree, on that device).

    Reproduces CLIP.encode_text (openai/CLIP model.py:343-358): embeddings
    read at the EOT position (argmax of ids — EOT is the largest id in
    every CLIP tokenization), then the bias-free text projection. L may be
    any length <= the positional table (the reference always uses 77)."""
    tok = token_ids.long()
    x = params["token_embedding"][tok]
    x = x + params["positional_embedding"][: tok.shape[1]]
    for blk in params["blocks"]:
        x = _block(x, blk, n_heads)
    x = _layer_norm(x, params["ln_final"])
    eot = torch.argmax(tok, dim=-1)
    pooled = x[torch.arange(tok.shape[0], device=tok.device), eot]
    return pooled @ params["text_projection"]
