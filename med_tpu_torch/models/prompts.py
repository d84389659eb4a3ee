"""Frozen prompt embeddings for COG (port of ``med_tpu.models.prompts``).

The reference encodes 15 gesture prompts (8 with only the gestures observed
in the dataset, 45 skill-conditioned ones, and the skill-reasoning module's
15 skill statements) with the CLIP ViT-B/32 text encoder and freezes them
(models_COG.py:392-445); the model only consumes them through a trainable
projection. Three sources, in ``med_tpu``'s priority order:

1. the CLIP text tower (:mod:`med_tpu_torch.models.clip_text`), when a CLIP
   checkpoint and its BPE merges file are given — the ``clip_ckpt`` /
   ``bpe_vocab`` arguments or the ``MED_TPU_CLIP_CKPT`` /
   ``MED_TPU_CLIP_BPE`` environment variables, the names ``med_tpu`` reads,
   so one setting applies to both packages;
2. a table file (``.npy``, ``.npz`` with an ``embeddings`` array, or a
   torch-saved tensor such as the reference's ``gest_prompt.pt``);
3. a deterministic surrogate table seeded by each text.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

GESTURES = (
    "reaching for needle with right hand",
    "positioning needle",
    "pushing needle through tissue",
    "transferring needle from left to right",
    "moving to center with needle in grip",
    "pulling suture with left hand",
    "pulling suture with right hand",
    "orienting needle",
    "using right hand to help tighten suture",
    "loosening more suture",
    "dropping suture at end and moving to end points",
    "reaching for needle with left hand",
    "making C loop around right hand",
    "reaching for suture with right hand",
    "pulling suture with both hands",
)

# The reduced gesture set (only gestures observed in the dataset,
# reference models_COG.py:392-403).
GESTURES_OBSERVED = (
    "reaching for needle with right hand",
    "positioning needle",
    "pushing needle through tissue",
    "transferring needle from left to right",
    "moving to center with needle in grip",
    "pulling suture with left hand",
    "orienting needle",
    "using right hand to help tighten suture",
)

SKILL_STATEMENTS = (
    "Surgeon frequently uses excessive force on the tissue",
    "Surgeon had careful tissue handling but occasionally caused inadvertent damage",
    "Surgeon consistently respects the tissue",
    "Surgeon is awkward and unsure with repeated entanglement and poor knot tying",
    "Surgeon placed majority of knots with appropriate tension",
    "Surgeon has excellent suture control",
    "Surgeon made unnecessary moves",
    "Surgeon had efficient time/motion but some unnecessary moves",
    "Surgeon has a clear economy of movement and maximum efficiency",
    "Surgeon frequently interrupts the flow",
    "Surgeon demonstrates some forward planning and reasonable procedure progression",
    "Surgeon has efficient transitions in procedure",
    "Surgeon overall performance is poor",
    "Surgeon overall performance is competent",
    "Surgeon overall performance is clearly superior",
)

SKILL_LEVEL_PROMPTS = ("novice", "intermediate", "expert")

EMBED_DIM = 512
_CLIP_TYPICAL_NORM = 9.0  # typical L2 norm of CLIP ViT-B/32 text embeddings


def _surrogate_table(texts, dim: int = EMBED_DIM) -> np.ndarray:
    """Deterministic per-text embedding: Gaussian seeded by the text's
    SHA-256, scaled to the typical CLIP embedding norm."""
    rows = []
    for t in texts:
        h = int(hashlib.sha256(t.encode()).hexdigest()[:8], 16)
        r = np.random.default_rng(h).standard_normal(dim)
        rows.append(r / np.linalg.norm(r) * _CLIP_TYPICAL_NORM)
    return np.stack(rows).astype(np.float32)


def encode_texts(clip_params: dict, token_ids, n_heads: int = 8) -> np.ndarray:
    """Encode pre-tokenized prompts with the CLIP text tower on the CPU (the
    tables are built once, at construction, on whatever machine):
    (B, L) int ids -> (B, 512) fp32 embeddings."""
    from .clip_text import encode_text, params_to

    ids = torch.as_tensor(np.asarray(token_ids))
    return encode_text(params_to(clip_params, "cpu"), ids, n_heads=n_heads).numpy()


def encode_prompt_strings(clip_ckpt: str, texts, bpe_vocab: str) -> np.ndarray:
    """Text -> embeddings (reference models_COG.py:408-445, at construction):
    BPE-tokenize, then run the text tower."""
    from .clip_text import load_clip_text_params
    from .clip_tokenizer import ClipTokenizer

    params = load_clip_text_params(clip_ckpt)
    tok = ClipTokenizer(bpe_vocab)
    # context length = the checkpoint's positional table (77 for ViT-B/32)
    ctx = int(params["positional_embedding"].shape[0])
    return encode_texts(params, tok.tokenize(list(texts), ctx))


def load_prompt_embeddings(path: Optional[str] = None, texts=GESTURES,
                           dim: int = EMBED_DIM, clip_ckpt: Optional[str] = None,
                           bpe_vocab: Optional[str] = None) -> np.ndarray:
    """Load prompt embeddings: CLIP tower > table file > surrogate (module
    docstring)."""
    clip_ckpt = clip_ckpt or os.environ.get("MED_TPU_CLIP_CKPT")
    bpe_vocab = bpe_vocab or os.environ.get("MED_TPU_CLIP_BPE")
    if (clip_ckpt and bpe_vocab and os.path.exists(clip_ckpt)
            and os.path.exists(bpe_vocab)):
        emb = encode_prompt_strings(clip_ckpt, texts, bpe_vocab)
        if emb.shape[1] != dim:
            raise ValueError(f"CLIP tower width {emb.shape[1]} != requested dim {dim}")
        return emb
    if path and os.path.exists(path):
        if path.endswith(".npy"):
            emb = np.load(path)
        elif path.endswith(".npz"):
            with np.load(path) as z:
                emb = z["embeddings"]
        else:
            emb = torch.load(path, map_location="cpu", weights_only=False)
            emb = np.asarray(emb.detach().numpy() if hasattr(emb, "detach") else emb)
        emb = emb.astype(np.float32)
        if emb.shape != (len(texts), dim):
            raise ValueError(
                f"prompt embedding shape {emb.shape} != {(len(texts), dim)}")
        return emb
    return _surrogate_table(texts, dim)
