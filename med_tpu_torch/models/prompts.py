"""Frozen prompt embeddings for COG (port of the table part of
``med_tpu.models.prompts``).

The reference encodes 15 gesture prompts (8 with only the gestures observed
in the dataset, 45 skill-conditioned ones, and the skill-reasoning module's
15 skill statements) with the CLIP ViT-B/32 text encoder and freezes them
(models_COG.py:392-445); the model only consumes them through a trainable
projection. Two sources, in priority order: a table file (``.npy``,
``.npz`` with an ``embeddings`` array, or a torch-saved tensor such as the
reference's ``gest_prompt.pt``), else a deterministic surrogate table seeded
by each text. The CLIP text tower is not ported yet.
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


def load_prompt_embeddings(path: Optional[str] = None, texts=GESTURES,
                           dim: int = EMBED_DIM) -> np.ndarray:
    """Load prompt embeddings from a table file, else the surrogate table."""
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
