"""Checkpoint I/O in the JAX package's layout (port of the ``.npz`` part of
``med_tpu.train.checkpoint``): the param / batch-stat / constant trees
flattened into one ``.npz`` with '/'-joined key paths, plus an optional JSON
manifest. The two packages read each other's files. Importing the
reference's torch ``.pt`` checkpoints is not ported yet."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {'a/b/c': leaf}; empty dicts are dropped."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_checkpoint(
    path: str,
    params: Any,
    batch_stats: Any = None,
    constants: Any = None,
    meta: Optional[Dict] = None,
) -> None:
    tree: Dict[str, Any] = {"params": params}
    if batch_stats:
        tree["batch_stats"] = batch_stats
    if constants:
        tree["constants"] = constants
    flat = flatten_tree(tree)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=1)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a ``.npz`` checkpoint tree."""
    if path.endswith(".pt"):
        raise NotImplementedError(
            "importing reference .pt checkpoints is not ported yet "
            "(ROADMAP.md Queue A4)")
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_tree(flat)


def load_checkpoint_meta(path: str) -> Optional[Dict[str, Any]]:
    """The JSON meta that :func:`save_checkpoint` wrote beside ``path``
    (``<path>.json``, or ``<path>.npz.json`` when ``path`` was given without
    its extension), or None when there is none."""
    for meta_path in (path + ".json", path + ".npz.json"):
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
    return None


def load_best_checkpoint(ckpt_dir: str, setting: str, out: str) -> Dict[str, Any]:
    """Load ``best_model_{setting}_{out}.npz`` from a run's checkpoint dir."""
    base = os.path.join(ckpt_dir, f"best_model_{setting}_{out}")
    if os.path.exists(base + ".npz"):
        return load_checkpoint(base + ".npz")
    if os.path.exists(base + ".pt"):
        return load_checkpoint(base + ".pt")
    raise FileNotFoundError(base + ".{npz,pt}")
