"""Checkpoint I/O in the JAX package's layout (port of the ``.npz`` part of
``med_tpu.train.checkpoint``): the param / batch-stat / constant trees
flattened into one ``.npz`` with '/'-joined key paths, plus an optional JSON
manifest. The two packages read each other's files, and both import the
reference's torch ``.pt`` checkpoints (:mod:`..utils.torch_port`). The
mid-training snapshot for ``--resume`` is the port's own."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


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


def load_checkpoint(path: str, model_name: Optional[str] = None) -> Dict[str, Any]:
    """Load a checkpoint tree. A reference torch ``best_model_*.pt`` blob
    (modeling_utils.py:3028-3040) is imported through
    :mod:`med_tpu_torch.utils.torch_port`; ``model_name`` is required then,
    so that the state_dict's key layout can be mapped."""
    if path.endswith(".pt"):
        if model_name is None:
            raise ValueError(
                "model_name is required to import a reference .pt checkpoint")
        from ..utils.torch_port import import_reference_checkpoint

        return import_reference_checkpoint(path, model_name)
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


def load_best_checkpoint(ckpt_dir: str, setting: str, out: str,
                         model_name: Optional[str] = None) -> Dict[str, Any]:
    """Load ``best_model_{setting}_{out}`` from a run's checkpoint dir: the
    ``.npz`` when there is one, else a reference torch ``.pt`` blob with the
    same stem (the reference's save naming, modeling_utils.py:3028-3040)."""
    base = os.path.join(ckpt_dir, f"best_model_{setting}_{out}")
    if os.path.exists(base + ".npz"):
        return load_checkpoint(base + ".npz")
    if os.path.exists(base + ".pt"):
        return load_checkpoint(base + ".pt", model_name=model_name)
    raise FileNotFoundError(base + ".{npz,pt}")


# ----------------------------------------------------------------- resume
def save_train_state(path: str, exp, epoch: int) -> None:
    """Full mid-training snapshot of an :class:`Experiment` after ``epoch``,
    for exact resume: every entry of the net's state_dict (a window model's
    BatchNorm running statistics too), Adam's step and
    both moments per parameter (dead parameters too: they take weight decay
    every step), the dropout generator's state and the epoch.

    The file is the port's own ``.npz`` ("param/<key>", "adam/<i>/step",
    "adam/<i>/exp_avg", "adam/<i>/exp_avg_sq", "generator", "epoch"). It is
    not interchangeable with ``med_tpu``'s ``leaf_i`` snapshot, which lists
    the leaves of the flax ``TrainState`` (optax state and a JAX key).

    A tensor-parallel experiment writes its whole state: every rank of the
    ``model`` axis must call this (a gather), and rank 0 alone writes."""
    from ..parallel.launch import is_main
    from ..parallel.mesh import full_view

    with full_view(exp):
        arrays = {f"param/{k}": v.detach().cpu().numpy()
                  for k, v in exp.net.state_dict().items()}
        for i, p in enumerate(exp.optimizer.param_groups[0]["params"]):
            state = exp.optimizer.state[p]
            for name in ("step", "exp_avg", "exp_avg_sq"):
                arrays[f"adam/{i}/{name}"] = torch.as_tensor(state[name]).cpu().numpy()
    arrays["generator"] = exp.generator.get_state().numpy()
    arrays["generator_device"] = np.asarray(exp.generator.device.type)
    arrays["epoch"] = np.asarray(epoch)
    if is_main():
        np.savez(path, **arrays)


def load_train_state(path: str, exp) -> int:
    """Restore a snapshot of :func:`save_train_state` into ``exp`` (built
    from the same config, on the same kind of device: a generator's state
    does not move between the CPU and CUDA). A tensor-parallel experiment
    takes it whole and is placed on its mesh again. Returns the next
    epoch."""
    from ..parallel.mesh import shard_state, unshard_state

    mesh = getattr(exp, "mesh", None)
    unshard_state(exp)
    epoch = _load_train_state(path, exp)
    if mesh is not None:
        shard_state(exp, mesh)
    return epoch


def _load_train_state(path: str, exp) -> int:
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        saved = {k: z[k] for k in z.files}
    device_type = str(saved["generator_device"])
    if device_type != exp.generator.device.type:
        raise ValueError(f"the snapshot's dropout generator lived on "
                         f"{device_type}; this experiment runs on "
                         f"{exp.generator.device.type}")
    exp.net.load_state_dict({k[len("param/"):]: torch.as_tensor(v)
                             for k, v in saved.items() if k.startswith("param/")})
    n_params = len(exp.optimizer.param_groups[0]["params"])
    state = {i: {name: torch.as_tensor(saved[f"adam/{i}/{name}"])
                 for name in ("step", "exp_avg", "exp_avg_sq")}
             for i in range(n_params)}
    exp.optimizer.load_state_dict(
        {"state": state, "param_groups": exp.optimizer.state_dict()["param_groups"]})
    exp.generator.set_state(torch.as_tensor(saved["generator"]))
    return int(saved["epoch"]) + 1
