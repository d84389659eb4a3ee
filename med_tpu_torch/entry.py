"""The port's entry dry run: ``dryrun_multichip(n)`` drives the multi-rank
layouts once each on ``n`` spawned ranks, as ``med_tpu``'s
``__graft_entry__.py::dryrun_multichip`` does on an ``n``-device mesh:

- the data- and tensor-parallel window step (SimpleCNN, multimodal, the
  FeatureExtractor split over ``model``) and its eval step;
- a checkpoint round trip of the sharded state: snapshot, restore into a
  fresh experiment, place it on the mesh again, one more step;
- fold-parallel training and eval (the folds over ``data``);
- a trial-parallel COG step (the trial group over ``data``).

The ranks run on CUDA unless the caller passes ``device="cpu"`` (then over
gloo); without a GPU a CUDA run raises. On CUDA each rank owns a GPU under
NCCL; ``backend="gloo"`` lets the ranks share one card (a correctness
check, not a measurement)::

    python -m med_tpu_torch.entry 4          # 4 GPUs, NCCL
    python -m med_tpu_torch.entry 4 cpu      # 4 ranks on the CPU, gloo
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch


def _window_batch(rng, cfg, B: int) -> Dict[str, np.ndarray]:
    return {"images": rng.normal(size=(B, cfg.window_size, 2048)).astype(np.float32),
            "kinematics": rng.normal(size=(B, cfg.window_size, 26)).astype(np.float32),
            "labels": rng.integers(0, 2, B), "mask": np.ones(B, np.float32)}


def _rank(device: str, snapshot_dir: str) -> Dict[str, object]:
    """One rank's dry run on ``device`` (the rank's own: see
    ``launch.rank_device``)."""
    from .config import ExperimentConfig
    from .parallel import launch
    from .parallel.folds import FoldParallel
    from .parallel.mesh import full_view, make_mesh, shard_state
    from .train.checkpoint import load_train_state, save_train_state
    from .train.engine import Experiment

    n = launch.world_size()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    out: Dict[str, object] = {"mesh": dict(mesh.shape)}
    rng = np.random.default_rng(0)

    # data + tensor parallel window step and eval step
    cfg = ExperimentConfig(model_name="SimpleCNN", data_type="multimodal")
    exp = Experiment(cfg, device=dev)
    exp.init_weights(0)
    shard_state(exp, mesh)
    B = max(8, n * 2)
    batch = _window_batch(rng, cfg, B)
    loss = float(exp.train_step(batch)["loss"])
    eval_loss = float(exp.eval_step(batch)["loss"])
    if not (np.isfinite(loss) and np.isfinite(eval_loss)):
        raise RuntimeError(f"non-finite window losses {loss}, {eval_loss}")
    out.update(train_loss=loss, eval_loss=eval_loss, tp=sorted(exp.tp))

    # sharded-state snapshot: save (gathered; rank 0 writes), restore into a
    # fresh experiment, place it again, step
    path = os.path.join(snapshot_dir, "state.npz")
    save_train_state(path, exp, epoch=0)
    launch.barrier()
    template = Experiment(cfg, device=dev)
    template.init_weights(3)
    next_epoch = load_train_state(path, template)
    with full_view(exp):
        for (k, a), b in zip(exp.net.state_dict().items(), template.net.state_dict().values()):
            if not torch.equal(a, b):
                raise RuntimeError(f"restored {k} differs from the saved state")
    shard_state(template, mesh)
    resumed = float(template.train_step(batch)["loss"])
    if not np.isfinite(resumed) or next_epoch != 1:
        raise RuntimeError(f"resume: loss {resumed}, next epoch {next_epoch}")
    out["resumed_loss"] = resumed

    # fold parallelism: this rank's folds of F, the fold axis over 'data'
    n_data = mesh.shape["data"]
    F = max(2, n_data)
    per = F // n_data
    fp = FoldParallel(Experiment(cfg, device=dev))
    state = fp.init_states([10 + mesh.coord("data") * per + i for i in range(per)])
    folds = [_window_batch(rng, cfg, 4) for _ in range(F)]
    mine = folds[mesh.coord("data") * per:(mesh.coord("data") + 1) * per]
    stacked = {k: torch.as_tensor(np.stack([b[k] for b in mine]), device=fp.device)
               for k in mine[0]}
    fold_losses = fp.train_step(state, stacked, cfg.lr)["loss"].cpu().numpy()
    fold_eval = fp.eval_step(state, stacked)["loss"].cpu().numpy()
    if not (np.all(np.isfinite(fold_losses)) and np.all(np.isfinite(fold_eval))):
        raise RuntimeError(f"non-finite fold losses {fold_losses}, {fold_eval}")
    out["fold_losses"] = fold_losses.tolist()

    # trial-parallel COG step: the trial group over 'data'
    G = max(2, n_data)
    cfg_f = ExperimentConfig(model_name="COG", dataset_type="frame", data_type="kinematics",
                             out_features=2, trial_batch=G, num_layers_Basic=2,
                             num_layers_R=2, num_R=1, d_model=16, d_q=2, sequence_length=6,
                             fused_epoch=False, fused_run=False)
    exp_f = Experiment(cfg_f, device=dev)
    exp_f.init_weights(1)
    shard_state(exp_f, mesh)
    Tp = 64
    group = {"images": rng.normal(size=(G, 1, Tp, 2048)).astype(np.float32),
             "kinematics": rng.normal(size=(G, 1, Tp, 26)).astype(np.float32),
             "labels": rng.integers(0, 2, (G, Tp)), "mask": np.ones((G, Tp), np.float32),
             "true_len": np.full(G, Tp, np.int32), "trial_weight": np.ones(G, np.float32)}
    cog_loss = float(exp_f.train_step(group)["loss"])
    if not np.isfinite(cog_loss):
        raise RuntimeError(f"non-finite trial-parallel COG loss {cog_loss}")
    out["cog_loss"] = cog_loss
    return out


def dryrun_multichip(n_devices: int, device=None,
                     backend: Optional[str] = None) -> List[Dict[str, object]]:
    """Spawn ``n_devices`` ranks and run the dry run on them: on CUDA unless
    ``device`` is the CPU (raises without a GPU), over NCCL with a GPU a
    rank, or over ``backend`` ("gloo": the ranks share the card). Raises if
    any rank fails or a loss is not finite; returns each rank's numbers."""
    from .parallel import launch
    from .utils.device import resolve_device

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "snapshot")
        os.makedirs(snap)
        out = launch.spawn(_rank, n_devices, os.path.join(d, "ranks"),
                           args=(str(dev), snap), backend=backend, device=dev)
    r0 = out[0]
    # the ranks of one data row train the same folds: one row's each
    fold_losses = [round(x, 4) for r in out[::r0["mesh"]["model"]] for x in r["fold_losses"]]
    print(f"dryrun_multichip({n_devices}): window DP+TP mesh={r0['mesh']} "
          f"train_loss={r0['train_loss']:.4f} eval_loss={r0['eval_loss']:.4f} ok")
    print(f"dryrun_multichip({n_devices}): sharded checkpoint save/load/resume ok")
    print(f"dryrun_multichip({n_devices}): fold-parallel train+eval "
          f"losses={fold_losses} ok")
    print(f"dryrun_multichip({n_devices}): trial-parallel COG step "
          f"loss={r0['cog_loss']:.4f} ok")
    return out


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else None)
