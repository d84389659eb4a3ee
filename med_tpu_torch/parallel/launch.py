"""Starting ranks and their rendezvous (the port's own: ``med_tpu`` is one
process that sees every device; the port runs one process a rank).

- :func:`spawn` starts ``world_size`` processes with ``torch.multiprocessing``
  and meets them through a ``FileStore`` in a directory the caller names
  (no TCP port, so several groups can run side by side). Each rank runs
  ``fn(*args)`` and its return value comes back to the caller, a list by
  rank; a rank's exception ends the call with that exception.
- :func:`init_from_env` joins the group ``torchrun`` describes (``env://``),
  the way the CLIs run on several GPUs:
  ``torchrun --nproc-per-node N -m med_tpu_torch.cli.<cli> ...``.

Backends: ``nccl`` for CUDA, where each rank owns its own GPU
(``cuda:LOCAL_RANK``); ``gloo`` for the CPU. A CUDA world larger than the
GPU count raises unless the caller asks for ``gloo``, which lets several
ranks share one card (slowly, and only for correctness checks). No backend
is ever swapped for another after a failure.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process writes the run (rank 0, or the only process)."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def check_world(world: int, device, backend: Optional[str]) -> str:
    """The backend a world of ``world`` ranks on ``device`` runs on; raises
    where NCCL would need more GPUs than there are."""
    device = torch.device(device)
    backend = _backend_for(device, backend)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the ranks on the CPU")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"{world} NCCL ranks need {world} GPUs, there are "
                             f"{torch.cuda.device_count()}; pass backend='gloo' "
                             "to share a card between ranks")
    return backend


def rank_device(device, backend: str, local_rank: int) -> torch.device:
    """This rank's device: its own GPU under NCCL, the caller's otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        index = local_rank if backend == "nccl" else (device.index or 0)
        torch.cuda.set_device(index)
        return torch.device("cuda", index)
    return device


def _rank_main(local_rank: int, fn: Callable, world: int, backend: str, device: str,
               store_dir: str, args: Sequence[Any]) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=local_rank, world_size=world)
    try:
        rank_device(device, backend, local_rank)
        out = fn(*args)
        with open(os.path.join(store_dir, f"result_{local_rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, store_dir: str, args: Sequence[Any] = (),
          backend: Optional[str] = None, device=None) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` new ranks of one process group and
    return each rank's result, by rank. ``fn`` must be importable by name (a
    module-level function). ``store_dir``: an empty directory for the
    rendezvous and the results. ``device``: CUDA unless the caller asks for
    the CPU (raises without a GPU). Inside ``fn``, :func:`rank` and
    :func:`world_size` describe the group and CUDA's current device is the
    rank's (see :func:`rank_device`)."""
    import torch.multiprocessing as mp

    from ..utils.device import resolve_device

    device = resolve_device(device)
    backend = check_world(world_size, device, backend)
    os.makedirs(store_dir, exist_ok=True)
    mp.start_processes(_rank_main, args=(fn, world_size, backend, str(device), store_dir,
                                         tuple(args)),
                       nprocs=world_size, start_method="spawn")
    out = []
    for r in range(world_size):
        with open(os.path.join(store_dir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def init_from_env(device=None) -> Optional[torch.device]:
    """Join the process group that ``torchrun`` describes in the environment
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), once. Returns
    this rank's device, or None outside torchrun (a run of one rank, which
    needs no group). ``device``: the CLI's ``--device`` (CUDA by default)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if not dist.is_initialized():
        # the GPUs this node's ranks need: torchrun's local world
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = check_world(local_world, dev, None)
        if dev.type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method="env://")
    return rank_device(dev, dist.get_backend(), local)
