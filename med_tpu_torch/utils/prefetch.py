"""Host-to-device prefetch (port of ``med_tpu.utils.prefetch``).

``med_tpu`` starts each batch's transfer ``depth`` batches ahead (JAX's
device_put is asynchronous), so the chip never waits on input. The port
does the same on a side CUDA stream: each batch is copied into a fresh
pinned host buffer, then ``.to(device, non_blocking=True)`` on that stream,
and ``depth`` transfers stay in flight. A batch is handed out only after
the consuming stream waits on its copy's event, and each buffer is a
batch's own, so nothing a consumer reads is overwritten while a copy is in
flight (PyTorch's pinned-memory cache holds a buffer until its copy ends).
On the CPU batches pass through unchanged.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def _on_host(v) -> bool:
    return isinstance(v, np.ndarray) or (isinstance(v, torch.Tensor) and not v.is_cuda)


def prefetch_to_device(batches: Iterable[Dict], depth: int = 2, device=None,
                       mesh=None) -> Iterator[Dict]:
    """Yield the batches with their arrays on ``device``, keeping ``depth``
    transfers in flight (``depth`` 0: the batches pass through, and each
    goes up from pageable memory when its step takes it). Keys starting with '_' stay on the host. With a ``mesh`` each
    batch is first cut to this rank's rows (``parallel/mesh.py::shard_batch``).
    ``device`` None or a CPU device: the batches pass through."""
    if mesh is not None:
        from ..parallel.mesh import shard_batch

        batches = (shard_batch(b, mesh) for b in batches)
    device = None if device is None else torch.device(device)
    if device is None or device.type != "cuda" or depth <= 0:
        yield from batches
        return
    stream = torch.cuda.Stream(device)

    def put(batch):
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if k.startswith("_") or not _on_host(v):
                    out[k] = v
                    continue
                host = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray)
                                       else v).pin_memory()
                out[k] = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def ready(item):
        out, event = item
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                # its memory belongs to the consumer's stream from here on
                v.record_stream(current)
        return out

    it = iter(batches)
    queue: collections.deque = collections.deque()
    for b in it:
        queue.append(put(b))
        if len(queue) >= depth:
            break
    while queue:
        nxt: Optional[Dict] = next(it, None)
        head = ready(queue.popleft())
        if nxt is not None:
            queue.append(put(nxt))
        yield head
