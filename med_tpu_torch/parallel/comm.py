"""The collectives that ``shard_map`` gives ``med_tpu``, written out for one
process a rank (the port's own module). Each is a function over a process
group, and each that a gradient crosses is an autograd function:

- :func:`psum`: all-reduce sum. Its backward is the identity where every
  rank goes on to compute the same value from the sum (a loss), and an
  all-reduce of the cotangents (``grad="sum"``) where each rank feeds the
  sum into its own rows (a BatchNorm's statistics);
- :func:`fetch`: this rank receives the block of the rank ``hop`` places
  along the group (zeros past either end); backward sends each cotangent
  back where its block came from, i.e. ``fetch(g, -hop)``;
- :func:`seq_shift_right`: the distributed causal shift of a sequence
  sharded along its first axis: at most two fetches and one splice;
- :func:`halo_left`: the ``width`` rows before this shard, over as many
  hops as the width needs, with a fill row left of the global start;
- :func:`all_gather`: the shards concatenated along the first axis; its
  backward keeps this rank's slice.

Parameter gradients are summed over the data axis once a step
(:func:`all_reduce_grads`): autograd sees each rank's own graph only.

gloo takes CUDA tensors for all-reduce and broadcast alone, so under gloo
a point-to-point exchange or a gather of CUDA tensors is staged through
host memory here, explicitly; the computation stays on the card. A group of
None (a world of one rank) needs no process group: every collective is then
the identity, and a fetch from a neighbour gives zeros.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether gloo must see this CUDA tensor through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    if group_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad):
        ctx.group, ctx.grad = group, grad
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return _all_reduce(g, ctx.group), None, None
        return g, None, None


def psum(x: torch.Tensor, group, grad: str = "identity") -> torch.Tensor:
    """All-reduce sum over ``group``. ``grad``: "identity" where every rank
    then computes the same value from the sum (the loss: each rank's
    backward already starts from the whole cotangent), "sum" where each rank
    feeds it into its own rows (their cotangents are partial: summed)."""
    if grad not in ("identity", "sum"):
        raise ValueError(f"grad is 'identity' or 'sum', not {grad!r}")
    if group_size(group) == 1:
        return x
    return _PSum.apply(x, group, grad)


def _fetch(x: torch.Tensor, hop: int, group) -> torch.Tensor:
    """The block of group rank (this + hop), zeros where there is none; every
    rank of the group must call it with the same hop and shape."""
    n, i = group_size(group), group_rank(group)
    src, dst = i + hop, i - hop
    if n == 1 or hop == 0:
        return x if hop == 0 else torch.zeros_like(x)
    staged = _staged(x, group)
    send = x.detach().cpu() if staged else x.detach().contiguous()
    recv = torch.empty_like(send)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    if not 0 <= src < n:
        return torch.zeros_like(x)
    return recv.to(x.device) if staged else recv


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hop, group):
        ctx.hop, ctx.group = hop, group
        return _fetch(x, hop, group)

    @staticmethod
    def backward(ctx, g):
        return _fetch(g.contiguous(), -ctx.hop, ctx.group), None, None


def fetch(x: torch.Tensor, hop: int, group) -> torch.Tensor:
    """This rank's view of the block held ``hop`` ranks along the group
    (negative: to the left), zeros past either end of the group."""
    if hop == 0:
        return x
    if group_size(group) == 1:
        return torch.zeros_like(x)
    return _Fetch.apply(x, hop, group)


def seq_shift_right(x: torch.Tensor, offset: int, group) -> torch.Tensor:
    """This shard's block of the globally right-shifted sequence,
    ``y[g] = x[g - offset]`` with zeros for ``g < offset`` (the causal left
    pad). ``x`` is this rank's (S, ...) block; the shifted block spans at
    most two source shards (offset = k·S + r: rows >= r from rank i-k, rows
    < r from rank i-k-1), so the shift costs at most two fetches."""
    if offset == 0:
        return x
    S = x.shape[0]
    k, r = divmod(offset, S)
    if k >= group_size(group):
        return torch.zeros_like(x)
    a = fetch(x, -k, group)
    if r == 0:
        return a
    b = fetch(x, -(k + 1), group)
    return torch.cat([b[S - r:], a[:S - r]], dim=0)


def halo_left(x: torch.Tensor, width: int, group,
              fill_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, d) block -> (width, d): the ``width`` global rows before this
    shard. Rows left of the global start take ``fill_row`` (or zeros). A halo
    wider than the block comes from K = ceil(width / S) left neighbours."""
    S = x.shape[0]
    i = group_rank(group)
    K = -(-width // S)
    blocks = [fetch(x, -hop, group) for hop in range(K, 0, -1)]
    h = torch.cat(blocks, dim=0)[K * S - width:]
    # row r of the halo is global row i*S - width + r
    invalid = (torch.arange(width, device=x.device) < width - i * S)[:, None]
    edge = (torch.zeros_like(h) if fill_row is None
            else fill_row.to(h.dtype).expand_as(h))
    return torch.where(invalid, edge, h)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        staged = _staged(x, group)
        src = x.detach().cpu() if staged else x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(group_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, g):
        i = group_rank(ctx.group)
        return g[i * ctx.n:(i + 1) * ctx.n], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block concatenated along the first axis (equal blocks)."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum every parameter's ``.grad`` over ``group``, in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if group_size(group) == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def global_moments(x: torch.Tensor, dims, group):
    """(Σx, Σx², count) over ``dims`` summed over ``group`` in one
    all-reduce -> the global mean and E[x²]."""
    count = torch.tensor([float(x.numel() // x.shape[1])], dtype=x.dtype, device=x.device)
    stats = torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), count])
    total = psum(stats, group, grad="sum")
    C = x.shape[1]
    n = total[2 * C]
    return total[:C] / n, total[C:2 * C] / n
