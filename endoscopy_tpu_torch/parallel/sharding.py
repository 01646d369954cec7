"""The collectives of data parallelism (counterpart of
``endoscopy_tpu/parallel/sharding.py``).

The JAX package jits each step over the global batch, split on the mesh's
'data' axis, and XLA inserts the reductions that span it. The port runs
one process per rank on its rows of the global batch and issues those
reductions itself, over the default ``torch.distributed`` group:

- every rank's loss is its **share** of the global loss: the sum over its
  rows divided by the global count (:func:`batch_mean`). The shares add up
  to the 1-process loss on the global batch, so the gradients are
  **summed** over ranks (:func:`sync_grads`), not averaged;
- a value that must be global on every rank (CoMatch's distribution
  alignment, a weighted mean's denominator, the logged losses) is
  all-reduced (:func:`all_reduce_sum`, :func:`global_mean`);
- :func:`all_gather_rows` and :func:`flip_rows` hand a rank other ranks'
  rows, in the global batch's order.

Every rank holds the same number of rows (``cli/learn.py::build_data``
refuses a global batch the ranks do not divide), so a global count is the
local count times the world size. Outside a group each function is the
1-process computation it stands for, and issues nothing.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn

from endoscopy_tpu_torch.parallel.mesh import in_group


def _world_rank():
    return dist.get_world_size(), dist.get_rank()


def _reduced(x: torch.Tensor, op) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op)
    return y


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        return _reduced(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad.contiguous(), dist.ReduceOp.SUM)


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows, in rank order; the gradient of a rank's rows is
    its rows of the gradient summed over ranks."""

    @staticmethod
    def forward(ctx, x):
        world, rank = _world_rank()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.rows
        return _reduced(grad.contiguous(), dist.ReduceOp.SUM)[start:stop]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ranks (forward and backward); ``x`` outside a
    group."""
    return _AllReduceSum.apply(x) if in_group() else x


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over ranks, without gradient."""
    return _reduced(x, dist.ReduceOp.MAX) if in_group() else x


def all_reduce_min(x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum over ranks, without gradient."""
    return _reduced(x, dist.ReduceOp.MIN) if in_group() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order: the global
    batch's rows. The gradient flows back to each rank's own rows."""
    return _AllGatherRows.apply(x) if in_group() else x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, as this rank's share: its
    elements' sum over the global count. The ranks' shares add up to the
    mean; outside a group it is ``x.mean()``."""
    if not in_group():
        return x.mean()
    return x.sum() / (dist.get_world_size() * x.numel())


@torch.no_grad()
def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch's rows (dim 0), the same on every
    rank; ``x.mean(0)`` outside a group."""
    if not in_group():
        return x.mean(0)
    return _reduced(x.sum(0), dist.ReduceOp.SUM) / (
        dist.get_world_size() * x.shape[0])


def flip_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch's ``flip(0)``: rank ``r``'s
    partner rows are rank ``P - 1 - r``'s rows, reversed, exchanged with
    that rank. ``x.flip(0)`` outside a group."""
    if not in_group():
        return x.flip(0)
    world, rank = _world_rank()
    peer = world - 1 - rank
    if peer == rank:
        return x.flip(0)
    x = x.contiguous()
    other = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                       dist.P2POp(dist.irecv, other, peer)]):
        req.wait()
    return other.flip(0)


def local_rows(*global_sizes: int, device=None) -> torch.Tensor:
    """This rank's rows of a global batch laid out as consecutive blocks
    of ``global_sizes`` rows, each block split evenly over the ranks in
    rank order: rows ``[r·n/P, (r+1)·n/P)`` of every block. Outside a
    group every row."""
    world, rank = _world_rank() if in_group() else (1, 0)
    parts, offset = [], 0
    for n in global_sizes:
        if n % world:
            raise ValueError(f"{world} ranks do not divide a block of {n} "
                             "rows")
        share = n // world
        parts.append(torch.arange(offset + rank * share,
                                  offset + (rank + 1) * share))
        offset += n
    return torch.cat(parts).to(device)


@torch.no_grad()
def sync_grads(model: nn.Module | Iterable[nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over ranks, in one all-reduce of one
    flat float32 buffer. Every rank must hold a gradient for the same
    parameters, in the same order."""
    if not in_group():
        return
    params = model.parameters() if isinstance(model, nn.Module) else model
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


@torch.no_grad()
def broadcast_state(*modules: nn.Module | None) -> None:
    """Rank 0's parameters and buffers into every rank's copy of each
    module (``None`` skipped), one broadcast per dtype."""
    if not in_group():
        return
    tensors = [t for m in modules if m is not None
               for t in m.state_dict().values()]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def barrier() -> None:
    """Wait for every rank (on NCCL, on this process's card)."""
    if not in_group():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
