"""The collectives of the data-parallel step, on ``torch.distributed``.

They replace the all-reduce that XLA inserts into the JAX package's
GSPMD step (``train.py``: batch sharded over ``data``, parameters
replicated) and its gather of the vocabulary head's shards; they are
not a port of any Pallas kernel. Each takes a ``group`` that is None
without a process group, and then runs no collective and returns its
input untouched; over a group of one rank a sum or a gather is a copy.
Either way a world of one computes the one-card bits.

``all_reduce_sum`` and ``gather_last`` are autograd functions:
- ``all_reduce_sum``'s backward all-reduces the gradient, which carries
  the other ranks' share of a batch statistic's gradient back to this
  rank's rows (the masked BN's global statistics);
- ``gather_last`` all-gathers along the last dim; its backward keeps this
  rank's columns of the gradient, which every rank of a model group
  holds whole, since they compute the same loss;
- ``copy_to_group`` is the identity whose backward all-reduces, the
  input side of a column-parallel layer: each rank's columns give a
  partial gradient of the shared input.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[-1]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; its gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dim in rank order,
    differentiable."""
    return x if group is None else _GatherLast.apply(x, group)


@torch.no_grad()
def all_reduce_mean_(tensors: List[torch.Tensor], group) -> None:
    """Average ``tensors`` (one dtype, one device) over ``group`` in
    place, through ONE flat all-reduce."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def collective_device(group) -> torch.device:
    """Where a host value goes for a collective over ``group``: the
    current card for NCCL, the CPU for gloo."""
    backend = dist.get_backend(group)
    return (torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))


def host_all_reduce(values, group, op=None) -> torch.Tensor:
    """Host numbers reduced over ``group`` (default: summed), returned on
    the CPU."""
    t = torch.as_tensor(values)
    if group is None:
        return t
    t = t.to(collective_device(group))
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t.cpu()
