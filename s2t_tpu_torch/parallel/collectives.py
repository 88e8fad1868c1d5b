"""Collectives that autograd differentiates, and the gradient conventions they keep.

Over "data", "seq" and "pipe" a replicated value's true gradient is the SUM over the
group of the ranks' own gradients: each rank backpropagates its share of the loss
(its rows; 1 / (seq x pipe) of a loss every rank computes alike), and the Trainer sums
the parameters' gradients over those groups.  So a gather's backward is a
reduce-scatter (``gather``), a slice's backward puts the gradient in its own slot
(``split``), and a value sent downstream to every rank sums the ranks' gradients on its
way back (``broadcast``).  Over "model" every rank holds the true gradient of a
replicated value: Megatron's ``copy_to_group`` (identity forward, all-reduce backward)
and ``reduce_from_group`` (all-reduce forward, identity backward) keep it so around a
column- and a row-parallel layer.  Gloo has no reduce-scatter, so one is an all-reduce
and a slice.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing for None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * size, size)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return own_slice(g, ctx.dim, ctx.group).contiguous(), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' pieces of ``x`` concatenated along ``dim`` (sum convention)."""
    return x if group is None else _Gather.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal piece of a replicated ``x`` along ``dim`` (sum convention)."""
    return x if group is None else own_slice(x, dim, group)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g, None, None


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``; each rank's gradient
    is summed back (sum convention)."""
    return x if group is None else _Broadcast.apply(x, src, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce_(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the partial sums of a row-parallel layer, summed."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


class _GatherParam(torch.autograd.Function):
    """A parameter stored as its shards along ``dims`` over ``groups``, whole for one
    use.  Backward: over a group whose ranks see other rows (``reduce``) the ranks'
    gradients of the whole are summed first; then each keeps its own slice."""

    @staticmethod
    def forward(ctx, shard, dims, groups, reduce):
        ctx.dims, ctx.groups, ctx.reduce = dims, groups, reduce
        full = shard
        for dim, group in zip(dims, groups):
            full = all_gather_cat(full, dim, group)
        return full

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for dim, group, red in reversed(list(zip(ctx.dims, ctx.groups, ctx.reduce))):
            if red:
                g = all_reduce_(g.clone(), group)
            g = own_slice(g, dim, group)
        return g.contiguous(), None, None, None


def gather_param(shard: torch.Tensor, dims: List[int], groups: List, reduce: List[bool]):
    return _GatherParam.apply(shard, tuple(dims), tuple(groups), tuple(reduce))


def send(t: torch.Tensor, dst: int, group=None) -> None:
    dist.send(t.contiguous(), dst, group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    out = torch.empty_like(like).contiguous()
    dist.recv(out, src, group=group)
    return out


def sendrecv(t: torch.Tensor, dst: int, src: int, group=None) -> torch.Tensor:
    """Send ``t`` to ``dst`` while receiving one of its shape from ``src`` (a ring step)."""
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def next_prev(group) -> tuple:
    """The global ranks after and before this one around ``group``'s ring."""
    ranks = dist.get_process_group_ranks(group)
    i = ranks.index(dist.get_rank())
    return ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]
