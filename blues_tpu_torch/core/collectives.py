"""Collectives over a ``torch.distributed`` process group, differentiable
where a force passes through them.

The JAX package runs its multi-device code inside ``shard_map``, where
``psum``, ``psum_scatter`` and ``all_to_all`` have transpose rules, so
``jax.grad`` goes through them. Here each is a ``torch.autograd.Function``
whose backward is the adjoint collective:

  * ``all_reduce`` (sum): backward is the sum of the ranks' gradients, so
    a term replicated on every rank and weighted 1/D gets its full
    gradient back on each rank;
  * ``reduce_scatter`` along dim 0: backward is the all-gather;
  * ``all_gather`` along dim 0: backward is the reduce-scatter;
  * ``all_to_all`` of equal blocks along dim 0: backward is the same
    exchange of the gradient's blocks.

A plain in-place ``dist.all_reduce`` on a tensor that needs a gradient
would cut the graph, and the forces through it would come out D times too
small or too large; these functions never do that.

The group's backend and the tensor's device must agree: ``nccl`` takes
CUDA tensors and ``gloo`` CPU tensors. Nothing is staged through the host:
a mismatch raises (``check_device``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the names of torch >= 2.13, whose older names (the only ones before it)
# are deprecated there
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def check_device(t: torch.Tensor, group=None):
    """Raise unless ``t`` lives where the group's backend works: the card
    under ``nccl``, the CPU under ``gloo``."""
    backend = dist.get_backend(group)
    if backend == "nccl" and t.device.type != "cuda":
        raise ValueError(f"a 'nccl' group takes CUDA tensors, got one on {t.device}")
    if backend == "gloo" and t.device.type != "cpu":
        raise ValueError(
            f"a 'gloo' group takes CPU tensors, got one on {t.device}; use an 'nccl' group on the card"
        )


def _all_reduce(t, group):
    check_device(t, group)
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _reduce_scatter(t, group):
    check_device(t, group)
    d = dist.get_world_size(group)
    if t.shape[0] % d:
        raise ValueError(f"reduce_scatter of dim 0 = {t.shape[0]} over {d} ranks")
    out = t.new_empty((t.shape[0] // d, *t.shape[1:]))
    _scatter_from(out, t.contiguous(), group=group)
    return out


def _all_gather(t, group):
    check_device(t, group)
    d = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] * d, *t.shape[1:]))
    _gather_into(out, t.contiguous(), group=group)
    return out


def _all_to_all(t, group):
    check_device(t, group)
    d = dist.get_world_size(group)
    if t.shape[0] != d:
        raise ValueError(f"all_to_all needs dim 0 = {d} blocks (one per rank), got {tuple(t.shape)}")
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _reduce_scatter(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_reduce(t, group=None):
    """The sum of ``t`` over the group, on every rank (a new tensor)."""
    return _AllReduce.apply(t, group)


def reduce_scatter(t, group=None):
    """The sum over the group of ``t`` (dim 0 of D equal blocks), block
    ``rank`` of it on each rank."""
    return _ReduceScatter.apply(t, group)


def all_gather(t, group=None):
    """Every rank's ``t`` concatenated along dim 0 in rank order."""
    return _AllGather.apply(t, group)


def all_to_all(t, group=None):
    """``t`` is (D, ...): block j goes to rank j; the result's block j came
    from rank j."""
    return _AllToAll.apply(t, group)
