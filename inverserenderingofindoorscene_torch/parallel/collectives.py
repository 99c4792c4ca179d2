"""Collectives over a ``torch.distributed`` process group.

The counterparts of the JAX package's ``lax.psum`` / ``lax.pmean`` /
``lax.pmax`` under ``shard_map``: each rank holds its rows of a global
batch, and a value reduced here is the same on every rank.  ``group`` is
a process group (``multihost.initialize`` returns the world's) or None,
one process, where each function returns its input and runs no
collective.

The gradient rule is the JAX one (``train/steps.py:102-106``): a loss is
the global sum of its numerator over the global sum of its count, so a
rank's gradient is its own share (``psum``'s gradient is local), and
after ``backward`` the ranks' gradients are summed (:func:`sum_grads_`),
not averaged.  Only ``all_reduce`` (SUM, MAX) and ``broadcast`` are used:
gloo runs both on CUDA tensors as well as CPU ones, NCCL on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group's ranks; the gradient stays local
    (each rank's cotangent is the global loss's, so a rank takes the
    gradient of its own share)."""
    if group is None:
        return x
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` averaged over the group's ranks (``psum`` over the world
    size)."""
    if group is None:
        return x
    return psum(x, group) / dist.get_world_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group's ranks, for
    statistics: no gradient flows through it."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _AMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = torch.amax(x.detach())
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(x, out)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        mask = x == out
        # the cotangents of every rank and the count of elements at the
        # maximum on every rank, in one all_reduce
        buf = torch.stack([grad.to(x.dtype), mask.sum().to(x.dtype)])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.group)
        return (buf[0] / buf[1]) * mask, None


def amax(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum over every element of ``x`` on every rank: what
    ``torch.amax(x)`` gives on the ranks' tensors concatenated, with its
    gradient.  The ranks' cotangents are summed and shared evenly among
    the elements equal to the maximum on every rank, as ``torch.amax``
    shares its cotangent among ties."""
    if group is None:
        return torch.amax(x)
    return _AMax.apply(x, group)


def sum_grads_(params, group) -> None:
    """Sum each parameter's ``.grad`` over the group's ranks in place,
    in one flat all_reduce.  Parameters without a gradient are left out:
    the ranks run one graph, so they leave out the same ones."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
