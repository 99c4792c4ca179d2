"""Replicated parameters and a batch split over the ranks.

The counterpart of the JAX package's ``parallel/mesh.py``.  There the
training step is one XLA SPMD program over a ``{data, tile}`` mesh with
replicated params (``replicated``) and the batch split over ``data``
(``shard_batch``).  Here the ``data`` axis is a ``torch.distributed``
group: :func:`replicate_` makes every rank's parameters rank 0's, and
:func:`shard_batch` keeps a rank's rows.

The ``tile`` axis is not ported.  It shards the ``env_gt`` / ``env_pre``
lighting-grid columns inside one SPMD program (JAX ``mesh.py:59-70``),
with XLA inserting the reductions; a process group has no counterpart,
and JAX's own multi-process run is data-only too.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from inverserenderingofindoorscene_torch.parallel.multihost import (
    local_batch_slice,
)


@torch.no_grad()
def replicate_(module: torch.nn.Module, group) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from the group's
    rank 0, one flat broadcast a dtype, in place; returns ``module``.
    ``group`` None leaves it as it is."""
    if group is None:
        return module
    src = dist.get_global_rank(group, 0)
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return module


def shard_batch(batch: dict, group) -> dict:
    """This rank's rows of each tensor of ``batch`` (dim 0 split evenly
    over the group's ranks, :func:`local_batch_slice`); ``group`` None
    returns ``batch``."""
    if group is None:
        return batch
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    out = {}
    for k, v in batch.items():
        start, stop = local_batch_slice(rank, world, v.shape[0])
        out[k] = v[start:stop]
    return out
