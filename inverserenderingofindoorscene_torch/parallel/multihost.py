"""Process-group initialization and per-rank data sharding.

The counterpart of the JAX package's ``parallel/multihost.py``.  There,
every host runs one SPMD program and ``jax.distributed.initialize`` wires
the cluster; here every rank is a process of a ``torch.distributed``
group, holds its rows of the global batch (:func:`local_batch_slice`),
and the steps of ``train/steps.py`` reduce their losses and gradients
over the group (``parallel/collectives.py``).  Every group takes a
timeout, so a rank that fails makes its peers raise at their next
collective instead of waiting for ever.
"""

from __future__ import annotations

import os
import zlib
from datetime import timedelta

import torch
import torch.distributed as dist

from inverserenderingofindoorscene_torch.device import resolve_device

DEFAULT_TIMEOUT = timedelta(seconds=90)


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               timeout: timedelta = DEFAULT_TIMEOUT):
    """Join the process group; returns its world group, or None when no
    world is named (no argument, and no ``RANK`` / ``WORLD_SIZE`` of
    torchrun in the environment), as JAX's ``initialize`` does nothing in
    one process.

    A world of one is a group too.  ``backend`` defaults to ``nccl`` where
    CUDA is available (each rank then takes the card ``LOCAL_RANK``, else
    its rank, modulo the cards it sees) and ``gloo`` elsewhere;
    ``init_method`` to torchrun's ``env://``.  A group that is already
    initialized is returned as it is."""
    named = (init_method is not None or world_size is not None
             or rank is not None
             or {"RANK", "WORLD_SIZE"} <= set(os.environ))
    if not named:
        return None
    if dist.is_initialized():
        return dist.group.WORLD
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK", rank if rank is not None else
                               os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    kwargs = {k: v for k, v in (("world_size", world_size), ("rank", rank))
              if v is not None}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=timeout, **kwargs)
    return dist.group.WORLD


def initialize_cpu_cluster(init_method: str, world_size: int, rank: int,
                           timeout: timedelta = DEFAULT_TIMEOUT):
    """Join a gloo group of ``world_size`` processes, the path the CPU
    tests take (JAX ``initialize_cpu_cluster``): ``init_method`` is a
    ``file://`` or ``tcp://`` rendezvous.  Returns the world group."""
    return initialize("gloo", init_method, world_size, rank, timeout)


def local_batch_slice(rank: int, world: int, global_batch: int):
    """(start, stop): the rows of the global batch that ``rank`` of
    ``world`` holds.  Raises when the batch does not split evenly, which
    the JAX mesh cannot do either."""
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {world} ranks")
    per_rank = global_batch // world
    return rank * per_rank, (rank + 1) * per_rank


def global_batch_from_local(local_batch: dict, group, device=None) -> dict:
    """A rank's own rows of the global batch, checked and on ``device``
    (``None`` means CUDA).

    Under ``torch.distributed`` no array spans the ranks, so nothing is
    assembled, as JAX's ``make_array_from_process_local_data`` does: a
    rank keeps its rows, and the losses sum over the group.  What holds
    the ranks to one global batch is that their local batches agree in
    keys, dtypes and shapes; one all_reduce (MAX of a digest of them and
    of its negation) checks it, and every rank raises if any differs."""
    dev = resolve_device(device)
    batch = {k: torch.as_tensor(v) for k, v in local_batch.items()}
    if group is not None:
        layout = repr(sorted((k, str(v.dtype), tuple(v.shape))
                             for k, v in batch.items()))
        digest = zlib.crc32(layout.encode())
        both = torch.tensor([digest, -digest], dtype=torch.int64, device=dev)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        if int(both[0]) != -int(both[1]):
            raise ValueError("the ranks' local batches differ in keys, "
                             f"dtypes or shapes; this rank's: {layout}")
    return {k: v.to(dev) for k, v in batch.items()}
