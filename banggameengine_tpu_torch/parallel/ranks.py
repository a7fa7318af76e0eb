"""Ranks, meshes and placements for the sharded modes.

The JAX package shards over a ``jax.sharding.Mesh`` inside one process;
here every mesh position is a process (a rank) of a ``torch.distributed``
group, and a mesh is a one-dimensional ``DeviceMesh`` over the whole
group whose dim name is the JAX axis name (``"world"``, ``"entity"``,
``"entity_shard"``).  A sharded array is a ``DTensor``: ``Shard(0)`` where
JAX shards the leading axis, ``Shard(1)`` for the ``[T, N]`` trigger
planes, ``Replicate()`` for the rest, so ``full_tensor()`` stands where the
JAX tests read a sharded array back.  The step bodies compute on the
``to_local()`` rows with explicit collectives over ``mesh.get_group()``.

:func:`init_rank` joins this process to a group through a ``FileStore``
(NCCL for CUDA, gloo for the CPU); :func:`run_ranks` starts one process per
rank and returns what each returned.  NCCL takes one rank a card, so on a
single card the sharded modes run on one rank; gloo ranks on the CPU test
every mesh size.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist


COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def init_rank(rank: int, world_size: int, store_path: str,
              device: str = "cuda") -> torch.device:
    """Join the default process group as ``rank`` of ``world_size``,
    rendezvousing through the ``FileStore`` file ``store_path``.  On CUDA
    the rank takes card ``rank``; on the CPU it computes on one thread (the
    ranks share the host).  Returns the rank's device."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    store = dist.FileStore(store_path, world_size)
    # a collective that waits longer than this fails instead of hanging
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size,
                            timeout=COLLECTIVE_TIMEOUT)
    return dev


def _rank_main(rank: int, fn, world_size: int, store_dir: str, device: str,
               args: tuple) -> None:
    init_rank(rank, world_size, os.path.join(store_dir, "store"), device)
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(store_dir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device: str = "cuda",
              store_dir: str | None = None) -> list:
    """Start ``world_size`` processes, join them into one group
    (:func:`init_rank`) and return the list of ``fn(rank, world_size,
    *args)`` in rank order.

    ``fn`` and ``args`` are pickled into freshly spawned interpreters, so
    ``fn`` must be a module-level function whose module imports cheaply;
    results come back through ``torch.save`` files.  ``store_dir`` holds
    the ``FileStore`` and the results (a new temporary directory when
    None), so concurrent launches never share a port or a file.  A rank
    that raises makes this raise."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, world_size, tmp, device, args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]


def make_mesh(axis: str, device_type: str = "cuda", ranks=None):
    """A one-dimensional mesh over the initialised default group, its dim
    named ``axis``.  ``ranks`` (a sequence of ranks, or None) must name
    the whole group: a mesh position is a process."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: join one first (ranks.init_rank, or "
            "ranks.run_ranks to start the ranks)")
    n = dist.get_world_size()
    if ranks is not None and sorted(int(r) for r in ranks) != list(range(n)):
        raise ValueError(
            f"a mesh spans the whole group of {n} ranks; got ranks "
            f"{list(ranks)}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


# --- placements ----------------------------------------------------------


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(s)
    return tuple(reversed(stride))


def distribute(x: torch.Tensor, mesh, placement):
    """Place a full tensor, the same on every rank, onto the mesh: this
    rank keeps its own chunk (``torch.chunk``'s split, as ``Shard`` has
    it); no collective."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(placement, Shard):
        d = placement.dim
        chunks = torch.chunk(x, mesh.size(), dim=d)
        r = mesh.get_local_rank()
        local = (chunks[r] if r < len(chunks)
                 else x.narrow(d, 0, 0)).contiguous()
    else:
        local = x
    return DTensor.from_local(local, mesh, [placement], run_check=False,
                              shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def rewrap(local: torch.Tensor, like):
    """``local`` placed as ``like`` is (a DTensor of the same global
    shape); a plain ``like`` gives ``local`` back."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=_contiguous_stride(like.shape))


def local(x):
    """This rank's part of a DTensor (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def replicated(x):
    """The whole of a DTensor on this rank: its local tensor where it is
    replicated, else gathered (a collective every rank makes)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    if all(isinstance(p, Replicate) for p in x.placements):
        return x.to_local()
    return x.full_tensor()


def map_fields(fn, obj):
    """A dataclass with ``fn`` applied to each field."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def full(obj):
    """Every field of a dataclass of DTensors gathered whole (a collective
    every rank makes): the counterpart of ``np.asarray`` on a sharded JAX
    array."""
    return map_fields(replicated, obj)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' ``x`` [rows, ...] concatenated along dim 0 in rank
    order: ``jax.lax.all_gather(x, axis, tiled=True)``.  Booleans travel as
    uint8.  The collective runs on a group of one too."""
    n = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(torch.bool) if is_bool else out


def sum_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``jax.lax.psum``); a new
    tensor."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out
