"""Broadphase: the neighbor-list container, the dense all-pairs route and
the spatial-hash grid.

Counterpart of ``banggameengine_tpu/physics/broadphase.py``:
``NeighborLists``, ``build_neighbor_lists_dense`` and the grid's
``build_neighbor_lists`` with ``_cell_coords`` and ``_hash_coords``.  The
all-pairs route of the stress tick lives in :mod:`broadphase_kernel`.

The grid's integer outputs equal the JAX module's exactly: the hash is
computed in int32 and wraps as XLA's does, its modulo is a floor modulo
(``torch.remainder``), the sort of the hashes is stable, and the lists
are compacted by the same running-count rule (read as a gather, ROADMAP
"Not to port").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.physics import shapes as sh
from portbench.reference.physics.solver import compaction_index


# large primes for 3D spatial hashing
_P1, _P2, _P3 = 73856093, 19349663, 83492791


class NeighborLists(NamedTuple):
    idx: torch.Tensor            # int32[N, K] neighbor body ids, -1 padded
    valid: torch.Tensor          # bool[N, K]
    cell_overflow: torch.Tensor  # int32[] bodies dropped from full cells
    nbr_overflow: torch.Tensor   # int32[] candidate pairs dropped from full rows


def build_neighbor_lists_dense(
    pos: torch.Tensor,
    quat: torch.Tensor,
    shape_type: torch.Tensor,
    size: torch.Tensor,
    pair_mask: torch.Tensor,   # bool[N, N] extra validity (layers, dynamics)
    max_neighbors: int = 8,
    aabb_margin: float = 0.04,
) -> NeighborLists:
    """All-pairs AABB broadphase compacted to fixed neighbor lists, for
    small worlds: the ``[N, N]`` overlap matrix, then each row's first
    ``max_neighbors`` partners in id order.  The compaction is the JAX
    module's (running-count destinations) read as an index gather, so it
    costs O(N^2) memory where the one-hot contraction costs O(N^2 K)."""
    n = pos.shape[0]
    mn, mx = sh.shape_aabb(pos, quat, shape_type, size)
    ov = sh.aabb_overlap(mn[:, None], mx[:, None], mn[None, :], mx[None, :],
                         margin=aabb_margin)
    ov = ov & pair_mask & ~torch.eye(n, dtype=torch.bool, device=pos.device)
    src, valid, counts = compaction_index(ov, max_neighbors)
    idx = torch.where(valid, src.to(torch.int32), -1)
    overflow = (counts - max_neighbors).clamp_min(0).sum().to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=pos.device)
    return NeighborLists(idx=idx, valid=valid, cell_overflow=zero,
                         nbr_overflow=overflow)


def _cell_coords(pos: torch.Tensor, cell_size: float) -> torch.Tensor:
    """int32 cell coordinates ``floor(pos / cell_size)``.  The divisor is
    an f32 tensor on ``pos``'s device: a Python scalar would let the card
    multiply by its reciprocal, which rounds differently at cell faces."""
    cs = torch.full((), cell_size, dtype=pos.dtype, device=pos.device)
    return torch.floor(pos / cs).to(torch.int32)


def _hash_coords(c: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash of int32 cell coordinates [..., 3] into [0, table_size): the
    products wrap in int32, and the modulo is a floor modulo."""
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return torch.remainder(h, table_size)


def build_neighbor_lists(
    pos: torch.Tensor,            # f32[N, 3]
    quat: torch.Tensor,
    shape_type: torch.Tensor,
    size: torch.Tensor,
    active: torch.Tensor,         # bool[N] participate in the broadphase
    cell_size: float,
    table_size: int = 4096,
    cell_capacity: int = 8,
    max_neighbors: int = 16,
    aabb_margin: float = 0.04,
) -> NeighborLists:
    """Fixed-capacity neighbor lists from a uniform spatial hash grid:
    bodies are hashed by cell into a ``[table_size, cell_capacity]`` cell
    table (one stable sort, one scatter), and each body takes as
    candidates the bodies listed in its 27 neighbouring cells that really
    sit in those cells (hash collisions and repeats drop out), are active,
    are not itself and overlap its AABB; the first ``max_neighbors`` in
    (cell, slot) order are kept.  ``cell_overflow`` counts the bodies a
    full cell dropped, ``nbr_overflow`` the candidates a full list
    dropped.

    ``cell_size`` should be at least the largest dynamic body's diameter,
    so that a body's partners all lie in its 27 cells."""
    n = pos.shape[0]
    device = pos.device
    cells = _cell_coords(pos, cell_size)                     # [N, 3]
    hashes = torch.where(active, _hash_coords(cells, table_size),
                         table_size)

    # the cell table: bodies sorted by hash, ranked within each run
    sorted_h, order = torch.sort(hashes, stable=True)
    iota = torch.arange(n, device=device)
    starts = torch.ones(n, dtype=torch.bool, device=device)
    starts[1:] = sorted_h[1:] != sorted_h[:-1]
    seg_start = torch.cummax(torch.where(starts, iota, 0), dim=0).values
    rank = iota - seg_start
    ok = (rank < cell_capacity) & (sorted_h < table_size)
    # one dump row past the table takes the rows that are not ok, as in
    # the JAX module; it is cut off after the scatter
    table = torch.full(((table_size + 1) * cell_capacity,), -1,
                       dtype=torch.int32, device=device)
    dest = torch.where(ok, sorted_h * cell_capacity + rank,
                       table_size * cell_capacity)
    table.scatter_(0, dest.to(torch.int64), order.to(torch.int32))
    table = table[:table_size * cell_capacity].reshape(table_size,
                                                       cell_capacity)
    cell_overflow = ((sorted_h < table_size)
                     & (rank >= cell_capacity)).sum().to(torch.int32)

    # candidates from the 27-cell neighbourhood
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)
    nbr_cells = cells[:, None, :] + offs[None, :, :]         # [N, 27, 3]
    cand = table[_hash_coords(nbr_cells, table_size).to(torch.int64)]
    safe = cand.clamp_min(0).to(torch.int64)                 # [N, 27, cap]
    # genuine iff it sits in the probed cell: drops hash-collision ghosts
    # and a body listed under two probed hashes
    cell_match = (cells[safe] == nbr_cells[:, :, None, :]).all(dim=-1)
    cand_ok = ((cand >= 0) & cell_match
               & (cand != iota[:, None, None].to(torch.int32))
               & active[safe] & active[:, None, None])
    mn, mx = sh.shape_aabb(pos, quat, shape_type, size)
    cand_ok = cand_ok & sh.aabb_overlap(
        mn[:, None, None], mx[:, None, None], mn[safe], mx[safe],
        margin=aabb_margin)

    flat_ok = cand_ok.reshape(n, -1)
    src, valid, counts = compaction_index(flat_ok, max_neighbors)
    idx = torch.where(valid, torch.gather(cand.reshape(n, -1), 1, src), -1)
    nbr_overflow = (counts - max_neighbors).clamp_min(0).sum().to(
        torch.int32)
    return NeighborLists(idx=idx, valid=valid, cell_overflow=cell_overflow,
                         nbr_overflow=nbr_overflow)
