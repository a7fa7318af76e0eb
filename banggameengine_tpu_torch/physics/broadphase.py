"""Broadphase: the neighbor-list container and the dense all-pairs route.

Counterpart of ``NeighborLists`` and ``build_neighbor_lists_dense`` in
``banggameengine_tpu/physics/broadphase.py``.  The all-pairs route of the
stress tick lives in :mod:`broadphase_kernel`; the grid route
(``build_neighbor_lists``) is not ported (ROADMAP item 16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from banggameengine_tpu_torch.physics import shapes as sh
from banggameengine_tpu_torch.physics.solver import compaction_index


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
