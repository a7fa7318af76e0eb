"""Transform-hierarchy propagation.

Counterpart of ``banggameengine_tpu/ecs/transform.py``: the host groups
entities by depth once (:func:`compute_levels`, a copy of the JAX
package's numpy function), and the device recomputes every local matrix,
then walks the levels, each one a gather plus a batched 4x4 product
``world[c] = world[parent[c]] @ local[c]``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import math3d

Tensor = torch.Tensor


def compute_levels(parent: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Host-side: group entity indices by hierarchy depth.

    ``parent`` int32[N] (-1 for roots; an entity whose parent is not alive
    is a root), ``alive`` bool[N].  Returns an int32[L, M] table of entity
    ids per level, padded with -1, with L >= 1 even for an empty scene.
    """
    parent = np.asarray(parent, np.int32)
    alive = np.asarray(alive, bool)
    n = parent.shape[0]
    depth = np.full(n, -1, np.int64)
    for i in range(n):
        if not alive[i]:
            continue
        d, j, guard = 0, i, 0
        while parent[j] >= 0 and alive[parent[j]] and guard <= n:
            j = parent[j]
            d += 1
            guard += 1
        if guard > n:  # cycle: treat as root
            d = 0
        depth[i] = d
    max_depth = int(depth.max()) if (depth >= 0).any() else 0
    levels = []
    for d in range(max_depth + 1):
        ids = np.nonzero(depth == d)[0].astype(np.int32)
        levels.append(ids)
    width = max((len(l) for l in levels), default=1)
    width = max(width, 1)
    table = np.full((len(levels), width), -1, np.int32)
    for d, ids in enumerate(levels):
        table[d, : len(ids)] = ids
    return table


def scatter_rows(base: Tensor, ids: Tensor, rows: Tensor) -> Tensor:
    """``base`` with ``rows[m]`` written at row ``ids[m]`` for every
    ``ids[m] >= 0``; -1 entries write nothing.

    The valid ids must be distinct.  The -1 padding is routed to a sink row
    past the end that is dropped, so no two writes land on one kept row and
    the result is the same on every run on CUDA (the JAX form writes the
    padding to row 0).  No host synchronisation: the valid ids are never
    counted on the host.
    """
    n = base.shape[0]
    dest = torch.where(ids >= 0, ids, n).to(torch.int64)
    out = torch.cat([base, base[:1]], dim=0)
    # out of place: ``index_copy`` has a batching rule under
    # ``torch.func.vmap`` (the in-place form falls back to a per-world loop)
    return out.index_copy(0, dest, rows.to(base.dtype))[:n]


def update_world_matrices(pos, quat, scale, parent, level_nodes, alive):
    """Recompute all world matrices f32[N, 4, 4]:
    world[i] = world[parent[i]] @ local[i]; roots use local directly."""
    local = math3d.mat_from_srt(scale, quat, pos)
    world = local
    for lvl in range(1, level_nodes.shape[0]):
        ids = level_nodes[lvl]                      # int32[M], -1 padded
        safe_ids = ids.clamp_min(0).to(torch.int64)
        p = parent[safe_ids]
        safe_p = p.clamp_min(0).to(torch.int64)
        composed = math3d.mat_mul(world[safe_p], local[safe_ids])  # [M,4,4]
        world = scatter_rows(world, ids, composed)
    # dead entities keep their local matrix; callers mask by `alive`
    del alive
    return world
