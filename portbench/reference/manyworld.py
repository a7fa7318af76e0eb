"""One world of the lockstep rollout, stepped on its own.

Frozen copy of the per-world part of the port's
``parallel/manyworld.py`` ``_flat_static``: every solid box and capsule of
a world (characters excepted) lists every other as a partner, fixed when
the scene is built, and the solver's block shifts are the partner
offsets that topology produces.  :func:`static_route` gives the physics
step's keyword arguments for one world of that topology, so the
reference steps each world by itself through the same route the flat
layout runs, without flattening.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.state import (
    COMP_COLLIDER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
)


def static_route(static: StaticScene, comp_mask) -> dict:
    """``physics_step`` keyword arguments of one world: its fixed
    neighbor lists, its own entities as the character's candidates and
    the solver's block of one world."""
    dev = static.parent.device
    b = static.capacity
    ce = static.char_entity.cpu().numpy()
    is_char = np.zeros(b, bool)
    is_char[ce[ce >= 0]] = True
    st = static.shape_type.cpu().numpy()
    comp = comp_mask.cpu().numpy()
    solid = (((comp & COMP_COLLIDER) != 0)
             & ((st == SHAPE_BOX) | (st == SHAPE_CAPSULE)) & ~is_char)
    sol = np.where(solid)[0]
    k = max(int(len(sol)) - 1, 1)
    idx = np.zeros((b, k), np.int32)
    val = np.zeros((b, k), bool)
    for i in sol:
        others = [j for j in sol if j != i]
        idx[i, :len(others)] = others
        val[i, :len(others)] = True
    rows = np.broadcast_to(np.arange(b)[:, None], idx.shape)
    shifts = tuple(sorted({int(d) for d in (idx[val] - rows[val])}))
    return dict(
        broadphase="static",
        static_neighbors=(torch.as_tensor(idx, device=dev),
                          torch.as_tensor(val, device=dev)),
        char_candidates=torch.arange(b, dtype=torch.int32,
                                     device=dev)[None],
        solver_block_size=b, solver_block_shifts=shifts)
