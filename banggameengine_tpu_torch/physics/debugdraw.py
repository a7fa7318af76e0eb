"""Physics debug lines: collision-shape wireframes.

Counterpart of ``banggameengine_tpu/physics/debugdraw.py`` (the
reference's ``BulletDebugDrawer`` with the colour scheme of
``PhysicsSystem.cpp:1155-1173``): a fixed-capacity array of coloured 3D
segments for every collision shape, the trigger volumes and the ground
grid, in the JAX package's layout, ``L = N * 28 + T * 12 + 22``:

- 28 slots per entity: a box's 12 edges (the other 16 degenerate at its
  centre, not valid), or a capsule's two rings of 8, 4 verticals and 8
  cap arcs;
- 12 per trigger slot: its box;
- 22 grid lines over [-25, 25] at y = 0.

The JAX package builds one entity at a time under ``jax.vmap``; here
every entity's segments come from one batched computation.  Output is
``(points f32[L, 2, 3], colors f32[L, 4], valid bool[L])``, the input of
:func:`banggameengine_tpu_torch.render.lines.draw_lines`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.physics.shapes import box_corners
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
)

Tensor = torch.Tensor

# colours (RGBA): PhysicsSystem.cpp:1155-1173
COLOR_STATIC = (0.6, 0.6, 0.6, 1.0)     # grey
COLOR_DYNAMIC = (0.0, 1.0, 1.0, 1.0)    # cyan
COLOR_KINEMATIC = (0.5, 1.0, 1.0, 1.0)
COLOR_TRIGGER = (1.0, 0.0, 1.0, 1.0)    # magenta
COLOR_GRID = (0.35, 0.35, 0.35, 1.0)

_RING_SEGS = 8
# per-entity line budget: a capsule's 2 rings x 8 + 4 verticals + 8 arcs
LINES_PER_ENTITY = 28
GRID_LINES = 22

# box edges as corner-index pairs (corner k flips axis a iff bit a of k,
# the JAX package's _CORNERS order)
_BOX_EDGES = np.array(
    [(0, 1), (1, 3), (3, 2), (2, 0),      # z- ring
     (4, 5), (5, 7), (7, 6), (6, 4),      # z+ ring
     (0, 4), (1, 5), (2, 6), (3, 7)], np.int64)

# the capsule's ring in f64, then f32, as the JAX package takes it
_ANG = np.linspace(0, 2 * np.pi, _RING_SEGS, endpoint=False)
_CIRC = np.stack([np.cos(_ANG), np.zeros_like(_ANG), np.sin(_ANG)],
                 1).astype(np.float32)


def _grid() -> np.ndarray:
    """The ground grid's 22 segments f32[22, 2, 3]: 11 along z at the x
    ticks, then 11 along x at the z ticks."""
    ticks = np.linspace(-25.0, 25.0, 11).astype(np.float32)
    zeros, lo, hi = np.zeros(11), np.full(11, -25.0), np.full(11, 25.0)
    gx = np.stack([np.stack([ticks, zeros, lo], 1),
                   np.stack([ticks, zeros, hi], 1)], axis=1)
    gz = np.stack([np.stack([lo, zeros, ticks], 1),
                   np.stack([hi, zeros, ticks], 1)], axis=1)
    return np.concatenate([gx, gz]).astype(np.float32)


@functools.cache
def _tables(device: torch.device) -> dict[str, Tensor]:
    """The constant tables on ``device``, in one copy there, once per
    device (a copy to the card synchronises with the host)."""
    parts = dict(
        edges=_BOX_EDGES, circ=_CIRC, circ_next=np.roll(_CIRC, -1, axis=0),
        up=[0.0, 1.0, 0.0], grid=_grid(), static=COLOR_STATIC,
        dynamic=COLOR_DYNAMIC, kinematic=COLOR_KINEMATIC,
        trigger=COLOR_TRIGGER, grid_color=COLOR_GRID)
    arrays = {k: np.asarray(v, np.float32) for k, v in parts.items()}
    flat = torch.as_tensor(np.concatenate([a.ravel()
                                           for a in arrays.values()]),
                           device=device)
    out, at = {}, 0
    for k, a in arrays.items():
        out[k] = flat[at:at + a.size].reshape(a.shape)
        at += a.size
    out["edges"] = out["edges"].to(torch.int64)   # small ints, exact in f32
    return out


def _box_edges(pos: Tensor, quat: Tensor, half: Tensor,
               edges: Tensor) -> Tensor:
    """The 12 edges of each oriented box, f32[B, 12, 2, 3]."""
    corners = box_corners(pos, quat, half)                    # [B, 8, 3]
    return torch.stack([corners[:, edges[:, 0]], corners[:, edges[:, 1]]],
                       dim=2)


def _capsule_lines(pos: Tensor, quat: Tensor, radius: Tensor,
                   half_height: Tensor, tb: dict) -> Tensor:
    """Each capsule's wireframe f32[B, 28, 2, 3]: two rings, 4 verticals,
    the 8 two-segment arcs to the poles, in the JAX package's op order."""
    r = radius[:, None, None]
    hh = half_height[:, None, None]
    up = tb["up"]

    def ring(y):
        a = tb["circ"] * r + up * y
        b = tb["circ_next"] * r + up * y
        return torch.stack([a, b], dim=2)                     # [B, 8, 2, 3]

    quarter = tb["circ"][:: _RING_SEGS // 4]                  # [4, 3]
    vert_a = quarter * r + up * hh                            # [B, 4, 3]
    vert_b = quarter * r - up * hh
    pole_t = (up * (hh + r)).expand_as(vert_a)
    local = torch.cat([ring(hh), ring(-hh),
                       torch.stack([vert_a, vert_b], dim=2),
                       torch.stack([vert_a, pole_t], dim=2),
                       torch.stack([vert_b, -pole_t], dim=2)], dim=1)
    return (math3d.quat_rotate(quat[:, None, None, :], local)
            + pos[:, None, None, :])


def collision_shape_lines(state: WorldState, static: StaticScene):
    """All entity collision-shape wireframes, the trigger volumes and the
    ground grid: ``(points f32[L, 2, 3], colors f32[L, 4], valid bool[L])``
    with ``L = N * 28 + T * 12 + 22``, on the state's device, with no host
    synchronisation."""
    tb = _tables(state.pos.device)
    n = state.capacity
    pos, quat = state.pos, state.quat
    stype, size, btype = static.shape_type, static.shape_size, static.body_type

    box = _box_edges(pos, quat, size, tb["edges"])            # [N, 12, 2, 3]
    pad = pos[:, None, None, :].expand(n, LINES_PER_ENTITY - 12, 2, 3)
    box = torch.cat([box, pad], dim=1)
    cap = _capsule_lines(pos, quat, size[:, 0], size[:, 1], tb)
    is_box = stype == SHAPE_BOX
    is_cap = stype == SHAPE_CAPSULE
    segs = torch.where(is_box[:, None, None, None], box, cap)
    first12 = torch.arange(LINES_PER_ENTITY, device=pos.device) < 12
    ok = torch.where(is_box[:, None], first12[None, :], is_cap[:, None])
    ok = ok & state.alive[:, None]
    color = torch.where(
        (btype == BODY_DYNAMIC)[:, None], tb["dynamic"],
        torch.where((btype == BODY_KINEMATIC)[:, None], tb["kinematic"],
                    tb["static"]))                            # [N, 4]

    # trigger volumes (magenta boxes)
    te = static.trig_entity
    safe = te.clamp_min(0).to(torch.int64)
    tseg = _box_edges(pos[safe], quat[safe], static.trig_size, tb["edges"])
    tok = ((te >= 0) & state.trigger_active)[:, None].expand(-1, 12)
    t_lines = tseg.shape[0] * 12

    points = torch.cat([segs.reshape(-1, 2, 3), tseg.reshape(-1, 2, 3),
                        tb["grid"]])
    colors = torch.cat([
        color[:, None, :].expand(n, LINES_PER_ENTITY, 4).reshape(-1, 4),
        tb["trigger"].expand(t_lines, 4),
        tb["grid_color"].expand(GRID_LINES, 4)])
    valid = torch.cat([ok.reshape(-1), tok.reshape(-1),
                       static.ground_enabled.expand(GRID_LINES)])
    return points, colors, valid
