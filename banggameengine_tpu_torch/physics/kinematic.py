"""Kinematic body driving: the host-side API for animated platforms.

Counterpart of ``banggameengine_tpu/physics/kinematic.py``.  The reference
pushes kinematic Transforms into the physics world every tick
(``SyncKinematicBodiesToPhysics``, ``PhysicsSystem.cpp:952-989``) so that
Bullet derives their velocity.  Here the host sets the velocity that
carries a kinematic body onto its target over one fixed step; the step
integrates kinematic bodies by it and feeds it into the contacts' relative
velocity (friction drags riders along, normal impulses push obstacles
away).  Kinematic bodies have inverse mass 0, so they take no impulse.

Every function returns a new WorldState and leaves its argument as it
was.  ``entity`` is an int or an int tensor on the state's device; the
writes go through ``index_put``, so a device index needs no host copy.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.state import WorldState, tree_replace

Tensor = torch.Tensor


def _as_f32(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _set_row(a: Tensor, entity, row) -> Tensor:
    """``a`` with row ``entity`` replaced by ``row`` (a new tensor)."""
    idx = torch.as_tensor(entity, dtype=torch.int64,
                          device=a.device).reshape(1)
    out = a.clone()
    out.index_put_((idx,), _as_f32(row, a).reshape(1, -1))
    return out


def _row(a: Tensor, entity) -> Tensor:
    idx = torch.as_tensor(entity, dtype=torch.int64,
                          device=a.device).reshape(1)
    return a.index_select(0, idx)[0]


def velocity_to_target(pos: Tensor, quat: Tensor, target_pos: Tensor,
                       target_quat: Tensor, dt) -> tuple[Tensor, Tensor]:
    """(lin_vel, ang_vel) that carry (pos, quat) onto the target in ``dt``.

    The angular velocity is the exact inverse of the first-order
    ``quat_integrate``: omega = (2/dt) * dq.xyz / dq.w, the delta
    quaternion taken on the shortest arc (for small deltas theta/dt about
    its axis; it diverges only toward a half turn per step)."""
    dt = _as_f32(dt, pos).clamp_min(1e-9)
    lin = (target_pos - pos) / dt
    dq = math3d.quat_mul(target_quat, math3d.quat_conj(quat))
    dq = torch.where(dq[..., 3:4] < 0.0, -dq, dq)
    w = dq[..., 3:4].clamp_min(1e-6)
    ang = (torch.full_like(dt, 2.0) / dt) * dq[..., :3] / w
    return lin, ang


def set_kinematic_velocity(state: WorldState, entity, lin_vel,
                           ang_vel=None) -> WorldState:
    """Set a kinematic body's velocity directly (it persists until
    changed)."""
    new_ang = state.ang_vel
    if ang_vel is not None:
        new_ang = _set_row(new_ang, entity, ang_vel)
    return tree_replace(state, lin_vel=_set_row(state.lin_vel, entity,
                                                lin_vel),
                        ang_vel=new_ang)


def set_kinematic_target(state: WorldState, entity, target_pos,
                         target_quat=None, *, dt) -> WorldState:
    """Drive a kinematic body so that the next step lands it on the
    target transform (the velocity-level image of the reference's per-tick
    kinematic transform push)."""
    pos, quat = _row(state.pos, entity), _row(state.quat, entity)
    tq = quat if target_quat is None else _as_f32(target_quat, quat)
    lin, ang = velocity_to_target(pos, quat, _as_f32(target_pos, pos), tq,
                                  dt)
    return set_kinematic_velocity(state, entity, lin, ang)


def warp_kinematic(state: WorldState, entity, pos, quat=None) -> WorldState:
    """Teleport a kinematic body with no velocity (a warp, not a sweep:
    the reference's dirty-flag warp rebuild)."""
    new_quat = state.quat
    if quat is not None:
        new_quat = _set_row(new_quat, entity, quat)
    zero3 = torch.zeros(3, dtype=torch.float32, device=state.pos.device)
    return tree_replace(
        state, pos=_set_row(state.pos, entity, pos), quat=new_quat,
        lin_vel=_set_row(state.lin_vel, entity, zero3),
        ang_vel=_set_row(state.ang_vel, entity, zero3))
