"""Trigger volumes: overlap sets and Enter/Stay/Exit events.

Counterpart of ``banggameengine_tpu/physics/triggers.py``: the AABB mode
(Bullet's ghost objects report broadphase pairs), the exact shape mode
over :func:`narrowphase.boolean_overlap_pairs`, and the overlap diff.  The
filter mirrors Bullet's group/mask test both ways: ``(trig_layer &
other_mask) && (other_layer & trig_mask)``; oneShot deactivation happens
inside the step.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch.physics import narrowphase as nf
from banggameengine_tpu_torch.physics import shapes as sh


def _valid(trig_entity, trig_layer, trig_mask, trigger_active, layer, mask,
           alive, has_collision):
    """The pairs a trigger may report: a slot in use and active, a live
    entity with a collider, not the trigger's own entity, layers agreeing
    both ways."""
    n = alive.shape[0]
    layer_ok = (((trig_layer[:, None] & mask[None, :]) != 0)
                & ((layer[None, :] & trig_mask[:, None]) != 0))
    ids = torch.arange(n, device=alive.device)
    return ((trig_entity[:, None] >= 0)
            & trigger_active[:, None]
            & alive[None, :]
            & has_collision[None, :]
            & (trig_entity[:, None] != ids[None, :])
            & layer_ok)


def trigger_overlaps(
    trig_entity, trig_shape, trig_size, trig_layer, trig_mask, trigger_active,
    pos, quat, shape_type, size, layer, mask, alive, has_collision,
):
    """Exact shape overlap bool[T, N] of each trigger volume against each
    entity's collision shape (box SAT, capsule distance)."""
    safe_te = trig_entity.clamp_min(0).to(torch.int64)
    overlap = nf.boolean_overlap_pairs(
        pos[safe_te][:, None], quat[safe_te][:, None],
        trig_shape.to(shape_type.dtype)[:, None], trig_size[:, None],
        pos[None, :], quat[None, :], shape_type[None, :], size[None, :])
    return overlap & _valid(trig_entity, trig_layer, trig_mask,
                            trigger_active, layer, mask, alive,
                            has_collision)


def trigger_aabb_overlaps(
    trig_entity, trig_shape, trig_size, trig_layer, trig_mask, trigger_active,
    pos, quat, shape_type, size, layer, mask, alive, has_collision,
):
    """AABB-level overlap bool[T, N] (Bullet's ghost objects report
    broadphase pairs)."""
    n = pos.shape[0]
    safe_te = trig_entity.clamp_min(0).to(torch.int64)
    tmn, tmx = sh.shape_aabb(pos[safe_te], quat[safe_te],
                             trig_shape.to(shape_type.dtype), trig_size)
    emn, emx = sh.shape_aabb(pos, quat, shape_type, size)
    overlap = torch.ones((tmn.shape[0], n), dtype=torch.bool,
                         device=pos.device)
    for j in range(3):
        # out of place: under ``torch.func.vmap`` the right-hand side is
        # batched and the unbatched ``ones`` cannot take it in place
        overlap = overlap & ((tmn[:, j][:, None] <= emx[:, j][None, :])
                             & (emn[:, j][None, :] <= tmx[:, j][:, None]))
    return overlap & _valid(trig_entity, trig_layer, trig_mask,
                            trigger_active, layer, mask, alive,
                            has_collision)


def diff_events(prev_overlap, now_overlap, trig_one_shot, trigger_active):
    """Overlap diff -> (enter, stay, exit, new_overlap, new_active): Enter
    on appear, Stay on persist, Exit on disappear; a oneShot trigger
    deactivates after its first Enter."""
    enter = now_overlap & ~prev_overlap
    stay = now_overlap & prev_overlap
    exit_ = prev_overlap & ~now_overlap
    fired = enter.any(dim=1)
    new_active = trigger_active & ~(trig_one_shot & fired)
    return enter, stay, exit_, now_overlap, new_active
