"""Trigger volumes: overlap sets and Enter/Stay/Exit events.

Counterpart of ``banggameengine_tpu/physics/triggers.py``: the AABB mode
(Bullet's ghost objects report broadphase pairs), the exact shape mode
over :func:`narrowphase.boolean_overlap_pairs`, and the overlap diff.  The
filter mirrors Bullet's group/mask test both ways: ``(trig_layer &
other_mask) && (other_layer & trig_mask)``; oneShot deactivation happens
inside the step.

The sweeps take ``block``, the entities a trigger row sees: the N
entities form W = N / ``block`` worlds of ``block`` each, and the trigger
rows W worlds of T slots, so that trigger row w*T + t is tested against
world w's entities only and the plane is bool[W*T, block].  One world
(``block`` None or N) is the square bool[T, N] plane.  The flat
many-world layout (:mod:`parallel.manyworld`) carries its planes so, and
never forms a pair across worlds.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch.physics import narrowphase as nf
from banggameengine_tpu_torch.physics import shapes as sh


def _trig(x, w: int):
    """Trigger rows [W*T, ...] -> [W, T, 1, ...]."""
    return x.reshape((w, x.shape[0] // w) + tuple(x.shape[1:])).unsqueeze(2)


def _ent(x, w: int):
    """Entity rows [W*B, ...] -> [W, 1, B, ...]."""
    return x.reshape((w, x.shape[0] // w) + tuple(x.shape[1:])).unsqueeze(1)


def _valid(trig_entity, trig_layer, trig_mask, trigger_active, layer, mask,
           alive, has_collision, w: int):
    """The pairs a trigger may report, bool[W, T, B]: a slot in use and
    active, a live entity with a collider, not the trigger's own entity,
    layers agreeing both ways."""
    te = _trig(trig_entity, w)
    ids = _ent(torch.arange(alive.shape[0], device=alive.device), w)
    layer_ok = (((_trig(trig_layer, w) & _ent(mask, w)) != 0)
                & ((_ent(layer, w) & _trig(trig_mask, w)) != 0))
    return ((te >= 0)
            & _trig(trigger_active, w)
            & _ent(alive, w)
            & _ent(has_collision, w)
            & (te != ids)
            & layer_ok)


def trigger_overlaps(
    trig_entity, trig_shape, trig_size, trig_layer, trig_mask, trigger_active,
    pos, quat, shape_type, size, layer, mask, alive, has_collision,
    block: int | None = None,
):
    """Exact shape overlap bool[W*T, block] of each trigger volume against
    each entity of its world's block (box SAT, capsule distance); one
    world's bool[T, N] by default."""
    w = 1 if block is None else pos.shape[0] // block
    safe_te = trig_entity.clamp_min(0).to(torch.int64)
    overlap = nf.boolean_overlap_pairs(
        _trig(pos[safe_te], w), _trig(quat[safe_te], w),
        _trig(trig_shape.to(shape_type.dtype), w), _trig(trig_size, w),
        _ent(pos, w), _ent(quat, w), _ent(shape_type, w), _ent(size, w))
    overlap = overlap & _valid(trig_entity, trig_layer, trig_mask,
                               trigger_active, layer, mask, alive,
                               has_collision, w)
    return overlap.reshape(-1, overlap.shape[-1])


def trigger_aabb_overlaps(
    trig_entity, trig_shape, trig_size, trig_layer, trig_mask, trigger_active,
    pos, quat, shape_type, size, layer, mask, alive, has_collision,
    block: int | None = None,
):
    """AABB-level overlap bool[W*T, block] against each trigger's own
    world's entities (Bullet's ghost objects report broadphase pairs);
    one world's bool[T, N] by default."""
    n, t = pos.shape[0], trig_entity.shape[0]
    w = 1 if block is None else n // block
    # one AABB pass over the trigger volumes' rows, then the entities'
    rows = torch.cat([trig_entity.clamp_min(0).to(torch.int64),
                      torch.arange(n, device=pos.device)])
    mn, mx = sh.shape_aabb(pos[rows], quat[rows],
                           torch.cat([trig_shape.to(shape_type.dtype),
                                      shape_type]),
                           torch.cat([trig_size, size]))
    overlap = ((_trig(mn[:t], w) <= _ent(mx[t:], w))
               & (_ent(mn[t:], w) <= _trig(mx[:t], w))).all(dim=-1)
    overlap = overlap & _valid(trig_entity, trig_layer, trig_mask,
                               trigger_active, layer, mask, alive,
                               has_collision, w)
    return overlap.reshape(-1, overlap.shape[-1])


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
