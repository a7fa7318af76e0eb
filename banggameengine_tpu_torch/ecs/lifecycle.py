"""Runtime entity lifecycle: spawn, despawn and reparent in a running scene.

Counterpart of ``banggameengine_tpu/ecs/lifecycle.py`` (the reference
Scene's ``CreateEntity``/``DestroyEntity`` with id recycling,
``Scene.cpp:21-83``, and ``SetParent``, ``Scene.cpp:354-393``): a host
API over the fixed-capacity arrays and their alive mask, with the JAX
package's contract:

- ids are recycled lowest-free-first;
- ``despawn`` detaches the children into roots, erases the logical id and
  vacates the entity's trigger and character slots;
- ``reparent`` keeps the local transform and refuses cycles and
  self-parenting with a warning;
- the level table is re-baked into its existing ``[L, M]`` rectangle
  while the hierarchy fits, and grows (logged) only when it does not.

The static scene is written **in place**: every update is an index write
or a ``copy_`` into the tensor it changes, so no static tensor changes
shape, device or storage while the rectangle fits, and a step that takes
the static scene each call (``engine.make_hot_reloadable_step_fn``)
needs nothing new.  The state stays functional, as in the JAX package:
each call returns a new :class:`WorldState` and leaves the caller's as it
was.  The bit fields (``layer``, ``mask``, ``trig_layer``, ``trig_mask``,
``comp_mask``) are int32 with the uint32 bit pattern, so ``0xFFFFFFFF``
is written as -1.  Each call reads the alive mask (and, to re-bake the
levels, the parent table) to the host.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import compute_levels
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_STATIC,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    COMP_TRIGGER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
)

log = logging.getLogger("Lifecycle")

_BODY_TYPE = {"static": BODY_STATIC, "dynamic": BODY_DYNAMIC,
              "kinematic": BODY_KINEMATIC}
_SHAPE = {"box": SHAPE_BOX, "capsule": SHAPE_CAPSULE}

Tensor = torch.Tensor


def _bits(value) -> int:
    """A uint32 bit pattern (any Python int) as the int32 of the same
    bits: ``0xFFFFFFFF`` -> -1."""
    v = int(value) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _box_inertia_inv(mass: float, half) -> np.ndarray:
    """Bullet's box inertia, inverted, in f64 and then f32 (the scene
    build's form rounds in f32 first)."""
    e = 2.0 * np.asarray(half, np.float64)
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2]
    )
    return np.where(i > 0, 1.0 / np.maximum(i, 1e-12), 0.0).astype(np.float32)


def _rebake_levels(static: StaticScene, alive_np: np.ndarray) -> None:
    """Recompute the level-order schedule from the static parent table,
    into the existing [L, M] rectangle when the new hierarchy fits inside
    it; otherwise the table grows (a new tensor)."""
    table = compute_levels(static.parent.cpu().numpy(), alive_np)
    lo, mo = static.level_nodes.shape
    ln, mn = table.shape
    if ln <= lo and mn <= mo:
        padded = np.full((lo, mo), -1, np.int32)
        padded[:ln, :mn] = table
        static.level_nodes.copy_(torch.from_numpy(padded))
        return
    log.info(
        "[Lifecycle] hierarchy outgrew the level table (%dx%d -> %dx%d); "
        "next step will recompile", lo, mo, ln, mn,
    )
    static.level_nodes = torch.as_tensor(table,
                                         device=static.level_nodes.device)


def _with_row(t: Tensor, i: int, value) -> Tensor:
    """A copy of ``t`` with row ``i`` set to ``value``."""
    out = t.clone()
    out[i] = torch.as_tensor(value, dtype=out.dtype)
    return out


def free_slots(state: WorldState) -> np.ndarray:
    """Indices of dead (recyclable) entity slots, ascending."""
    return np.nonzero(~state.alive.cpu().numpy())[0]


def is_alive(state: WorldState, entity: int) -> bool:
    """Scene::IsAlive (Scene.cpp:43-47)."""
    e = int(entity)
    return 0 <= e < state.capacity and bool(state.alive[e])


def spawn(
    built,
    state: WorldState,
    *,
    name: str | None = None,
    pos=(0.0, 0.0, 0.0),
    euler=None,
    quat=None,
    scale=(1.0, 1.0, 1.0),
    parent: int | str | None = None,
    collider: dict | None = None,
    rigid_body: dict | None = None,
    trigger: dict | None = None,
    velocity=(0.0, 0.0, 0.0),
) -> tuple[WorldState, int]:
    """Create an entity in the lowest free slot (Scene::CreateEntity with id
    recycling, Scene.cpp:21-41).  Writes ``built.static`` (and the
    logical-id table) in place; returns the new WorldState and entity id.

    ``collider``: {"shape": "box"|"capsule", "size": (3,)}
    ``rigid_body``: {"type": "static"|"dynamic"|"kinematic", "mass",
        "friction", "restitution", "layer", "mask"}
    ``trigger``: {"shape", "size", "layer", "mask", "one_shot", "active"}:
        needs a free trigger slot (slots are capacity-padded at build).

    A spawned entity has physics and triggers but no mesh: the render
    scene is baked per scene load, so it shows only in the physics
    overlay, as the reference's entity without a MeshRenderer."""
    static = built.static
    free = free_slots(state)
    if len(free) == 0:
        raise RuntimeError(
            f"scene capacity {state.capacity} exhausted; rebuild with a "
            "larger capacity to spawn more entities"
        )
    i = int(free[0])

    if isinstance(parent, str):
        parent = built.find_entity(parent)
        if parent < 0:
            log.warning("[Lifecycle] spawn parent '%s' not found", parent)
    p = -1 if parent is None else int(parent)

    comp = COMP_TRANSFORM
    q = (math3d.quat_from_euler_xyz(torch.tensor(euler, dtype=torch.float32))
         if euler is not None
         else torch.tensor(quat if quat is not None else [0, 0, 0, 1],
                           dtype=torch.float32))

    row = dict(parent=p, body_type=0, shape_type=0,
               shape_size=np.zeros(3, np.float32), inv_mass=0.0,
               inv_inertia_body=np.zeros(3, np.float32), friction=0.5,
               restitution=0.0, layer=0, mask=0)

    shape_t = SHAPE_BOX
    size = np.zeros(3, np.float32)
    if collider is not None:
        comp |= COMP_COLLIDER
        shape_t = _SHAPE.get(collider.get("shape", "box"), SHAPE_BOX)
        size = np.asarray(collider.get("size", (0.5, 0.5, 0.5)),
                          np.float32).copy()
        if shape_t == SHAPE_BOX:
            size = np.maximum(size, 0.01)  # PhysicsSystem.cpp:692-701 clamps
        else:
            size[0] = max(size[0], 0.01)
            size[1] = max(size[1], 0.0)
            size[2] = 0.0
        # a collider without a body: static collision-only (the build's rule)
        row.update(shape_type=shape_t, shape_size=size, body_type=BODY_STATIC,
                   layer=1, mask=_bits(0xFFFFFFFF))

    if rigid_body is not None:
        comp |= COMP_RIGID_BODY
        bt = _BODY_TYPE.get(rigid_body.get("type", "static"), BODY_STATIC)
        row.update(body_type=bt,
                   friction=float(rigid_body.get("friction", 0.5)),
                   restitution=float(rigid_body.get("restitution", 0.0)),
                   layer=_bits(int(rigid_body.get("layer", 1)) or 1),
                   mask=_bits(rigid_body.get("mask", 0xFFFFFFFF)))
        if bt == BODY_DYNAMIC:
            m = max(float(rigid_body.get("mass", 1.0)), 0.01)
            if shape_t == SHAPE_CAPSULE:
                half = np.array([size[0], size[1] + size[0], size[0]],
                                np.float32)
            else:
                half = size
            row.update(inv_mass=1.0 / m,
                       inv_inertia_body=_box_inertia_inv(m, half))

    trig_slot = -1
    if trigger is not None:
        comp |= COMP_TRIGGER
        empty = np.nonzero(static.trig_entity.cpu().numpy() < 0)[0]
        if len(empty) == 0:
            raise RuntimeError(
                "no free trigger slots; rebuild with max_trigger_slots > "
                f"{static.num_trigger_slots}"
            )
        trig_slot = int(empty[0])

    alive_np = state.alive.cpu().numpy().copy()
    alive_np[i] = True
    for field, value in row.items():
        getattr(static, field)[i] = torch.as_tensor(
            value, dtype=getattr(static, field).dtype)
    if trig_slot >= 0:
        s = trig_slot
        static.trig_entity[s] = i
        static.trig_shape[s] = _SHAPE.get(trigger.get("shape", "box"),
                                          SHAPE_BOX)
        static.trig_size[s] = torch.tensor(trigger.get("size",
                                                       (0.5, 0.5, 0.5)),
                                           dtype=torch.float32)
        static.trig_layer[s] = _bits(trigger.get("layer", 4))
        static.trig_mask[s] = _bits(trigger.get("mask", 0xFFFFFFFF))
        static.trig_one_shot[s] = bool(trigger.get("one_shot", False))
    _rebake_levels(static, alive_np)

    f32 = torch.float32
    new_state = dataclasses.replace(
        state,
        alive=_with_row(state.alive, i, True),
        comp_mask=_with_row(state.comp_mask, i, comp),
        pos=_with_row(state.pos, i, torch.tensor(pos, dtype=f32)),
        quat=_with_row(state.quat, i, q),
        scale=_with_row(state.scale, i, torch.tensor(scale, dtype=f32)),
        lin_vel=_with_row(state.lin_vel, i, torch.tensor(velocity,
                                                         dtype=f32)),
        ang_vel=_with_row(state.ang_vel, i, 0.0),
        char_vel_y=_with_row(state.char_vel_y, i, 0.0),
        char_on_ground=_with_row(state.char_on_ground, i, False),
    )
    if trig_slot >= 0:
        new_state = dataclasses.replace(
            new_state,
            trigger_active=_with_row(new_state.trigger_active, trig_slot,
                                     bool(trigger.get("active", True))),
            trigger_overlap=_with_row(new_state.trigger_overlap, trig_slot,
                                      False),
        )

    # logical-id registration (Scene.cpp:508-521 semantics; dupes overwrite)
    while len(built.entity_names) < state.capacity:
        built.entity_names.append("")
    if name:
        built.logical_ids[name] = i
        built.entity_names[i] = name
    else:
        built.entity_names[i] = f"__entity_{i}"
    built.counts["entities"] += 1
    return new_state, i


def despawn(built, state: WorldState, entity: int) -> WorldState:
    """Destroy an entity (Scene::DestroyEntity, Scene.cpp:43-83): the slot is
    recycled, children detach and become roots (Scene.cpp:67-76), the logical
    id is erased, any trigger or character slot is vacated (the reference
    prunes dead characters, PhysicsSystem.cpp:1271-1284)."""
    i = int(entity)
    if not is_alive(state, i):
        return state
    static = built.static

    # children become roots
    parent_np = static.parent.cpu().numpy().copy()
    parent_np[parent_np == i] = -1
    parent_np[i] = -1
    static.parent.copy_(torch.from_numpy(parent_np))
    static.body_type[i] = 0
    static.layer[i] = 0
    static.mask[i] = 0

    owned = np.nonzero(static.trig_entity.cpu().numpy() == i)[0]
    for s in owned:
        static.trig_entity[int(s)] = -1
    for s in np.nonzero(static.char_entity.cpu().numpy() == i)[0]:
        static.char_entity[int(s)] = -1

    alive_np = state.alive.cpu().numpy().copy()
    alive_np[i] = False
    _rebake_levels(static, alive_np)

    # erase the logical id (Scene.cpp:82)
    for k, v in list(built.logical_ids.items()):
        if v == i:
            del built.logical_ids[k]
    if i < len(built.entity_names):
        built.entity_names[i] = ""
    built.counts["entities"] -= 1

    new_state = dataclasses.replace(
        state,
        alive=_with_row(state.alive, i, False),
        comp_mask=_with_row(state.comp_mask, i, 0),
        lin_vel=_with_row(state.lin_vel, i, 0.0),
        ang_vel=_with_row(state.ang_vel, i, 0.0),
    )
    if len(owned):
        overlap = new_state.trigger_overlap.clone()
        overlap[torch.as_tensor(owned)] = False
        new_state = dataclasses.replace(new_state, trigger_overlap=overlap)
    return new_state


def reparent(built, state: WorldState, entity: int,
             new_parent: int | str | None) -> None:
    """Scene::SetParent (Scene.cpp:354-393): the local transform is kept,
    the world transform re-derives under the new parent on the next step."""
    i = int(entity)
    if isinstance(new_parent, str):
        new_parent = built.find_entity(new_parent)
    p = -1 if new_parent is None else int(new_parent)
    if p == i:
        log.warning("[Lifecycle] reparent to self ignored")
        return
    static = built.static
    # cycle guard: walking up from p must not reach i
    parent_np = static.parent.cpu().numpy()
    j, guard = p, 0
    while j >= 0 and guard <= len(parent_np):
        if j == i:
            log.warning("[Lifecycle] reparent would create a cycle; ignored")
            return
        j = int(parent_np[j])
        guard += 1
    static.parent[i] = p
    _rebake_levels(static, state.alive.cpu().numpy())
