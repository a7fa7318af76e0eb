"""Procedural benchmark scenes (no asset files needed).

Counterpart of ``banggameengine_tpu/scene/synthetic.py``
:func:`build_falling_boxes`.  The scene is drawn with numpy from the same
``default_rng(seed)`` in the same order, so one seed gives the same scene
as the JAX builder: positions and every static field bit-equal, rotations
equal to the last ulp of f32 sin/cos.
"""

from __future__ import annotations

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import compute_levels
from banggameengine_tpu_torch.physics.config import PhysicsConfig
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    COMP_TRIGGER,
    LAYER_CHARACTER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
    make_world_state,
    tree_replace,
)


def _box_inertia_inv(mass, half):
    e = 2.0 * np.asarray(half, np.float64)
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2]
    )
    return (1.0 / np.maximum(i, 1e-12)).astype(np.float32)


def build_falling_boxes(
    num_bodies: int,
    seed: int = 0,
    spread: float | None = None,
    config: PhysicsConfig | None = None,
    with_character: bool = False,
    with_trigger: bool = False,
    device: torch.device | str = "cpu",
) -> tuple[WorldState, StaticScene]:
    """A world of ``num_bodies`` dynamic unit boxes raining onto the ground
    plane (the stress scene), on ``device``.  Deterministic for a seed."""
    cfg = (config or PhysicsConfig()).sanitized()
    rng = np.random.default_rng(seed)
    extra = (1 if with_character else 0) + (1 if with_trigger else 0)
    n = max(8, int(np.ceil((num_bodies + extra) / 8.0)) * 8)

    alive = np.zeros(n, bool)
    comp = np.zeros(n, np.uint32)
    pos = np.zeros((n, 3), np.float32)
    euler = np.zeros((n, 3), np.float32)
    body_type = np.zeros(n, np.int8)
    shape_type = np.zeros(n, np.int8)
    size = np.zeros((n, 3), np.float32)
    inv_mass = np.zeros(n, np.float32)
    inv_inertia = np.zeros((n, 3), np.float32)
    friction = np.full(n, 0.5, np.float32)
    restitution = np.zeros(n, np.float32)
    layer = np.zeros(n, np.uint32)
    mask = np.zeros(n, np.uint32)

    if spread is None:
        # spacing so resting boxes roughly tile the ground one layer deep
        spread = max(4.0, 1.2 * np.sqrt(num_bodies))

    half = np.array([0.5, 0.5, 0.5], np.float32)
    inertia = _box_inertia_inv(1.0, half)
    # the draws stay one body at a time, in the JAX builder's order
    for i in range(num_bodies):
        pos[i] = (
            rng.uniform(-spread, spread),
            rng.uniform(2.0, 2.0 + 0.5 * num_bodies),
            rng.uniform(-spread, spread),
        )
        euler[i] = rng.uniform(-np.pi, np.pi, 3)
    boxes = slice(0, num_bodies)
    alive[boxes] = True
    comp[boxes] = COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY
    body_type[boxes] = BODY_DYNAMIC
    shape_type[boxes] = SHAPE_BOX
    size[boxes] = half
    inv_mass[boxes] = 1.0
    inv_inertia[boxes] = inertia
    layer[boxes] = 1
    mask[boxes] = 0xFFFFFFFF

    cursor = num_bodies
    characters = []
    if with_character:
        ci = cursor
        cursor += 1
        alive[ci] = True
        comp[ci] = COMP_TRANSFORM | COMP_COLLIDER | COMP_CHARACTER
        pos[ci] = (0.0, 7.0, -5.0)
        shape_type[ci] = SHAPE_CAPSULE
        size[ci] = (cfg.capsule_radius, cfg.capsule_height * 0.5, 0.0)
        body_type[ci] = BODY_KINEMATIC
        layer[ci] = LAYER_CHARACTER
        mask[ci] = 0xFFFFFFFF
        characters.append(ci)

    triggers = []
    if with_trigger:
        ti = cursor
        cursor += 1
        alive[ti] = True
        comp[ti] = COMP_TRANSFORM | COMP_TRIGGER
        pos[ti] = (5.0, 1.0, 5.0)
        triggers.append(ti)

    t_slots = max(1, len(triggers))
    trig_entity = np.full(t_slots, -1, np.int32)
    trig_entity[: len(triggers)] = triggers
    c_slots = max(1, len(characters))
    char_entity = np.full(c_slots, -1, np.int32)
    char_entity[: len(characters)] = characters
    parent = np.full(n, -1, np.int32)

    def t(a, dtype=None):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)   # bit view: 0xFFFFFFFF -> -1
        return torch.as_tensor(a, dtype=dtype, device=device)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    def f32_slots(v):
        return torch.full((c_slots,), v, dtype=torch.float32, device=device)

    static = StaticScene(
        parent=t(parent),
        level_nodes=t(compute_levels(parent, alive)),
        body_type=t(body_type),
        shape_type=t(shape_type),
        shape_size=t(size),
        inv_mass=t(inv_mass),
        inv_inertia_body=t(inv_inertia),
        friction=t(friction),
        restitution=t(restitution),
        layer=t(layer),
        mask=t(mask),
        trig_entity=t(trig_entity),
        trig_shape=t(np.full(t_slots, SHAPE_BOX, np.int8)),
        trig_size=t(np.tile(np.asarray([1.5, 1.5, 1.5], np.float32),
                            (t_slots, 1))),
        trig_layer=t(np.full(t_slots, 4, np.uint32)),
        trig_mask=t(np.full(t_slots, 0xFFFFFFFF, np.uint32)),
        trig_one_shot=t(np.zeros(t_slots, bool)),
        char_entity=t(char_entity),
        char_radius=f32_slots(cfg.capsule_radius),
        char_half_height=f32_slots(cfg.capsule_height * 0.5),
        char_walk_speed=f32_slots(cfg.walk_speed),
        char_jump_impulse=f32_slots(cfg.jump_impulse),
        gravity=f32(cfg.gravity),
        fixed_dt=f32(cfg.fixed_step),
        step_height=f32(cfg.step_height),
        max_slope_cos=f32(float(np.cos(np.deg2rad(cfg.max_slope_deg)))),
        ground_enabled=torch.ones((), dtype=torch.bool, device=device),
    )

    state = make_world_state(n, t_slots, device=device)
    state = tree_replace(
        state,
        alive=t(alive),
        comp_mask=t(comp),
        pos=t(pos),
        quat=math3d.quat_from_euler_xyz(t(euler)),
    )
    return state, static
