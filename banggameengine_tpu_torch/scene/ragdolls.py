"""Bullet's ragdoll benchmark scene: a pyramid of jointed capsule ragdolls.

Bullet3's ``examples/Benchmarks/BenchmarkDemo.cpp``: ``createTest3``
("136 ragdolls") stacks rows of ``size``, ``size - 1``, ..., 1 ragdolls of
the ``RagDoll`` class, ragdoll ``i`` of a row of ``s`` at ``x = -(pitch /
2) s + pitch i`` (pitch 6), each row 7 m above the last (from ``y = 1``)
and 2 m further towards -z.  A ragdoll is capsules along their local y
joined by hinges and cone-twists (Bullet's: 11 capsules of mass 1,
damping 0.05 and 0.85, 5 hinges and 5 cone-twists), every length times
``scale``.  Bullet's capsule inertia is that of the box of half extents
``(r, r + h/2, r)``.

The ragdoll is a description, as the benchmark's ``bullet-ragdolls136``
configuration writes it (its ``scene``): ``size``, ``scale``,
``row_start``, ``row_step``, ``ragdoll_pitch_x``, ``mass``,
``linear_damping``, ``angular_damping``, optionally ``jitter_m`` and
``jitter_yaw_deg``, and two tables keyed by name (a ``columns`` entry
names their columns and is skipped): ``parts``, each ``[radius, cylinder
height, x, y, z, turn about z]``, and ``joints``, each ``[kind ("hinge" |
"cone_twist"), part a, part b, a's frame as setEulerZYX (x, y, z), a's
anchor, b's frame, b's anchor, limits]``, the limits a hinge's ``(lo,
hi)`` or a cone-twist's ``(swing span, twist span)``; lengths before
``scale``.

:func:`build_ragdoll_pyramid` returns the scene, its state and its
:class:`physics.joints.JointSet`, to step on the dense route
(``engine.make_multi_step_fn(static, n, joints=joints,
broadphase="dense")``).  A seed moves each ragdoll by up to ``jitter_m``
in x and z and turns it about y by up to ``jitter_yaw_deg``, so that
seeds differ; without jitter the pyramid is the source's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import compute_levels
from banggameengine_tpu_torch.physics.config import PhysicsConfig
from banggameengine_tpu_torch.physics.joints import (
    CONE_TWIST,
    HINGE,
    JointSet,
    make_joint_set,
)
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
    make_world_state,
    tree_replace,
)

KINDS = {"hinge": HINGE, "cone_twist": CONE_TWIST}


@dataclasses.dataclass
class RagdollScene:
    static: StaticScene
    state: WorldState
    joints: JointSet
    ragdolls: int


def pyramid_offsets(ragdoll: dict) -> np.ndarray:
    """``createTest3``'s ragdoll origins, row by row: f64[R, 3]."""
    start = np.asarray(ragdoll["row_start"], np.float64)
    step = np.asarray(ragdoll["row_step"], np.float64)
    pitch = float(ragdoll["ragdoll_pitch_x"])
    out = []
    for k, row in enumerate(range(int(ragdoll["size"]), 0, -1)):
        for i in range(row):
            out.append(start + k * step + (pitch * (i - 0.5 * row), 0, 0))
    return np.asarray(out)


def _table(rows: dict) -> list:
    return [v for k, v in rows.items() if k != "columns"]


def euler_zyx(euler) -> np.ndarray:
    """Bullet's ``setEulerZYX(x, y, z)``: Rz Ry Rx."""
    x, y, z = euler
    cx, sx, cy, sy = math.cos(x), math.sin(x), math.cos(y), math.sin(y)
    cz, sz = math.cos(z), math.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _capsule_inv_inertia(mass: float, r: float, h: float) -> np.ndarray:
    e = 2.0 * np.array([r, r + 0.5 * h, r])
    i = mass / 12.0 * np.array([e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2,
                                e[0] ** 2 + e[1] ** 2])
    return 1.0 / i


def build_ragdoll_pyramid(ragdoll: dict, seed: int = 0,
                          count: int | None = None,
                          device: torch.device | str = "cuda"
                          ) -> RagdollScene:
    """The pyramid of the description ``ragdoll`` (see the module
    docstring; ``size (size + 1) / 2`` ragdolls, or the first ``count``)
    on ``device``, under Bullet's demo gravity -10 at the engine's 1/120 s
    tick, with Bullet's default friction 0.5 and restitution 0 on every
    part and the ground."""
    cfg = PhysicsConfig(gravity=-10.0)
    parts, joint_rows = _table(ragdoll["parts"]), _table(ragdoll["joints"])
    names = [k for k in ragdoll["parts"] if k != "columns"]
    scale, mass = float(ragdoll["scale"]), float(ragdoll["mass"])
    origins = pyramid_offsets(ragdoll)[:count]
    n_rag, n_part = len(origins), len(parts)
    n = n_rag * n_part
    rng = np.random.default_rng(seed)
    jitter_m = float(ragdoll.get("jitter_m", 0.0))
    jitter_yaw = math.radians(float(ragdoll.get("jitter_yaw_deg", 0.0)))
    shift = rng.uniform(-jitter_m, jitter_m, (n_rag, 2))
    yaw = rng.uniform(-1.0, 1.0, n_rag) * jitter_yaw

    local = np.array([p[2:5] for p in parts]) * scale       # [P, 3]
    cos, sin = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    # each ragdoll turned about y through its origin, then moved
    px = cos * local[None, :, 0] + sin * local[None, :, 2]
    pz = -sin * local[None, :, 0] + cos * local[None, :, 2]
    pos = np.stack([px, np.broadcast_to(local[None, :, 1], px.shape), pz],
                   -1) + origins[:, None]
    pos[:, :, 0] += shift[:, :1]
    pos[:, :, 2] += shift[:, 1:]
    euler = np.zeros((n_rag, n_part, 3))
    euler[:, :, 1] = yaw[:, None]
    q_yaw = math3d.quat_from_euler_xyz(torch.as_tensor(
        euler.reshape(n, 3), dtype=torch.float32))
    turn = np.zeros((n_part, 3))
    turn[:, 2] = [p[5] for p in parts]
    q_part = math3d.quat_from_euler_xyz(torch.as_tensor(
        np.tile(turn, (n_rag, 1)), dtype=torch.float32))
    quat = math3d.quat_mul(q_yaw, q_part)

    size_part = np.array([(p[0] * scale, 0.5 * p[1] * scale, 0.0)
                          for p in parts], np.float32)
    inertia = np.array([_capsule_inv_inertia(mass, p[0] * scale,
                                             p[1] * scale) for p in parts])
    alive = np.ones(n, bool)
    parent = np.full(n, -1, np.int32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def f32(v):
        return torch.full((), float(v), dtype=torch.float32, device=device)

    static = StaticScene(
        parent=t(parent, torch.int32),
        level_nodes=t(compute_levels(parent, alive), torch.int32),
        body_type=t(np.full(n, BODY_DYNAMIC), torch.int8),
        shape_type=t(np.full(n, SHAPE_CAPSULE), torch.int8),
        shape_size=t(np.tile(size_part, (n_rag, 1)), torch.float32),
        inv_mass=t(np.full(n, 1.0 / mass), torch.float32),
        inv_inertia_body=t(np.tile(inertia, (n_rag, 1)), torch.float32),
        friction=t(np.full(n, 0.5), torch.float32),
        restitution=t(np.zeros(n), torch.float32),
        layer=t(np.ones(n), torch.int32),
        mask=t(np.full(n, -1), torch.int32),
        trig_entity=t([-1], torch.int32),
        trig_shape=t([0], torch.int8),
        trig_size=t([[1.5, 1.5, 1.5]], torch.float32),
        trig_layer=t([4], torch.int32),
        trig_mask=t([-1], torch.int32),
        trig_one_shot=t([False], torch.bool),
        char_entity=t([-1], torch.int32),
        char_radius=t([cfg.capsule_radius], torch.float32),
        char_half_height=t([cfg.capsule_height * 0.5], torch.float32),
        char_walk_speed=t([cfg.walk_speed], torch.float32),
        char_jump_impulse=t([cfg.jump_impulse], torch.float32),
        gravity=f32(cfg.gravity),
        fixed_dt=f32(cfg.fixed_step),
        step_height=f32(cfg.step_height),
        max_slope_cos=f32(math.cos(math.radians(cfg.max_slope_deg))),
        ground_enabled=torch.ones((), dtype=torch.bool, device=device),
    )
    state = tree_replace(
        make_world_state(n, 1, device=device),
        alive=t(alive, torch.bool),
        comp_mask=t(np.full(n, COMP_TRANSFORM | COMP_COLLIDER
                            | COMP_RIGID_BODY), torch.int32),
        pos=t(pos.reshape(n, 3), torch.float32),
        quat=quat.to(device))

    first = np.arange(n_rag)[:, None] * n_part

    def per_joint(values):
        a = np.asarray(values, np.float64)
        return np.tile(a, (n_rag,) + (1,) * (a.ndim - 1))

    joints = make_joint_set(
        n,
        body_a=(first + [names.index(j[1]) for j in joint_rows]).reshape(-1),
        body_b=(first + [names.index(j[2]) for j in joint_rows]).reshape(-1),
        kind=per_joint([KINDS[j[0]] for j in joint_rows]),
        origin_a=per_joint([np.asarray(j[4]) * scale for j in joint_rows]),
        origin_b=per_joint([np.asarray(j[6]) * scale for j in joint_rows]),
        basis_a=per_joint([euler_zyx(j[3]) for j in joint_rows]),
        basis_b=per_joint([euler_zyx(j[5]) for j in joint_rows]),
        limit_lo=per_joint([j[7][0] for j in joint_rows]),
        limit_hi=per_joint([j[7][1] for j in joint_rows]),
        lin_damping=np.full(n, float(ragdoll["linear_damping"])),
        ang_damping=np.full(n, float(ragdoll["angular_damping"])),
        device=device)
    return RagdollScene(static=static, state=state, joints=joints,
                        ragdolls=n_rag)
