"""Bullet's ragdoll pyramid from a configuration and a seed, and the
reference's steps of it.

:func:`ragdoll_pyramid` returns the scene's raw fields, ``(static, state,
joints)``: three dicts of tensors keyed by the field names of the state
types and of the joint table (:class:`reference.physics.joints.Joints`),
so that the program and the reference wrap the same tensors.  The
ragdoll's parts and joints are the configuration's tables (Bullet's
``RagDoll``), every length times ``scale``; the pyramid is
``createTest3``'s.  The seed moves each ragdoll in x and z and turns it
about y through its origin, with one generator on the device.

:func:`step` runs the reference (:mod:`reference.physics.jointed`) for a
call of the program, as :func:`refsteps.step` does for the scenes without
joints: ``mode="control"`` in bfloat16 storage, ``"rounding"`` from a
state one rounding away in its positions and its orientations
(:func:`nudged`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.harness import refsteps, scenes
from portbench.reference import math3d
from portbench.reference.ecs.transform import compute_levels
from portbench.reference.physics import jointed
from portbench.reference.physics import joints as jr
from portbench.reference.state import (
    BODY_DYNAMIC,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    SHAPE_CAPSULE,
)

KINDS = {"hinge": jr.HINGE, "cone_twist": jr.CONE_TWIST}


def euler_zyx(x: float, y: float, z: float) -> np.ndarray:
    """Bullet's ``btMatrix3x3::setEulerZYX(x, y, z)``: Rz(z) Ry(y) Rx(x)."""
    cx, sx, cy, sy = math.cos(x), math.sin(x), math.cos(y), math.sin(y)
    cz, sz = math.cos(z), math.sin(z)
    return np.array([
        [cy * cz, sy * sx * cz - cx * sz, sy * cx * cz + sx * sz],
        [cy * sz, sy * sx * sz + cx * cz, sy * cx * sz - sx * cz],
        [-sy, cy * sx, cy * cx]])


def origins(scene: dict) -> np.ndarray:
    """Each ragdoll's offset, row by row (``createTest3``): f64[R, 3]."""
    out = []
    start = np.asarray(scene["row_start"], np.float64)
    step = np.asarray(scene["row_step"], np.float64)
    pitch = float(scene["ragdoll_pitch_x"])
    for k, size in enumerate(range(int(scene["size"]), 0, -1)):
        for i in range(size):
            out.append(start + k * step
                       + [-0.5 * size * pitch + i * pitch, 0.0, 0.0])
    return np.asarray(out)


def ragdoll_pyramid(scene: dict, physics: dict, seed: int, device):
    """The configuration's pyramid: ``(static, state, joints)`` raw
    fields."""
    parts = {k: v for k, v in scene["parts"].items() if k != "columns"}
    names = list(parts)
    table = np.asarray([parts[k] for k in names], np.float64)   # [P, 6]
    scale = float(scene["scale"])
    base = origins(scene)
    n_rag, n_part = len(base), len(names)
    n = n_rag * n_part

    g = scenes.generator(seed, device, stream=1)
    jit = float(scene["jitter_m"])
    yaw_max = math.radians(float(scene["jitter_yaw_deg"]))
    shift = scenes.uniform(g, (n_rag, 2), -jit, jit, device)
    yaw = scenes.uniform(g, n_rag, -yaw_max, yaw_max, device)

    local = torch.as_tensor(table[:, 2:5] * scale, dtype=torch.float32,
                            device=device)                    # [P, 3]
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    pos = torch.stack([c * local[:, 0] + s * local[:, 2],
                       local[:, 1].expand(n_rag, n_part),
                       -s * local[:, 0] + c * local[:, 2]], -1)
    pos = pos + torch.as_tensor(base, dtype=torch.float32,
                                device=device)[:, None]
    pos[..., 0] += shift[:, :1]
    pos[..., 2] += shift[:, 1:]
    zeros = torch.zeros(n_rag, device=device)
    q_yaw = math3d.quat_from_euler_xyz(torch.stack([zeros, yaw, zeros], -1))
    turn = torch.zeros((n_part, 3), device=device)
    turn[:, 2] = torch.as_tensor(table[:, 5], dtype=torch.float32,
                                 device=device)
    q_turn = math3d.quat_from_euler_xyz(turn)
    quat = math3d.quat_mul(q_yaw[:, None].expand(n_rag, n_part, 4),
                           q_turn[None].expand(n_rag, n_part, 4))

    mass = float(scene["mass"])
    radius, height = table[:, 0] * scale, table[:, 1] * scale
    size = np.stack([radius, 0.5 * height, np.zeros(n_part)], -1)
    inertia = np.asarray([scenes.box_inv_inertia(mass, (r, r + 0.5 * h, r))
                          for r, h in zip(radius, height)])
    alive = np.ones(n, bool)
    static = scenes._static(
        n, physics, device,
        level_nodes=compute_levels(np.full(n, -1, np.int32), alive),
        body_type=np.full(n, BODY_DYNAMIC),
        shape_type=np.full(n, SHAPE_CAPSULE),
        shape_size=np.tile(size, (n_rag, 1)),
        inv_mass=np.full(n, 1.0 / mass),
        inv_inertia_body=np.tile(inertia, (n_rag, 1)),
        layer=np.ones(n), mask=np.full(n, -1))
    comp = torch.full((n,), COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY,
                      dtype=torch.int32, device=device)
    state = scenes._state(n, device, torch.ones(n, dtype=torch.bool,
                                                device=device),
                          comp, pos.reshape(n, 3), quat.reshape(n, 4))

    rows = [v for k, v in scene["joints"].items() if k != "columns"]
    first = np.arange(n_rag)[:, None] * n_part

    def per_joint(values, dtype):
        a = np.asarray(values, np.float64)
        return torch.as_tensor(np.tile(a, (n_rag,) + (1,) * (a.ndim - 1)),
                               dtype=dtype, device=device)

    def body(col):
        ids = first + [names.index(r[col]) for r in rows]
        return torch.as_tensor(ids.reshape(-1), dtype=torch.int32,
                               device=device)

    joints = dict(
        body_a=body(1), body_b=body(2),
        kind=per_joint([KINDS[r[0]] for r in rows], torch.int8),
        origin_a=per_joint([np.asarray(r[4]) * scale for r in rows],
                           torch.float32),
        origin_b=per_joint([np.asarray(r[6]) * scale for r in rows],
                           torch.float32),
        basis_a=per_joint([euler_zyx(*r[3]) for r in rows], torch.float32),
        basis_b=per_joint([euler_zyx(*r[5]) for r in rows], torch.float32),
        limit_lo=per_joint([r[7][0] for r in rows], torch.float32),
        limit_hi=per_joint([r[7][1] for r in rows], torch.float32),
        lin_damping=torch.full((n,), float(scene["linear_damping"]),
                               device=device),
        ang_damping=torch.full((n,), float(scene["angular_damping"]),
                               device=device))
    return static, state, joints


def nudged(state):
    """``state`` one rounding away: every other entity's position one
    float32 step up (:func:`refsteps.nudged`) and every component of each
    body's quaternion one float32 step up.  The joints' limit rows are
    decided by the orientations alone: the source's pose puts the knees,
    the elbows and the hips exactly on a bound, and a seed's turn of a
    whole ragdoll leaves them there to within a rounding, where that step
    decides whether a row is on."""
    state = refsteps.nudged(state)
    quat = torch.nextafter(state.quat,
                           torch.full_like(state.quat, float("inf")))
    return dataclasses.replace(state, quat=quat)


def step(state, static, joints, impulse, steps: int, iterations: int,
         max_neighbors: int, mode: str = "program"):
    """``steps`` reference steps from ``state`` (reference types) and the
    joints' ``impulse``; returns (state, impulse, the limit rows at their
    bound in the last step)."""
    control = mode == "control"
    if mode == "rounding":
        state = nudged(state)
    if control:
        state, static, joints = (refsteps.bf16(state), refsteps.bf16(static),
                                 refsteps.bf16(joints))
        impulse = impulse.to(torch.bfloat16).to(torch.float32)
    limits = torch.zeros((), dtype=torch.int32)
    for _ in range(steps):
        state, impulse, limits = jointed.engine_step(
            state, static, joints, impulse, iterations, max_neighbors)
        if control:
            state = refsteps.bf16(state)
            impulse = impulse.to(torch.bfloat16).to(torch.float32)
    return state, impulse, limits


def joints_of(raw: dict) -> jr.Joints:
    """The reference's joint table from the raw fields (cloned)."""
    return jr.Joints(**{f.name: raw[f.name].clone()
                        for f in dataclasses.fields(jr.Joints)})
