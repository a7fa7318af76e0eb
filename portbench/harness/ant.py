"""IsaacGymEnvs' Ant worlds from a configuration and a seed, the
reference's scene and steps of one world, and a census of the worlds'
state.

:func:`ant_worlds` builds the program's worlds through the port's builder
(``scene/ant.py``): one world's scene and joints, and each world's start
drawn from the seed as ``ant.py``'s ``reset_idx`` draws it.  The
reference takes from the program only what a call carries (the state, the
joints' impulses, the command).

:func:`reference_scene` builds the reference's scene, joint table and
motors of one world here, from the configuration's tables alone: each
body's mass and inertia by slicing its geoms into thin disks at the
density (not the closed forms the builder uses), the welded capsules
added to the torso by the parallel-axis rule, each hinge's armature added
to its child's inertia about the hinge's axis, the joints' anchors,
frames, ranges, gears and damping from the legs' table.  The bodies'
frames are the ones the program's state carries (the builder's
convention, stated in its module): the torso's axes are the source's; a
limb's x runs along its parent hinge's axis, its y along its capsule
(the port's capsule axis), its z is x cross y.  A hinge's frame has its
x along the child's capsule and its z along the hinge's axis.

:func:`step` runs the reference (:mod:`reference.physics.articulated`)
for a call of the program on one world, as :func:`ragdolls.step` does:
``mode="control"`` in bfloat16 storage (the state, the scene, the joint
table, the motors, the impulses and the command), ``"rounding"`` from a
state one rounding away in its positions and its orientations
(:func:`ragdolls.nudged`): the start clamps joints onto their bounds,
where one rounding decides whether a limit row is on.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.harness import ragdolls, refsteps, scenes
from portbench.reference import math3d
from portbench.reference import state as rs
from portbench.reference.ecs.transform import compute_levels
from portbench.reference.physics import articulated
from portbench.reference.physics import joints as jr
from portbench.reference.physics.step import GROUND_FRICTION
from portbench.reference.state import BODY_DYNAMIC, SHAPE_CAPSULE

SLICES = 20_000     # disks a section of a geom is sliced into


def ant_worlds(cfg: dict, seed: int, device):
    """The configuration's worlds: the port's ``AntWorlds`` (one world's
    scene and joints, every world's start)."""
    from banggameengine_tpu_torch.scene.ant import build_ant_worlds

    return build_ant_worlds(cfg["scene"], cfg["physics"], seed=seed,
                            device=device)


def sliced_capsule(density: float, r: float, length: float):
    """(mass, inertia about the axis, about a perpendicular through the
    centre) of a capsule of radius ``r`` whose cylinder is ``length``
    long, summed over thin disks: the cylinder's along its axis, each cap's
    at ``s = length/2 + r sin t`` (radius ``r cos t``) over even steps of
    ``t``, float64."""
    h = (np.arange(SLICES, dtype=np.float64) + 0.5) / SLICES
    t = h * (math.pi / 2)
    s_cap = length / 2 + r * np.sin(t)
    s = np.concatenate([(h - 0.5) * length, s_cap, -s_cap])
    rad = np.concatenate([np.full(SLICES, r), r * np.cos(t), r * np.cos(t)])
    ds = np.concatenate([np.full(SLICES, length / SLICES),
                         np.tile(r * np.cos(t) * (math.pi / 2) / SLICES, 2)])
    dm = density * math.pi * rad ** 2 * ds
    return (float(dm.sum()), float((dm * rad ** 2 / 2).sum()),
            float((dm * (rad ** 2 / 4 + s ** 2)).sum()))


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def reference_bodies(layout: dict) -> dict:
    """One ant at the source's reference pose from the configuration's
    ``layout`` (z up, float64 numpy): per body ``mass``, ``inertia`` (the
    diagonal in its own frame), ``rot`` (its axes as columns), ``com``,
    ``radius``, ``half_height``; per joint ``a``, ``b``, ``anchor``,
    ``axis``, ``frame`` (columns), ``lo``, ``hi`` (rad)."""
    rho = float(layout["density"])
    r = float(layout["limb_radius"])
    legs = [v for k, v in layout["legs"].items() if k != "columns"]
    rs_ = float(layout["torso_sphere_radius"])
    m, _, perp = sliced_capsule(rho, rs_, 0.0)
    torso_m, torso_i = m, perp * np.eye(3)
    for leg in legs:
        tip = np.asarray(leg[0], np.float64)
        m, axial, perp = sliced_capsule(rho, r, float(np.linalg.norm(tip)))
        d, c = _unit(tip), tip / 2
        torso_i = (torso_i + perp * (np.eye(3) - np.outer(d, d))
                   + axial * np.outer(d, d)
                   + m * (c @ c * np.eye(3) - np.outer(c, c)))
        torso_m += m
    bodies = [dict(mass=torso_m, inertia=np.diag(torso_i), rot=np.eye(3),
                   com=np.zeros(3), radius=rs_, half_height=0.0)]
    joints = []
    for leg in legs:
        points = [np.asarray(p, np.float64) for p in leg[:3]]
        for k, (axis, rng) in enumerate(((leg[3], leg[4]),
                                         (leg[5], leg[6]))):
            root, end = points[k], points[k + 1]
            axis = _unit(axis)
            d = _unit(end - root)
            length = float(np.linalg.norm(end - root))
            m, axial, perp = sliced_capsule(rho, r, length)
            joints.append(dict(
                a=0 if k == 0 else len(bodies) - 1, b=len(bodies),
                anchor=root, axis=axis,
                frame=np.stack([d, np.cross(axis, d), axis], axis=1),
                lo=math.radians(rng[0]), hi=math.radians(rng[1])))
            bodies.append(dict(
                mass=m, inertia=np.array([perp + float(layout["armature"]),
                                          axial, perp]),
                rot=np.stack([axis, d, np.cross(axis, d)], axis=1),
                com=(root + end) / 2, radius=r, half_height=length / 2))
    return dict(bodies=bodies, joints=joints)


def reference_scene(cfg: dict, device):
    """The reference's ``(StaticScene, Joints, Motors, sweeps)`` of one
    world, from the configuration alone (see the module docstring)."""
    layout, physics = cfg["scene"]["layout"], cfg["physics"]
    ant = reference_bodies(layout)
    bs, js = ant["bodies"], ant["joints"]
    n = len(bs)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    # no self-collision (the source's collision filter): one layer that
    # the mask leaves out
    static = scenes._static(
        n, {**physics, "capsule_radius": 0.0, "capsule_height": 0.0,
            "walk_speed": 0.0, "jump_impulse": 0.0, "step_height": 0.0,
            "max_slope_deg": 0.0}, device,
        level_nodes=compute_levels(np.full(n, -1, np.int32),
                                   np.ones(n, bool)),
        body_type=np.full(n, BODY_DYNAMIC),
        shape_type=np.full(n, SHAPE_CAPSULE),
        shape_size=[(b["radius"], b["half_height"], 0.0) for b in bs],
        inv_mass=[1.0 / b["mass"] for b in bs],
        inv_inertia_body=[1.0 / b["inertia"] for b in bs],
        friction=np.full(n, float(physics["friction"]) / GROUND_FRICTION),
        layer=np.ones(n), mask=np.full(n, ~1))

    def in_body(j, side):
        body = bs[j[side]]
        return body["rot"].T @ (j["anchor"] - body["com"])

    joints = jr.Joints(
        body_a=torch.as_tensor([j["a"] for j in js], dtype=torch.int32,
                               device=device),
        body_b=torch.as_tensor([j["b"] for j in js], dtype=torch.int32,
                               device=device),
        kind=torch.full((len(js),), jr.HINGE, dtype=torch.int8,
                        device=device),
        origin_a=f32([in_body(j, "a") for j in js]),
        origin_b=f32([in_body(j, "b") for j in js]),
        basis_a=f32([bs[j["a"]]["rot"].T @ j["frame"] for j in js]),
        basis_b=f32([bs[j["b"]]["rot"].T @ j["frame"] for j in js]),
        limit_lo=f32([j["lo"] for j in js]),
        limit_hi=f32([j["hi"] for j in js]),
        lin_damping=torch.zeros(n, device=device),
        ang_damping=torch.zeros(n, device=device))
    motors = articulated.Motors(
        gear=f32(np.full(len(js), float(layout["motor_gear"]))),
        damping=f32(np.full(len(js), float(layout["joint_damping"]))))
    return (rs.StaticScene(**static), joints, motors,
            int(physics["joint_position_iterations"]))


def step(state, static, joints, motors, sweeps, impulse, command,
         steps: int, iterations: int, mode: str = "program"):
    """``steps`` reference steps of one world from ``state`` (reference
    types), the joints' ``impulse`` and the motors' ``command``, the
    anchors held by ``sweeps`` position passes; returns (state,
    impulse)."""
    control = mode == "control"
    if mode == "rounding":
        state = ragdolls.nudged(state)
    if control:
        state, static, joints, motors = (
            refsteps.bf16(state), refsteps.bf16(static),
            refsteps.bf16(joints), refsteps.bf16(motors))
        impulse = impulse.to(torch.bfloat16).to(torch.float32)
        command = command.to(torch.bfloat16).to(torch.float32)
    for _ in range(steps):
        state, impulse, _ = articulated.engine_step(
            state, static, joints, motors, impulse, command, iterations,
            sweeps=sweeps)
        if control:
            state = refsteps.bf16(state)
            impulse = impulse.to(torch.bfloat16).to(torch.float32)
    return state, impulse


def census(state, limit_rows, joints: jr.Joints,
           termination_height: float) -> dict:
    """The worlds' state in numbers (a batched state [W, 9, ...] of either
    side, and the reference's joint table of one world): torso heights and
    the share under the termination height; the joints' anchor gaps (m)
    and angles past their limits (rad); the limit rows on; the share of
    torsos tilted past 37 degrees (where a welded capsule, 0.28 m out and
    0.08 m thick, would reach the ground before the sphere of 0.25 m); the
    bodies' speeds (m/s); whether every float field is finite."""
    pos, quat = state.pos.double(), state.quat.double()
    w = pos.shape[0]
    rot = math3d.quat_to_mat3(quat.float()).double()        # [W, 9, 3, 3]
    a, b = joints.body_a.long(), joints.body_b.long()

    def side(o, body):
        return pos[:, body] + (rot[:, body] @ o.double()[..., None])[..., 0]

    gap = (side(joints.origin_b, b) - side(joints.origin_a, a)).norm(
        dim=-1).reshape(-1)
    fa = rot[:, a] @ joints.basis_a.double()
    fb = rot[:, b] @ joints.basis_b.double()
    angle = torch.atan2((fb[..., 0] * fa[..., 1]).sum(-1),
                        (fb[..., 0] * fa[..., 0]).sum(-1))
    lo, hi = joints.limit_lo.double(), joints.limit_hi.double()
    past = torch.maximum(lo - angle, angle - hi).clamp_min(0.0).reshape(-1)
    height = pos[:, 0, 1]
    # the torso's source z (the port's y) against its own z axis: the
    # torso's axes are the source's, its z the port's y when upright
    up = rot[:, 0, 1, 2]
    tilt = torch.rad2deg(torch.acos(up.clamp(-1.0, 1.0)))
    speed = state.lin_vel.double().norm(dim=-1).reshape(-1)

    def q(x, p):
        return float(torch.quantile(x, p))

    finite = all(bool(torch.isfinite(getattr(state, f.name).double()).all())
                 for f in dataclasses.fields(state)
                 if getattr(state, f.name).is_floating_point())
    return {
        "worlds": w,
        "torso_height_m": [q(height, p) for p in (0.01, 0.5, 0.99)]
        + [float(height.max())],
        "under_termination_share": float((height < termination_height)
                                         .double().mean()),
        "anchor_gap_m": [q(gap, 0.5), q(gap, 0.99), float(gap.max())],
        "past_limit_rad": [q(past, 0.5), q(past, 0.99), float(past.max())],
        "past_limit_share": float((past > 0).double().mean()),
        "limit_rows": int(limit_rows),
        "tilted_past_37deg_share": float((tilt > 37.0).double().mean()),
        "speed_m_s": [q(speed, 0.5), q(speed, 0.99), float(speed.max())],
        "finite": finite,
    }
