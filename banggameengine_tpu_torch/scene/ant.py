"""IsaacGymEnvs' Ant: worlds of one articulated body, its hinges driven by
motors.

The Ant of ``assets/mjcf/nv_ant.xml`` (IsaacGymEnvs, Makoviychuk et al.
2021): a torso (a sphere and four capsules welded to it) and four legs,
each a thigh on a hip hinge and a shin on an ankle hinge, every hinge
driven by a motor of gear 15.  The description is the benchmark's
``isaacgym-ant4k`` configuration (its ``scene``, z up as in the source):

- ``layout``: ``density``, ``limb_radius``, ``torso_sphere_radius``,
  ``joint_damping``, ``armature``, ``motor_gear``, and ``legs``, a table
  keyed by leg (a ``columns`` entry names its columns and is skipped),
  each ``[hip point, ankle point, foot point, hip axis, hip range (deg),
  ankle axis, ankle range (deg)]``: the torso's welded capsule runs from
  the centre to the hip point, the thigh from the hip to the ankle point,
  the shin from the ankle to the foot point;
- ``start``: ``torso_height``, ``dof_pos_noise`` and ``dof_vel_noise``.

The port's world is y up: a source point ``(x, y, z)`` is the port's
``(x, z, -y)``.  Masses and inertias come from the geoms at the density
(capsules as a cylinder and two hemispheres, the welded capsules counted
in the torso), each hinge's armature folded into its child's inertia
about the hinge's axis.  Only the torso's sphere collides (a capsule of
half height 0); the limbs are capsules along their local y.  Every body
is in one layer whose mask leaves that layer out, so an ant's bodies
meet the ground plane only.  A hinge's frame has its z along the
source's axis and equals its child's at angle 0, the source's reference
pose with every leg flat, so an angle turns right-handed about the
source's axis and the ranges read as the source's.  A world's 9 bodies
are the torso, then each leg's thigh and shin; its 8 joints hip_1,
ankle_1, ..., hip_4, ankle_4, the source's order of degrees of freedom,
so an action's components drive them in that order.

:func:`build_ant_worlds` draws each world's start as ``ant.py``'s
``reset_idx`` does: the torso at ``torso_height``, at rest; each joint at
the bound nearest 0 (``initial_dof_pos``) plus ``U(-dof_pos_noise,
dof_pos_noise)`` rad, clamped to its range; each joint's speed
``U(-dof_vel_noise, dof_vel_noise)`` rad/s; the poses and velocities by
the tree's forward kinematics.  Step them with
``parallel.manyworld.make_many_world_step(..., joints=joints)`` and a
command a joint, the action times the source's power scale.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.ecs.transform import compute_levels
from banggameengine_tpu_torch.physics.joints import (
    HINGE,
    JointSet,
    make_joint_set,
)
from banggameengine_tpu_torch.physics.step import GROUND_FRICTION
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

ANT_LAYER = 1 << 3  # an ant's bodies: one layer, left out of its mask

# the source's z-up point (x, y, z) is the port's (x, z, -y)
Y_UP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])


@dataclasses.dataclass
class AntWorlds:
    static: StaticScene   # one world of 9 bodies
    state: WorldState     # [W, 9, ...] each world's start
    joints: JointSet      # one world's 8 motor hinges
    tables: dict          # the joint table as make_joint_set takes it


def _legs(layout: dict) -> list:
    return [v for k, v in layout["legs"].items() if k != "columns"]


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def capsule_mass(density: float, r: float, length: float) -> float:
    """A capsule's mass: its cylinder of ``length`` and its two
    hemispheres of radius ``r``."""
    return density * math.pi * r * r * (length + 4.0 * r / 3.0)


def capsule_inertia(density: float, r: float, length: float):
    """(about the axis, about a perpendicular through the centre) of a
    capsule: the cylinder's plus the hemispheres' (each at 3r/8 from its
    flat face, shifted to the centre)."""
    mc = density * math.pi * r * r * length
    ms = density * 4.0 / 3.0 * math.pi * r ** 3
    axial = mc * r * r / 2.0 + ms * 2.0 * r * r / 5.0
    perp = (mc * (length * length / 12.0 + r * r / 4.0)
            + ms * (2.0 * r * r / 5.0 + length * length / 4.0
                    + 3.0 * length * r / 8.0))
    return axial, perp


def _capsule_tensor(density, r, a, b, about):
    """A capsule's mass and inertia tensor about the point ``about``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    length = float(np.linalg.norm(b - a))
    m = capsule_mass(density, r, length)
    axial, perp = capsule_inertia(density, r, length)
    d = _unit(b - a)
    i = perp * (np.eye(3) - np.outer(d, d)) + axial * np.outer(d, d)
    c = 0.5 * (a + b) - np.asarray(about, np.float64)
    return m, i + m * (c @ c * np.eye(3) - np.outer(c, c))


def _frame(x, y) -> np.ndarray:
    """The rotation whose columns are ``x``, ``y`` and ``x`` cross ``y``."""
    x, y = _unit(x), _unit(y)
    return np.stack([x, y, np.cross(x, y)], axis=1)


def ant_body(layout: dict) -> dict:
    """One ant at the source's reference pose (every leg flat), z up, as
    float64 numpy: each body's ``mass``, principal ``inertia`` (in its
    own frame), centre ``com`` and frame ``rot`` (the body's axes as
    columns; a limb's y along its capsule, its x along its parent
    hinge's axis), ``radius`` and capsule ``half_height``; each joint's
    ``parent``, ``child``, ``anchor``, ``axis`` and range ``lo``, ``hi``
    (rad)."""
    rho = float(layout["density"])
    r = float(layout["limb_radius"])
    arm = float(layout["armature"])
    legs = _legs(layout)
    rs = float(layout["torso_sphere_radius"])
    torso_m = rho * 4.0 / 3.0 * math.pi * rs ** 3
    torso_i = 2.0 / 5.0 * torso_m * rs * rs * np.eye(3)
    for leg in legs:
        m, i = _capsule_tensor(rho, r, (0, 0, 0), leg[0], (0, 0, 0))
        torso_m, torso_i = torso_m + m, torso_i + i
    if np.abs(torso_i - np.diag(np.diag(torso_i))).max() > 1e-12:
        raise ValueError("the torso's welded capsules are not symmetric")
    bodies = [dict(mass=torso_m, inertia=np.diag(torso_i), com=np.zeros(3),
                   rot=np.eye(3), radius=rs, half_height=0.0)]
    joints = []
    for leg in legs:
        hip, ankle, foot = (np.asarray(p, np.float64) for p in leg[:3])
        for a, b, axis, rng in ((hip, ankle, leg[3], leg[4]),
                                (ankle, foot, leg[5], leg[6])):
            length = float(np.linalg.norm(b - a))
            axial, perp = capsule_inertia(rho, r, length)
            parent = 0 if a is hip else len(bodies) - 1
            joints.append(dict(parent=parent, child=len(bodies), anchor=a,
                               axis=_unit(axis),
                               lo=math.radians(rng[0]),
                               hi=math.radians(rng[1])))
            # the armature turns with the hinge: the child's x
            bodies.append(dict(mass=capsule_mass(rho, r, length),
                               inertia=np.array([perp + arm, axial, perp]),
                               com=0.5 * (a + b), rot=_frame(axis, b - a),
                               radius=r, half_height=0.5 * length))
    return dict(bodies=bodies, joints=joints)


def joint_tables(body: dict, layout: dict) -> dict:
    """The joint table (:func:`physics.joints.make_joint_set`'s
    arguments, numpy) of one ant: each hinge's frame z along its axis and
    x along its child's capsule, equal in both bodies at the reference
    pose; its anchor in each body's frame; its range, gear and joint
    damping."""
    js, bs = body["joints"], body["bodies"]
    out = {k: [] for k in ("body_a", "body_b", "origin_a", "origin_b",
                           "basis_a", "basis_b", "limit_lo", "limit_hi")}
    for j in js:
        pa, ch = bs[j["parent"]], bs[j["child"]]
        frame = np.stack([ch["rot"][:, 1], np.cross(j["axis"],
                                                    ch["rot"][:, 1]),
                          j["axis"]], axis=1)
        for side, b in (("a", pa), ("b", ch)):
            out["origin_" + side].append(b["rot"].T @ (j["anchor"]
                                                       - b["com"]))
            out["basis_" + side].append(b["rot"].T @ frame)
        out["body_a"].append(j["parent"])
        out["body_b"].append(j["child"])
        out["limit_lo"].append(j["lo"])
        out["limit_hi"].append(j["hi"])
    n = len(js)
    tables = {k: np.asarray(v) for k, v in out.items()}
    tables.update(kind=np.full(n, HINGE),
                  gear=np.full(n, float(layout["motor_gear"])),
                  joint_damping=np.full(n, float(layout["joint_damping"])))
    return tables


def _rot(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] of ``angle`` about unit ``axis``."""
    k = torch.zeros(axis.shape[:-1] + (3, 3), dtype=axis.dtype,
                    device=axis.device)
    k[..., 0, 1], k[..., 0, 2] = -axis[..., 2], axis[..., 1]
    k[..., 1, 0], k[..., 1, 2] = axis[..., 2], -axis[..., 0]
    k[..., 2, 0], k[..., 2, 1] = -axis[..., 1], axis[..., 0]
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None,
                                                              None]
    return torch.eye(3, dtype=axis.dtype, device=axis.device) + s * k + (
        1.0 - c) * (k @ k)


def start_poses(body: dict, start: dict, num_worlds: int, seed: int,
                device) -> dict:
    """Each world's start, z up, by forward kinematics from joint angles
    and speeds drawn as ``reset_idx`` draws them (see the module
    docstring): ``pos``, ``rot`` [W, 9, 3(, 3)], ``lin_vel``, ``ang_vel``
    [W, 9, 3] (float64) and the joint ``angle`` [W, 8]."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    js, bs = body["joints"], body["bodies"]
    w, f64 = num_worlds, dict(dtype=torch.float64, device=device)
    lo = torch.tensor([j["lo"] for j in js], **f64)
    hi = torch.tensor([j["hi"] for j in js], **f64)
    rest = torch.where(lo > 0, lo, torch.where(hi < 0, hi, 0.0))
    noise = float(start["dof_pos_noise"])
    q = torch.minimum(torch.maximum(
        rest + noise * (2 * torch.rand((w, len(js)), generator=g, **f64)
                        - 1), lo), hi)
    qd = float(start["dof_vel_noise"]) * (
        2 * torch.rand((w, len(js)), generator=g, **f64) - 1)
    nb = len(bs)
    pos = torch.zeros((w, nb, 3), **f64)
    rot = torch.eye(3, **f64).repeat(w, nb, 1, 1)   # world turn of each body
    lin = torch.zeros((w, nb, 3), **f64)
    ang = torch.zeros((w, nb, 3), **f64)
    pos[:, 0, 2] = float(start["torso_height"])
    ref_com = torch.tensor(np.stack([b["com"] for b in bs]), **f64)
    for k, j in enumerate(js):     # parents come before their children
        p, c = j["parent"], j["child"]
        anchor0 = torch.tensor(j["anchor"], **f64)
        axis = rot[:, p] @ torch.tensor(j["axis"], **f64)       # [W, 3]
        anchor = pos[:, p] + rot[:, p] @ (anchor0 - ref_com[p])
        rot[:, c] = _rot(axis, q[:, k]) @ rot[:, p]
        pos[:, c] = anchor + rot[:, c] @ (ref_com[c] - anchor0)
        ang[:, c] = ang[:, p] + qd[:, k, None] * axis
        v_anchor = lin[:, p] + torch.cross(ang[:, p], anchor - pos[:, p],
                                           dim=-1)
        lin[:, c] = v_anchor + torch.cross(ang[:, c], pos[:, c] - anchor,
                                           dim=-1)
    body_rot = torch.tensor(np.stack([b["rot"] for b in bs]), **f64)
    return dict(pos=pos, rot=rot @ body_rot, lin_vel=lin, ang_vel=ang,
                angle=q)


def build_ant_worlds(scene: dict, physics: dict, num_worlds: int | None = None,
                     seed: int = 0, device: torch.device | str = "cuda"
                     ) -> AntWorlds:
    """``num_worlds`` ants (default ``scene["num_worlds"]``) on
    ``device``: one world's scene and joints, and every world's start
    drawn from ``seed`` (see the module docstring).  ``physics`` gives
    ``gravity``, ``fixed_dt``, ``friction`` (the ground's: a body's
    friction is set so that the port's ground contact, which scales it
    by :data:`physics.step.GROUND_FRICTION`, reads it) and
    ``restitution``."""
    layout = scene["layout"]
    w = int(scene["num_worlds"] if num_worlds is None else num_worlds)
    body = ant_body(layout)
    bs = body["bodies"]
    n = len(bs)
    turn = torch.tensor(Y_UP, dtype=torch.float64, device=device)
    start = start_poses(body, scene["start"], w, seed, device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def f32(v):
        return torch.full((), float(v), dtype=torch.float32, device=device)

    def up(v):                     # z-up vectors [..., 3] into the port's
        return (v @ turn.T).to(torch.float32)

    parent = np.full(n, -1, np.int32)
    alive = np.ones(n, bool)
    static = StaticScene(
        parent=t(parent, torch.int32),
        level_nodes=t(compute_levels(parent, alive), torch.int32),
        body_type=t(np.full(n, BODY_DYNAMIC), torch.int8),
        shape_type=t(np.full(n, SHAPE_CAPSULE), torch.int8),
        shape_size=t([(b["radius"], b["half_height"], 0.0) for b in bs],
                     torch.float32),
        inv_mass=t([1.0 / b["mass"] for b in bs], torch.float32),
        inv_inertia_body=t([1.0 / b["inertia"] for b in bs], torch.float32),
        friction=t(np.full(n, float(physics["friction"]) / GROUND_FRICTION),
                   torch.float32),
        restitution=t(np.full(n, float(physics["restitution"])),
                      torch.float32),
        layer=t(np.full(n, ANT_LAYER), torch.int32),
        mask=t(np.full(n, ~ANT_LAYER), torch.int32),
        trig_entity=t([-1], torch.int32),
        trig_shape=t([0], torch.int8),
        trig_size=t([[0.0, 0.0, 0.0]], torch.float32),
        trig_layer=t([0], torch.int32),
        trig_mask=t([0], torch.int32),
        trig_one_shot=t([False], torch.bool),
        char_entity=t([-1], torch.int32),
        char_radius=t([0.0], torch.float32),
        char_half_height=t([0.0], torch.float32),
        char_walk_speed=t([0.0], torch.float32),
        char_jump_impulse=t([0.0], torch.float32),
        gravity=f32(physics["gravity"]),
        fixed_dt=f32(physics["fixed_dt"]),
        step_height=f32(0.0),
        max_slope_cos=f32(1.0),
        ground_enabled=torch.ones((), dtype=torch.bool, device=device),
    )
    one = make_world_state(n, 1, device=device)
    batch = {f.name: getattr(one, f.name).expand(
        (w,) + getattr(one, f.name).shape).clone()
        for f in dataclasses.fields(one)}
    batch.update(
        alive=torch.ones((w, n), dtype=torch.bool, device=device),
        comp_mask=torch.full((w, n), COMP_TRANSFORM | COMP_COLLIDER
                             | COMP_RIGID_BODY, dtype=torch.int32,
                             device=device),
        pos=up(start["pos"]), lin_vel=up(start["lin_vel"]),
        ang_vel=up(start["ang_vel"]),
        quat=math3d.quat_from_mat3((turn @ start["rot"]).to(torch.float32)))
    state = tree_replace(one, **batch)
    tables = joint_tables(body, layout)
    joints = make_joint_set(
        n, **tables, device=device,
        position_iterations=int(physics["joint_position_iterations"]),
        mass_splitting=bool(physics["joint_mass_splitting"]))
    return AntWorlds(static=static, state=state, joints=joints,
                     tables=tables)
