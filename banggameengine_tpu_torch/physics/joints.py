"""Joints of the dense route: hinges and cone-twists as rows of the unified
Jacobi solve, and per-body damping.

The JAX package has no joints: this module is the port's own design.  A
scene's joints travel as a :class:`JointSet` (the joint table, its frames
and limits, each body's damping and its joints), their impulses from step
to step as a :class:`JointState`; both are given to
:func:`physics.step.physics_step` and the step factories beside the
scene, and a scene without them steps as it did before joints existed.

Joint ``j`` joins bodies ``a`` and ``b`` at the anchors ``oA``, ``oB``
with the frames ``MA``, ``MB`` (rotations in each body's frame).  Per
step, from the body poses: ``rA = Ra oA``, ``pA = xa + rA`` (b likewise)
and the world frames ``FA = Ra MA``, ``FB = Rb MB``.  Each row ``r`` is a
Jacobian (``jl``: the linear part, +jl on b and -jl on a; ``ja``, ``jb``:
the angular parts on a and b), a target speed and, for a one-sided row,
the floor 0 on its impulse:

- rows 0-2, the point: for d = world x, y, z, ``jl = d``, ``ja = -(rA x
  d)``, ``jb = rB x d``, driven to ``-(ERP/dt) d.(pB - pA)``, ERP being
  Bullet's global 0.2;
- rows 3-4, a hinge's axes: the hinge axis is the frame's z, ``aA = FA
  ez``, ``aB = FB ez``; along ``u = FA ex`` and ``FA ey``, ``ja = -u``,
  ``jb = u``, driven to ``-(ERP/dt) u.(aA x aB)``;
- row 5, a hinge's limit: ``theta = atan2(FB ex . FA ey, FB ex . FA ex)``;
  below ``lo`` the row ``ja = -aA``, ``jb = aA`` is driven to ``(0.3/dt)
  (lo - theta)``, above ``hi`` the row of the other sign to ``(0.3/dt)
  (theta - hi)``; a cone-twist's swing: with ``tA = FA ex``, ``tB = FB
  ex``, ``phi = acos(tA . tB)`` past the span ``s``, the row along ``n =
  (tA x tB)/|tA x tB|``, ``ja = n``, ``jb = -n``, driven to ``(0.3/dt)
  (phi - s)``;
- row 6, a cone-twist's twist: ``psi`` in [0, pi], the angle of the twist
  part about x of ``FA^-1 FB`` once the swing is taken out (the
  quaternion's swing-twist split), with its axis ``+-tB``; past the span
  ``t``, ``ja = axis``, ``jb = -axis``, driven to ``(0.3/dt) (psi - t)``.

0.3 is Bullet's ``setLimit`` bias factor; its softness and relaxation are
left out.  The rows join the contacts' mass-splitting Jacobi iterations
(:func:`solver.solve_contacts_unified`): each iteration moves a joint's
active rows together, from the velocities at its start, by ``K^-1
(target - J v)``, ``K = J M^-1 J^T`` being the effective mass of the
joint's active rows against each other (a point's three rows are coupled
through the lever arms, and one row at a time lets such a chain diverge),
then takes the heavy-ball step and the floor of a one-sided row, and adds
the change of impulse to both bodies divided by each body's split, its
contacts and joints counted.  The rows are warm-started from the last
step's impulses by Bullet's warm-starting factor.  Bullet solves them by
sequential impulses; the Jacobi solve is this port's departure.

A set with ``mass_splitting`` solves its rows by Tonge et al.'s mass
splitting (2012) instead: ``K`` takes each body's inverse mass and
inertia times its split, and both bodies take the change of impulse
whole, so a joint's impulses are equal and opposite and the iteration
converges whatever the bodies' masses.  Dividing each side by its own
split, as above, gives a joint between bodies of unequal splits unequal
impulses, and at the Ant's mass and inertia ratios (a torso of 0.48 kg
on legs of 0.04-0.07 kg whose inertia about their own axis is 2e-4 kg
m^2) the iteration diverges in some worlds; the ragdolls, equal masses,
keep the first form.

Per-body damping is Bullet's ``applyDamping``, after gravity and before
the contact phase: ``v *= (1 - d)^dt`` on the dynamic bodies.

Motors drive hinges (a cone-twist has none).  A hinge's ``gear`` is the
torque of a unit command and its ``joint_damping`` the torque against a
rad/s of relative spin (MuJoCo's ``gear`` and joint ``damping``); each
step takes a command ``u`` a joint.  After the bodies' damping and before
the contact phase (:func:`apply_motors`), about the hinge's world axis
``a = FA ez``, the torque ``tau = gear u - joint_damping ((wb - wa) .
a)`` turns b and, equal and opposite, a: ``wb += dt Ib^-1 tau a``, ``wa
-= dt Ia^-1 tau a``, every joint's torque from the same velocities.  A
set runs its motors exactly when some gear or joint damping is not zero
(``JointSet.motored``, read once when the set is built); such a set's
step needs a command, and a set without motors takes none.

A set may also hold its joints by position (``position_iterations``,
PhysX TGS's position iterations and Box2D's position solve; zero: none).
After the integration, each sweep moves every joint's anchors together
from the poses at its start: with ``C = pB - pA`` and ``K = (1/ma + 1/mb)
E - [rA]x IA^-1 [rA]x - [rB]x IB^-1 [rB]x`` (``[r]x`` the cross-product
matrix, the world inverse inertias at the integrated poses), the
correction is ``P = -K^-1 C``; b moves by ``P / mb`` and turns by ``IB^-1
(rB x P)``, a by the opposite, each divided by the body's joint count
(the split, as in the velocity solve), dynamic bodies only.  The
velocities are left as the solve made them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.physics.solver import (
    BAUMGARTE,
    WARM_START_FACTOR,
    _matvec,
    compaction_index,
    inv_inertia_world,
)

Tensor = torch.Tensor

HINGE = 0
CONE_TWIST = 1
ROWS = 7            # 3 point, 2 hinge axes, the limit or swing, the twist
LIMIT_BIAS = 0.3    # Bullet's setLimit default bias factor
_LIMIT_ROW = 5      # rows 5 and 6 are one-sided


@dataclasses.dataclass
class JointSet:
    """The joints of a scene of N bodies (J joints), and each body's
    damping.  Build it with :func:`make_joint_set`."""

    body_a: Tensor        # int32[J]
    body_b: Tensor        # int32[J]
    kind: Tensor          # int8[J] HINGE | CONE_TWIST
    origin_a: Tensor      # f32[J, 3] anchor in a's body frame
    origin_b: Tensor      # f32[J, 3]
    frame_a: Tensor       # f32[J, 4] joint frame in a's body frame (xyzw)
    frame_b: Tensor       # f32[J, 4]
    limit_lo: Tensor      # f32[J] hinge: lower angle; cone-twist: swing span
    limit_hi: Tensor      # f32[J] hinge: upper angle; cone-twist: twist span
    lin_damping: Tensor   # f32[N]
    ang_damping: Tensor   # f32[N]
    # each body's joints as rows of the stacked [a sides; b sides; zero]
    # impulse table: j (the body is j's a), J + j (its b), 2J (no joint)
    body_rows: Tensor     # int32[N, JB]
    gear: Tensor          # f32[J] a hinge motor's torque a unit command
    joint_damping: Tensor  # f32[J] torque a rad/s of the hinge's spin
    motored: bool         # some gear or joint damping is not zero
    position_iterations: int  # sweeps of the position pass (0: none)
    mass_splitting: bool  # the rows solved by Tonge et al.'s splitting

    @property
    def num_joints(self) -> int:
        return self.body_a.shape[-1]


@dataclasses.dataclass
class JointState:
    """What the joints carry from step to step."""

    impulse: Tensor       # f32[J, ROWS] the rows' accumulated impulses
    limit_rows: Tensor    # int32[] the limit rows at their bound last step


def make_joint_set(capacity: int, body_a, body_b, kind, origin_a, origin_b,
                   basis_a, basis_b, limit_lo, limit_hi, lin_damping=None,
                   ang_damping=None, gear=None, joint_damping=None,
                   position_iterations: int = 0,
                   mass_splitting: bool = False, device=None) -> JointSet:
    """A :class:`JointSet` of ``capacity`` bodies from the joint table
    (arrays or tensors; ``basis_a``/``basis_b`` f32[J, 3, 3], the frames'
    axes as columns in each body's frame), the bodies' damping, the
    hinges' motors (``gear``, ``joint_damping``; zero where None, and
    ValueError on a cone-twist), the sweeps of the position pass and the
    solve's form (see the module docstring).
    Reads each body's joint count, and whether any motor is set, to the
    host once."""
    device = torch.device(device or "cpu")

    def t(x, dtype):
        if not torch.is_tensor(x):
            x = np.asarray(x)
        return torch.as_tensor(x, dtype=dtype, device=device)

    a, b = t(body_a, torch.int32), t(body_b, torch.int32)
    j = a.shape[0]
    if ((a < 0) | (a >= capacity) | (b < 0) | (b >= capacity)
            | (a == b)).any():
        raise ValueError("a joint joins two distinct bodies of the scene")
    sides = torch.cat([a, b]).to(torch.int64)                  # [2J]
    touches = (torch.arange(capacity, device=device)[:, None]
               == sides[None, :])                              # [N, 2J]
    width = max(1, int(touches.sum(dim=1).max()) if j else 1)
    src, valid, _ = compaction_index(touches, width)
    body_rows = torch.where(valid, src, 2 * j).to(torch.int32)
    zeros = torch.zeros(capacity, dtype=torch.float32, device=device)
    kinds = t(kind, torch.int8)
    motor = [torch.zeros(j, dtype=torch.float32, device=device) if m is None
             else t(m, torch.float32) for m in (gear, joint_damping)]
    motored = (motor[0] != 0) | (motor[1] != 0)
    if (motored & (kinds != HINGE)).any():
        raise ValueError("a motor drives a hinge; a cone-twist takes none")
    if position_iterations < 0:
        raise ValueError("position_iterations counts sweeps: 0 or more")
    return JointSet(
        body_a=a, body_b=b, kind=kinds,
        origin_a=t(origin_a, torch.float32),
        origin_b=t(origin_b, torch.float32),
        frame_a=math3d.quat_from_mat3(t(basis_a, torch.float32)),
        frame_b=math3d.quat_from_mat3(t(basis_b, torch.float32)),
        limit_lo=t(limit_lo, torch.float32),
        limit_hi=t(limit_hi, torch.float32),
        lin_damping=(zeros if lin_damping is None
                     else t(lin_damping, torch.float32)),
        ang_damping=(zeros.clone() if ang_damping is None
                     else t(ang_damping, torch.float32)),
        body_rows=body_rows, gear=motor[0], joint_damping=motor[1],
        motored=bool(motored.any()),
        position_iterations=int(position_iterations),
        mass_splitting=bool(mass_splitting))


def make_joint_state(joints: JointSet,
                     num_worlds: int | None = None) -> JointState:
    """Zero impulses: the joints' state before the first step, f32[J, 7],
    or with ``num_worlds`` a [W, J, 7] batch (the many-world steps')."""
    dev = joints.body_a.device
    lead = () if num_worlds is None else (num_worlds,)
    return JointState(
        impulse=torch.zeros(lead + (joints.num_joints, ROWS),
                            dtype=torch.float32, device=dev),
        limit_rows=torch.zeros((), dtype=torch.int32, device=dev))


def apply_damping(vel: Tensor, ang: Tensor, is_dynamic: Tensor,
                  joints: JointSet, dt: Tensor) -> tuple[Tensor, Tensor]:
    """Bullet's ``applyDamping``: ``v *= (1 - d)^dt`` on dynamic bodies."""
    lin_f = torch.pow(1.0 - joints.lin_damping, dt)
    ang_f = torch.pow(1.0 - joints.ang_damping, dt)
    dyn = is_dynamic[:, None]
    return (torch.where(dyn, vel * lin_f[:, None], vel),
            torch.where(dyn, ang * ang_f[:, None], ang))


def apply_motors(ang: Tensor, quat: Tensor, inv_inertia_body: Tensor,
                 is_dynamic: Tensor, joints: JointSet, command: Tensor,
                 dt: Tensor) -> Tensor:
    """The hinges' motors (see the module docstring): ``ang`` with each
    dynamic body turned by ``dt I^-1`` times the torques of its joints
    under ``command`` f32[J], all from the same velocities."""
    a = joints.body_a.to(torch.int64)
    b = joints.body_b.to(torch.int64)
    ez = torch.zeros_like(joints.origin_a)
    ez[:, 2] = 1.0
    axis = math3d.quat_rotate(math3d.quat_mul(quat[a], joints.frame_a), ez)
    spin = _dot(ang[b] - ang[a], axis)
    torque = (joints.gear * command - joints.joint_damping * spin)[:, None] \
        * axis
    table = torch.cat([-torque, torque, torch.zeros_like(torque[:1])])
    per_body = table[joints.body_rows.to(torch.int64)].sum(dim=1)
    turn = _matvec(inv_inertia_world(quat, inv_inertia_body), per_body)
    return torch.where(is_dynamic[:, None], ang + dt * turn, ang)


def project_joints(pos: Tensor, quat: Tensor, is_dynamic: Tensor,
                   alive: Tensor, inv_mass: Tensor, inv_inertia_body: Tensor,
                   joints: JointSet) -> tuple[Tensor, Tensor]:
    """The position pass (see the module docstring): ``pos`` and ``quat``
    after ``joints.position_iterations`` sweeps, each moving every live
    joint's anchors together from the poses at the sweep's start."""
    a = joints.body_a.to(torch.int64)
    b = joints.body_b.to(torch.int64)
    live = (alive[a] & alive[b])[:, None]
    inv_m = torch.where(is_dynamic, inv_mass, 0.0)
    inv_i = torch.where(is_dynamic[:, None, None],
                        inv_inertia_world(quat, inv_inertia_body), 0.0)
    ia, ib = inv_i[a], inv_i[b]
    body_rows = joints.body_rows.to(torch.int64)
    split = (body_rows < 2 * a.shape[0]).sum(dim=1).clamp_min(1)[:, None]
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    for _ in range(joints.position_iterations):
        r_a = math3d.quat_rotate(quat[a], joints.origin_a)
        r_b = math3d.quat_rotate(quat[b], joints.origin_b)
        gap = (pos[b] + r_b) - (pos[a] + r_a)
        sa, sb = _skew(r_a), _skew(r_b)
        k = ((inv_m[a] + inv_m[b])[:, None, None] * eye
             - _matmul(_matmul(sa, ia), sa) - _matmul(_matmul(sb, ib), sb))
        p = torch.where(live, -_matvec(_spd_inverse(k), gap), 0.0)
        table = torch.cat([torch.cat([-p, -_cross(r_a, p)], dim=1),
                           torch.cat([p, _cross(r_b, p)], dim=1),
                           torch.zeros_like(p[:1, :1]).expand(1, 6)], dim=0)
        per_body = table[body_rows].sum(dim=1) / split      # [N, 6]
        pos = pos + inv_m[:, None] * per_body[:, :3]
        turn = _matvec(inv_i, per_body[:, 3:])
        quat = torch.where(is_dynamic[:, None], math3d.quat_integrate(
            quat, turn, torch.ones((), dtype=pos.dtype, device=pos.device)),
            quat)
    return pos, quat


def _matmul(m: Tensor, n: Tensor) -> Tensor:
    """``m @ n`` of [..., 3, 3] matrices as multiplies and a sum."""
    return (m[..., :, :, None] * n[..., None, :, :]).sum(dim=-2)


def _skew(r: Tensor) -> Tensor:
    """[..., 3, 3]: the matrices of ``v -> r x v``."""
    z = torch.zeros_like(r[..., 0])
    x, y, w = r.unbind(-1)
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def jointed_pairs(joints: JointSet, n: int) -> Tensor:
    """bool[N, N]: the pairs a joint joins, both ways (Bullet's
    ``addConstraint(c, true)`` leaves them out of the contacts)."""
    a = joints.body_a.to(torch.int64)
    b = joints.body_b.to(torch.int64)
    out = torch.zeros((n, n), dtype=torch.bool, device=a.device)
    on = torch.ones_like(a, dtype=torch.bool)
    out.index_put_((a, b), on)
    out.index_put_((b, a), on)
    return out


class JointRows(NamedTuple):
    """One step's joint rows, set up from the poses (:func:`joint_rows`)."""

    a: Tensor             # int64[J]
    b: Tensor             # int64[J]
    jl: Tensor            # f32[J, ROWS, 3] linear Jacobian (+ on b, - on a)
    ja: Tensor            # f32[J, ROWS, 3] angular Jacobian on a
    jb: Tensor            # f32[J, ROWS, 3] angular Jacobian on b
    inv_k: Tensor         # f32[J, ROWS, ROWS] the rows' effective mass
    target: Tensor        # f32[J, ROWS] target speed
    floor: Tensor         # f32[J, ROWS] 0 (one-sided) or -inf
    active: Tensor        # bool[J, ROWS]
    warm: Tensor          # f32[J, ROWS] the warm-start impulses
    limit_rows: Tensor    # int32[] active limit, swing and twist rows
    body_rows: Tensor     # int64[N, JB] (JointSet.body_rows)
    count: Tensor         # f32[N] joints of each body (the split's share)
    mass_splitting: bool  # impulses whole on both bodies (JointSet's)

    def update(self, v: Tensor, w: Tensor, lam: Tensor, plam: Tensor,
               momentum: float) -> Tensor:
        """One Jacobi update of every joint's active rows together from the
        velocities ``v``, ``w``: ``lam + K^-1 (target - J v)``, the
        heavy-ball step over the iterates (``plam`` the one before
        ``lam``), the floor of the one-sided rows.  Inactive rows keep
        ``lam``."""
        vw = torch.cat([v, w], dim=1)
        vwa, vwb = vw[self.a], vw[self.b]
        jv = (_dot(self.jl, (vwb[:, :3] - vwa[:, :3])[:, None])
              + _dot(self.ja, vwa[:, None, 3:])
              + _dot(self.jb, vwb[:, None, 3:]))
        res = torch.where(self.active, self.target - jv, 0.0)
        new = torch.maximum(lam + _dot(self.inv_k, res[:, None]),
                            self.floor)
        if momentum:
            new = torch.maximum(new + momentum * (new - plam), self.floor)
        return torch.where(self.active, new, lam)

    def body_impulse(self, dl: Tensor) -> Tensor:
        """f32[N, 6]: the linear and angular impulse each body takes from the
        rows' impulses ``dl`` [J, ROWS], summed over its joints."""
        d = dl[..., None]
        lin = (d * self.jl).sum(dim=1)
        side_a = torch.cat([-lin, (d * self.ja).sum(dim=1)], dim=1)
        side_b = torch.cat([lin, (d * self.jb).sum(dim=1)], dim=1)
        table = torch.cat([side_a, side_b, torch.zeros_like(lin[:1, :1])
                           .expand(1, 6)], dim=0)          # [2J + 1, 6]
        return table[self.body_rows].sum(dim=1)


def _dot(u: Tensor, v: Tensor) -> Tensor:
    return (u * v).sum(dim=-1)


def _spd_inverse(m: Tensor) -> Tensor:
    """The inverses of symmetric positive definite [..., R, R] matrices by
    Gauss-Jordan elimination without pivoting (their pivots are
    positive), in elementwise ops."""
    r = m.shape[-1]
    eye = torch.eye(r, dtype=m.dtype, device=m.device)
    aug = torch.cat([m, eye.expand(m.shape)], dim=-1)     # [..., R, 2R]
    for i in range(r):
        pivot = aug[..., i:i + 1, :] / aug[..., i:i + 1, i:i + 1]
        aug = torch.where(eye[:, i:i + 1].bool(), pivot,
                          aug - aug[..., :, i:i + 1] * pivot)
    return aug[..., r:]


def _cross(u: Tensor, v: Tensor) -> Tensor:
    return math3d._cross(u, v)


def joint_rows(joints: JointSet, joint_state: JointState, pos: Tensor,
               quat: Tensor, alive: Tensor, inv_m: Tensor,
               inv_i_world: Tensor, dt: Tensor,
               contacts: Tensor | None = None) -> JointRows:
    """The rows of every joint at the poses ``pos``/``quat`` (see the
    module docstring): anchors, axes, angles, which limits are passed, the
    effective masses, and the warm start from ``joint_state``.  A set with
    ``mass_splitting`` takes each body's split from its joints and its
    contacts in the solve, the valid slots of ``contacts`` bool[N, C]."""
    a = joints.body_a.to(torch.int64)
    b = joints.body_b.to(torch.int64)
    body_rows = joints.body_rows.to(torch.int64)
    count = (body_rows < 2 * a.shape[0]).sum(dim=1).to(torch.float32)
    if joints.mass_splitting:
        split = (contacts.sum(dim=-1).to(torch.float32)
                 + count).clamp_min(1.0)
        inv_m = inv_m * split
        inv_i_world = inv_i_world * split[:, None, None]
    qa, qb = quat[a], quat[b]
    fa = math3d.quat_mul(qa, joints.frame_a)          # world frames
    fb = math3d.quat_mul(qb, joints.frame_b)
    ma = math3d.quat_to_mat3(fa)                      # [J, 3, 3] columns
    mb = math3d.quat_to_mat3(fb)
    xa, ya, za = ma[..., 0], ma[..., 1], ma[..., 2]
    xb, zb = mb[..., 0], mb[..., 2]
    r_a = math3d.quat_rotate(qa, joints.origin_a)
    r_b = math3d.quat_rotate(qb, joints.origin_b)
    gap = (pos[b] + r_b) - (pos[a] + r_a)
    erp = torch.full_like(dt, BAUMGARTE) / dt
    bias = torch.full_like(dt, LIMIT_BIAS) / dt
    hinge = joints.kind == HINGE
    cone = ~hinge
    lo, hi = joints.limit_lo, joints.limit_hi

    # rows 0-2: the point, along the world axes
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device).expand(
        a.shape[0], 3, 3)
    p_ja = -_cross(r_a[:, None], eye)
    p_jb = _cross(r_b[:, None], eye)
    p_tgt = -erp * gap

    # rows 3-4: the hinge axis held along A's
    h_u = torch.stack([xa, ya], dim=1)                # [J, 2, 3]
    h_tgt = -erp * _dot(_cross(za, zb)[:, None], h_u)

    # row 5: the hinge's limit, or the cone's swing
    theta = torch.atan2(_dot(xb, ya), _dot(xb, xa))
    below, above = theta < lo, theta > hi
    limit_dir = torch.where(below[:, None], -za, za)
    limit_err = torch.where(below, lo - theta, theta - hi)
    c = _cross(xa, xb)
    c_len = torch.sqrt(_dot(c, c))
    swing_n = torch.where((c_len > 1e-6)[:, None],
                          c / c_len.clamp_min(1e-6)[:, None], ya)
    phi = torch.acos(_dot(xa, xb).clamp(-1.0, 1.0))
    swing_on = cone & (phi > lo)
    r5_dir = torch.where(hinge[:, None], limit_dir, swing_n)
    r5_err = torch.where(hinge, limit_err, phi - lo)
    r5_on = torch.where(hinge, below | above, swing_on)

    # row 6: the cone's twist, the x part of FA^-1 FB's swing-twist split
    rel = math3d.quat_mul(math3d.quat_conj(fa), fb)
    rel = torch.where(rel[:, 3:4] < 0.0, -rel, rel)
    psi = 2.0 * torch.atan2(rel[:, 0].abs(), rel[:, 3])
    twist_dir = torch.where((rel[:, 0] < 0.0)[:, None], -xb, xb)
    twist_on = cone & (psi > hi)

    one_dir = torch.stack([r5_dir, twist_dir], dim=1)  # [J, 2, 3]
    jl = torch.cat([eye, torch.zeros_like(eye[:, :1]).expand(
        -1, ROWS - 3, 3)], dim=1)
    ja = torch.cat([p_ja, -h_u, one_dir], dim=1)
    jb = torch.cat([p_jb, h_u, -one_dir], dim=1)
    target = torch.cat([p_tgt, h_tgt,
                        (bias * torch.stack([r5_err, psi - hi], dim=1))],
                       dim=1)
    live = (alive[a] & alive[b])[:, None]
    active = torch.cat([live.expand(-1, 3), (hinge[:, None] & live)
                        .expand(-1, 2), (r5_on[:, None] & live),
                        (twist_on[:, None] & live)], dim=1)
    one_sided = torch.arange(ROWS, device=pos.device) >= _LIMIT_ROW
    floor = torch.where(one_sided, 0.0, -torch.inf).to(pos.dtype).expand(
        active.shape)

    # the active rows' effective mass K = J M^-1 J^T, row against row:
    # (1/ma + 1/mb) jl.jl' + ja.(Ia^-1 ja') + jb.(Ib^-1 jb'); an inactive
    # row is the identity's, so its residual 0 leaves it at 0
    ia = inv_i_world[a][:, None]                      # [J, 1, 3, 3]
    ib = inv_i_world[b][:, None]
    ia_ja = (ia * ja[..., None, :]).sum(dim=-1)       # [J, ROWS, 3]
    ib_jb = (ib * jb[..., None, :]).sum(dim=-1)
    k = ((inv_m[a] + inv_m[b])[:, None, None]
         * _dot(jl[:, :, None], jl[:, None])
         + _dot(ja[:, :, None], ia_ja[:, None])
         + _dot(jb[:, :, None], ib_jb[:, None]))      # [J, ROWS, ROWS]
    eye_r = torch.eye(ROWS, dtype=pos.dtype, device=pos.device)
    both = active[:, :, None] & active[:, None, :]
    inv_k = _spd_inverse(torch.where(both, k, eye_r))

    prev = joint_state.impulse
    warm = torch.where(active, torch.maximum(prev, floor) * WARM_START_FACTOR,
                       0.0)
    limit_rows = active[:, _LIMIT_ROW:].sum().to(torch.int32)
    return JointRows(a=a, b=b, jl=jl, ja=ja, jb=jb, inv_k=inv_k,
                     target=target,
                     floor=floor, active=active, warm=warm,
                     limit_rows=limit_rows, body_rows=body_rows, count=count,
                     mass_splitting=joints.mass_splitting)
