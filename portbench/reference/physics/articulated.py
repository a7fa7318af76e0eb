"""An articulated body's step with motor-driven hinges, plain and eager:
the benchmark's reference for a world of IsaacGymEnvs' Ant.

The jointed dense step of :mod:`jointed` with three changes.  First,
after gravity and the bodies' damping, and before the contacts and the
joints' solve, each hinge's motor turns its two bodies.  The torque is
written from its equation, with frames as matrices
(:func:`motor_torques`):

    tau = gear u - damping ((wb - wa) . a),   a = Ra (basis_a ez),

``u`` the joint's command, ``a`` the hinge's axis in the world (the
frame's z in body a); ``wb += dt Ib^-1 tau a`` and ``wa -= dt Ia^-1 tau
a``, every joint's torque from the same velocities, summed body by body.

Second, the joints' rows are solved with mass splitting (Tonge et al.
2012, :func:`split_solve`): each body's split is its contacts and its
joints; a joint's effective mass ``K`` takes each body's inverse mass
and inertia times its split, and the change of a joint's impulses goes
whole to both bodies, equal and opposite.  The contacts' rows are the
jointed step's: each body's share divided by its split.

Third, after the integration, ``sweeps`` passes hold the joints' anchors
together by position (:func:`hold_joints`): each, from the poses at its
start, takes every joint's gap ``C = pB - pA`` and the point's effective
mass ``K = (1/ma + 1/mb) E - [rA]x IA^-1 [rA]x - [rB]x IB^-1 [rB]x`` as
matrices (``[r]x`` the cross-product matrix, the inverse inertias at the
integrated poses), solves ``K P = -C``, and moves b by ``P / mb``, turning
it by ``IB^-1 (rB x P)``, a by the opposite, each body's sum over its
joints divided by its number of joints; the velocities stay.  Imports
nothing of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import math3d
from portbench.reference.ecs.transform import update_world_matrices
from portbench.reference.engine import visual_positions
from portbench.reference.physics import jointed
from portbench.reference.physics import joints as jr
from portbench.reference.physics import solver as sv
from portbench.reference.physics.broadphase import build_neighbor_lists_dense
from portbench.reference.physics.step import GROUND_FRICTION, _finish_step
from portbench.reference.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    tree_replace,
)


@dataclasses.dataclass
class Motors:
    """Each joint's motor: the torque of a unit command and the torque
    against a rad/s of the hinge's relative spin (zero where none)."""

    gear: torch.Tensor        # f32[J]
    damping: torch.Tensor     # f32[J]


def motor_torques(joints: jr.Joints, motors: Motors, command, quat,
                  ang) -> torch.Tensor:
    """f32[N, 3]: the world torque each body takes from the motors under
    ``command`` f32[J]."""
    a, b = joints.body_a.long(), joints.body_b.long()
    axis = (math3d.quat_to_mat3(quat[a]) @ joints.basis_a)[..., 2]
    spin = ((ang[b] - ang[a]) * axis).sum(-1)
    tau = (motors.gear * command - motors.damping * spin)[:, None] * axis
    out = torch.zeros_like(ang)
    out.index_add_(0, b, tau)
    out.index_add_(0, a, -tau)
    return out


def _cross_matrix(r):
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1)], -2)


def hold_joints(state, static, joints: jr.Joints, sweeps: int):
    """``state`` with its joints' anchors held together by ``sweeps``
    position passes (see the module docstring)."""
    pos, quat = state.pos, state.quat
    a, b = joints.body_a.long(), joints.body_b.long()
    dyn = (static.body_type == BODY_DYNAMIC) & state.alive
    live = (state.alive[a] & state.alive[b])[:, None]
    inv_m = torch.where(dyn, static.inv_mass, 0.0)
    inv_i = torch.where(dyn[:, None, None],
                        sv.inv_inertia_world(quat, static.inv_inertia_body),
                        0.0)
    count = torch.bincount(torch.cat([a, b]), minlength=pos.shape[0])
    count = count.clamp_min(1).to(pos.dtype)[:, None]
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    for _ in range(sweeps):
        rot = math3d.quat_to_mat3(quat)
        r_a = (rot[a] @ joints.origin_a[..., None])[..., 0]
        r_b = (rot[b] @ joints.origin_b[..., None])[..., 0]
        gap = pos[b] + r_b - pos[a] - r_a
        xa, xb = _cross_matrix(r_a), _cross_matrix(r_b)
        k = ((inv_m[a] + inv_m[b])[:, None, None] * eye
             - xa @ inv_i[a] @ xa - xb @ inv_i[b] @ xb)
        p = torch.where(live, -torch.linalg.solve(k, gap), 0.0)
        lin = torch.zeros_like(pos)
        lin.index_add_(0, b, p)
        lin.index_add_(0, a, -p)
        spin = torch.zeros_like(pos)
        spin.index_add_(0, b, torch.cross(r_b, p, dim=-1))
        spin.index_add_(0, a, -torch.cross(r_a, p, dim=-1))
        pos = pos + inv_m[:, None] * lin / count
        turn = (inv_i @ (spin / count)[..., None])[..., 0]
        quat = torch.where(dyn[:, None], math3d.quat_integrate(
            quat, turn, torch.ones((), dtype=pos.dtype, device=pos.device)),
            quat)
    return tree_replace(state, pos=pos, quat=quat)


def split_solve(v, w, pos, inv_m, inv_i, c_b, c_pt, c_n, c_d, c_valid, c_mu,
                c_e, dt, warm, jrows, split, iterations):
    """The contacts' and the joints' rows in one Jacobi solve, the joints'
    rows set up with each body's mass divided by ``split`` (see the
    module docstring); returns (v, w, the contacts' (ln, lt1, lt2), the
    joints' impulses)."""
    n = v.shape[0]
    a, b, jl, ja, jb, jk, jtarget, one_sided, active, jlam, _ = jrows
    is_static = c_b < 0
    safe_b = c_b.clamp_min(0).long()
    ra = c_pt - pos[:, None]
    rb = c_pt - pos[safe_b]
    t1, t2 = sv._orthonormal_tangents(c_n)
    dirs = torch.stack([c_n, t1, t2], dim=-2)              # [N, C, 3, 3]
    im_b = torch.where(is_static, 0.0, inv_m[safe_b])
    i_b = torch.where(is_static[..., None, None], 0.0, inv_i[safe_b])

    def turn(i, r):
        # the speed along each direction that a unit impulse there gives
        # through the lever arm r: d . ((I^-1 (r x d)) x r)
        arm = torch.cross(r[..., None, :].expand(dirs.shape), dirs, dim=-1)
        spin = (i[..., None, :, :] @ arm[..., None])[..., 0]
        return (torch.cross(spin, r[..., None, :].expand(dirs.shape),
                            dim=-1) * dirs).sum(-1)

    k = ((inv_m[:, None] + im_b)[..., None] + turn(inv_i[:, None], ra)
         + turn(i_b, rb)).clamp_min(1e-9)                  # [N, C, 3]

    def contact_speed(v_, w_):
        va = v_[:, None] + torch.cross(w_[:, None].expand(ra.shape), ra,
                                       dim=-1)
        vb = torch.where(is_static[..., None], 0.0, v_[safe_b] + torch.cross(
            w_[safe_b], rb, dim=-1))
        return ((va - vb)[..., None, :] * dirs).sum(-1)

    vn0 = contact_speed(v, w)[..., 0]
    bounce = c_e * (-vn0 - sv.RESTITUTION_THRESHOLD).clamp_min(0.0)
    baum = (torch.full_like(dt, sv.BAUMGARTE) / dt) * (
        c_d - sv.PENETRATION_SLOP).clamp_min(0.0)
    tgt = torch.stack([torch.maximum(bounce, baum), torch.zeros_like(c_d),
                       torch.zeros_like(c_d)], -1)

    def push(v_, w_, lin, ang, share):
        return (v_ + lin * (inv_m / share)[:, None],
                w_ + (inv_i @ ang[..., None])[..., 0] / share[:, None])

    def contact_push(v_, w_, dl):
        imp = (dl[..., None] * dirs).sum(-2)
        return push(v_, w_, imp.sum(1),
                    torch.cross(ra, imp, dim=-1).sum(1), split)

    whole = torch.ones_like(split)

    def joint_push(v_, w_, dl):
        imp = jr.body_impulses(n, a, b, jl, ja, jb, dl)
        return push(v_, w_, imp[:, :3], imp[:, 3:], whole)

    valid3 = c_valid[..., None]
    lam = torch.where(valid3, torch.stack(
        [warm[0].clamp_min(0.0), warm[1], warm[2]], -1)
        * sv.WARM_START_FACTOR, 0.0)
    v, w = contact_push(v, w, lam)
    v, w = joint_push(v, w, jlam)
    floor = torch.tensor([0.0, -torch.inf, -torch.inf], device=v.device)
    jfloor = torch.where(one_sided, 0.0, -torch.inf)
    plam, jplam = lam, jlam
    for _ in range(iterations):
        vw = torch.cat([v, w], dim=1)
        speed = ((jl * (vw[b, None, :3] - vw[a, None, :3])).sum(-1)
                 + (ja * vw[a, None, 3:]).sum(-1)
                 + (jb * vw[b, None, 3:]).sum(-1))
        res = torch.where(active, jtarget - speed, 0.0)
        jnew = torch.maximum(
            jlam + torch.linalg.solve(jk, res[..., None])[..., 0], jfloor)
        jnew = torch.maximum(jnew + jointed.MOMENTUM * (jnew - jplam),
                             jfloor)
        jnew = torch.where(active, jnew, jlam)
        jdl = jnew - jlam
        jplam, jlam = jlam, jnew
        new = torch.maximum(lam - (contact_speed(v, w) - tgt) / k, floor)
        new = new + jointed.MOMENTUM * (new - plam)
        ln = new[..., 0].clamp_min(0.0)
        cap = (c_mu * torch.where(c_valid, ln, lam[..., 0]))[..., None]
        new = torch.cat([ln[..., None], torch.clamp(new[..., 1:], -cap, cap)],
                        -1)
        dl = torch.where(valid3, new - lam, 0.0)
        plam, lam = lam, torch.where(valid3, new, lam)
        v, w = contact_push(v, w, dl)
        v, w = joint_push(v, w, jdl)
    return v, w, lam.unbind(-1), jlam


def physics_step(state, static, joints: jr.Joints, motors: Motors, impulse,
                 command, iterations: int = 10, max_neighbors: int = 8,
                 sweeps: int = 0):
    """One step of a jointed scene with no character and no trigger on the
    dense route, its hinges driven by ``command``, its anchors held by
    ``sweeps`` position passes; returns (state, the joints' impulses [J,
    7], the limit rows at their bound)."""
    dt = static.fixed_dt
    alive = state.alive
    has_collider = (state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    is_dynamic = (static.body_type == BODY_DYNAMIC) & alive
    moving = is_dynamic | ((static.body_type == BODY_KINEMATIC) & alive)
    pos, quat = state.pos, state.quat
    gdt = static.gravity * dt
    zero = torch.zeros_like(gdt)
    dyn = is_dynamic[:, None]
    vel = torch.where(dyn, state.lin_vel + torch.stack([zero, gdt, zero]),
                      state.lin_vel)
    vel = torch.where(dyn, vel * torch.pow(1.0 - joints.lin_damping,
                                           dt)[:, None], vel)
    ang = torch.where(dyn, state.ang_vel * torch.pow(
        1.0 - joints.ang_damping, dt)[:, None], state.ang_vel)
    inv_i = sv.inv_inertia_world(quat, static.inv_inertia_body)
    torque = motor_torques(joints, motors, command, quat, ang)
    ang = torch.where(dyn, ang + dt * (inv_i @ torque[..., None])[..., 0],
                      ang)
    solid = alive & has_collider & ((state.comp_mask & COMP_CHARACTER) == 0)

    nl = build_neighbor_lists_dense(
        pos, quat, static.shape_type, static.shape_size,
        jointed._pair_mask(static, joints, solid, is_dynamic),
        max_neighbors=min(max_neighbors, 8))
    c_b, c_pt, c_n, c_d, c_valid, overflow, c_f = jointed._contacts(
        static, pos, quat, is_dynamic, solid, nl)
    safe_b = c_b.clamp_min(0).long()
    fric = static.friction[:, None]
    c_mu = torch.where(c_b < 0, fric * GROUND_FRICTION,
                       fric * static.friction[safe_b])
    c_e = torch.where(c_b < 0, 0.0,
                      static.restitution[:, None] * static.restitution[safe_b])
    match = ((c_f[:, :, None] == state.contact_feat[:, None, :])
             & (c_f >= 0)[:, :, None]).to(torch.float32)
    warm = (match[..., None] * state.contact_imp[:, None]).sum(2).unbind(-1)
    count = torch.bincount(torch.cat([joints.body_a, joints.body_b]).long(),
                           minlength=pos.shape[0])
    split = (c_valid.sum(-1) + count).clamp_min(1).to(pos.dtype)
    jrows = jr.rows(joints, pos, quat, alive, static.inv_mass * split,
                    inv_i * split[:, None, None], dt, impulse)
    vel, ang, lams, impulse = split_solve(
        vel, ang, pos, static.inv_mass, inv_i, c_b, c_pt, c_n, c_d, c_valid,
        c_mu, c_e, dt, warm, jrows, split, iterations)
    cache = (c_f, torch.where(c_valid[..., None], torch.stack(lams, -1), 0.0))
    state, _ = _finish_step(state, static, pos, quat, vel, ang,
                            state.char_vel_y, state.char_on_ground, moving,
                            alive, has_collider, dt, False,
                            contact_cache=cache, contact_overflow=overflow)
    return hold_joints(state, static, joints, sweeps), impulse, jrows[-1]


def engine_step(state, static, joints, motors, impulse, command,
                iterations: int = 10, max_neighbors: int = 8,
                sweeps: int = 0):
    """:func:`physics_step`, then the world matrices."""
    state, impulse, limits = physics_step(state, static, joints, motors,
                                          impulse, command, iterations,
                                          max_neighbors, sweeps)
    world = update_world_matrices(
        visual_positions(state, static), state.quat, state.scale,
        static.parent, static.level_nodes, state.alive)
    return tree_replace(state, world=world), impulse, limits
