"""The dense route's step with joints, plain and eager: the benchmark's
reference for a jointed scene (Bullet's ragdolls).

One step: the masks and gravity, each body's damping ``v *= (1 - d)^dt``
(Bullet's ``applyDamping``), the all-pairs AABB neighbor lists with the
jointed pairs left out before the lists are cut to their width, the
narrowphase and compaction of the frozen modules, then one Jacobi solve
of the contacts and the joints' rows (:mod:`joints`) together, the frozen
step's integration and the world matrices.  Each body's split counts its
contacts and its joints; each iteration computes the contacts' and the
joints' impulses from the same velocities and adds both.  Imports
nothing of the port.
"""

from __future__ import annotations

import torch

from portbench.reference.ecs.transform import update_world_matrices
from portbench.reference.engine import visual_positions
from portbench.reference.physics import joints as jr
from portbench.reference.physics import narrowphase as nf
from portbench.reference.physics import solver as sv
from portbench.reference.physics.broadphase import build_neighbor_lists_dense
from portbench.reference.physics.step import (
    CONTACT_BUDGET,
    GROUND_FRICTION,
    _finish_step,
)
from portbench.reference.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    FEAT_STRIDE,
    tree_replace,
)

MOMENTUM = 0.5


def _pair_mask(static, joints, solid, is_dynamic):
    """Solid pairs whose layers meet, one body dynamic, no joint between."""
    n = solid.shape[0]
    layer_ok = (((static.layer[:, None] & static.mask[None, :]) != 0)
                & ((static.layer[None, :] & static.mask[:, None]) != 0))
    a, b = joints.body_a.long(), joints.body_b.long()
    jointed = torch.zeros((n, n), dtype=torch.bool, device=solid.device)
    jointed[a, b] = True
    jointed[b, a] = True
    return (solid[:, None] & solid[None, :] & layer_ok
            & (is_dynamic[:, None] | is_dynamic[None, :]) & ~jointed)


def _contacts(static, pos, quat, is_dynamic, solid, nl):
    """The narrowphase manifolds of the listed pairs and the ground,
    compacted to the per-body budget (the frozen dense route's)."""
    n = pos.shape[0]
    safe_j = nl.idx.clamp_min(0).long()
    p_point, p_normal, p_depth, p_gvalid = nf.pair_contacts(
        pos[:, None], quat[:, None],
        static.shape_type[:, None], static.shape_size[:, None],
        pos[safe_j], quat[safe_j],
        static.shape_type[safe_j], static.shape_size[safe_j],
        enable_capsule=True)
    p_valid = p_gvalid & (p_depth > 0.0) & nl.valid[..., None]
    g_point, g_normal, g_depth, g_gvalid = nf.ground_contacts(
        pos, quat, static.shape_type, static.shape_size)
    g_valid = (g_gvalid & (g_depth > 0.0) & (is_dynamic & solid)[:, None]
               & static.ground_enabled)
    k_pair = p_depth.shape[2]
    m = p_depth.shape[1] * k_pair
    partner = nl.idx[:, :, None].expand(p_depth.shape)
    slots = torch.arange(k_pair, dtype=torch.int32, device=pos.device)
    ground = torch.arange(nf.K_GROUND, dtype=torch.int32, device=pos.device)
    return sv.compact_contacts(
        torch.cat([partner.reshape(n, m),
                   torch.full((n, nf.K_GROUND), -1, dtype=torch.int32,
                              device=pos.device)], dim=1),
        torch.cat([p_point.reshape(n, m, 3), g_point], dim=1),
        torch.cat([p_normal.reshape(n, m, 3), g_normal], dim=1),
        torch.cat([p_depth.reshape(n, m), g_depth], dim=1),
        torch.cat([p_valid.reshape(n, m), g_valid], dim=1),
        CONTACT_BUDGET,
        feat=torch.cat([((partner + 1) * FEAT_STRIDE + slots).reshape(n, m),
                        ground.expand(n, nf.K_GROUND)], dim=1))


def _solve(v, w, pos, inv_m, inv_i, c_b, c_pt, c_n, c_d, c_valid, c_mu,
           c_e, dt, warm, jrows, iterations):
    """The contacts' and the joints' rows in one Jacobi solve; returns (v,
    w, the contacts' (ln, lt1, lt2), the joints' impulses)."""
    n = v.shape[0]
    a, b, jl, ja, jb, jk, jtarget, one_sided, active, jwarm, _ = jrows
    is_static = c_b < 0
    safe_b = c_b.clamp_min(0).long()
    ra = c_pt - pos[:, None]
    rb = c_pt - pos[safe_b]
    t1, t2 = sv._orthonormal_tangents(c_n)
    dirs = torch.stack([c_n, t1, t2], dim=-2)
    im_b = torch.where(is_static, 0.0, inv_m[safe_b])
    ib = torch.where(is_static[..., None, None], 0.0, inv_i[safe_b])
    ra3, rb3 = ra[..., None, :], rb[..., None, :]
    ang_a = sv._cross(sv._matvec(inv_i[:, None, None], sv._cross(ra3, dirs)),
                      ra3)
    ang_b = sv._cross(sv._matvec(ib[..., None, :, :], sv._cross(rb3, dirs)),
                      rb3)
    k = ((inv_m[:, None] + im_b)[..., None] + (dirs * ang_a).sum(-1)
         + (dirs * ang_b).sum(-1)).clamp_min(1e-9)

    def rel_vel(v_, w_):
        va = v_[:, None] + sv._cross(w_[:, None], ra)
        vw_b = torch.where(is_static[..., None], 0.0,
                           torch.cat([v_, w_], dim=1)[safe_b])
        return va - (vw_b[..., :3] + sv._cross(vw_b[..., 3:], rb))

    def along(vr):
        return (vr[..., None, :] * dirs).sum(-1)

    vn0 = along(rel_vel(v, w))[..., 0]
    bounce = c_e * (-vn0 - sv.RESTITUTION_THRESHOLD).clamp_min(0.0)
    baum = (torch.full_like(dt, sv.BAUMGARTE) / dt) * (
        c_d - sv.PENETRATION_SLOP).clamp_min(0.0)
    target = torch.maximum(bounce, baum)

    count = torch.zeros(n, dtype=v.dtype, device=v.device)
    ones = torch.ones_like(a, dtype=v.dtype)
    count.index_add_(0, a, ones)
    count.index_add_(0, b, ones)
    split = (c_valid.sum(-1).to(v.dtype) + count).clamp_min(1.0)

    def push(v_, w_, lin, ang):
        return (v_ + lin * (inv_m / split)[:, None],
                w_ + sv._matvec(inv_i, ang) / split[:, None])

    def contact_push(v_, w_, dl):
        imp = (dl[..., None] * dirs).sum(-2)
        return push(v_, w_, imp.sum(1), sv._cross(ra, imp).sum(1))

    def joint_push(v_, w_, dl):
        imp = jr.body_impulses(n, a, b, jl, ja, jb, dl)
        return push(v_, w_, imp[:, :3], imp[:, 3:])

    valid3 = c_valid[..., None]
    if warm is None:
        lam = torch.zeros_like(k)
    else:
        lam = torch.where(valid3, torch.stack(
            [warm[0].clamp_min(0.0), warm[1], warm[2]], -1)
            * sv.WARM_START_FACTOR, 0.0)
        v, w = contact_push(v, w, lam)
    jlam = jwarm
    v, w = joint_push(v, w, jlam)
    tgt = torch.cat([target[..., None], torch.zeros_like(lam[..., 1:])], -1)
    floor = torch.tensor([0.0, -torch.inf, -torch.inf], device=v.device)
    jfloor = torch.where(one_sided, 0.0, -torch.inf)
    plam, jplam = lam, jlam
    for _ in range(iterations):
        # the joints' rows, from the iteration's starting velocities
        vw = torch.cat([v, w], dim=1)
        speed = ((jl * (vw[b, None, :3] - vw[a, None, :3])).sum(-1)
                 + (ja * vw[a, None, 3:]).sum(-1)
                 + (jb * vw[b, None, 3:]).sum(-1))
        res = torch.where(active, jtarget - speed, 0.0)
        step = torch.linalg.solve(jk, res[..., None])[..., 0]
        jnew = torch.maximum(jlam + step, jfloor)
        jnew = torch.maximum(jnew + MOMENTUM * (jnew - jplam), jfloor)
        jnew = torch.where(active, jnew, jlam)
        jdl = jnew - jlam
        jplam, jlam = jlam, jnew
        # the contacts, from the same velocities
        new = torch.maximum(lam - (along(rel_vel(v, w)) - tgt) / k, floor)
        new = new + MOMENTUM * (new - plam)
        ln = new[..., 0].clamp_min(0.0)
        cap = (c_mu * torch.where(c_valid, ln, lam[..., 0]))[..., None]
        new = torch.cat([ln[..., None], torch.clamp(new[..., 1:], -cap, cap)],
                        -1)
        dl = torch.where(valid3, new - lam, 0.0)
        plam, lam = lam, torch.where(valid3, new, lam)
        v, w = contact_push(v, w, dl)
        v, w = joint_push(v, w, jdl)
    return v, w, lam.unbind(-1), jlam


def physics_step(state, static, joints: jr.Joints, impulse,
                 iterations: int = 10, max_neighbors: int = 8):
    """One step of a jointed scene with no character and no trigger on the
    dense route; returns (state, the joints' impulses [J, 7], the limit
    rows at their bound)."""
    dt = static.fixed_dt
    alive = state.alive
    has_collider = (state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    is_dynamic = (static.body_type == BODY_DYNAMIC) & alive
    moving = is_dynamic | ((static.body_type == BODY_KINEMATIC) & alive)
    pos, quat = state.pos, state.quat
    gdt = static.gravity * dt
    zero = torch.zeros_like(gdt)
    vel = torch.where(is_dynamic[:, None],
                      state.lin_vel + torch.stack([zero, gdt, zero]),
                      state.lin_vel)
    ang = state.ang_vel
    vel = torch.where(is_dynamic[:, None],
                      vel * torch.pow(1.0 - joints.lin_damping, dt)[:, None],
                      vel)
    ang = torch.where(is_dynamic[:, None],
                      ang * torch.pow(1.0 - joints.ang_damping, dt)[:, None],
                      ang)
    solid = alive & has_collider & ((state.comp_mask & COMP_CHARACTER) == 0)

    nl = build_neighbor_lists_dense(
        pos, quat, static.shape_type, static.shape_size,
        _pair_mask(static, joints, solid, is_dynamic),
        max_neighbors=min(max_neighbors, 8))
    c_b, c_pt, c_n, c_d, c_valid, overflow, c_f = _contacts(
        static, pos, quat, is_dynamic, solid, nl)

    safe_b = c_b.clamp_min(0).long()
    fric = static.friction[:, None]
    c_mu = torch.where(c_b < 0, fric * GROUND_FRICTION,
                       fric * static.friction[safe_b])
    c_e = torch.where(c_b < 0, 0.0,
                      static.restitution[:, None] * static.restitution[safe_b])
    inv_i = sv.inv_inertia_world(quat, static.inv_inertia_body)
    match = ((c_f[:, :, None] == state.contact_feat[:, None, :])
             & (c_f >= 0)[:, :, None]).to(torch.float32)
    warm = (match[..., None] * state.contact_imp[:, None]).sum(2).unbind(-1)
    jrows = jr.rows(joints, pos, quat, alive, static.inv_mass, inv_i, dt,
                    impulse)
    vel, ang, lams, impulse = _solve(
        vel, ang, pos, static.inv_mass, inv_i, c_b, c_pt, c_n, c_d, c_valid,
        c_mu, c_e, dt, warm, jrows, iterations)
    cache = (c_f, torch.where(c_valid[..., None], torch.stack(lams, -1), 0.0))
    state, _ = _finish_step(state, static, pos, quat, vel, ang,
                            state.char_vel_y, state.char_on_ground, moving,
                            alive, has_collider, dt, False,
                            contact_cache=cache, contact_overflow=overflow)
    return state, impulse, jrows[-1]


def engine_step(state, static, joints, impulse, iterations: int = 10,
                max_neighbors: int = 8):
    """:func:`physics_step`, then the world matrices."""
    state, impulse, limits = physics_step(state, static, joints, impulse,
                                          iterations, max_neighbors)
    world = update_world_matrices(
        visual_positions(state, static), state.quat, state.scale,
        static.parent, static.level_nodes, state.alive)
    return tree_replace(state, world=world), impulse, limits
