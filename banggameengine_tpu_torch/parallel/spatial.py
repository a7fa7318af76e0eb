"""Entity-axis sharding of one large world's contact phase.

Counterpart of ``banggameengine_tpu/parallel/spatial.py``.  Each rank of
an ``("entity_shard",)`` mesh owns a contiguous row range of bodies,
builds neighbor lists and contact manifolds for its rows against every
body, and runs the Jacobi solver on its rows, exchanging velocities with
one all-gather per iteration (the halo exchange).  The solver's mirrored
rows make this exact: a rank updates only its own bodies, and the
mirrored copy of each cross-rank pair lives on the partner's rank, so only
velocities cross ranks.

This shards compute (narrowphase and solve); the state stays replicated.
The JAX module compacts the neighbor lists by a one-hot product
(``solver.compaction_matrix``, ROADMAP "Not to port"); here the running-
count gather of :func:`solver.compaction_index` gives the same lists on
finite inputs.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch.parallel import ranks
from banggameengine_tpu_torch.physics import narrowphase as nf
from banggameengine_tpu_torch.physics import shapes as sh
from banggameengine_tpu_torch.physics import solver as sv
from banggameengine_tpu_torch.physics.step import (
    CONTACT_BUDGET,
    GROUND_FRICTION,
)

AXIS = "entity_shard"
MOMENTUM = 0.5   # the heavy-ball factor of the engine's default solver


def local_rows_contact_solve(
    r0, rows, n,
    pos_l, quat_l, vel_l, ang_l,         # [rows, ...] this rank's bodies
    pos_f, quat_f, vel_f, ang_f,         # [N, ...] full (gathered) views
    st_l, st_f,                          # static columns (local / full)
    ground_enabled, dt, iterations, max_neighbors, group,
    aabb_margin=0.04,
):
    """Contact pipeline for one rank's row range ``[r0, r0 + rows)``
    against the whole world of ``n`` bodies.

    ``st_l``/``st_f`` carry shape_type, size, layer, mask, friction,
    restitution, inv_mass, inv_inertia, dyn (bool) and solid (bool), for
    the local rows and the whole world.  Runs the dense AABB broadphase of
    the local rows against every body, the local narrowphase, and the
    mirrored-row Jacobi solve with one velocity all-gather over ``group``
    per iteration.  Returns ``(vel_local, ang_local, vel_full,
    ang_full)``.
    """
    dev = pos_l.device
    # --- broadphase: local rows against ALL bodies (dense AABB) ----------
    mn_f, mx_f = sh.shape_aabb(pos_f, quat_f, st_f["shape_type"],
                               st_f["size"])
    mn_l, mx_l = sh.shape_aabb(pos_l, quat_l, st_l["shape_type"],
                               st_l["size"])
    ov = sh.aabb_overlap(mn_l[:, None], mx_l[:, None], mn_f[None, :],
                         mx_f[None, :], margin=aabb_margin)
    row_ids = r0 + torch.arange(rows, device=dev)
    ov = ov & (row_ids[:, None] != torch.arange(n, device=dev)[None, :])
    layer_ok = (((st_l["layer"][:, None] & st_f["mask"][None, :]) != 0)
                & ((st_f["layer"][None, :] & st_l["mask"][:, None]) != 0))
    any_dyn = st_l["dyn"][:, None] | st_f["dyn"][None, :]
    ov = (ov & st_l["solid"][:, None] & st_f["solid"][None, :] & layer_ok
          & any_dyn)

    src, nvalid, _counts = sv.compaction_index(ov, max_neighbors)
    nbr = torch.where(nvalid, src.to(torch.int32), -1)
    safe_j = nbr.clamp_min(0).to(torch.int64)

    # --- local narrowphase --------------------------------------------------
    p_pt, p_n, p_d, p_gv = nf.pair_contacts(
        pos_l[:, None], quat_l[:, None],
        st_l["shape_type"][:, None], st_l["size"][:, None],
        pos_f[safe_j], quat_f[safe_j],
        st_f["shape_type"][safe_j], st_f["size"][safe_j])
    p_v = p_gv & (p_d > 0.0) & nvalid[..., None]
    partner = nbr[:, :, None].expand(p_d.shape)

    g_pt, g_n, g_d, g_gv = nf.ground_contacts(
        pos_l, quat_l, st_l["shape_type"], st_l["size"])
    g_v = (g_gv & (g_d > 0.0) & (st_l["dyn"] & st_l["solid"])[:, None]
           & ground_enabled)

    m_pair = p_d.shape[1] * p_d.shape[2]
    all_b = torch.cat([partner.reshape(rows, m_pair),
                       torch.full((rows, nf.K_GROUND), -1,
                                  dtype=torch.int32, device=dev)], dim=1)
    all_pt = torch.cat([p_pt.reshape(rows, m_pair, 3), g_pt], dim=1)
    all_n = torch.cat([p_n.reshape(rows, m_pair, 3), g_n], dim=1)
    all_d = torch.cat([p_d.reshape(rows, m_pair), g_d], dim=1)
    all_v = torch.cat([p_v.reshape(rows, m_pair), g_v], dim=1)
    c_b, c_pt, c_n, c_d, c_valid, _ = sv.compact_contacts(
        all_b, all_pt, all_n, all_d, all_v, CONTACT_BUDGET)
    sb = c_b.clamp_min(0).to(torch.int64)
    stat_side = c_b < 0
    c_mu = torch.where(
        stat_side, st_l["friction"][:, None] * GROUND_FRICTION,
        st_l["friction"][:, None] * st_f["friction"][sb])
    c_e = torch.where(
        stat_side, 0.0,
        st_l["restitution"][:, None] * st_f["restitution"][sb])

    # --- solver: local rows, velocity halo per iteration -----------------
    inv_i_full = sv.inv_inertia_world(quat_f, st_f["inv_inertia"])
    inv_i_l = sv.inv_inertia_world(quat_l, st_l["inv_inertia"])
    inv_m_l = st_l["inv_mass"]

    ra = c_pt - pos_l[:, None]
    rb = c_pt - pos_f[sb]
    t1, t2 = sv._orthonormal_tangents(c_n)
    im_b = torch.where(stat_side, 0.0, st_f["inv_mass"][sb])
    ib = torch.where(stat_side[..., None, None], 0.0, inv_i_full[sb])
    ia = inv_i_l[:, None]
    cross, matvec = sv._cross, sv._matvec

    def k_along(direction):
        ang_a = cross(matvec(ia, cross(ra, direction)), ra)
        ang_b = cross(matvec(ib, cross(rb, direction)), rb)
        return (inv_m_l[:, None] + im_b
                + (direction * ang_a).sum(dim=-1)
                + (direction * ang_b).sum(dim=-1)).clamp_min(1e-9)

    kn, kt1, kt2 = k_along(c_n), k_along(t1), k_along(t2)
    stat3 = stat_side[..., None]

    def rel_vel(vf, wf, vl, wl):
        va = vl[:, None] + cross(wl[:, None], ra)
        vb = (torch.where(stat3, 0.0, vf[sb])
              + cross(torch.where(stat3, 0.0, wf[sb]), rb))
        return va - vb

    vn0 = (rel_vel(vel_f, ang_f, vel_l, ang_l) * c_n).sum(dim=-1)
    bounce = c_e * (-vn0 - sv.RESTITUTION_THRESHOLD).clamp_min(0.0)
    # f32 / f32, as JAX evaluates BAUMGARTE / dt
    baum = (torch.full_like(dt, sv.BAUMGARTE) / dt) * (
        c_d - sv.PENETRATION_SLOP).clamp_min(0.0)
    target = torch.maximum(bounce, baum)
    split = c_valid.sum(dim=-1).to(torch.float32).clamp_min(1.0)

    # heavy-ball extrapolation over the lambda iterates, the JAX module's
    # op for op (the default dense solver's momentum of 0.5)
    zeros = torch.zeros_like(c_d)
    v_l, w_l, v_f, w_f = vel_l, ang_l, vel_f, ang_f
    ln = lt1 = lt2 = pln = plt1 = plt2 = zeros
    for _ in range(iterations):
        vr = rel_vel(v_f, w_f, v_l, w_l)
        vn = (vr * c_n).sum(dim=-1)
        dln = (-(vn - target)) / kn
        ln_new = (ln + dln).clamp_min(0.0)
        ln_new = (ln_new + MOMENTUM * (ln_new - pln)).clamp_min(0.0)
        dln = torch.where(c_valid, ln_new - ln, 0.0)
        pln = ln
        ln = torch.where(c_valid, ln_new, ln)
        vt1 = (vr * t1).sum(dim=-1)
        vt2 = (vr * t2).sum(dim=-1)
        mx_f2 = c_mu * ln
        l1n = lt1 - vt1 / kt1
        l2n = lt2 - vt2 / kt2
        l1n = l1n + MOMENTUM * (l1n - plt1)
        l2n = l2n + MOMENTUM * (l2n - plt2)
        l1n = torch.clamp(l1n, -mx_f2, mx_f2)
        l2n = torch.clamp(l2n, -mx_f2, mx_f2)
        d1 = torch.where(c_valid, l1n - lt1, 0.0)
        d2 = torch.where(c_valid, l2n - lt2, 0.0)
        plt1, plt2 = lt1, lt2
        lt1 = torch.where(c_valid, l1n, lt1)
        lt2 = torch.where(c_valid, l2n, lt2)
        imp = (dln[..., None] * c_n + d1[..., None] * t1
               + d2[..., None] * t2)
        lin = imp.sum(dim=1)
        angi = cross(ra, imp).sum(dim=1)
        v_l = v_l + lin * (inv_m_l / split)[:, None]
        w_l = w_l + matvec(inv_i_l, angi) / split[:, None]
        # the halo exchange: every rank sees the new velocities, linear
        # and angular in one gather
        vw_f = ranks.gather_rows(torch.cat([v_l, w_l], dim=1), group)
        v_f, w_f = vw_f[:, :3], vw_f[:, 3:]
    return v_l, w_l, v_f, w_f


def static_columns(static, sl=None):
    """The static-scene columns the sharded contact pipeline consumes;
    ``sl`` slices them to a rank's rows (None: the whole world)."""
    take = (lambda a: a) if sl is None else sl
    return dict(
        shape_type=take(static.shape_type),
        size=take(static.shape_size),
        layer=take(static.layer),
        mask=take(static.mask),
        friction=take(static.friction),
        restitution=take(static.restitution),
        inv_mass=take(static.inv_mass),
        inv_inertia=take(static.inv_inertia_body),
    )


def make_entity_sharded_contact_phase(
    static,
    mesh,
    max_neighbors: int = 8,
    solver_iterations: int = 10,
    aabb_margin: float = 0.04,
):
    """Build the sharded (narrowphase + solve) phase over an
    ``("entity_shard",)`` mesh.

    Returns ``fn(pos, quat, vel, ang, is_dynamic, solid, dt) -> (vel,
    ang)``: every argument and result replicated (the same whole tensors
    on every rank; replicated DTensors are read locally); rank d
    processes rows ``[d*N/D, (d+1)*N/D)``, and N must divide by D.
    """
    n_dev = mesh.size()
    rank = mesh.get_local_rank()
    group = mesh.get_group()

    def phase(pos, quat, vel, ang, is_dynamic, solid, dt):
        pos, quat, vel, ang, is_dynamic, solid, dt = (
            ranks.replicated(a)
            for a in (pos, quat, vel, ang, is_dynamic, solid, dt))
        dt = torch.as_tensor(dt, dtype=torch.float32, device=pos.device)
        n = pos.shape[0]
        if n % n_dev:
            raise ValueError(f"{n} bodies do not divide over {n_dev} ranks")
        rows = n // n_dev
        r0 = rank * rows

        def sl(a):
            return a[r0:r0 + rows]

        st_f = static_columns(static)
        st_f["dyn"], st_f["solid"] = is_dynamic, solid
        st_l = static_columns(static, sl)
        st_l["dyn"], st_l["solid"] = sl(is_dynamic), sl(solid)
        _, _, v_full, w_full = local_rows_contact_solve(
            r0, rows, n, sl(pos), sl(quat), sl(vel), sl(ang),
            pos, quat, vel, ang, st_l, st_f, static.ground_enabled, dt,
            solver_iterations, max_neighbors, group,
            aabb_margin=aabb_margin)
        return v_full, w_full

    return phase
