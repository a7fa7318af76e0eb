"""Velocity-level contact solver: fixed-iteration mass-splitting Jacobi.

Counterpart of ``banggameengine_tpu/physics/solver.py``: the constants the
transposed pipeline (:mod:`contact_t`) reads, and the ``[..., 3]``-minor
solver of the dense route: :func:`compact_contacts` compresses the
narrowphase's candidate slots to a fixed per-body budget, and
:func:`solve_contacts_unified` runs the warm-started, heavy-ball,
mass-splitting Jacobi iterations over them.  Each unordered pair appears
mirrored in both bodies' rows, so a body's impulses sum along its row.
Partner id -1 is the static world (the ground plane): no velocity,
infinite mass.

Where the JAX module moves payloads with one-hot contractions (the
compaction, and the partner read when ``n <= 128``), this one gathers by
index: the same entries land in the same slots, so ids, masks and feature
ids are equal and finite floats are equal up to the sign of zero.  A
one-hot contraction multiplies every unselected entry by 0, so a
non-finite value in an unselected slot turns the selected one into NaN
there (ROADMAP §3); a gather returns only the selected entries.  Small dot
products are written as multiplies and sums, so no matmul (TF32 or not)
carries payload.
"""

from __future__ import annotations

import contextlib

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

BAUMGARTE = 0.2            # Bullet global ERP default
PENETRATION_SLOP = 0.005   # ~ Bullet linear slop
RESTITUTION_THRESHOLD = 1.0  # Bullet restitution velocity threshold
WARM_START_FACTOR = 0.85   # btContactSolverInfo m_warmstartingFactor


def _cross(u: Tensor, v: Tensor) -> Tensor:
    return math3d._cross(u, v)


def _matvec(m: Tensor, v: Tensor) -> Tensor:
    """``einsum("...ij,...j->...i", m, v)`` as multiplies and a sum."""
    return (m * v[..., None, :]).sum(dim=-1)


def _orthonormal_tangents(n: Tensor) -> tuple[Tensor, Tensor]:
    """Two tangents orthogonal to the unit normal ``n``, branchless."""
    x_axis = torch.zeros_like(n)
    x_axis[..., 0] = 1.0
    y_axis = torch.zeros_like(n)
    y_axis[..., 1] = 1.0
    helper = torch.where((n[..., 0].abs() < 0.7)[..., None], x_axis, y_axis)
    t1 = _cross(n, helper)
    t1 = t1 / torch.sqrt((t1 * t1).sum(dim=-1, keepdim=True)).clamp_min(1e-9)
    return t1, _cross(n, t1)


def inv_inertia_world(quat: Tensor, inv_inertia_body: Tensor) -> Tensor:
    """I^-1_world = R diag(I^-1_body) R^T, [..., 3, 3]."""
    r = math3d.quat_to_mat3(quat)
    rd = r * inv_inertia_body[..., None, :]
    return (rd[..., :, None, :] * r[..., None, :, :]).sum(dim=-1)


def compaction_index(valid: Tensor,
                     budget: int) -> tuple[Tensor, Tensor, Tensor]:
    """Stable compaction in index form, the counterpart of the JAX
    module's one-hot ``compaction_matrix``.

    valid bool[..., M] -> (src int64[..., budget]: the candidate slot that
    lands in each output slot, clamped into range where none does;
    new_valid bool[..., budget]; counts int32[...] of valid slots).  Output
    slot c takes the (c+1)-th valid candidate: the first slot whose running
    count reaches c + 1."""
    m = valid.shape[-1]
    counts_incl = torch.cumsum(valid.to(torch.int32), dim=-1,
                               dtype=torch.int32)
    want = torch.arange(1, budget + 1, dtype=torch.int32,
                        device=valid.device)
    want = want.expand(valid.shape[:-1] + (budget,)).contiguous()
    src = torch.searchsorted(counts_incl.contiguous(), want).clamp_max(m - 1)
    counts = counts_incl[..., -1]
    new_valid = (torch.arange(budget, device=valid.device)
                 < counts.clamp_max(budget)[..., None])
    return src, new_valid, counts


def compact_contacts(
    b_idx: Tensor,    # int32[N, M] partner per slot (-1 = static world)
    point: Tensor,    # f32[N, M, 3]
    normal: Tensor,   # f32[N, M, 3]
    depth: Tensor,    # f32[N, M]
    valid: Tensor,    # bool[N, M]
    budget: int,
    feat: Tensor | None = None,  # int32[N, M] contact feature ids
):
    """Compress candidate slots to ``[N, budget]`` per-body contact lists:
    (c_b, c_point, c_normal, c_depth, c_valid, overflow[, c_feat]).  Empty
    slots hold partner -1, feature -1 and zero floats; ``overflow`` counts
    the valid candidates past the budget."""
    src, new_valid, counts = compaction_index(valid, budget)
    src3 = src[..., None].expand(src.shape + (3,))

    def move(a, fill):
        return torch.where(new_valid, torch.gather(a, -1, src), fill)

    def move3(a):
        return torch.where(new_valid[..., None], torch.gather(a, -2, src3),
                           0.0)

    out = (move(b_idx, -1), move3(point), move3(normal), move(depth, 0.0),
           new_valid)
    overflow = (counts - budget).clamp_min(0).sum().to(torch.int32)
    if feat is not None:
        return out + (overflow, move(feat, -1))
    return out + (overflow,)


def solve_contacts_unified(
    v: Tensor,            # f32[N, 3] linear velocity (pre-solve)
    w: Tensor,            # f32[N, 3] angular velocity
    pos: Tensor,          # f32[N, 3] body centres
    inv_m: Tensor,        # f32[N]
    inv_i_world: Tensor,  # f32[N, 3, 3]
    c_b: Tensor,          # int32[N, C] partner ids (-1 = static world)
    c_point: Tensor,      # f32[N, C, 3]
    c_normal: Tensor,     # f32[N, C, 3] from the partner toward the row body
    c_depth: Tensor,      # f32[N, C]
    c_valid: Tensor,      # bool[N, C]
    c_mu: Tensor,         # f32[N, C] combined friction
    c_e: Tensor,          # f32[N, C] combined restitution
    dt: Tensor,
    warm: tuple[Tensor, Tensor, Tensor] | None,
    momentum: float,
    iterations: int = 10,
    sor: float = 1.0,
    joints=None,
):
    """Solve the compacted contact set; returns the post-solve (v, w) and
    the accumulated (ln, lt1, lt2) [N, C] for the caller's contact cache.

    ``warm`` = last step's feature-matched (ln, lt1, lt2): applied up
    front, damped by Bullet's warm-starting factor, and the accumulators
    start from them; None starts from zero.  ``momentum`` is the
    heavy-ball factor over the lambda iterates (0 skips it, as the JAX
    function does), ``sor`` the over-relaxation of each update.

    The three directions of a contact (normal, tangent 1, tangent 2) run
    as one ``[N, C, 3, 3]`` block wherever the JAX function applies the
    same operations to each, and the three accumulators as one ``[N, C,
    3]`` block: the same arithmetic per element in fewer launches.  The
    impulse ``dln n + dlt1 t1 + dlt2 t2`` is a sum over the direction axis
    in that order.

    ``joints`` (:class:`joints.JointRows`, the dense route's joint rows)
    joins the joints' rows to the iterations: each body's split counts its
    joints beside its contacts, the rows' warm start goes in after the
    contacts', and each iteration updates the rows from the velocities at
    its start (span ``physics.joints``), then the contacts from the same
    velocities (span ``physics.solver``), and adds both changes: one
    Jacobi step.  The caller then holds no span open, and the call
    returns the rows' accumulated impulses [J, ROWS] last."""
    def stage(name):
        return (contextlib.nullcontext() if joints is None
                else span(name, v.device))

    with stage("physics.solver"):
        is_static = c_b < 0
        safe_b = c_b.clamp_min(0).to(torch.int64)

        ra = c_point - pos[:, None]                    # [N, C, 3]
        rb = c_point - pos[safe_b]
        t1, t2 = _orthonormal_tangents(c_normal)
        dirs = torch.stack([c_normal, t1, t2], dim=-2)  # [N, C, 3 dirs, 3]

        im_b = torch.where(is_static, 0.0, inv_m[safe_b])
        ib = torch.where(is_static[..., None, None], 0.0,
                         inv_i_world[safe_b])

        # k along each direction: inv_m_a + inv_m_b + d.((I_a (ra x d)) x ra)
        # + d.((I_b (rb x d)) x rb), floored at 1e-9
        ra3, rb3 = ra[..., None, :], rb[..., None, :]
        ang_a = _cross(_matvec(inv_i_world[:, None, None],
                               _cross(ra3, dirs)), ra3)
        ang_b = _cross(_matvec(ib[..., None, :, :], _cross(rb3, dirs)), rb3)
        k = ((inv_m[:, None] + im_b)[..., None]
             + (dirs * ang_a).sum(dim=-1) + (dirs * ang_b).sum(dim=-1)
             ).clamp_min(1e-9)                         # [N, C, 3 dirs]

        static6 = is_static[..., None]

        def rel_vel(v_, w_):
            va = v_[:, None] + _cross(w_[:, None], ra)
            # the partner's linear and angular velocity in one gather
            vw_b = torch.where(static6, 0.0,
                               torch.cat([v_, w_], dim=1)[safe_b])
            return va - (vw_b[..., :3] + _cross(vw_b[..., 3:], rb))

        def along(vr):
            """The relative velocity along (normal, tangent 1, tangent 2)."""
            return (vr[..., None, :] * dirs).sum(dim=-1)

        vn0 = along(rel_vel(v, w))[..., 0]
        bounce = c_e * (-vn0 - RESTITUTION_THRESHOLD).clamp_min(0.0)
        # f32 / f32, as JAX evaluates BAUMGARTE / dt
        baum = (torch.full_like(dt, BAUMGARTE) / dt) * (
            c_depth - PENETRATION_SLOP).clamp_min(0.0)
        target = torch.maximum(bounce, baum)

        split = c_valid.sum(dim=-1).to(torch.float32)
        if joints is not None:
            split = split + joints.count
        split = split.clamp_min(1.0)
        inv_m_split = (inv_m / split)[:, None]
        # the joints' impulses: each side's share divided by its split, or
        # whole where the rows' effective masses took the split already
        joint_split = (torch.ones_like(split) if joints is not None
                       and joints.mass_splitting else split)

        def apply(v_, w_, dl):
            """Add the impulses ``dl`` [N, C, 3 dirs] along the directions."""
            imp = (dl[..., None] * dirs).sum(dim=-2)   # [N, C, 3]
            lin = imp.sum(dim=1)
            ang = _cross(ra, imp).sum(dim=1)
            return (v_ + lin * inv_m_split,
                    w_ + _matvec(inv_i_world, ang) / split[:, None])

        # the cached impulses go in before iterating (the restitution target
        # above already holds the true pre-solve approach speed)
        if warm is None:
            lam = torch.zeros_like(k)
        else:
            lam = torch.where(
                c_valid[..., None],
                torch.stack([warm[0].clamp_min(0.0), warm[1], warm[2]],
                            dim=-1) * WARM_START_FACTOR, 0.0)
            v, w = apply(v, w, lam)
        # the accumulators (ln, lt1, lt2) as one [N, C, 3] block: each update
        # is lam - (v_d - target_d) / k_d, the normal's target the bounce
        # or Baumgarte speed and the tangents' 0; then the normal is clamped
        # at 0 (a floor of -inf leaves the tangents), and after the heavy-ball
        # step the tangents at +-mu ln with the normal's new ln.  -(vn -
        # target) / kn added is (vn - target) / kn subtracted, exactly.
        tgt = torch.cat([target[..., None], torch.zeros_like(lam[..., 1:])],
                        dim=-1)
        floor = torch.where(torch.arange(3, device=lam.device) == 0, 0.0,
                            -torch.inf).to(lam.dtype)
        valid3 = c_valid[..., None]
    plam = lam
    if joints is not None:
        with stage("physics.joints"):
            jlam = joints.warm
            v, w = _add_joints(v, w, joints.body_impulse(jlam), inv_m,
                               inv_i_world, joint_split)
        jplam = jlam

    for _ in range(iterations):
        if joints is not None:
            with stage("physics.joints"):
                jnew = joints.update(v, w, jlam, jplam, momentum)
                jimp = joints.body_impulse(jnew - jlam)
                jplam, jlam = jlam, jnew
        with stage("physics.solver"):
            step = along(rel_vel(v, w)) - tgt
            if sor != 1.0:
                step = sor * step
            new = torch.maximum(lam - step / k, floor)
            if momentum:
                # heavy-ball extrapolation over the lambda iterates,
                # projected back onto the cone
                new = new + momentum * (new - plam)
            ln_new = new[..., 0].clamp_min(0.0)
            max_f = (c_mu * torch.where(c_valid, ln_new, lam[..., 0])
                     )[..., None]
            new = torch.cat([ln_new[..., None],
                             torch.clamp(new[..., 1:], -max_f, max_f)],
                            dim=-1)
            dl = torch.where(valid3, new - lam, 0.0)
            plam = lam
            lam = torch.where(valid3, new, lam)
            v, w = apply(v, w, dl)
            if joints is not None:
                v, w = _add_joints(v, w, jimp, inv_m, inv_i_world,
                                   joint_split)
    if joints is None:
        return v, w, lam.unbind(-1)
    return v, w, lam.unbind(-1), jlam


def _add_joints(v, w, imp, inv_m, inv_i_world, split):
    """``v``, ``w`` with the joints' impulses ``imp`` [N, 6] added, each
    body's share divided by its split."""
    return (v + imp[:, :3] * (inv_m / split)[:, None],
            w + _matvec(inv_i_world, imp[:, 3:]) / split[:, None])
