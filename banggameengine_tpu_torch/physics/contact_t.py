"""Transposed (component-form) box contact pipeline and Jacobi solver.

Counterpart of ``banggameengine_tpu/physics/contact_t.py`` for box-only
scenes: :func:`box_contacts_t` (15-axis SAT, corner and edge-edge
manifolds, ground contacts, the 4-point per-pair cap, the per-body budget
and the persistent-cache feature ids) and :func:`solve_contacts_t`
(warm-started, heavy-ball mass-splitting Jacobi) on its gather route.
Every intermediate is ``[slots, N]`` with the body axis last, as in the
JAX module, and the math is the same expression for expression, so the two
agree to f32 rounding.

Not ported yet: the capsule slots (``shape_type=``) and the block-diagonal
lane-roll partner read (``block_size=``); both raise NotImplementedError.

Compaction: where the JAX module moves the c-th valid candidate by a sum
of one-hot selects, this one finds the candidate's row with a stable sort
of the validity mask and gathers it.  Both pick the same row, so integer
outputs are equal and float outputs equal up to the sign of zero.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.physics.solver import (
    BAUMGARTE,
    PENETRATION_SLOP,
    RESTITUTION_THRESHOLD,
    WARM_START_FACTOR,
)
from banggameengine_tpu_torch.state import FEAT_STRIDE

Tensor = torch.Tensor

_LATERAL_MARGIN = 0.02   # == narrowphase._LATERAL_MARGIN
K_BB = 17                # 8 + 8 corners + SAT-center fallback
K_GROUND = 8
_MANIFOLD_CAP = 4        # Bullet's MANIFOLD_CACHE_SIZE

# the 8 corner sign combinations of a box (x, y, z in {-1, +1})
_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
          for sz in (-1.0, 1.0)]


def _rot_comps(quat: Tensor):
    """quat [N,4] -> tuple of 9 tensors [N]: row-major R[i][j]."""
    r = math3d.quat_to_mat3(quat)
    return tuple(r[:, i, j] for i in range(3) for j in range(3))


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _sign_eps(x, eps=1e-5):
    return torch.where(x > eps, 1.0, torch.where(x < -eps, -1.0, 0.0))


def _first_valid_rows(valid: Tensor, c: int) -> tuple[Tensor, Tensor]:
    """Rows of the first ``c`` True entries of ``valid`` [S, ...] along dim
    0, in ascending order: (rows int64[min(c, S), ...], got bool[c, ...]),
    where ``got[r]`` says the r-th valid entry exists."""
    rows = torch.sort((~valid).to(torch.uint8), dim=0, stable=True).indices
    counts = valid.sum(dim=0)
    iota = torch.arange(c, device=valid.device).view((c,) + (1,) * counts.dim())
    return rows[:c], iota < counts


def _gather_rows(planes: Tensor, rows: Tensor, got: Tensor, fill) -> Tensor:
    """planes [F, S, ...] -> [F, c, ...]: the chosen rows of every plane,
    ``fill`` where ``got`` is False (and past S when S < c)."""
    idx = rows.unsqueeze(0).expand((planes.shape[0],) + rows.shape)
    out = torch.gather(planes, 1, idx)
    c = got.shape[0]
    if out.shape[1] < c:
        pad = out.new_full((out.shape[0], c - out.shape[1]) + out.shape[2:],
                           fill)
        out = torch.cat([out, pad], dim=1)
    return torch.where(got, out, fill)


def box_contacts_t(
    pos: Tensor,        # f32[N,3]
    quat: Tensor,       # f32[N,4]
    half: Tensor,       # f32[N,3] box half extents
    nb_idx: Tensor,     # int32[N,K] partner ids (-1 padded)
    nb_valid: Tensor,   # bool[N,K]
    ground_valid: Tensor,  # bool[N] row may contact the ground plane
    budget: int = 12,
    orig_id: Tensor | None = None,  # int[N] original (unsorted) body ids
    shape_type: Tensor | None = None,
):
    """Box-box SAT manifolds + ground contacts, compacted per body.

    Returns transposed contact tensors, each [C, N] (C = budget): partner
    ids (int32, -1 = ground), point xyz, normal xyz (from partner toward
    the row body), depth, valid, then the int32 overflow count.  With
    ``orig_id``, an extra int32 ``c_feat`` [C, N] of persistent-cache
    feature ids: ``(orig_partner + 1) * FEAT_STRIDE + candidate_slot`` for
    pair contacts, the bare corner index for ground contacts.
    """
    if shape_type is not None:
        raise NotImplementedError(
            "box_contacts_t(shape_type=...): the capsule slots are not "
            "ported yet (ROADMAP queue 1, item 5)")
    n = pos.shape[0]
    k = nb_idx.shape[1]
    cap = _MANIFOLD_CAP
    want_feat = orig_id is not None
    kn_shape = (k, n)

    px, py, pz = pos.unbind(1)
    hx, hy, hz = half.unbind(1)
    a = _rot_comps(quat)   # a[3*i+j] = Ra[i][j], shape [N]

    idx_t = nb_idx.T                        # [K,N]
    ok_t = nb_valid.T
    safe = idx_t.clamp_min(0).to(torch.int64)

    # partner attributes in one channel-major gather: [15, N] -> [15, K, N]
    g = torch.stack([px, py, pz, hx, hy, hz, *a])[:, safe]
    qbx, qby, qbz = g[0], g[1], g[2]
    gx, gy, gz = g[3], g[4], g[5]
    b = tuple(g[6 + i] for i in range(9))               # Rb comps, [K,N]

    # ---- SAT: 15 axes, component form ---------------------------------
    # R = Ra^T Rb  (r[i][j] = sum_k Ra[k][i] Rb[k][j]), [K,N]
    r = [[a[0 + i] * b[0 + j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j]
          for j in range(3)] for i in range(3)]
    ar = [[r[i][j].abs() for j in range(3)] for i in range(3)]

    twx, twy, twz = qbx - px, qby - py, qbz - pz       # t in world
    ta = [a[0 + i] * twx + a[3 + i] * twy + a[6 + i] * twz for i in range(3)]
    tb = [b[0 + i] * twx + b[3 + i] * twy + b[6 + i] * twz for i in range(3)]

    ha = [c.expand(kn_shape) for c in (hx, hy, hz)]
    hb = [gx, gy, gz]

    best_d = torch.full(kn_shape, float("inf"), device=pos.device)
    zeros_kn = torch.zeros(kn_shape, device=pos.device)
    best = (best_d, zeros_kn, zeros_kn, zeros_kn,
            torch.zeros(kn_shape, dtype=torch.int32, device=pos.device),
            torch.zeros(kn_shape, dtype=torch.bool, device=pos.device))

    def consider(ov, axx, axy, axz, axis_ok, axis_id, best):
        best_d, bnx, bny, bnz, best_ax, separated = best
        sep = ov < 0.0
        take = ov < best_d
        if axis_ok is not None:
            sep = sep & axis_ok
            take = take & axis_ok
        separated = separated | sep
        best_d = torch.where(take, ov, best_d)
        bnx = torch.where(take, axx, bnx)
        bny = torch.where(take, axy, bny)
        bnz = torch.where(take, axz, bnz)
        best_ax = torch.where(take, axis_id, best_ax)
        return best_d, bnx, bny, bnz, best_ax, separated

    for i in range(3):      # A face axes (world = Ra column i)
        ov = (ha[i] + hb[0] * ar[i][0] + hb[1] * ar[i][1] + hb[2] * ar[i][2]
              - ta[i].abs())
        best = consider(ov, a[0 + i], a[3 + i], a[6 + i], None, i, best)
    for j in range(3):      # B face axes (world = Rb column j)
        ov = (ha[0] * ar[0][j] + ha[1] * ar[1][j] + ha[2] * ar[2][j] + hb[j]
              - tb[j].abs())
        best = consider(ov, b[0 + j], b[3 + j], b[6 + j], None, 3 + j, best)
    for i in range(3):      # cross axes A_i x B_j
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ln = torch.sqrt((1.0 - r[i][j] ** 2).clamp_min(0.0))
            axis_ok = ln > 1e-4
            inv_ln = 1.0 / ln.clamp_min(1e-4)
            ra_ij = ha[i1] * ar[i2][j] + ha[i2] * ar[i1][j]
            rb_ij = hb[j1] * ar[i][j2] + hb[j2] * ar[i][j1]
            dist = (ta[i2] * r[i1][j] - ta[i1] * r[i2][j]).abs()
            ov = (ra_ij + rb_ij - dist) * inv_ln
            # axis = (Ra col i) x (Rb col j), then normalized by inv_ln
            cx, cy, cz = _cross(a[0 + i], a[3 + i], a[6 + i],
                                b[0 + j], b[3 + j], b[6 + j])
            best = consider(ov, cx * inv_ln, cy * inv_ln, cz * inv_ln,
                            axis_ok, 6 + 3 * i + j, best)
    sat_d, bnx, bny, bnz, best_ax, separated = best

    # orient the normal from b toward a: axis . (-t) > 0
    sgn = torch.sign(-(bnx * twx + bny * twy + bnz * twz))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    bnx, bny, bnz = bnx * sgn, bny * sgn, bnz * sgn
    overlap = ok_t & ~separated & torch.isfinite(sat_d)
    sat_d = torch.where(overlap, sat_d, 0.0)

    # ---- manifold candidates (17 slots per pair) ------------------------
    # support extents of each box along n
    proj_a = (ha[0] * (a[0] * bnx + a[3] * bny + a[6] * bnz).abs()
              + ha[1] * (a[1] * bnx + a[4] * bny + a[7] * bnz).abs()
              + ha[2] * (a[2] * bnx + a[5] * bny + a[8] * bnz).abs())
    proj_b = (hb[0] * (b[0] * bnx + b[3] * bny + b[6] * bnz).abs()
              + hb[1] * (b[1] * bnx + b[4] * bny + b[7] * bnz).abs()
              + hb[2] * (b[2] * bnx + b[5] * bny + b[8] * bnz).abs())
    plane_b = (bnx * qbx + bny * qby + bnz * qbz) + proj_b
    plane_a = (bnx * px + bny * py + bnz * pz) - proj_a

    # corners of a: 8 x [N] components (per body, shared across K)
    ca = []
    for sx, sy, sz in _SIGNS:
        ox, oy, oz = sx * hx, sy * hy, sz * hz
        ca.append((
            px + a[0] * ox + a[1] * oy + a[2] * oz,
            py + a[3] * ox + a[4] * oy + a[5] * oz,
            pz + a[6] * ox + a[7] * oy + a[8] * oz,
        ))
    # corners of b: 8 x [K,N]
    cbn = []
    for sx, sy, sz in _SIGNS:
        ox, oy, oz = sx * gx, sy * gy, sz * gz
        cbn.append((
            qbx + b[0] * ox + b[1] * oy + b[2] * oz,
            qby + b[3] * ox + b[4] * oy + b[5] * oz,
            qbz + b[6] * ox + b[7] * oy + b[8] * oz,
        ))

    slots_pt = []     # each: (x,y,z) [K,N]
    slots_depth = []
    slots_valid = []

    any_corner = torch.zeros(kn_shape, dtype=torch.bool, device=pos.device)
    for cx, cy, cz in ca:      # a's corners against b's slab + volume
        d = plane_b - (bnx * cx + bny * cy + bnz * cz)
        dxw, dyw, dzw = cx - qbx, cy - qby, cz - qbz   # corner in b's frame
        lb0 = b[0] * dxw + b[3] * dyw + b[6] * dzw
        lb1 = b[1] * dxw + b[4] * dyw + b[7] * dzw
        lb2 = b[2] * dxw + b[5] * dyw + b[8] * dzw
        inside = ((lb0.abs() <= hb[0] + _LATERAL_MARGIN)
                  & (lb1.abs() <= hb[1] + _LATERAL_MARGIN)
                  & (lb2.abs() <= hb[2] + _LATERAL_MARGIN))
        v = overlap & inside & (d <= sat_d + _LATERAL_MARGIN)
        slots_pt.append((cx.expand(kn_shape), cy.expand(kn_shape),
                         cz.expand(kn_shape)))
        slots_depth.append(d)
        slots_valid.append(v)
        any_corner = any_corner | v
    for cx, cy, cz in cbn:     # b's corners against a's slab + volume
        d = (bnx * cx + bny * cy + bnz * cz) - plane_a
        dxw, dyw, dzw = cx - px, cy - py, cz - pz
        la0 = a[0] * dxw + a[3] * dyw + a[6] * dzw
        la1 = a[1] * dxw + a[4] * dyw + a[7] * dzw
        la2 = a[2] * dxw + a[5] * dyw + a[8] * dzw
        inside = ((la0.abs() <= ha[0] + _LATERAL_MARGIN)
                  & (la1.abs() <= ha[1] + _LATERAL_MARGIN)
                  & (la2.abs() <= ha[2] + _LATERAL_MARGIN))
        v = overlap & inside & (d <= sat_d + _LATERAL_MARGIN)
        slots_pt.append((cx, cy, cz))
        slots_depth.append(d)
        slots_valid.append(v)
        any_corner = any_corner | v

    # Slot 16, the non-corner contact: for a cross-axis winner the closest
    # points of the two edges; for a face-axis winner with no corner, the
    # support-midpoint fallback.
    na0 = a[0] * bnx + a[3] * bny + a[6] * bnz   # Ra^T n comps
    na1 = a[1] * bnx + a[4] * bny + a[7] * bnz
    na2 = a[2] * bnx + a[5] * bny + a[8] * bnz
    sa0 = _sign_eps(na0) * ha[0]
    sa1 = _sign_eps(na1) * ha[1]
    sa2 = _sign_eps(na2) * ha[2]
    supax = px - (a[0] * sa0 + a[1] * sa1 + a[2] * sa2)
    supay = py - (a[3] * sa0 + a[4] * sa1 + a[5] * sa2)
    supaz = pz - (a[6] * sa0 + a[7] * sa1 + a[8] * sa2)
    nb0 = b[0] * bnx + b[3] * bny + b[6] * bnz
    nb1 = b[1] * bnx + b[4] * bny + b[7] * bnz
    nb2 = b[2] * bnx + b[5] * bny + b[8] * bnz
    sb0 = _sign_eps(nb0) * hb[0]
    sb1 = _sign_eps(nb1) * hb[1]
    sb2 = _sign_eps(nb2) * hb[2]
    supbx = qbx + (b[0] * sb0 + b[1] * sb1 + b[2] * sb2)
    supby = qby + (b[3] * sb0 + b[4] * sb1 + b[5] * sb2)
    supbz = qbz + (b[6] * sb0 + b[7] * sb1 + b[8] * sb2)

    is_edge = best_ax >= 6
    ei = torch.div(best_ax - 6, 3, rounding_mode="floor").clamp(0, 2)
    ej = torch.remainder(best_ax - 6, 3).clamp(0, 2)

    def pick(comps3, sel):
        return torch.where(sel == 0, comps3[0],
                           torch.where(sel == 1, comps3[1], comps3[2]))

    # edge directions: column ei of Ra, column ej of Rb
    uax = pick((a[0], a[1], a[2]), ei)
    uay = pick((a[3], a[4], a[5]), ei)
    uaz = pick((a[6], a[7], a[8]), ei)
    ubx = pick((b[0], b[1], b[2]), ej)
    uby = pick((b[3], b[4], b[5]), ej)
    ubz = pick((b[6], b[7], b[8]), ej)
    # edge centers: support corners with the edge-axis component zeroed
    za = (torch.where(ei == 0, 0.0, sa0), torch.where(ei == 1, 0.0, sa1),
          torch.where(ei == 2, 0.0, sa2))
    pacx = px - (a[0] * za[0] + a[1] * za[1] + a[2] * za[2])
    pacy = py - (a[3] * za[0] + a[4] * za[1] + a[5] * za[2])
    pacz = pz - (a[6] * za[0] + a[7] * za[1] + a[8] * za[2])
    zb = (torch.where(ej == 0, 0.0, sb0), torch.where(ej == 1, 0.0, sb1),
          torch.where(ej == 2, 0.0, sb2))
    pbcx = qbx + (b[0] * zb[0] + b[1] * zb[1] + b[2] * zb[2])
    pbcy = qby + (b[3] * zb[0] + b[4] * zb[1] + b[5] * zb[2])
    pbcz = qbz + (b[6] * zb[0] + b[7] * zb[1] + b[8] * zb[2])
    wx_, wy_, wz_ = pacx - pbcx, pacy - pbcy, pacz - pbcz
    cc_ = _dot(uax, uay, uaz, ubx, uby, ubz)
    a1_ = _dot(uax, uay, uaz, wx_, wy_, wz_)
    b1_ = _dot(ubx, uby, ubz, wx_, wy_, wz_)
    den = (1.0 - cc_ * cc_).clamp_min(1e-8)
    t_b = (b1_ - cc_ * a1_) / den
    s_a = cc_ * t_b - a1_
    ha_i = pick((ha[0], ha[1], ha[2]), ei)
    hb_j = pick((hb[0], hb[1], hb[2]), ej)
    s_a = torch.clamp(s_a, -ha_i, ha_i)
    t_b = torch.clamp(t_b, -hb_j, hb_j)
    edge_x = 0.5 * (pacx + s_a * uax + pbcx + t_b * ubx)
    edge_y = 0.5 * (pacy + s_a * uay + pbcy + t_b * uby)
    edge_z = 0.5 * (pacz + s_a * uaz + pbcz + t_b * ubz)

    slots_pt.append((
        torch.where(is_edge, edge_x, 0.5 * (supax + supbx)),
        torch.where(is_edge, edge_y, 0.5 * (supay + supby)),
        torch.where(is_edge, edge_z, 0.5 * (supaz + supbz)),
    ))
    slots_depth.append(sat_d)
    slots_valid.append(overlap & (is_edge | ~any_corner))

    # ---- stage 1: cap each pair's manifold at 4 points -------------------
    pts3 = torch.stack([
        torch.stack([s[0] for s in slots_pt]),
        torch.stack([s[1] for s in slots_pt]),
        torch.stack([s[2] for s in slots_pt]),
        torch.stack(slots_depth),
    ])                                             # [4, 17, K, N]
    val3 = torch.stack(slots_valid) & (pts3[3] > 0.0)
    rows3, cval = _first_valid_rows(val3, cap)     # [cap, K, N]
    cnt3 = val3.sum(dim=0)
    pair_overflow = (cnt3 - cap).clamp_min(0).sum()

    m_pair = k * cap
    pair = _gather_rows(pts3, rows3, cval, 0.0).reshape(4, m_pair, n)
    val = cval.reshape(m_pair, n)
    # normals are per-pair constants (the SAT axis): broadcast
    pair_n = torch.stack([bnx, bny, bnz])[:, None].expand(3, cap, k, n)
    prt = idx_t.expand(cap, k, n).reshape(m_pair, n)
    if want_feat:
        # preserved ORIGINAL candidate-slot ids (stable geometric features)
        partner_orig = orig_id.to(torch.int32)[safe]            # [K,N]
        feat = ((partner_orig + 1) * FEAT_STRIDE
                + rows3.to(torch.int32)).reshape(m_pair, n)

    # ground: 8 corners of each box against y=0 (normal +Y), same cap
    g_pts3 = torch.stack([
        torch.stack([c[0] for c in ca]),
        torch.stack([c[1] for c in ca]),
        torch.stack([c[2] for c in ca]),
    ])                                             # [3, 8, N]
    g_pts3 = torch.cat([g_pts3, -g_pts3[1:2]])     # + depth = -y
    g_val3 = ground_valid[None, :] & (g_pts3[3] > 0.0)
    g_rows, g_val = _first_valid_rows(g_val3, cap)
    g_cnt = g_val3.sum(dim=0)
    ground_overflow = (g_cnt - cap).clamp_min(0).sum()
    ground = _gather_rows(g_pts3, g_rows, g_val, 0.0)          # [4, cap, N]

    zeros_cn = torch.zeros((cap, n), device=pos.device)
    # [7, m_pair + cap, N]: point xyz, normal xyz, depth
    rows_f = torch.cat([
        torch.cat([pair[:3], pair_n.reshape(3, m_pair, n), pair[3:]]),
        torch.stack([ground[0], ground[1], ground[2], zeros_cn,
                     torch.ones_like(zeros_cn), zeros_cn, ground[3]]),
    ], dim=1)
    val = torch.cat([val, g_val])
    prt = torch.cat([prt, torch.full((cap, n), -1, dtype=prt.dtype,
                                     device=pos.device)])

    # ---- stage 2: compact to [budget, N] ---------------------------------
    rows2, c_valid = _first_valid_rows(val, budget)
    counts = val.sum(dim=0)
    c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep = _gather_rows(
        rows_f, rows2, c_valid, 0.0)
    int_planes = [prt]
    if want_feat:
        int_planes.append(torch.cat([feat, g_rows.to(torch.int32)]))
    ints = _gather_rows(torch.stack(int_planes), rows2, c_valid, -1)
    c_prt = ints[0]
    overflow = ((counts - budget).clamp_min(0).sum() + pair_overflow
                + ground_overflow).to(torch.int32)
    base = (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
            overflow)
    if want_feat:
        return base + (ints[1],)
    return base


def _inertia_world_comps(quat: Tensor, inv_inertia_body: Tensor):
    """Symmetric world-frame inverse inertia, 6 comps [N]
    (i00,i01,i02,i11,i12,i22); I = R diag(d) R^T."""
    a = _rot_comps(quat)
    d0, d1, d2 = inv_inertia_body.unbind(1)

    def entry(i, j):
        return (a[3 * i + 0] * d0 * a[3 * j + 0]
                + a[3 * i + 1] * d1 * a[3 * j + 1]
                + a[3 * i + 2] * d2 * a[3 * j + 2])

    return (entry(0, 0), entry(0, 1), entry(0, 2),
            entry(1, 1), entry(1, 2), entry(2, 2))


def _sym_mul(i6, vx, vy, vz):
    """(symmetric 3x3 given by 6 comps) @ v, component-wise."""
    i00, i01, i02, i11, i12, i22 = i6
    return (i00 * vx + i01 * vy + i02 * vz,
            i01 * vx + i11 * vy + i12 * vz,
            i02 * vx + i12 * vy + i22 * vz)


def solve_contacts_t(
    vel: Tensor,        # f32[N,3]
    ang: Tensor,        # f32[N,3]
    pos: Tensor,        # f32[N,3]
    quat: Tensor,       # f32[N,4]
    inv_m: Tensor,      # f32[N]
    inv_inertia_body: Tensor,  # f32[N,3]
    c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
    friction, restitution,    # [N] material params (mu/e derived per pair)
    dt: Tensor,               # f32[]
    iterations: int = 10,
    ground_friction: float = 0.5,
    warm=None,
    return_lambdas: bool = False,
    momentum: float = 0.0,
    block_size: int | None = None,
    block_shifts: tuple | None = None,
):
    """Mass-splitting Jacobi contact solve on the gather route; returns
    (vel, ang) and, with ``return_lambdas``, the accumulated (ln, lt1, lt2).

    ``warm`` = cached (ln, lt1, lt2), each [C, N], from feature-matched
    previous-step contacts: applied up front and used to seed the
    accumulators.  ``momentum`` is the heavy-ball factor over the lambda
    iterates.
    """
    if block_size is not None or block_shifts:
        raise NotImplementedError(
            "solve_contacts_t(block_size=...): the lane-roll partner read "
            "is not ported yet (ROADMAP queue 1, item 8)")
    vx, vy, vz = vel.unbind(1)
    wx, wy, wz = ang.unbind(1)
    px, py, pz = pos.unbind(1)

    is_static = c_prt < 0
    safe = c_prt.clamp_min(0).to(torch.int64)

    # iteration-invariant partner attributes in one gather: [12, C, N]
    ia = _inertia_world_comps(quat, inv_inertia_body)       # 6 x [N]
    gp = torch.stack([px, py, pz, inv_m, friction, restitution, *ia])[:, safe]

    rax = c_ptx - px[None]
    ray = c_pty - py[None]
    raz = c_ptz - pz[None]
    rbx = c_ptx - gp[0]
    rby = c_pty - gp[1]
    rbz = c_ptz - gp[2]

    c_mu = torch.where(is_static, friction[None, :] * ground_friction,
                       friction[None, :] * gp[4])
    c_e = torch.where(is_static, 0.0, restitution[None, :] * gp[5])

    # orthonormal tangents (the same branchless helper as the JAX solver)
    use_x = c_nx.abs() < 0.7
    hx = torch.where(use_x, 1.0, 0.0)
    hy = torch.where(use_x, 0.0, 1.0)
    t1x, t1y, t1z = _cross(c_nx, c_ny, c_nz, hx, hy, torch.zeros_like(hx))
    t1n = torch.sqrt(t1x ** 2 + t1y ** 2 + t1z ** 2).clamp_min(1e-9)
    t1x, t1y, t1z = t1x / t1n, t1y / t1n, t1z / t1n
    t2x, t2y, t2z = _cross(c_nx, c_ny, c_nz, t1x, t1y, t1z)

    ia_c = tuple(c[None] for c in ia)                       # broadcast [1,N]
    ib = tuple(torch.where(is_static, 0.0, gp[6 + i]) for i in range(6))
    im_a = inv_m[None]
    im_b = torch.where(is_static, 0.0, gp[3])

    def k_along(dx, dy, dz):
        cxa, cya, cza = _cross(rax, ray, raz, dx, dy, dz)
        ixa, iya, iza = _sym_mul(ia_c, cxa, cya, cza)
        axx, axy, axz = _cross(ixa, iya, iza, rax, ray, raz)
        cxb, cyb, czb = _cross(rbx, rby, rbz, dx, dy, dz)
        ixb, iyb, izb = _sym_mul(ib, cxb, cyb, czb)
        bxx, bxy, bxz = _cross(ixb, iyb, izb, rbx, rby, rbz)
        kk = (im_a + im_b
              + _dot(dx, dy, dz, axx, axy, axz)
              + _dot(dx, dy, dz, bxx, bxy, bxz))
        return kk.clamp_min(1e-9)

    kn = k_along(c_nx, c_ny, c_nz)
    kt1 = k_along(t1x, t1y, t1z)
    kt2 = k_along(t2x, t2y, t2z)

    def rel_vel(vx_, vy_, vz_, wx_, wy_, wz_):
        cax, cay, caz = _cross(wx_[None], wy_[None], wz_[None],
                               rax, ray, raz)
        vax = vx_[None] + cax
        vay = vy_[None] + cay
        vaz = vz_[None] + caz
        # partner velocities in one gather: [6, C, N]
        g = torch.stack([vx_, vy_, vz_, wx_, wy_, wz_])[:, safe]
        g = torch.where(is_static[None], 0.0, g)
        cbx, cby, cbz = _cross(g[3], g[4], g[5], rbx, rby, rbz)
        return (vax - g[0] - cbx, vay - g[1] - cby, vaz - g[2] - cbz)

    rx, ry, rz = rel_vel(vx, vy, vz, wx, wy, wz)
    vn0 = _dot(rx, ry, rz, c_nx, c_ny, c_nz)
    bounce = c_e * (-vn0 - RESTITUTION_THRESHOLD).clamp_min(0.0)
    # f32 / f32, as JAX evaluates BAUMGARTE / dt (a Python numerator would
    # go through the reciprocal and differ in the last bit)
    baum = (torch.full_like(dt, BAUMGARTE) / dt) * (
        c_dep - PENETRATION_SLOP).clamp_min(0.0)
    target = torch.maximum(bounce, baum)

    cnt = c_valid.sum(dim=0).to(torch.float32)
    inv_split_m = inv_m / cnt.clamp_min(1.0)
    inv_split = 1.0 / cnt.clamp_min(1.0)

    if warm is not None:
        # Bullet's 0.85 warm-starting factor: damped reuse
        ln0 = torch.where(c_valid, warm[0].clamp_min(0.0) * WARM_START_FACTOR,
                          0.0)
        lt10 = torch.where(c_valid, warm[1] * WARM_START_FACTOR, 0.0)
        lt20 = torch.where(c_valid, warm[2] * WARM_START_FACTOR, 0.0)
        impx0 = ln0 * c_nx + lt10 * t1x + lt20 * t2x
        impy0 = ln0 * c_ny + lt10 * t1y + lt20 * t2y
        impz0 = ln0 * c_nz + lt10 * t1z + lt20 * t2z
        vx = vx + impx0.sum(dim=0) * inv_split_m
        vy = vy + impy0.sum(dim=0) * inv_split_m
        vz = vz + impz0.sum(dim=0) * inv_split_m
        tqx0, tqy0, tqz0 = _cross(rax, ray, raz, impx0, impy0, impz0)
        iwx0, iwy0, iwz0 = _sym_mul(
            ia, tqx0.sum(dim=0), tqy0.sum(dim=0), tqz0.sum(dim=0))
        wx = wx + iwx0 * inv_split
        wy = wy + iwy0 * inv_split
        wz = wz + iwz0 * inv_split
    else:
        ln0 = lt10 = lt20 = torch.zeros_like(c_dep)

    ln, lt1, lt2 = ln0, lt10, lt20
    pln, plt1, plt2 = ln0, lt10, lt20
    for _ in range(iterations):
        rx, ry, rz = rel_vel(vx, vy, vz, wx, wy, wz)
        vn = _dot(rx, ry, rz, c_nx, c_ny, c_nz)
        ln_new = (ln + (-(vn - target)) / kn).clamp_min(0.0)
        if momentum:
            # heavy-ball extrapolation over the lambda iterates
            ln_new = (ln_new + momentum * (ln_new - pln)).clamp_min(0.0)
        dln = torch.where(c_valid, ln_new - ln, 0.0)
        pln = ln
        ln = torch.where(c_valid, ln_new, ln)

        vt1 = _dot(rx, ry, rz, t1x, t1y, t1z)
        vt2 = _dot(rx, ry, rz, t2x, t2y, t2z)
        max_f = c_mu * ln
        lt1_new = lt1 - vt1 / kt1
        lt2_new = lt2 - vt2 / kt2
        if momentum:
            lt1_new = lt1_new + momentum * (lt1_new - plt1)
            lt2_new = lt2_new + momentum * (lt2_new - plt2)
        lt1_new = torch.clamp(lt1_new, -max_f, max_f)
        lt2_new = torch.clamp(lt2_new, -max_f, max_f)
        dlt1 = torch.where(c_valid, lt1_new - lt1, 0.0)
        dlt2 = torch.where(c_valid, lt2_new - lt2, 0.0)
        plt1, plt2 = lt1, lt2
        lt1 = torch.where(c_valid, lt1_new, lt1)
        lt2 = torch.where(c_valid, lt2_new, lt2)

        impx = dln * c_nx + dlt1 * t1x + dlt2 * t2x
        impy = dln * c_ny + dlt1 * t1y + dlt2 * t2y
        impz = dln * c_nz + dlt1 * t1z + dlt2 * t2z
        tqx, tqy, tqz = _cross(rax, ray, raz, impx, impy, impz)
        vx = vx + impx.sum(dim=0) * inv_split_m
        vy = vy + impy.sum(dim=0) * inv_split_m
        vz = vz + impz.sum(dim=0) * inv_split_m
        iwx, iwy, iwz = _sym_mul(ia, tqx.sum(dim=0), tqy.sum(dim=0),
                                 tqz.sum(dim=0))
        wx = wx + iwx * inv_split
        wy = wy + iwy * inv_split
        wz = wz + iwz * inv_split

    out = (torch.stack([vx, vy, vz], dim=1), torch.stack([wx, wy, wz], dim=1))
    if return_lambdas:
        return out + ((ln, lt1, lt2),)
    return out
