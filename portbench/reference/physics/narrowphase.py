"""Narrowphase contact generation for the reference's shape set.

Counterpart of ``banggameengine_tpu/physics/narrowphase.py``: oriented
boxes, Y-axis capsules and the implicit static ground plane y = 0, with
branchless, mask-driven manifolds in the ``[..., 3]``-minor layout and the
JAX module's slot order (the contact cache's feature ids name these slots):

- box-box: the 15-axis SAT minimum-translation vector, both boxes' 8
  corners laterally inside the other box, and a SAT-centre slot (the edges'
  closest points when a cross axis wins), ``K_BB = 17`` slots;
- box-capsule: the capsule's core segment sampled at 3 points, each a
  sphere against the box (slots 17-19);
- capsule-capsule: the segments' closest points (slot 20);
- ground: box corners or capsule end spheres against y = 0.

The normal points from body b toward body a; ``depth > 0`` penetrates.
Every function broadcasts over leading batch dimensions.  Small dot
products are multiplies and sums (no matmul), and the SAT's winning axis
is ``torch.argmin``'s first minimum, as ``jnp.argmin`` picks it.
"""

from __future__ import annotations

import torch

from portbench.reference import math3d
from portbench.reference.physics import shapes as sh
from portbench.reference.state import SHAPE_BOX, SHAPE_CAPSULE

Tensor = torch.Tensor

# contact slots per pair: 17 box-box (8 + 8 corners + 1 SAT centre)
#                         + 3 capsule samples + 1 capsule-capsule
K_BB = 17
K_PAIR = K_BB + 3 + 1
# ground contact slots per body: 8 corners (box) / 2 end spheres (capsule)
K_GROUND = 8

_LATERAL_MARGIN = 0.02  # corner containment slack for manifold selection


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(dim=-1)


def _rot_t_vec(rot: Tensor, v: Tensor) -> Tensor:
    """``einsum("...ij,...i->...j", rot, v)``: R^T v."""
    return (rot * v[..., :, None]).sum(dim=-2)


def _rot_vec(rot: Tensor, v: Tensor) -> Tensor:
    """``einsum("...ij,...j->...i", rot, v)``: R v."""
    return (rot * v[..., None, :]).sum(dim=-1)


def _unit_y(like: Tensor) -> Tensor:
    """(0, 1, 0) shaped like ``like`` [..., 3], made on its device."""
    y = torch.zeros_like(like)
    y[..., 1] = 1.0
    return y


def _cap_samples(seg0: Tensor, seg1: Tensor) -> Tensor:
    """The capsule core's sample points at t = 0, 0.5, 1: [..., 3, 3]."""
    ts = (torch.arange(3, dtype=seg0.dtype, device=seg0.device)
          * 0.5)[:, None]
    return seg0[..., None, :] + (seg1 - seg0)[..., None, :] * ts


def _point_in_obb(pts, pos_b, rot_b, half_b, margin):
    """Boolean: points inside the oriented box grown by ``margin``."""
    local = _rot_t_vec(rot_b, pts - pos_b)
    return (local.abs() <= half_b + margin).all(dim=-1)


def box_box_sat_mtv(pos_a, rot_a, half_a, pos_b, rot_b, half_b):
    """Batched box-box SAT with the minimum-translation vector.

    Inputs broadcast to a common batch shape B; returns (n f32[B, 3] unit
    axis from b toward a, depth f32[B], overlap bool[B], best int32[B] the
    winning axis: 0-2 A's faces, 3-5 B's faces, 6-14 the cross axes
    A_i x B_j with i = (best-6)//3, j = (best-6)%3)."""
    b_shape = torch.broadcast_shapes(pos_a.shape[:-1], pos_b.shape[:-1])
    pos_a = pos_a.expand(b_shape + (3,))
    pos_b = pos_b.expand(b_shape + (3,))
    rot_a = rot_a.expand(b_shape + (3, 3))
    rot_b = rot_b.expand(b_shape + (3, 3))
    ha = half_a.expand(b_shape + (3,))
    hb = half_b.expand(b_shape + (3,))
    # R = A^T B: r[i, j] = sum_k a[k, i] b[k, j]
    r = (rot_a[..., :, :, None] * rot_b[..., :, None, :]).sum(dim=-3)
    abs_r = r.abs()
    t_world = pos_b - pos_a
    t_a = _rot_t_vec(rot_a, t_world)
    t_b = _rot_t_vec(rot_b, t_world)

    # A's and B's face axes
    ov_fa = ha + (hb[..., None, :] * abs_r).sum(dim=-1) - t_a.abs()
    ov_fb = (ha[..., :, None] * abs_r).sum(dim=-2) + hb - t_b.abs()
    cols_a = rot_a.transpose(-1, -2)          # [..., i, xyz]: A's axis i
    cols_b = rot_b.transpose(-1, -2)

    # cross axes A_i x B_j as [..., i, j] planes; i1 = (i+1)%3 reads a
    # roll by -1 along i, i2 = (i+2)%3 a roll by -2 (likewise for j)
    def roll_i(x, s):
        return torch.roll(x, -s, dims=-2)

    def roll_j(x, s):
        return torch.roll(x, -s, dims=-1)

    ln = torch.sqrt((1.0 - r ** 2).clamp_min(0.0))
    ok = ln > 1e-4
    inv_ln = 1.0 / ln.clamp_min(1e-4)
    ha_i = ha[..., :, None]
    hb_j = hb[..., None, :]
    ra_ij = (roll_i(ha_i, 1) * roll_i(abs_r, 2)
             + roll_i(ha_i, 2) * roll_i(abs_r, 1))
    rb_ij = (roll_j(hb_j, 1) * roll_j(abs_r, 2)
             + roll_j(hb_j, 2) * roll_j(abs_r, 1))
    ta_i = t_a[..., :, None]
    dist = (roll_i(ta_i, 2) * roll_i(r, 1) - roll_i(ta_i, 1) * roll_i(r, 2)
            ).abs()
    ov_x = (ra_ij + rb_ij - dist) * inv_ln
    ax_x = (math3d._cross(cols_a[..., :, None, :], cols_b[..., None, :, :])
            * inv_ln[..., None])

    ov_all = torch.cat([ov_fa, ov_fb, ov_x.flatten(-2)], dim=-1)   # [B, 15]
    ax_all = torch.cat([cols_a, cols_b, ax_x.flatten(-3, -2)], dim=-2)
    va_all = torch.cat([torch.ones_like(ov_fa, dtype=torch.bool),
                        torch.ones_like(ov_fb, dtype=torch.bool),
                        ok.flatten(-2)], dim=-1)

    ov_masked = torch.where(va_all, ov_all, torch.inf)
    separated = (ov_masked < 0.0).any(dim=-1)
    best = torch.argmin(ov_masked, dim=-1, keepdim=True)
    depth = torch.gather(ov_masked, -1, best)[..., 0]
    axis = torch.gather(ax_all, -2, best[..., None].expand(b_shape + (1, 3))
                        )[..., 0, :]
    sign = torch.sign(_dot(axis, -t_world))
    sign = torch.where(sign == 0.0, 1.0, sign)
    axis = axis * sign[..., None]
    overlap = ~separated & torch.isfinite(depth)
    depth = torch.where(overlap, depth, 0.0)
    return axis, depth, overlap, best[..., 0].to(torch.int32)


def _sphere_box_contact(center, radius, pos_b, quat_b, half_b):
    """Sphere against an oriented box -> (depth, normal out of the box,
    point on the box surface), all in world space.  Broadcasts."""
    local = math3d.quat_rotate(math3d.quat_conj(quat_b), center - pos_b)
    p_local, n_local, sdist = sh.closest_point_on_box(local, half_b)
    return (radius - sdist, math3d.quat_rotate(quat_b, n_local),
            math3d.quat_rotate(quat_b, p_local) + pos_b)


def _proj_half(rot, half, axis):
    """Support extent of an oriented box along a unit axis."""
    return (half * _rot_t_vec(rot, axis).abs()).sum(dim=-1)


def _sign_eps(x, eps=1e-5):
    """sign() with a deadband, so axes nearly perpendicular to the normal
    pick no corner from float noise."""
    return torch.where(x > eps, 1.0, torch.where(x < -eps, -1.0, 0.0))


def _broadcast_pair(pos_a, quat_a, type_a, size_a,
                    pos_b, quat_b, type_b, size_b):
    b_shape = torch.broadcast_shapes(pos_a.shape[:-1], pos_b.shape[:-1],
                                     type_a.shape, type_b.shape)
    return b_shape, (
        pos_a.expand(b_shape + (3,)), quat_a.expand(b_shape + (4,)),
        type_a.expand(b_shape), size_a.expand(b_shape + (3,)),
        pos_b.expand(b_shape + (3,)), quat_b.expand(b_shape + (4,)),
        type_b.expand(b_shape), size_b.expand(b_shape + (3,)))


def pair_contacts(
    pos_a, quat_a, type_a, size_a,
    pos_b, quat_b, type_b, size_b,
    enable_capsule: bool = True,
):
    """Contact manifold for batched shape pairs.

    All inputs broadcast to a common batch shape B.  Returns (point
    f32[B, K, 3], normal f32[B, K, 3] from b toward a, depth f32[B, K],
    gvalid bool[B, K]): gvalid marks the slots whose shape-type case
    applies (penetration is ``depth > 0``).  K = K_PAIR, or K_BB when
    ``enable_capsule=False`` (box-only scenes skip the capsule blocks)."""
    b_shape, (pos_a, quat_a, type_a, size_a,
              pos_b, quat_b, type_b, size_b) = _broadcast_pair(
        pos_a, quat_a, type_a, size_a, pos_b, quat_b, type_b, size_b)
    a_box = type_a == SHAPE_BOX
    b_box = type_b == SHAPE_BOX
    a_cap = type_a == SHAPE_CAPSULE
    b_cap = type_b == SHAPE_CAPSULE
    rot_a = math3d.quat_to_mat3(quat_a)
    rot_b = math3d.quat_to_mat3(quat_b)

    # ---- box-box SAT manifold (slots 0..16) ----------------------------
    sat_n, sat_depth, sat_overlap, sat_best = box_box_sat_mtv(
        pos_a, rot_a, size_a, pos_b, rot_b, size_b)
    corners_a = sh.box_corners(pos_a, quat_a, size_a)     # [B, 8, 3]
    corners_b = sh.box_corners(pos_b, quat_b, size_b)

    plane_b = _dot(sat_n, pos_b) + _proj_half(rot_b, size_b, sat_n)
    plane_a = _dot(sat_n, pos_a) - _proj_half(rot_a, size_a, sat_n)
    depth_ca = plane_b[..., None] - _dot(sat_n[..., None, :], corners_a)
    inside_b = _point_in_obb(corners_a, pos_b[..., None, :],
                             rot_b[..., None, :, :], size_b[..., None, :],
                             _LATERAL_MARGIN)
    valid_ca = inside_b & (depth_ca <= sat_depth[..., None] + _LATERAL_MARGIN)
    depth_cb = _dot(sat_n[..., None, :], corners_b) - plane_a[..., None]
    inside_a = _point_in_obb(corners_b, pos_a[..., None, :],
                             rot_a[..., None, :, :], size_a[..., None, :],
                             _LATERAL_MARGIN)
    valid_cb = inside_a & (depth_cb <= sat_depth[..., None] + _LATERAL_MARGIN)

    # slot 16, the non-corner contact: the support midpoint, or for a
    # cross-axis winner the closest points of the two touching edges
    n_in_a = _sign_eps(_rot_t_vec(rot_a, sat_n))
    n_in_b = _sign_eps(_rot_t_vec(rot_b, sat_n))
    sup_a = pos_a - _rot_vec(rot_a, size_a * n_in_a)
    sup_b = pos_b + _rot_vec(rot_b, size_b * n_in_b)

    is_edge = sat_best >= 6
    rel = sat_best.to(torch.int64) - 6
    ei = torch.div(rel, 3, rounding_mode="floor").clamp(0, 2)
    ej = torch.remainder(rel, 3).clamp(0, 2)
    eye = torch.eye(3, dtype=pos_a.dtype, device=pos_a.device)
    hot_i = eye[ei]
    hot_j = eye[ej]
    ua = _rot_vec(rot_a, hot_i)                          # A's edge direction
    ub = _rot_vec(rot_b, hot_j)
    pa_c = pos_a - _rot_vec(rot_a, size_a * n_in_a * (1.0 - hot_i))
    pb_c = pos_b + _rot_vec(rot_b, size_b * n_in_b * (1.0 - hot_j))
    w = pa_c - pb_c
    cc_ = _dot(ua, ub)
    a1 = _dot(ua, w)
    b1 = _dot(ub, w)
    den = (1.0 - cc_ * cc_).clamp_min(1e-8)
    t_b = (b1 - cc_ * a1) / den
    s_a = cc_ * t_b - a1
    ha_i = _dot(size_a, hot_i)
    hb_j = _dot(size_b, hot_j)
    s_a = torch.clamp(s_a, -ha_i, ha_i)
    t_b = torch.clamp(t_b, -hb_j, hb_j)
    edge_pt = 0.5 * (pa_c + s_a[..., None] * ua + pb_c + t_b[..., None] * ub)

    center_pt = torch.where(is_edge[..., None], edge_pt,
                            0.5 * (sup_a + sup_b))[..., None, :]
    any_corner = valid_ca.any(dim=-1) | valid_cb.any(dim=-1)
    center_valid = (is_edge | ~any_corner)[..., None]

    bb_gate = (a_box & b_box & sat_overlap)[..., None]
    bb_pts = torch.cat([corners_a, corners_b, center_pt], dim=-2)
    bb_n = sat_n[..., None, :].expand(b_shape + (K_BB, 3))
    bb_depth = torch.cat([depth_ca, depth_cb, sat_depth[..., None]], dim=-1)
    bb_gvalid = torch.cat([valid_ca, valid_cb, center_valid],
                          dim=-1) & bb_gate
    if not enable_capsule:
        return bb_pts, bb_n, bb_depth, bb_gvalid

    # ---- box-capsule sphere samples (slots 17..19) ---------------------
    seg_a0, seg_a1 = sh.capsule_segment(pos_a, quat_a, size_a[..., 1])
    seg_b0, seg_b1 = sh.capsule_segment(pos_b, quat_b, size_b[..., 1])
    rad_a = size_a[..., 0]
    rad_b = size_b[..., 0]
    # a capsule against b box
    d_cb, n_cb, p_cb = _sphere_box_contact(
        _cap_samples(seg_a0, seg_a1), rad_a[..., None],
        pos_b[..., None, :], quat_b[..., None, :], size_b[..., None, :])
    # a box against b capsule (b's spheres against box a; normal flipped)
    d_bc, n_bc_outa, p_bc = _sphere_box_contact(
        _cap_samples(seg_b0, seg_b1), rad_b[..., None],
        pos_a[..., None, :], quat_a[..., None, :], size_a[..., None, :])
    a_cap_b_box = (a_cap & b_box)[..., None]
    a_box_b_cap = (a_box & b_cap)[..., None]
    bc_pts = torch.where(a_cap_b_box[..., None], p_cb, p_bc)
    bc_n = torch.where(a_cap_b_box[..., None], n_cb, -n_bc_outa)
    bc_depth = torch.where(a_cap_b_box, d_cb, d_bc)
    bc_gvalid = (a_cap_b_box | a_box_b_cap).expand(b_shape + (3,))

    # ---- capsule-capsule (slot 20) -------------------------------------
    c1, c2 = sh.closest_segment_segment(seg_a0, seg_a1, seg_b0, seg_b1)
    delta = c1 - c2
    dist = torch.sqrt(_dot(delta, delta))
    cc_n = torch.where(dist[..., None] > 1e-9,
                       delta / dist.clamp_min(1e-9)[..., None],
                       _unit_y(delta))
    cc_depth = rad_a + rad_b - dist
    cc_pt = 0.5 * (c1 + c2)
    cc_gvalid = a_cap & b_cap

    point = torch.cat([bb_pts, bc_pts, cc_pt[..., None, :]], dim=-2)
    normal = torch.cat([bb_n, bc_n, cc_n[..., None, :]], dim=-2)
    depth = torch.cat([bb_depth, bc_depth, cc_depth[..., None]], dim=-1)
    gvalid = torch.cat([bb_gvalid, bc_gvalid, cc_gvalid[..., None]], dim=-1)
    return point, normal, depth, gvalid


def pair_contacts_dense(pos, quat, shape_type, size):
    """All-pairs dense contacts over entity arrays: [N, N, K_PAIR]."""
    return pair_contacts(
        pos[:, None], quat[:, None], shape_type[:, None], size[:, None],
        pos[None, :], quat[None, :], shape_type[None, :], size[None, :])


def ground_contacts(pos, quat, shape_type, size):
    """Contacts of every shape against the implicit static plane y = 0:
    (point [N, K_GROUND, 3], normal (+y), depth, geometric validity).
    Boxes contribute their 8 corners, capsules their two end spheres."""
    n = pos.shape[0]
    is_box = shape_type == SHAPE_BOX
    is_cap = shape_type == SHAPE_CAPSULE

    corners = sh.box_corners(pos, quat, size)             # [N, 8, 3]
    box_depth = -corners[..., 1]
    seg_a, seg_b = sh.capsule_segment(pos, quat, size[..., 1])
    ends = torch.stack([seg_a, seg_b], dim=1)             # [N, 2, 3]
    radius = size[..., 0]
    cap_depth = radius[:, None] - ends[..., 1]
    cap_pts = ends.clone()
    cap_pts[..., 1] = ends[..., 1] + (-radius[:, None])

    pts = torch.where(is_box[:, None, None], corners,
                      torch.cat([cap_pts, torch.zeros_like(corners[:, 2:])],
                                dim=1))
    depth = torch.where(is_box[:, None], box_depth,
                        torch.cat([cap_depth,
                                   torch.full_like(box_depth[:, 2:], -1.0)],
                                  dim=1))
    slot = torch.arange(K_GROUND, device=pos.device)
    slot_valid = (is_box[:, None] | (slot < 2)) & (is_box | is_cap)[:, None]
    normal = _unit_y(corners)
    return pts, normal, depth, slot_valid.expand(n, K_GROUND)


def boolean_overlap_pairs(
    pos_a, quat_a, type_a, size_a,
    pos_b, quat_b, type_b, size_b,
):
    """Boolean shape overlap of batched pairs (no manifolds): box-box by
    the 15-axis SAT, box-capsule by 3 sampled spheres, capsule-capsule by
    the segments' distance.  The exact trigger mode runs it every step."""
    _, (pos_a, quat_a, type_a, size_a,
        pos_b, quat_b, type_b, size_b) = _broadcast_pair(
        pos_a, quat_a, type_a, size_a, pos_b, quat_b, type_b, size_b)
    a_box = type_a == SHAPE_BOX
    b_box = type_b == SHAPE_BOX
    a_cap = type_a == SHAPE_CAPSULE
    b_cap = type_b == SHAPE_CAPSULE
    rot_a = math3d.quat_to_mat3(quat_a)
    rot_b = math3d.quat_to_mat3(quat_b)
    _, _, sat, _ = box_box_sat_mtv(pos_a, rot_a, size_a, pos_b, rot_b, size_b)

    seg_a0, seg_a1 = sh.capsule_segment(pos_a, quat_a, size_a[..., 1])
    seg_b0, seg_b1 = sh.capsule_segment(pos_b, quat_b, size_b[..., 1])
    d_cb, _, _ = _sphere_box_contact(
        _cap_samples(seg_a0, seg_a1), size_a[..., 0:1],
        pos_b[..., None, :], quat_b[..., None, :], size_b[..., None, :])
    d_bc, _, _ = _sphere_box_contact(
        _cap_samples(seg_b0, seg_b1), size_b[..., 0:1],
        pos_a[..., None, :], quat_a[..., None, :], size_a[..., None, :])
    mixed = torch.where(a_cap & b_box, (d_cb > 0).any(dim=-1),
                        (d_bc > 0).any(dim=-1))

    c1, c2 = sh.closest_segment_segment(seg_a0, seg_a1, seg_b0, seg_b1)
    delta = c1 - c2
    cc = torch.sqrt(_dot(delta, delta)) < size_a[..., 0] + size_b[..., 0]
    return torch.where(
        a_box & b_box, sat,
        torch.where(a_cap & b_cap, cc,
                    ((a_cap & b_box) | (a_box & b_cap)) & mixed))


def boolean_overlap_matrix(pos, quat, shape_type, size, margin: float = 0.0):
    """Boolean shape overlap [N, N]: box pairs by the SAT, the others by
    any penetrating contact slot deeper than ``-margin``."""
    _, _, depth, gvalid = pair_contacts_dense(pos, quat, shape_type, size)
    pen = (gvalid & (depth > -margin)).any(dim=-1)
    rot = math3d.quat_to_mat3(quat)
    _, _, sat_overlap, _ = box_box_sat_mtv(
        pos[:, None], rot[:, None], size[:, None],
        pos[None, :], rot[None, :], size[None, :])
    is_box = shape_type == SHAPE_BOX
    return torch.where(is_box[:, None] & is_box[None, :], sat_overlap, pen)
