"""Shape geometry helpers: AABBs, box corners, capsule segments.

Counterpart of ``banggameengine_tpu/physics/shapes.py``.  Box
``size`` = half extents; capsule ``size`` = (radius, half_height, 0), with
half_height half the cylinder section.  Collider sizes are world-space and
ignore entity scale.
"""

from __future__ import annotations

import torch

from portbench.reference import math3d
from portbench.reference.state import SHAPE_BOX, SHAPE_CAPSULE

Tensor = torch.Tensor


def box_corners(pos: Tensor, quat: Tensor, half: Tensor) -> Tensor:
    """World-space corners of an oriented box, [..., 8, 3]; corner k flips
    axis a iff bit a of k."""
    hx, hy, hz = half.unbind(-1)
    local = torch.stack(
        [
            torch.stack([-hx, -hy, -hz], -1), torch.stack([hx, -hy, -hz], -1),
            torch.stack([-hx, hy, -hz], -1), torch.stack([hx, hy, -hz], -1),
            torch.stack([-hx, -hy, hz], -1), torch.stack([hx, -hy, hz], -1),
            torch.stack([-hx, hy, hz], -1), torch.stack([hx, hy, hz], -1),
        ],
        dim=-2,
    )
    return math3d.quat_rotate(quat[..., None, :], local) + pos[..., None, :]


def capsule_segment(pos: Tensor, quat: Tensor,
                    half_height: Tensor) -> tuple[Tensor, Tensor]:
    """World-space endpoints of a capsule's core segment (local Y axis)."""
    # (0, hh, 0) built out of place: under ``torch.func.vmap`` a batched
    # half height cannot be written into an unbatched buffer
    hh = half_height.to(torch.float32).expand(pos.shape[:-1])
    zero = torch.zeros_like(hh)
    up = torch.stack([zero, hh, zero], dim=-1)
    axis = math3d.quat_rotate(quat, up)
    return pos - axis, pos + axis


def shape_aabb(pos: Tensor, quat: Tensor, shape_type: Tensor,
               size: Tensor) -> tuple[Tensor, Tensor]:
    """Conservative world AABB (min, max) [..., 3] of each shape.

    Box: half extents through |R|; capsule: segment extent + radius;
    other shapes: a zero-size AABB at pos."""
    r = math3d.quat_to_mat3(quat)
    box_ext = (r.abs() * size[..., None, :]).sum(dim=-1)
    a, b = capsule_segment(pos, quat, size[..., 1])
    cap_min = torch.minimum(a, b) - size[..., 0:1]
    cap_max = torch.maximum(a, b) + size[..., 0:1]

    is_box = (shape_type == SHAPE_BOX)[..., None]
    is_cap = (shape_type == SHAPE_CAPSULE)[..., None]
    mn = torch.where(is_box, pos - box_ext, torch.where(is_cap, cap_min, pos))
    mx = torch.where(is_box, pos + box_ext, torch.where(is_cap, cap_max, pos))
    return mn, mx


def aabb_overlap(mn_a: Tensor, mx_a: Tensor, mn_b: Tensor, mx_b: Tensor,
                 margin: float = 0.0) -> Tensor:
    """Boolean AABB intersection test (broadcasts)."""
    return ((mn_a <= mx_b + margin) & (mn_b <= mx_a + margin)).all(dim=-1)


def closest_point_on_box(q: Tensor,
                         half: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Closest point on a local-frame box to the local point ``q``:
    (point, normal, signed distance).  Outside, the normal points from the
    surface point toward ``q`` and the distance is positive; inside, the
    nearest face is used (the first axis wins a tie) and the distance is
    minus its clearance."""
    clamped = torch.clamp(q, -half, half)
    delta = q - clamped
    dist = torch.sqrt((delta * delta).sum(dim=-1))
    outside = dist > 1e-9
    n_out = delta / dist.clamp_min(1e-9)[..., None]

    face_clear = half - q.abs()              # >= 0 inside
    axis = torch.argmin(face_clear, dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(q, -1, axis))
    sign = torch.where(sign == 0.0, 1.0, sign)
    hot = torch.arange(3, device=q.device) == axis
    n_in = hot.to(q.dtype) * sign
    min_clear = torch.gather(face_clear, -1, axis)
    p_in = q + n_in * min_clear              # q projected onto that face

    point = torch.where(outside[..., None], clamped, p_in)
    normal = torch.where(outside[..., None], n_out, n_in)
    sdist = torch.where(outside, dist, -min_clear[..., 0])
    return point, normal, sdist


def closest_segment_segment(p1: Tensor, q1: Tensor, p2: Tensor,
                            q2: Tensor) -> tuple[Tensor, Tensor]:
    """Closest points (c1, c2) between segments [p1, q1] and [p2, q2]
    (branchless, Ericson RTCD 5.1.9)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = (d1 * d1).sum(dim=-1)
    e = (d2 * d2).sum(dim=-1)
    f = (d2 * r).sum(dim=-1)
    c = (d1 * r).sum(dim=-1)
    b = (d1 * d2).sum(dim=-1)
    denom = a * e - b * b
    s = torch.where(
        denom > 1e-12,
        torch.clamp((b * f - c * e) / denom.clamp_min(1e-12), 0.0, 1.0), 0.0)
    t = (b * s + f) / e.clamp_min(1e-12)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / a.clamp_min(1e-12), 0.0, 1.0)
    return p1 + d1 * s[..., None], p2 + d2 * t_cl[..., None]
