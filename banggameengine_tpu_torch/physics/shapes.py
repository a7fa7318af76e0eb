"""Shape geometry helpers: AABBs, box corners, capsule segments.

Counterpart of ``banggameengine_tpu/physics/shapes.py`` (``:22-69``).  Box
``size`` = half extents; capsule ``size`` = (radius, half_height, 0), with
half_height half the cylinder section.  Collider sizes are world-space and
ignore entity scale.
"""

from __future__ import annotations

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.state import SHAPE_BOX, SHAPE_CAPSULE

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
    up = torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                     device=pos.device)
    up[..., 1] = half_height
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
