"""Layer-masked raycasts against the world's collision shapes.

Counterpart of ``banggameengine_tpu/physics/raycast.py`` (the reference's
``PhysicsSystem::Raycast``/``RaycastAll``): one ray against every entity
shape at once (boxes by the slab test, capsules by the cylinder and its
two cap spheres) plus the implicit ground plane y = 0, hit from above
only; the closest hit is a masked argmin.  An object is hit when
``(object_layer & ray_mask) != 0``.  ``ray_mask`` is a Python int (any
uint32 value) or an int32 tensor of the same bits; nothing here
synchronises with the host.
"""

from __future__ import annotations

import dataclasses

import torch

from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.state import SHAPE_BOX, SHAPE_CAPSULE

Tensor = torch.Tensor

GROUND_ENTITY = -2  # sentinel for the implicit ground plane
NO_HIT = -1


@dataclasses.dataclass
class RaycastHit:
    """The reference's ``PhysicsRaycastHit``."""

    entity: Tensor    # int32[]: entity id, GROUND_ENTITY, or NO_HIT
    point: Tensor     # f32[3]
    normal: Tensor    # f32[3]
    distance: Tensor  # f32[]

    @property
    def hit(self) -> Tensor:
        return self.entity != NO_HIT


def _mask_bits(ray_mask):
    """A uint32 mask given as a Python int -> the same bits as int32."""
    if isinstance(ray_mask, int):
        return (ray_mask + 2**31) % 2**32 - 2**31
    return ray_mask


def _ray_box(origin_l: Tensor, dir_l: Tensor, half: Tensor):
    """Slab test in the box's frame -> (t_enter, hit, normal_local)."""
    safe = torch.where(dir_l.abs() > 1e-9, dir_l,
                       torch.where(dir_l >= 0, 1e-9, -1e-9))
    inv_d = 1.0 / safe
    t1 = (-half - origin_l) * inv_d
    t2 = (half - origin_l) * inv_d
    tmin_ax = torch.minimum(t1, t2)
    tmax_ax = torch.maximum(t1, t2)
    t_enter = tmin_ax.amax(dim=-1)
    t_exit = tmax_ax.amin(dim=-1)
    hit = (t_exit >= t_enter.clamp_min(0.0)) & (t_enter >= 0.0)
    axis = tmin_ax.argmax(dim=-1)
    sign = -torch.sign(torch.gather(dir_l, -1, axis[..., None]))[..., 0]
    sign = torch.where(sign == 0, 1.0, sign)
    n_local = (torch.nn.functional.one_hot(axis, 3).to(origin_l.dtype)
               * sign[..., None])
    return t_enter, hit, n_local


def _ray_sphere(origin: Tensor, direction: Tensor, center: Tensor,
                radius: Tensor):
    """(t, hit) of the nearest non-negative intersection."""
    oc = origin - center
    b = (oc * direction).sum(dim=-1)
    c = (oc * oc).sum(dim=-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 >= 0.0, t0, t1)
    hit = (disc >= 0.0) & (t >= 0.0)
    return t, hit


def _ray_capsule(origin: Tensor, direction: Tensor, pos: Tensor,
                 quat: Tensor, radius: Tensor, half_height: Tensor):
    """Ray against Y-axis capsules, in each capsule's frame ->
    (t, hit, normal_world)."""
    qc = math3d.quat_conj(quat)
    o = math3d.quat_rotate(qc, origin - pos)
    d = math3d.quat_rotate(qc, direction)

    # the infinite cylinder x^2 + z^2 = r^2
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    b = o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2]
    c = o[..., 0] ** 2 + o[..., 2] ** 2 - radius * radius
    disc = b * b - a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    safe_a = a.clamp_min(1e-12)
    t_cyl = (-b - sq) / safe_a
    y_at = o[..., 1] + d[..., 1] * t_cyl
    cyl_hit = ((disc >= 0.0) & (a > 1e-12) & (t_cyl >= 0.0)
               & (y_at.abs() <= half_height))

    # the cap spheres at (0, +-h, 0)
    up = torch.zeros_like(o)
    up[..., 1] = half_height
    t_top, hit_top = _ray_sphere(o, d, up, radius)
    t_bot, hit_bot = _ray_sphere(o, d, -up, radius)

    inf = torch.inf
    t = torch.minimum(
        torch.where(cyl_hit, t_cyl, inf),
        torch.minimum(torch.where(hit_top, t_top, inf),
                      torch.where(hit_bot, t_bot, inf)))
    hit = torch.isfinite(t)
    p = o + d * t[..., None]
    axis_pt = torch.zeros_like(p)
    axis_pt[..., 1] = torch.clamp(p[..., 1], -half_height, half_height)
    n_local = p - axis_pt
    n_local = n_local / torch.linalg.vector_norm(
        n_local, dim=-1, keepdim=True).clamp_min(1e-9)
    return t, hit, math3d.quat_rotate(quat, n_local)


def raycast_all(
    origin: Tensor, direction: Tensor, max_dist, ray_mask,
    pos, quat, shape_type, size, layer, alive, has_collision,
    ground_enabled=True,
):
    """One ray against every shape -> per-entity (t [N], hit [N],
    normal [N, 3]) and the ground's (t_g, hit_g).  ``direction`` must be
    normalized."""
    ray_mask = _mask_bits(ray_mask)
    qc = math3d.quat_conj(quat)
    o_l = math3d.quat_rotate(qc, origin[None, :] - pos)
    d_l = math3d.quat_rotate(qc, direction.expand(pos.shape))
    t_box, hit_box, n_box_l = _ray_box(o_l, d_l, size)
    n_box = math3d.quat_rotate(quat, n_box_l)

    t_cap, hit_cap, n_cap = _ray_capsule(
        origin[None, :], direction[None, :], pos, quat, size[..., 0],
        size[..., 1])

    is_box = shape_type == SHAPE_BOX
    is_cap = shape_type == SHAPE_CAPSULE
    t = torch.where(is_box, t_box, torch.where(is_cap, t_cap, torch.inf))
    hit = torch.where(is_box, hit_box, is_cap & hit_cap)
    normal = torch.where(is_box[:, None], n_box, n_cap)

    hit = (hit & alive & has_collision & (t <= max_dist)
           & ((layer & ray_mask) != 0))

    # the implicit ground plane y = 0, on the world layer
    denom = direction[1]
    usable = denom.abs() > 1e-9
    t_g = torch.where(usable, -origin[1] / torch.where(usable, denom, 1.0),
                      torch.inf)
    hit_g = ((t_g >= 0.0) & (t_g <= max_dist) & ((ray_mask & 1) != 0)
             & ground_enabled)
    return t, hit, normal, t_g, hit_g


def raycast_closest(
    origin, direction, max_dist, ray_mask,
    pos, quat, shape_type, size, layer, alive, has_collision,
    ground_enabled=True,
) -> RaycastHit:
    """The closest hit (the reference's ``Physics::Raycast``)."""
    t, hit, normal, t_g, hit_g = raycast_all(
        origin, direction, max_dist, ray_mask,
        pos, quat, shape_type, size, layer, alive, has_collision,
        ground_enabled,
    )
    t_masked = torch.where(hit, t, torch.inf)
    best = t_masked.argmin()[None]              # [1], first minimum
    t_best = t_masked.index_select(0, best)[0]

    use_ground = torch.where(hit_g, t_g, torch.inf) < t_best
    any_hit = torch.isfinite(t_best) | hit_g

    dist = torch.where(use_ground, t_g, t_best)
    ent = torch.where(
        any_hit,
        torch.where(use_ground, GROUND_ENTITY, best[0].to(torch.int32)),
        NO_HIT,
    ).to(torch.int32)
    up = (torch.arange(3, device=origin.device) == 1).to(origin.dtype)
    n = torch.where(use_ground, up, normal.index_select(0, best)[0])
    finite = torch.isfinite(dist)
    point = origin + direction * torch.where(finite, dist, 0.0)
    return RaycastHit(entity=ent, point=point, normal=n,
                      distance=torch.where(finite, dist, 0.0))
