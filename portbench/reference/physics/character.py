"""Kinematic character controller: the per-slot and the planar step.

Counterpart of ``banggameengine_tpu/physics/character.py``: the per-slot
``step_character`` with ``walk_velocity`` and ``_capsule_world_contacts``
(its ``_entity_capsule_segments`` and ``_closest_seg`` are
``shapes.capsule_segment`` and ``shapes.closest_segment_segment``, which
broadcast a slot's segment against every entity's), and the planar
``step_characters_t`` with its helpers ``_qrot_comps`` and
``_box_local_comps``.  The controller reproduces the observable
behaviour of the reference's ``btKinematicCharacterController``
(``PhysicsSystem.cpp:709-846``): a camera-yaw-relative walk at
``walkSpeed`` (x1.8 sprinting), a jump only from the ground, gravity with
the fall speed capped at 3|g|, a fixed number of depenetration passes
against the boxes, capsules and the ground plane (each lifting by at most
``stepHeight``), then a ground-support probe under the slope limit.  It
is a ghost: it pushes only itself.

The per-slot step runs every character slot against every entity of its
world; where the JAX package vmaps the one-slot function over the slots,
this one carries a leading slot axis ``[C, ...]`` through the same
``[..., 3]``-minor expressions.  The planar step takes ``[K, C]``
candidate planes, characters last (the flat many-world's static
candidates), the JAX module's formulas expression for expression, with
the three capsule sample spheres as one ``[3, K, C]`` block.  Both order
their contacts the same way (sample spheres against each box, the core
segment against each capsule, the end spheres against the ground), so
the deepest contact breaks ties the same way, the first one winning as
``jnp.argmax`` picks it.
"""

from __future__ import annotations

import torch

from portbench.reference import math3d
from portbench.reference.physics import narrowphase as nf
from portbench.reference.physics.config import SPRINT_MULTIPLIER
from portbench.reference.physics.shapes import (
    capsule_segment,
    closest_segment_segment,
)
from portbench.reference.state import SHAPE_BOX, SHAPE_CAPSULE

Tensor = torch.Tensor

DEPENETRATION_ITERS = 4
CONTACT_TOLERANCE = 0.05   # ground-support probe distance


def _norm(v: Tensor) -> Tensor:
    """``jnp.linalg.norm(v, axis=-1)``."""
    return torch.sqrt((v * v).sum(dim=-1))


def _unit_y(like: Tensor) -> Tensor:
    """(0, 1, 0) broadcast to ``like``'s shape, made on its device."""
    y = torch.zeros_like(like)
    y[..., 1] = 1.0
    return y


def walk_velocity(move_forward, move_right, cam_yaw, walk_speed, sprint):
    """Horizontal walk velocity [..., 3] from the input axes, relative to
    the camera's yaw (``HandleCharacterInput``, PhysicsSystem.cpp:790-846);
    every argument [...]."""
    fwd = math3d.yaw_pitch_forward(cam_yaw, torch.zeros_like(cam_yaw))
    fwd = fwd * (1.0 - _unit_y(fwd))           # y = 0
    fwd = fwd / _norm(fwd).clamp_min(1e-9)[..., None]
    right = -math3d._cross(fwd, _unit_y(fwd))  # the reference's up x fwd
    wish = fwd * move_forward[..., None] + right * move_right[..., None]
    norm = _norm(wish)[..., None]
    wish = torch.where(norm > 1e-6, wish / norm.clamp_min(1e-9), 0.0)
    speed = walk_speed * torch.where(sprint, SPRINT_MULTIPLIER, 1.0)
    return wish * speed[..., None]


def _capsule_world_contacts(c_pos, radius, half_height, pos, quat,
                            shape_type, size, obstacle_mask):
    """Contacts of the upright capsule of each slot at ``c_pos`` [C, 3]
    (``radius``, ``half_height`` [C]) against every entity [N] and the
    ground plane: (normals [C, M, 3] pushing the capsule out, depths
    [C, M], valid [C, M]), M = 3N + N + 2 in the order sample spheres x
    boxes, core segment x capsules, end spheres x ground.
    ``obstacle_mask`` is bool[C, N]."""
    c = c_pos.shape[0]
    n = pos.shape[0]
    ts = (torch.arange(3, dtype=c_pos.dtype, device=c_pos.device)
          * 0.5)[:, None]                                     # 0, 0.5, 1
    axis = _unit_y(c_pos) * half_height[:, None]
    lo = c_pos - axis
    hi = c_pos + axis
    samples = lo[:, None, :] + (hi - lo)[:, None, :] * ts     # [C, 3, 3]

    # vs boxes: sphere-box per (sample, entity)
    d_box, n_box, _ = nf._sphere_box_contact(
        samples[:, :, None, :], radius[:, None, None], pos, quat, size)
    valid_box = (shape_type == SHAPE_BOX)[None, :] & obstacle_mask

    # vs capsules: segment-segment against each entity's core segment (its
    # local Y axis scaled by size[:, 1], whatever its shape)
    seg_a, seg_b = capsule_segment(pos, quat, size[:, 1])
    c1, c2 = closest_segment_segment(lo[:, None], hi[:, None], seg_a, seg_b)
    delta = c1 - c2
    dist = _norm(delta)[..., None]                            # [C, N, 1]
    n_cap = torch.where(dist > 1e-9, delta / dist.clamp_min(1e-9),
                        _unit_y(delta))
    d_cap = radius[:, None] + size[:, 0] - dist[..., 0]       # [C, N]
    valid_cap = (shape_type == SHAPE_CAPSULE)[None, :] & obstacle_mask

    # ground plane: both end spheres, normal +y
    ends = torch.stack([lo, hi], dim=1)                       # [C, 2, 3]
    d_gnd = radius[:, None] - ends[..., 1]
    n_gnd = _unit_y(ends)

    normals = torch.cat([n_box.reshape(c, 3 * n, 3), n_cap, n_gnd], dim=1)
    depths = torch.cat([d_box.reshape(c, 3 * n), d_cap, d_gnd], dim=1)
    valid = torch.cat([valid_box[:, None].expand(c, 3, n).reshape(c, 3 * n),
                       valid_cap,
                       torch.ones_like(d_gnd, dtype=torch.bool)], dim=1)
    return normals, depths, valid


def step_character(
    c_pos, vel_y, on_ground,                 # [C, 3], [C], bool[C]
    radius, half_height, walk_speed, jump_speed,   # [C]
    inp_forward, inp_right, inp_jump, inp_sprint, cam_yaw,  # [C]
    pos, quat, shape_type, size,             # every entity, [N, ...]
    obstacle_mask,                           # bool[C, N]
    gravity, dt, step_height, max_slope_cos,
):
    """Advance every character slot by one fixed step against every
    entity: returns (new centres [C, 3], vel_y [C], grounded [C])."""
    walk = walk_velocity(inp_forward, inp_right, cam_yaw, walk_speed,
                         inp_sprint)

    # -- vertical dynamics --
    do_jump = inp_jump & on_ground
    vel_y = torch.where(do_jump, jump_speed, vel_y)
    vel_y = vel_y + gravity * dt
    fall_cap = 3.0 * gravity.abs()           # setFallSpeed(|g| * 3)
    vel_y = torch.maximum(vel_y, -fall_cap)

    # -- proposed motion --
    up = _unit_y(c_pos)
    p = c_pos + (walk * dt + up * (vel_y * dt)[:, None])

    # -- depenetration passes --
    lo_push = -step_height
    hi_push = step_height + radius
    for _ in range(DEPENETRATION_ITERS):
        normals, depths, valid = _capsule_world_contacts(
            p, radius, half_height, pos, quat, shape_type, size,
            obstacle_mask)
        pen = torch.where(valid, depths, -torch.inf)
        worst = torch.argmax(pen, dim=1, keepdim=True)        # [C, 1]
        d = torch.gather(pen, 1, worst).clamp_min(0.0)        # [C, 1]
        push = torch.gather(normals, 1, worst[..., None].expand(-1, 1, 3)
                            )[:, 0] * d
        # never lift by more than stepHeight in one pass
        push_y = torch.minimum(torch.maximum(push[:, 1], lo_push), hi_push)
        push = torch.where(up > 0.0, push_y[:, None], push)
        p = torch.where(d > 0.0, p + push, p)

    # -- ground support probe --
    normals, depths, valid = _capsule_world_contacts(
        p, radius, half_height, pos, quat, shape_type, size, obstacle_mask)
    support = (valid & (depths > -CONTACT_TOLERANCE)
               & (normals[..., 1] > max_slope_cos))
    grounded = support.any(dim=1)
    vel_y = torch.where(grounded & (vel_y < 0.0), 0.0, vel_y)
    return p, vel_y, grounded


def _qrot_comps(qx, qy, qz, qw, vx, vy, vz):
    """Componentwise ``math3d.quat_rotate`` (2-cross form):
    v' = v + 2*cross(u, cross(u, v) + w*v)."""
    c1x = qy * vz - qz * vy + qw * vx
    c1y = qz * vx - qx * vz + qw * vy
    c1z = qx * vy - qy * vx + qw * vz
    ox = vx + 2.0 * (qy * c1z - qz * c1y)
    oy = vy + 2.0 * (qz * c1x - qx * c1z)
    oz = vz + 2.0 * (qx * c1y - qy * c1x)
    return ox, oy, oz


def _sgn(x: Tensor) -> Tensor:
    s = torch.sign(x)
    return torch.where(s == 0.0, 1.0, s)


def _box_local_comps(lb0, lb1, lb2, hb0, hb1, hb2):
    """Componentwise closest point on a box, in the box's frame (the first
    axis wins a tie of clearances) -> (n0, n1, n2, signed distance)."""
    cl0 = torch.clamp(lb0, -hb0, hb0)
    cl1 = torch.clamp(lb1, -hb1, hb1)
    cl2 = torch.clamp(lb2, -hb2, hb2)
    d0, d1, d2 = lb0 - cl0, lb1 - cl1, lb2 - cl2
    dist = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    outside = dist > 1e-9
    inv = 1.0 / dist.clamp_min(1e-9)
    f0 = hb0 - lb0.abs()
    f1 = hb1 - lb1.abs()
    f2 = hb2 - lb2.abs()
    min_clear = torch.minimum(torch.minimum(f0, f1), f2)
    ax0 = (f0 <= f1) & (f0 <= f2)
    ax1 = ~ax0 & (f1 <= f2)
    ax2 = ~ax0 & ~ax1
    ni0 = torch.where(ax0, _sgn(lb0), 0.0)
    ni1 = torch.where(ax1, _sgn(lb1), 0.0)
    ni2 = torch.where(ax2, _sgn(lb2), 0.0)
    n0 = torch.where(outside, d0 * inv, ni0)
    n1 = torch.where(outside, d1 * inv, ni1)
    n2 = torch.where(outside, d2 * inv, ni2)
    sdist = torch.where(outside, dist, -min_clear)
    return n0, n1, n2, sdist


def deepest_contact(nx, ny, nz, dd, vv):
    """The deepest valid contact of each column of ``[M, C]`` planes:
    (normal x, y, z, depth >= 0).  The first row wins a tie, as
    ``jnp.argmax`` does; a column with no valid row has depth 0."""
    pen = torch.where(vv, dd, -torch.inf)
    idx = torch.argmax(pen, dim=0, keepdim=True)               # [1, C]
    d = pen.amax(dim=0).clamp_min(0.0)
    w = torch.gather(torch.stack([nx, ny, nz]), 1,
                     idx.unsqueeze(0).expand(3, 1, -1))[:, 0]  # [3, C]
    return w[0], w[1], w[2], d


def step_characters_t(
    cx, cy, cz,            # f32[C] capsule centres
    vel_y, on_ground,      # f32[C], bool[C]
    radius, half_height, walk_speed, jump_speed,   # f32[C]
    inp_forward, inp_right, inp_jump, inp_sprint, cam_yaw,  # [C]
    bpx, bpy, bpz,         # f32[K,C] candidate positions
    bqx, bqy, bqz, bqw,    # f32[K,C] candidate quats
    b_is_box, b_is_cap,    # bool[K,C] candidate masks (shape & obstacle)
    hb0, hb1, hb2,         # f32[K,C] candidate half sizes
    gravity, dt, step_height, max_slope_cos,
):
    """Advance C characters by one fixed step; returns (cx, cy, cz,
    vel_y, grounded), each [C]."""
    # -- walk velocity (camera-relative, pitch 0 so |fwd| = 1) --
    fx = torch.cos(cam_yaw)
    fz = torch.sin(cam_yaw)
    fn = torch.sqrt(fx * fx + fz * fz).clamp_min(1e-9)
    fx, fz = fx / fn, fz / fn
    # right = -(fwd x up) = (fz, 0, -fx)
    wx = fx * inp_forward + fz * inp_right
    wz = fz * inp_forward - fx * inp_right
    wn = torch.sqrt(wx * wx + wz * wz)
    inv_wn = 1.0 / wn.clamp_min(1e-9)
    wx = torch.where(wn > 1e-6, wx * inv_wn, 0.0)
    wz = torch.where(wn > 1e-6, wz * inv_wn, 0.0)
    speed = walk_speed * torch.where(inp_sprint, SPRINT_MULTIPLIER, 1.0)

    # -- vertical dynamics --
    do_jump = inp_jump & on_ground
    vel_y = torch.where(do_jump, jump_speed, vel_y)
    vel_y = vel_y + gravity * dt
    fall_cap = 3.0 * gravity.abs()
    vel_y = torch.maximum(vel_y, -fall_cap)

    px = cx + wx * speed * dt
    py = cy + vel_y * dt
    pz = cz + wz * speed * dt

    # loop-invariant candidate frames
    cqx, cqy, cqz = -bqx, -bqy, -bqz           # conjugate: world -> local
    # entity capsule core segments: axis = R @ (0, hb1, 0)
    zeros = torch.zeros_like(hb1)
    axx, axy, axz = _qrot_comps(bqx, bqy, bqz, bqw, zeros, hb1, zeros)
    sax, say, saz = bpx - axx, bpy - axy, bpz - axz
    sbx, sby, sbz = bpx + axx, bpy + axy, bpz + axz
    d2x, d2y, d2z = sbx - sax, sby - say, sbz - saz        # [K,C]
    e_ = d2x * d2x + d2y * d2y + d2z * d2z
    # the sample heights (0, 0.5, 1) made on the device (no host copy)
    ts = (torch.arange(3, dtype=cx.dtype, device=cx.device) * 0.5).view(3, 1)
    k = bpx.shape[0]

    def contacts(px_, py_, pz_):
        """Every candidate contact of the C capsules at (px_, py_, pz_):
        (nx, ny, nz, depth, valid) planes [M, C], M = 3K + K + 2 (three
        sample spheres against each box, the core segment against each
        capsule, the two end spheres against the ground)."""
        loy = py_ - half_height
        hiy = py_ + half_height
        # vs boxes: sphere-box per (sample, candidate), samples [3, 1, C]
        sy = (loy + (hiy - loy) * ts)[:, None]
        dx0 = px_[None] - bpx
        dy0 = sy - bpy
        dz0 = pz_[None] - bpz
        l0, l1, l2 = _qrot_comps(cqx, cqy, cqz, bqw,
                                 dx0.expand_as(dy0), dy0, dz0.expand_as(dy0))
        n0, n1, n2, sd = _box_local_comps(l0, l1, l2, hb0, hb1, hb2)
        bnx, bny, bnz = _qrot_comps(bqx, bqy, bqz, bqw, n0, n1, n2)
        bd = radius - sd                                    # [3, K, C]
        # vs capsules: segment-segment (closest_segment_segment in comps;
        # d1 = the character's axis (0, hiy - loy, 0), r = p1 - p2)
        d1y = hiy - loy                                     # [C]
        rx = px_[None] - sax
        ry = loy[None] - say
        rz = pz_[None] - saz
        a_ = (d1y * d1y)[None]
        f_ = d2x * rx + d2y * ry + d2z * rz
        c_ = d1y[None] * ry
        b_ = d1y[None] * d2y
        den = a_ * e_ - b_ * b_
        s_ = torch.where(
            den > 1e-12,
            torch.clamp((b_ * f_ - c_ * e_) / den.clamp_min(1e-12),
                        0.0, 1.0), 0.0)
        t2 = (b_ * s_ + f_) / e_.clamp_min(1e-12)
        t2 = torch.clamp(t2, 0.0, 1.0)
        s_ = torch.clamp((b_ * t2 - c_) / a_.clamp_min(1e-12), 0.0, 1.0)
        c2x = sax + d2x * t2
        c2y = say + d2y * t2
        c2z = saz + d2z * t2
        dx_ = px_[None] - c2x
        dy_ = (loy[None] + d1y[None] * s_) - c2y
        dz_ = pz_[None] - c2z
        dist = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
        ok_d = dist > 1e-9
        inv = 1.0 / dist.clamp_min(1e-9)
        # ground plane: both end spheres, normal +y
        ends = torch.stack([loy, hiy])                      # [2, C]
        one = torch.ones_like(ends)
        zero = torch.zeros_like(ends)
        nx = torch.cat([bnx.reshape(3 * k, -1),
                        torch.where(ok_d, dx_ * inv, 0.0), zero])
        ny = torch.cat([bny.reshape(3 * k, -1),
                        torch.where(ok_d, dy_ * inv, 1.0), one])
        nz = torch.cat([bnz.reshape(3 * k, -1),
                        torch.where(ok_d, dz_ * inv, 0.0), zero])
        dd = torch.cat([bd.reshape(3 * k, -1), radius[None] + hb0 - dist,
                        radius[None] - ends])
        vv = torch.cat([b_is_box[None].expand(3, -1, -1).reshape(3 * k, -1),
                        b_is_cap, torch.ones_like(ends, dtype=torch.bool)])
        return nx, ny, nz, dd, vv                           # [M, C]

    lo_push = -step_height
    hi_push = step_height + radius
    for _ in range(DEPENETRATION_ITERS):
        wnx, wny, wnz, d = deepest_contact(*contacts(px, py, pz))
        hit = d > 0.0
        push_y = torch.minimum(torch.maximum(wny * d, lo_push), hi_push)
        px = torch.where(hit, px + wnx * d, px)
        py = torch.where(hit, py + push_y, py)
        pz = torch.where(hit, pz + wnz * d, pz)

    # -- ground support probe --
    nx, ny, nz, dd, vv = contacts(px, py, pz)
    support = vv & (dd > -CONTACT_TOLERANCE) & (ny > max_slope_cos)
    grounded = support.any(dim=0)
    vel_y = torch.where(grounded & (vel_y < 0.0), 0.0, vel_y)
    return px, py, pz, vel_y, grounded
