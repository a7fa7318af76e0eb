"""3D math: quaternions and 4x4 transforms.

PyTorch counterpart of ``banggameengine_tpu/math3d.py``, with the same
conventions: column-vector ``float32[..., 4, 4]`` matrices,
``local = T @ R @ S``, Euler XYZ radians with ``R = Rz @ Ry @ Rx``,
quaternions ``[x, y, z, w]``.  Every function broadcasts over leading
batch dimensions.  Small matrix-vector products are multiplies and sums,
so no matmul (TF32 or not) rounds them.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def quat_identity(shape=(), device: torch.device | str = "cuda") -> Tensor:
    """Identity quaternion, optionally batched to ``shape + (4,)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.sqrt((q * q).sum(dim=-1, keepdim=True))
    return q / n.clamp_min(eps)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b (rotation b applied first, then a)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    """Conjugate (the inverse of a unit quaternion): (-x, -y, -z, w),
    made on the tensor's device (no host copy inside a step)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _cross(u: Tensor, v: Tensor) -> Tensor:
    u, v = torch.broadcast_tensors(u, v)
    return torch.linalg.cross(u, v, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v by unit quaternion(s) q:
    v' = v + 2*cross(q.xyz, cross(q.xyz, v) + w*v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    c1 = _cross(u, v) + w * v
    return v + 2.0 * _cross(u, c1)


def quat_from_axis_angle(axis: Tensor, angle: Tensor) -> Tensor:
    """Rotation by ``angle`` radians about ``axis`` (normalised here)."""
    norm = torch.sqrt((axis * axis).sum(dim=-1, keepdim=True))
    axis = axis / norm.clamp_min(1e-12)
    half = angle[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_from_euler_xyz(euler: Tensor) -> Tensor:
    """Euler XYZ radians -> quaternion with R = Rz @ Ry @ Rx."""
    hx, hy, hz = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    cx, sx = torch.cos(hx), torch.sin(hx)
    cy, sy = torch.cos(hy), torch.sin(hy)
    cz, sz = torch.cos(hz), torch.sin(hz)
    # q = qz * qy * qx  (apply X first)
    return torch.stack(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        dim=-1,
    )


def quat_to_mat3(q: Tensor) -> Tensor:
    """Unit quaternion -> 3x3 rotation matrix (column-vector convention)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_mat3(m: Tensor) -> Tensor:
    """3x3 rotation matrix -> unit quaternion: Shepperd's method with the
    four candidates selected branch-free."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def scale(x):
        return torch.sqrt(x.clamp_min(1e-12)) * 2.0

    s0 = scale(tr + 1.0)                       # trace dominant
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0,
                      0.25 * s0], -1)
    s1 = scale(1.0 + m00 - m11 - m22)          # m00 dominant
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    s2 = scale(1.0 - m00 + m11 - m22)          # m11 dominant
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    s3 = scale(1.0 - m00 - m11 + m22)          # m22 dominant
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], -1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def euler_zyx_from_quat(q: Tensor) -> Tensor:
    """Euler XYZ angles [ax, ay, az] of ``R = Rz @ Ry @ Rx`` (Bullet's
    ``getEulerZYX``); near gimbal lock az is 0."""
    m = quat_to_mat3(q)
    ay = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    near_gimbal = torch.cos(ay).abs() < 1e-6
    ax = torch.where(near_gimbal,
                     torch.atan2(-m[..., 1, 2], m[..., 1, 1]),
                     torch.atan2(m[..., 2, 1], m[..., 2, 2]))
    az = torch.where(near_gimbal, torch.zeros_like(ay),
                     torch.atan2(m[..., 1, 0], m[..., 0, 0]))
    return torch.stack([ax, ay, az], dim=-1)


def quat_nlerp(a: Tensor, b: Tensor, t) -> Tensor:
    """Normalized linear interpolation with hemisphere correction (for the
    small rotations between two fixed steps it matches slerp to float
    precision).  ``t`` is a float or an f32 tensor that broadcasts."""
    sign = torch.where((a * b).sum(dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    return quat_normalize(a + (b * sign - a) * t)


def quat_integrate(q: Tensor, omega: Tensor, dt: Tensor) -> Tensor:
    """Integrate unit quaternion by world angular velocity over dt:
    q' = normalize(q + 0.5 * dt * [omega, 0] * q), first order.

    ``dt`` is an f32 tensor (0-d or batched) so the product stays f32."""
    ow = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * quat_mul(ow, q)
    return quat_normalize(q + dq * dt[..., None])


def mat_identity(shape=(), device: torch.device | str = "cuda") -> Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(
        tuple(shape) + (4, 4))


def mat_from_srt(scale: Tensor, quat: Tensor, pos: Tensor) -> Tensor:
    """Compose local = T @ R @ S from scale[...,3], quat[...,4], pos[...,3]."""
    r = quat_to_mat3(quat)
    return _affine(r * scale[..., None, :], pos)  # R @ diag(s): scale columns


def mat_from_euler_srt(scale: Tensor, euler: Tensor, pos: Tensor) -> Tensor:
    return mat_from_srt(scale, quat_from_euler_xyz(euler), pos)


def mat_mul(a: Tensor, b: Tensor) -> Tensor:
    """f32 matrix product (TF32 stays off: see the package docstring)."""
    return torch.matmul(a, b)


def _matvec3(a: Tensor, v: Tensor) -> Tensor:
    """``einsum("...ij,...j->...i", a, v)`` as multiplies and a sum."""
    return (a * v[..., None, :]).sum(dim=-1)


def mat_transform_point(m: Tensor, p: Tensor) -> Tensor:
    """Apply 4x4 ``m`` to the 3-vector point(s) ``p``."""
    return _matvec3(m[..., :3, :3], p) + m[..., :3, 3]


def mat_transform_dir(m: Tensor, v: Tensor) -> Tensor:
    return _matvec3(m[..., :3, :3], v)


def mat_affine_inverse(m: Tensor) -> Tensor:
    """Inverse of an affine TRS matrix (general 3x3 inverse +
    translation)."""
    inv_a = inverse(m[..., :3, :3])
    return _affine(inv_a, -_matvec3(inv_a, m[..., :3, 3]))


def inverse(m: Tensor) -> Tensor:
    """Batched matrix inverse without the host synchronisation of
    ``torch.linalg.inv`` (which checks for singular input on the host); a
    singular matrix gives non-finite entries instead of an error."""
    return torch.linalg.inv_ex(m).inverse


def normal_matrix(world: Tensor) -> Tensor:
    """(world^-1)^T upper-left 3x3, the reference's normal transform."""
    return inverse(world[..., :3, :3]).transpose(-1, -2)


def _affine(rot: Tensor, t: Tensor) -> Tensor:
    """[..., 3, 3] and [..., 3] -> [..., 4, 4] with bottom row (0, 0, 0, 1)."""
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mtx_look_at(eye: Tensor, at: Tensor, up: Tensor | None = None) -> Tensor:
    """View matrix looking from ``eye`` to ``at``: rows right, up, forward,
    with the camera looking down +Z (bgfx/D3D convention)."""
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], dtype=eye.dtype, device=eye.device)
    f = at - eye
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-12)
    r = _cross(up, f)
    r = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp_min(1e-12)
    u = _cross(f, r)
    rot = torch.stack([r, u, f], dim=-2)
    t = -torch.einsum("...ij,...j->...i", rot, eye)
    return _affine(rot, t)


def mtx_proj(fovy_deg: float, aspect: float, near: float, far: float,
             device: torch.device | str = "cuda") -> Tensor:
    """Perspective projection with depth in [0, 1] (D3D style), +Z forward,
    computed in f32 like the JAX package's."""
    f32 = dict(dtype=torch.float32, device=device)
    fovy = torch.deg2rad(torch.tensor(fovy_deg, **f32))
    h = 1.0 / torch.tan(fovy * 0.5)
    w = h / torch.tensor(aspect, **f32)
    near_t = torch.tensor(near, **f32)
    far_t = torch.tensor(far, **f32)
    a = far_t / (far_t - near_t)
    b = -near_t * a
    m = torch.zeros((4, 4), **f32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = a
    m[2, 3] = b
    m[3, 2] = 1.0
    return m


def mtx_ortho(left, right, bottom, top, near, far,
              device: torch.device | str = "cuda") -> Tensor:
    """Orthographic projection, depth in [0, 1] (D3D style)."""
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = 1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def yaw_pitch_forward(yaw: Tensor, pitch: Tensor) -> Tensor:
    """Forward vector from yaw/pitch; yaw = pi/2 faces +Z."""
    cp = torch.cos(pitch)
    return torch.stack([torch.cos(yaw) * cp, torch.sin(pitch),
                        torch.sin(yaw) * cp], dim=-1)
