"""3D math: quaternions and 4x4 transforms.

PyTorch counterpart of the functions of ``banggameengine_tpu/math3d.py``
that the physics tick calls, with the same conventions: column-vector
``float32[..., 4, 4]`` matrices, ``local = T @ R @ S``, Euler XYZ radians
with ``R = Rz @ Ry @ Rx``, quaternions ``[x, y, z, w]``.  Every function
broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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


def quat_integrate(q: Tensor, omega: Tensor, dt: Tensor) -> Tensor:
    """Integrate unit quaternion by world angular velocity over dt:
    q' = normalize(q + 0.5 * dt * [omega, 0] * q), first order.

    ``dt`` is an f32 tensor (0-d or batched) so the product stays f32."""
    ow = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * quat_mul(ow, q)
    return quat_normalize(q + dq * dt[..., None])


def mat_from_srt(scale: Tensor, quat: Tensor, pos: Tensor) -> Tensor:
    """Compose local = T @ R @ S from scale[...,3], quat[...,4], pos[...,3]."""
    r = quat_to_mat3(quat)
    rs = r * scale[..., None, :]  # R @ diag(s): scale columns
    top = torch.cat([rs, pos[..., :, None]], dim=-1)  # [...,3,4]
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat_mul(a: Tensor, b: Tensor) -> Tensor:
    """f32 matrix product (TF32 stays off: see the package docstring)."""
    return torch.matmul(a, b)
