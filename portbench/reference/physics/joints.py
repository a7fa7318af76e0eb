"""Hinge and cone-twist joint rows, written from their equations.

The benchmark's plain reference for the port's joints; it imports nothing
of the port and is not a copy of its joint code.  Frames are rotation
matrices here (``F = R M``, the frame's axes as columns), the twist is
measured geometrically, and each row is built on its own.

Joint j joins bodies a and b.  ``rA = Ra oA``, ``pA = xa + rA``; ``FA =
Ra MA``; b likewise.  A row is ``(jl, ja, jb)``: its speed is ``jl . (vb
- va) + ja . wa + jb . wb``, and an impulse ``lam`` along it adds ``-lam
jl / ma`` and ``lam Ia^-1 ja`` to a, ``lam jl / mb`` and ``lam Ib^-1 jb``
to b.

- Point (3 rows, d = world x, y, z): ``jl = d``, ``ja = -(rA x d)``, ``jb =
  rB x d``; target ``-(ERP/dt) d.(pB - pA)``; lam free.
- Hinge (axis: the frames' z, ``aA``, ``aB``): 2 rows, ``ja = -u``, ``jb =
  u`` for u = FA x and FA y, target ``-(ERP/dt) u.(aA x aB)``; lam free.
  Its angle ``theta = atan2(FB x . FA y, FB x . FA x)``; below ``lo``, the
  row ``ja = -aA``, ``jb = aA``, target ``(0.3/dt)(lo - theta)``; above
  ``hi``, ``ja = aA``, ``jb = -aA``, target ``(0.3/dt)(theta - hi)``; lam
  >= 0.
- Cone-twist (twist axis: the frames' x, ``tA``, ``tB``): the swing
  ``phi = acos(tA . tB)``; past the span s, along ``n = tA x tB / |tA x
  tB|``, ``ja = n``, ``jb = -n``, target ``(0.3/dt)(phi - s)``, lam >= 0.
  The twist: ``S``, the shortest turn taking ``tA`` onto ``tB``, carries
  ``FA y`` to ``S FA y``; the twist is the signed angle from ``S FA y`` to
  ``FB y`` about ``tB``, ``psi`` its size and ``sign(twist) tB`` its
  axis; past the span t, ``ja = axis``, ``jb = -axis``, target
  ``(0.3/dt)(psi - t)``, lam >= 0.

ERP is 0.2, Bullet's global; 0.3 is Bullet's ``setLimit`` bias factor.
A joint's active rows are solved together: their effective mass is the
matrix ``K[r, s] = (1/ma + 1/mb) jl_r . jl_s + ja_r . Ia^-1 ja_s + jb_r .
Ib^-1 jb_s``, and an iteration moves the rows' impulses by ``K^-1 (target
- speed)``.  The rows carry their impulses from step to step and are
warm-started from them, times 0.85, one-sided rows from their positive
part.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import math3d

HINGE = 0
CONE_TWIST = 1
ERP = 0.2
LIMIT_BIAS = 0.3
WARM = 0.85
ROWS = 7      # point x, y, z; hinge x, y; hinge limit or swing; twist


@dataclasses.dataclass
class Joints:
    """The joint table as the scene gives it (raw fields), and each
    body's damping."""

    body_a: torch.Tensor      # int32[J]
    body_b: torch.Tensor      # int32[J]
    kind: torch.Tensor        # int8[J]
    origin_a: torch.Tensor    # f32[J, 3]
    origin_b: torch.Tensor    # f32[J, 3]
    basis_a: torch.Tensor     # f32[J, 3, 3] frame axes (columns), body a
    basis_b: torch.Tensor     # f32[J, 3, 3]
    limit_lo: torch.Tensor    # f32[J] hinge lower bound | swing span
    limit_hi: torch.Tensor    # f32[J] hinge upper bound | twist span
    lin_damping: torch.Tensor  # f32[N]
    ang_damping: torch.Tensor  # f32[N]


def _mm(m, n):
    """Matrix times matrix, [..., 3, 3], as multiplies and sums."""
    return (m[..., :, :, None] * n[..., None, :, :]).sum(dim=-2)


def _mv(m, v):
    return (m * v[..., None, :]).sum(dim=-1)


def _dot(u, v):
    return (u * v).sum(dim=-1)


def _cross(u, v):
    return torch.linalg.cross(u, v, dim=-1)


def _unit(v, eps=1e-6):
    n = torch.sqrt(_dot(v, v))
    return v / n.clamp_min(eps)[..., None], n


def twist(fa, fb):
    """(psi in [0, pi], its world axis) of the twist about x of frame
    ``fb`` relative to ``fa`` ([J, 3, 3] world frames), the swing that
    takes ``fa``'s x onto ``fb``'s taken out."""
    ta, tb = fa[..., 0], fb[..., 0]
    ya, yb = fa[..., 1], fb[..., 1]
    c = _dot(ta, tb)
    kk = _cross(ta, tb)
    # Rodrigues' formula for the shortest turn S from ta to tb:
    # S v = c v + k x v + k (k . v) / (1 + c), k = ta x tb
    s_ya = (c[..., None] * ya + _cross(kk, ya)
            + kk * (_dot(kk, ya) / (1.0 + c).clamp_min(1e-6))[..., None])
    angle = torch.atan2(_dot(_cross(s_ya, yb), tb), _dot(s_ya, yb))
    axis = torch.where((angle < 0.0)[..., None], -tb, tb)
    return angle.abs(), axis


def rows(joints: Joints, pos, quat, alive, inv_m, inv_i_world, dt, impulse):
    """Every joint's rows at these poses: ``(a, b, jl, ja, jb [J, 7, 3],
    K [J, 7, 7] (an inactive row's the identity's), target, one_sided,
    active [J, 7], warm [J, 7], limit count)``."""
    a = joints.body_a.long()
    b = joints.body_b.long()
    ra_m = math3d.quat_to_mat3(quat[a])
    rb_m = math3d.quat_to_mat3(quat[b])
    fa = _mm(ra_m, joints.basis_a)
    fb = _mm(rb_m, joints.basis_b)
    r_a = _mv(ra_m, joints.origin_a)
    r_b = _mv(rb_m, joints.origin_b)
    sep = (pos[b] + r_b) - (pos[a] + r_a)
    erp = ERP / dt
    lim = LIMIT_BIAS / dt
    hinge = joints.kind == HINGE
    cone = joints.kind == CONE_TWIST
    live = alive[a] & alive[b]
    zero = torch.zeros_like(r_a)

    out = []        # (jl, ja, jb, target, active, one_sided) per row
    for i in range(3):
        d = torch.zeros_like(r_a)
        d[:, i] = 1.0
        out.append((d, -_cross(r_a, d), _cross(r_b, d), -erp * sep[:, i],
                    live, False))
    a_axis, b_axis = fa[..., 2], fb[..., 2]
    err = _cross(a_axis, b_axis)
    for i in range(2):
        u = fa[..., i]
        out.append((zero, -u, u, -erp * _dot(u, err), live & hinge, False))

    theta = torch.atan2(_dot(fb[..., 0], fa[..., 1]),
                        _dot(fb[..., 0], fa[..., 0]))
    lo, hi = joints.limit_lo, joints.limit_hi
    low = hinge & (theta < lo)
    high = hinge & (theta > hi)
    tip, n_len = _unit(_cross(fa[..., 0], fb[..., 0]))
    n = torch.where((n_len > 1e-6)[:, None], tip, fa[..., 1])
    phi = torch.acos(torch.clamp(_dot(fa[..., 0], fb[..., 0]), -1.0, 1.0))
    swing = cone & (phi > lo)
    axis5 = torch.where(low[:, None], -a_axis,
                        torch.where(high[:, None], a_axis, n))
    err5 = torch.where(low, lo - theta,
                       torch.where(high, theta - hi, phi - lo))
    out.append((zero, axis5, -axis5, lim * err5, live & (low | high | swing),
                True))
    psi, t_axis = twist(fa, fb)
    out.append((zero, t_axis, -t_axis, lim * (psi - hi),
                live & cone & (psi > hi), True))

    jl = torch.stack([r[0] for r in out], dim=1)
    ja = torch.stack([r[1] for r in out], dim=1)
    jb = torch.stack([r[2] for r in out], dim=1)
    target = torch.stack([r[3] for r in out], dim=1)
    active = torch.stack([r[4] for r in out], dim=1)
    one_sided = torch.tensor([r[5] for r in out], device=pos.device)
    one_sided = one_sided.expand(active.shape)

    ia, ib = inv_i_world[a][:, None], inv_i_world[b][:, None]
    mass = torch.zeros(active.shape + (ROWS,), dtype=pos.dtype,
                       device=pos.device)
    for r in range(ROWS):
        mass[:, r] = ((inv_m[a] + inv_m[b])[:, None] * _dot(jl[:, r:r + 1],
                                                            jl)
                      + _dot(ja[:, r:r + 1], _mv(ia, ja))
                      + _dot(jb[:, r:r + 1], _mv(ib, jb)))
    both = active[:, :, None] & active[:, None, :]
    mass = torch.where(both, mass, torch.eye(ROWS, device=pos.device))
    prev = torch.where(one_sided, impulse.clamp_min(0.0), impulse)
    warm = torch.where(active, prev * WARM, 0.0)
    limits = active[:, 5:].sum().to(torch.int32)
    return a, b, jl, ja, jb, mass, target, one_sided, active, warm, limits


def body_impulses(n, a, b, jl, ja, jb, lam):
    """[N, 6]: each body's linear and angular impulse from the rows'
    impulses ``lam`` [J, 7]."""
    lin = (lam[..., None] * jl).sum(dim=1)
    on_a = torch.cat([-lin, (lam[..., None] * ja).sum(dim=1)], dim=1)
    on_b = torch.cat([lin, (lam[..., None] * jb).sum(dim=1)], dim=1)
    out = torch.zeros((n, 6), dtype=lam.dtype, device=lam.device)
    out.index_add_(0, a, on_a)
    out.index_add_(0, b, on_b)
    return out
