"""Entity-level frustum culling.

Counterpart of ``banggameengine_tpu/render/cull.py``: each entity's
object-space AABB is transformed by its world matrix, its 8 corners are
tested against the clip-space half-spaces of ``proj @ view``, and an
entity is culled only when all 8 corners lie outside one plane.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def entity_frustum_mask(ent_aabb_min: Tensor, ent_aabb_max: Tensor,
                        ent_has_mesh: Tensor, world_mats: Tensor,
                        view: Tensor, proj: Tensor) -> Tensor:
    """bool[N]: entity potentially visible (clip-space tests x, y in
    [-w, w], z in [0, w])."""
    ax, ay, az = ent_aabb_min.unbind(-1)
    bx, by, bz = ent_aabb_max.unbind(-1)
    corners = torch.stack([
        torch.stack(c, dim=-1) for c in (
            (ax, ay, az), (bx, ay, az), (ax, by, az), (bx, by, az),
            (ax, ay, bz), (bx, ay, bz), (ax, by, bz), (bx, by, bz))
    ], dim=1)                                              # [N,8,3]
    wc = (torch.einsum("nij,nkj->nki", world_mats[:, :3, :3], corners)
          + world_mats[:, None, :3, 3])
    vp = torch.matmul(proj, view)
    wc4 = torch.cat([wc, torch.ones_like(wc[..., :1])], dim=-1)
    clip = torch.einsum("ij,nkj->nki", vp, wc4)            # [N,8,4]
    x, y, z, cw = clip.unbind(-1)
    culled = ((x < -cw).all(dim=1) | (x > cw).all(dim=1)
              | (y < -cw).all(dim=1) | (y > cw).all(dim=1)
              | (z < 0.0).all(dim=1) | (z > cw).all(dim=1))
    return ent_has_mesh & ~culled
