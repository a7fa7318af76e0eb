"""Global physics facade.

Counterpart of ``banggameengine_tpu/physics/api.py`` (the reference's
``Physics::SetActiveSystem`` facade): the reference publishes one active
physics system so any code can raycast or reach the trigger event bus
without plumbing references.  Here the facade wraps the active provider
of ``state``, ``built`` and ``bus`` (the :class:`Application`); the free
functions are the reference's ``Physics::Raycast``, ``RaycastAll`` and
``GetEventBus``.  The queries run on the device of the active state and
read their answer to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from banggameengine_tpu_torch.physics import raycast as rc
from banggameengine_tpu_torch.state import COMP_CHARACTER, COMP_COLLIDER

_active = None  # the Application (or any provider of state, built, bus)


def set_active_system(app) -> None:
    """Register the provider; None clears it (as the reference's physics
    shutdown does)."""
    global _active
    _active = app


def get_active_system():
    return _active


def get_event_bus():
    """The active system's event bus, None when no system is active."""
    return _active.bus if _active is not None else None


def _query_args():
    s = _active.built.static
    st = _active.state
    return (
        st.pos, st.quat, s.shape_type, s.shape_size, s.layer, st.alive,
        (st.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0,
        s.ground_enabled,
    )


def _ray(origin, direction, device) -> tuple[torch.Tensor, torch.Tensor]:
    o = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    d = torch.as_tensor(np.asarray(direction, np.float32), device=device)
    return o, d / torch.linalg.vector_norm(d).clamp_min(1e-9)


def raycast(origin, direction, max_dist: float = 1000.0,
            mask: int = 0xFFFFFFFF) -> rc.RaycastHit | None:
    """The closest hit in the active world, or None when no system is
    active or nothing was hit."""
    if _active is None:
        return None
    o, d = _ray(origin, direction, _active.state.pos.device)
    hit = rc.raycast_closest(o, d, max_dist, mask, *_query_args())
    if int(hit.entity) == rc.NO_HIT:
        return None
    return hit


def raycast_all(origin, direction, max_dist: float = 1000.0,
                mask: int = 0xFFFFFFFF) -> list[rc.RaycastHit]:
    """Every hit, sorted by distance (the reference returns them unsorted;
    sorted here for determinism), as host (CPU) tensors read in one
    copy."""
    if _active is None:
        return []
    o, d = _ray(origin, direction, _active.state.pos.device)
    t, hit, normal, t_g, hit_g = rc.raycast_all(o, d, max_dist, mask,
                                                *_query_args())
    n = t.shape[0]
    host = torch.cat([t, hit.float(), normal.reshape(-1), t_g[None],
                      hit_g.float()[None], o, d]).cpu()
    t, hit, normal = host[:n], host[n:2 * n] > 0, host[2 * n:5 * n]
    t_g, hit_g, o, d = host[5 * n], host[5 * n + 1] > 0, host[-6:-3], host[-3:]
    normal = normal.reshape(n, 3)
    hits = [rc.RaycastHit(entity=torch.tensor(i, dtype=torch.int32),
                          point=o + d * t[i], normal=normal[i],
                          distance=t[i])
            for i in hit.nonzero()[:, 0].tolist()]
    if bool(hit_g):
        hits.append(rc.RaycastHit(
            entity=torch.tensor(rc.GROUND_ENTITY, dtype=torch.int32),
            point=o + d * t_g, normal=torch.tensor([0.0, 1.0, 0.0]),
            distance=t_g))
    hits.sort(key=lambda h: float(h.distance))
    return hits
