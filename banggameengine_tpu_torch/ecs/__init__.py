"""Entity-component helpers: the transform hierarchy, the runtime
lifecycle (spawn, despawn, reparent) and the submit-style render path."""

from banggameengine_tpu_torch.ecs.lifecycle import (
    despawn,
    free_slots,
    is_alive,
    reparent,
    spawn,
)
from banggameengine_tpu_torch.ecs.transform import (
    compute_levels,
    update_world_matrices,
)

__all__ = [
    "compute_levels",
    "update_world_matrices",
    "spawn",
    "despawn",
    "reparent",
    "is_alive",
    "free_slots",
]
