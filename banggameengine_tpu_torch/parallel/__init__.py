"""Many worlds in lockstep: the flat block-diagonal step on one device."""

from banggameengine_tpu_torch.parallel.manyworld import (  # noqa: F401
    make_flat_many_world_step,
    replicate_input,
    replicate_state,
)

__all__ = [
    "make_flat_many_world_step",
    "replicate_input",
    "replicate_state",
]
