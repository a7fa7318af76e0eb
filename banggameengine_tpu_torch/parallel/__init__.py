"""Many worlds in lockstep and the sharded modes over ``torch.distributed``."""

from banggameengine_tpu_torch.parallel.dryrun import (  # noqa: F401
    dryrun_multichip,
)
from banggameengine_tpu_torch.parallel.manyworld import (  # noqa: F401
    make_flat_many_world_step,
    make_many_world_step,
    make_sharded_many_world_step,
    make_world_mesh,
    replicate_input,
    replicate_state,
    shard_batched,
    world_metrics,
)

__all__ = [
    "dryrun_multichip",
    "make_flat_many_world_step",
    "make_many_world_step",
    "make_sharded_many_world_step",
    "make_world_mesh",
    "replicate_input",
    "replicate_state",
    "shard_batched",
    "world_metrics",
]
