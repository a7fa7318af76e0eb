"""Utilities: checkpoints (:mod:`.checkpoint`), the checked step
(:mod:`.debug`), timers, spans and traces (:mod:`.profiling`)."""

from banggameengine_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
]
