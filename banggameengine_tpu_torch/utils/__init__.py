"""Utilities: checkpoints (:mod:`.checkpoint`), the checked step
(:mod:`.debug`), timers and traces (:mod:`.profiling`)."""

from banggameengine_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from banggameengine_tpu_torch.utils.profiling import (
    StepTimer,
    trace_annotation,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "StepTimer",
    "trace_annotation",
]
