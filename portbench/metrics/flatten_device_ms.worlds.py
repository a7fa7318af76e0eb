"""flatten_device_ms.worlds:
the device ms a step of the stages ``manyworld_flatten`` + ``manyworld_unflatten``, read by
``portbench.harness.span_readers``."""

from portbench.harness.span_readers import per_step

read = per_step("manyworld_flatten", "manyworld_unflatten")
