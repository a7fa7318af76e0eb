"""narrowphase_device_ms.sim:
the device ms a step of the stage ``physics_narrowphase``, read by
``portbench.harness.span_readers``."""

from portbench.harness.span_readers import per_step

read = per_step("physics_narrowphase")
