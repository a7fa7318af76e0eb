"""joints_device_ms.worlds:
the device ms a step of the stage ``physics_joints`` in the flat
many-world step (the joint rows' set-up and their updates inside the
solver's iterations), read by ``portbench.harness.span_readers``."""

from portbench.harness.span_readers import per_step

read = per_step("physics_joints")
