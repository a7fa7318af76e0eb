"""motors_device_ms.worlds:
the device ms a step of the stage ``physics_motors`` (the hinges' motor
torques, turned into the bodies' spin before the contact phase), read by
``portbench.harness.span_readers``."""

from portbench.harness.span_readers import per_step

read = per_step("physics_motors")
