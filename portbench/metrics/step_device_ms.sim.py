"""step_device_ms.sim: see ``portbench.harness.readers.step_device_ms``."""

from portbench.harness.readers import step_device_ms as read  # noqa: F401
