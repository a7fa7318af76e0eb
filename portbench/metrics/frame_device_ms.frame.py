"""frame_device_ms.frame: see ``portbench.harness.readers.frame_device_ms``."""

from portbench.harness.readers import frame_device_ms as read  # noqa: F401
