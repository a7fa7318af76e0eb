"""shade_device_ms.frame:
the device ms a frame of the stage ``render_shade``, read by
``portbench.harness.span_readers``."""

from portbench.harness.span_readers import per_frame

read = per_frame("render_shade")
