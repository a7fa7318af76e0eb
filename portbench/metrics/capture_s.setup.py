"""capture_s.setup: see ``portbench.harness.span_readers.capture_s``."""

from portbench.harness.span_readers import capture_s as read  # noqa: F401
