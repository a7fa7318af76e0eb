"""resolve_roofline.frame: see ``portbench.harness.readers.resolve_roofline``."""

from portbench.harness.readers import resolve_roofline as read  # noqa: F401
