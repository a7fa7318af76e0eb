"""walk_roofline.frame: see ``portbench.harness.readers.walk_roofline``."""

from portbench.harness.readers import walk_roofline as read  # noqa: F401
