"""broadphase_roofline.sim: see ``portbench.harness.readers.broadphase_roofline``."""

from portbench.harness.readers import broadphase_roofline as read  # noqa: F401
