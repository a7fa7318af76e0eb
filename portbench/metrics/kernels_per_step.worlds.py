"""kernels_per_step.worlds: see ``portbench.harness.readers.kernels_per_step``."""

from portbench.harness.readers import kernels_per_step as read  # noqa: F401
