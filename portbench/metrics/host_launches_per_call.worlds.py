"""host_launches_per_call.worlds: see ``portbench.harness.readers.host_launches_per_call``."""

from portbench.harness.readers import host_launches_per_call as read  # noqa: F401
