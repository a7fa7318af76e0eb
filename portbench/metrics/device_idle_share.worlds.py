"""device_idle_share.worlds: see ``portbench.harness.readers.idle_share``."""

from portbench.harness.readers import idle_share as read  # noqa: F401
