"""Utilities: timers and traces (:mod:`.profiling`)."""
