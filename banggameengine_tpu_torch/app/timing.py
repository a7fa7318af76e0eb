"""Frame timer: delta, elapsed, instantaneous FPS.

A copy of ``banggameengine_tpu/app/timing.py`` (the JAX package cannot be
imported without JAX), its logic unchanged.

Equivalent of the static steady-clock timer in ``src/core/Time.{h,cpp}``
(``Tick`` at ``Time.cpp:16-29``), as an instantiable class (no global
statics) with an injectable clock for tests.
"""

from __future__ import annotations

import time as _time
from typing import Callable


class Time:
    def __init__(self, clock: Callable[[], float] = _time.perf_counter):
        self._clock = clock
        self._start = clock()
        self._last = self._start
        self._delta = 0.0
        self._fps = 0.0

    def tick(self) -> float:
        now = self._clock()
        self._delta = now - self._last
        self._last = now
        self._fps = 1.0 / self._delta if self._delta > 1e-9 else 0.0
        return self._delta

    @property
    def delta_time(self) -> float:
        return self._delta

    @property
    def elapsed_time(self) -> float:
        return self._last - self._start

    @property
    def fps(self) -> float:
        return self._fps
