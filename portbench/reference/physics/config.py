"""Physics configuration (assets/config/physics.json).

A copy of ``banggameengine_tpu/physics/config.py`` (pure Python): the port
cannot import the JAX package, which imports ``jax`` on any import.

Mirrors the reference's config load + sanitation
(``src/physics/PhysicsSystem.cpp:216-324``): parse failure keeps the previous
config, ``fixedStep <= 0`` is sanitized to 1/120 (``:277-280``), and the
internal step is clamped to >= 1/240 at step time (``:34``, ``:855``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

log = logging.getLogger("Physics")

MIN_INTERNAL_STEP = 1.0 / 240.0  # PhysicsSystem.cpp:34
MAX_SUBSTEPS = 4                 # PhysicsSystem.cpp:863
SPRINT_MULTIPLIER = 1.8          # PhysicsSystem.cpp:35


@dataclasses.dataclass
class PhysicsConfig:
    gravity: float = -9.81
    fixed_step: float = 1.0 / 120.0
    step_height: float = 0.35
    max_slope_deg: float = 55.0
    capsule_height: float = 2.6   # cylinder section height (btCapsuleShape arg)
    capsule_radius: float = 0.65
    walk_speed: float = 3.6
    jump_impulse: float = 8.5     # applied as jump *speed* (setJumpSpeed)
    solver_iterations: int = 10
    mtime: float = 0.0            # source file mtime for hot reload

    def sanitized(self) -> "PhysicsConfig":
        cfg = dataclasses.replace(self)
        if cfg.fixed_step <= 0.0:
            cfg.fixed_step = 1.0 / 120.0
        cfg.capsule_radius = max(cfg.capsule_radius, 0.01)
        cfg.capsule_height = max(cfg.capsule_height, 0.01)
        cfg.step_height = max(cfg.step_height, 0.0)
        return cfg


def load_physics_config(
    path: str, previous: PhysicsConfig | None = None
) -> PhysicsConfig:
    """Load config; on failure return ``previous`` (or defaults)."""
    fallback = previous if previous is not None else PhysicsConfig()
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        log.warning("[Physics] config load failed (%s), keeping previous", e)
        return fallback

    cfg = dataclasses.replace(fallback)
    cfg.gravity = float(data.get("gravity", cfg.gravity))
    cfg.fixed_step = float(data.get("fixedStep", cfg.fixed_step))
    cfg.step_height = float(data.get("stepHeight", cfg.step_height))
    cfg.max_slope_deg = float(data.get("maxSlopeDeg", cfg.max_slope_deg))
    capsule = data.get("capsule", {}) or {}
    cfg.capsule_height = float(capsule.get("height", cfg.capsule_height))
    cfg.capsule_radius = float(capsule.get("radius", cfg.capsule_radius))
    cfg.walk_speed = float(data.get("walkSpeed", cfg.walk_speed))
    cfg.jump_impulse = float(data.get("jumpImpulse", cfg.jump_impulse))
    cfg.solver_iterations = int(data.get("solverIterations", cfg.solver_iterations))
    try:
        cfg.mtime = os.path.getmtime(path)
    except OSError:
        pass
    return cfg.sanitized()
