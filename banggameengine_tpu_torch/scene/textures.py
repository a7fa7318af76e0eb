"""Procedural textures: the checker fallback and the 1x1 white texture.

Copied from ``banggameengine_tpu/scene/textures.py`` (numpy only; the
JAX package cannot be imported without JAX).  The image loader is not
needed by the port's scenes, which are procedural.
"""

from __future__ import annotations

import numpy as np


def make_checker_rgba8(size: int = 2) -> np.ndarray:
    """Magenta/black checker fallback texture, so a missing texture is
    obvious."""
    y, x = np.mgrid[0:size, 0:size]
    on = ((x + y) % 2 == 0)
    tex = np.zeros((size, size, 4), np.uint8)
    tex[..., 0] = np.where(on, 255, 30)
    tex[..., 1] = np.where(on, 0, 30)
    tex[..., 2] = np.where(on, 255, 30)
    tex[..., 3] = 255
    return tex


def make_white_rgba8() -> np.ndarray:
    """1x1 white texture for untextured draws."""
    return np.full((1, 1, 4), 255, np.uint8)
