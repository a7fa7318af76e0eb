"""On-screen debug-text HUD, composited on the host.

Counterpart of ``banggameengine_tpu/app/hud.py`` (the reference's
bgfx debug-text console, ``Renderer.cpp:540-561``: title, renderer,
FPS, camera, controls, light, input, orbit, raycast, sim time).  The
frame is already on the host for display, so the text is drawn there,
in the JAX package's layout: line k at x = 4, y = 2 + 12k, over a black
shadow one pixel right and down, coloured by the low 4 bits of its
attribute.  The JAX package draws with PIL's default font, which the
card's machine lacks; the port draws the glyphs of PIL's bitmap default
font from its own copy (:mod:`hud_font`), as PIL pastes them: each
glyph's box overwrites the line's mask in turn, then the ink fills the
mask.  Characters outside printable ASCII draw nothing and take no room.
"""

from __future__ import annotations

import numpy as np
import torch

from banggameengine_tpu_torch.app import hud_font
from banggameengine_tpu_torch.physics import raycast as rc

# bgfx 4-bit console palette (index -> RGB), as dbgTextPrintf colours it
PALETTE = {
    0x0A: (85, 255, 85),    # green
    0x0B: (85, 255, 255),   # cyan
    0x0C: (255, 85, 85),    # red
    0x0E: (255, 255, 85),   # yellow
    0x0F: (255, 255, 255),  # white
}
RENDERER = "torch-cuda-raster"
_LINE_X, _LINE_Y, _LINE_STEP = 4, 2, 12


def _glyph_bitmap(rows: tuple, width: int) -> np.ndarray:
    return ((np.asarray(rows, np.int64)[:, None] >> np.arange(width)) & 1
            ).astype(bool)


_BITMAPS = {code: _glyph_bitmap(g[6], g[4] - g[2])
            for code, g in hud_font.GLYPHS.items()}


def text_mask(text: str) -> np.ndarray:
    """The text's mask bool[HEIGHT, width]: each glyph's bitmap pasted at
    the pen over what the earlier glyphs left (boxes may overlap by a
    column), the pen advancing by each glyph's ``dx``."""
    codes = [ord(c) for c in text if ord(c) in hud_font.GLYPHS]
    width = sum(hud_font.GLYPHS[c][0] for c in codes)
    mask = np.zeros((hud_font.HEIGHT, width), bool)
    x, b = 0, hud_font.BASELINE
    for c in codes:
        dx, dy, x0, y0, x1, y1, _ = hud_font.GLYPHS[c]
        bits = _BITMAPS[c]
        # the box clipped to the mask, and the bitmap with it
        cx0, cy0 = max(x + x0, 0), max(b + y0, 0)
        cx1, cy1 = min(x + x1, width), min(b + y1, hud_font.HEIGHT)
        if cx1 > cx0 and cy1 > cy0:
            mask[cy0:cy1, cx0:cx1] = bits[cy0 - b - y0:cy1 - b - y0,
                                          cx0 - x - x0:cx1 - x - x0]
        x += dx
        b += dy
    return mask


def _draw(out: np.ndarray, x: int, y: int, text: str, color) -> None:
    """Fill ``color`` where the text's mask is set, its top-left corner at
    (x, y), clipped to the frame."""
    mask = text_mask(text)
    h, w = out.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + mask.shape[1], w), min(y + mask.shape[0], h)
    if x1 <= x0 or y1 <= y0:
        return
    region = out[y0:y1, x0:x1]
    region[mask[y0 - y:y1 - y, x0 - x:x1 - x]] = (*color, 255)


def compose_hud(frame: np.ndarray, lines: list[tuple[int, str]]) -> np.ndarray:
    """Draw HUD text lines onto a u8[H, W, 4] frame; returns a new array.
    ``lines``: (bgfx colour attribute, text) pairs."""
    out = np.array(frame, np.uint8, copy=True)
    y = _LINE_Y
    for attr, text in lines:
        color = PALETTE.get(attr & 0x0F, (255, 255, 255))
        _draw(out, _LINE_X + 1, y + 1, text, (0, 0, 0))  # soft shadow
        _draw(out, _LINE_X, y, text, color)
        y += _LINE_STEP
    return out


def standard_hud_lines(app) -> list[tuple[int, str]]:
    """The reference's 10-line HUD (Renderer.cpp:540-561), as the JAX
    package adapts it; line 2 names the port's renderer.  The sim time,
    the step index and the ray hit come to the host in one read."""
    cam = app.camera.position
    state, hit = app.state, app.last_ray_hit
    parts = [state.time.reshape(1), state.step_idx.reshape(1)]
    if hit is not None:
        parts += [hit.entity.reshape(1), hit.distance.reshape(1)]
    values = torch.cat([p.to(torch.float64) for p in parts]).tolist()
    ray = "none"
    if hit is not None and int(values[2]) != rc.NO_HIT:
        ray = f"{app.entity_label(int(values[2]))} d={values[3]:.2f}"
    return [
        (0x0F, "BangGameEngine-TPU"),
        (0x0A, f"Renderer: {RENDERER}"),
        (0x0B, f"FPS: {app.time.fps:.1f}"),
        (0x0E, f"Camera: ({cam[0]:.1f}, {cam[1]:.1f}, {cam[2]:.1f})"),
        (0x0C, f"Controls: WASD/Mouse, F1=Wireframe({'on' if app.wireframe else 'off'}), "
               f"V=VSync({'on' if app.vsync else 'off'})"),
        (0x0F, f"F3=PhysicsDebug({'on' if app.physics_overlay else 'off'}), "
               "F5=ReloadScene, F9=Stats"),
        (0x0E, f"Axes: F={app.input.get_axis('MoveForward'):+.2f} "
               f"R={app.input.get_axis('MoveRight'):+.2f} "
               f"Jump={'Y' if app.input.action_held('Jump') else 'n'} "
               f"Sprint={'Y' if app.input.action_held('Sprint') else 'n'}"),
        (0x0B, app.orbit.hud_line()),
        (0x0A, f"Raycast down: {ray}"),
        (0x0F, f"Sim t={values[0]:.2f}s steps={int(values[1])}"),
    ]
