"""The port's HUD (``app/hud.py``) against the JAX package's on the CPU.

The JAX package draws the HUD with PIL's default font, a FreeType font
where Pillow has FreeType, so its pixels depend on the Pillow build.  The
port draws PIL's bitmap default font from its own copy
(``app/hud_font.py``, written by ``app/make_hud_font.py``), so the bar for
the pixels is PIL drawing the same lines with that bitmap font: the JAX
package's own ``compose_hud`` with PIL's default font set to it.  Bars:
the pixels exactly equal, the pixels outside the text bands unchanged;
the font table equal to what the script writes from this Pillow; the
HUD's strings equal the JAX app's but for line 2, which names the port's
renderer; ``render_current_frame(hud=True)`` is the frame with the HUD
composed on its host copy.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from PIL import ImageFont

from banggameengine_tpu.app import hud as jax_hud
from banggameengine_tpu.app.application import Application as JaxApplication
from banggameengine_tpu_torch.app import hud, hud_font
from banggameengine_tpu_torch.app.application import Application
from banggameengine_tpu_torch.app.make_hud_font import glyph_table
from banggameengine_tpu_torch.physics import raycast as rc
from test_torch_app_golden import ASSETS, SMALL
from test_torch_app_golden import assets_env  # noqa: F401 (a fixture)

PRINTABLE = [chr(c) for c in range(32, 127)]


@pytest.fixture
def pil_bitmap_font(monkeypatch):
    """PIL's default font set to its bitmap default font, the font the
    port copies."""
    font = ImageFont.load_default_imagefont()
    monkeypatch.setattr(ImageFont, "load_default", lambda size=None: font)


def test_font_table_is_current():
    baseline, height, glyphs = glyph_table()
    assert (baseline, height) == (hud_font.BASELINE, hud_font.HEIGHT)
    assert glyphs == hud_font.GLYPHS
    assert sorted(glyphs) == list(range(32, 127))


@pytest.mark.parametrize("seed", range(4))
def test_compose_hud_matches_pil(pil_bitmap_font, seed):
    """Random printable lines (every glyph, overlapping boxes, lines
    running off the frame's right and bottom edges) over a random frame:
    every pixel equal to PIL's, and the frame unchanged outside the text
    bands."""
    rng = np.random.default_rng(seed)
    h, w = [(32, 128), (72, 128), (140, 400), (20, 50)][seed]
    frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    lines = [(int(rng.integers(0, 256)),
              "".join(rng.choice(PRINTABLE, int(rng.integers(0, 80)))))
             for _ in range(12)]
    lines[0] = (0x0F, "".join(PRINTABLE))
    ref = jax_hud.compose_hud(frame, lines)
    got = hud.compose_hud(frame, lines)
    assert got.dtype == np.uint8 and got.shape == frame.shape
    assert np.array_equal(got, ref)
    assert not np.array_equal(got, frame)
    # the text bands: line k's glyphs and shadow span rows 2 + 12k ..
    # 2 + 12k + HEIGHT, columns from 4
    band = np.zeros((h, w), bool)
    for k in range(len(lines)):
        band[2 + 12 * k: 3 + 12 * k + hud_font.HEIGHT, 3:] = True
    assert np.array_equal(got[~band], frame[~band])


def test_compose_hud_colours(pil_bitmap_font):
    """The palette by the low 4 bits of the attribute, white otherwise,
    and the black shadow one pixel right and down."""
    frame = np.full((16, 40, 4), 128, np.uint8)
    for attr, rgb in [(0x1A, (85, 255, 85)), (0x07, (255, 255, 255))]:
        got = hud.compose_hud(frame, [(attr, "I")])
        assert np.array_equal(got, jax_hud.compose_hud(frame, [(attr, "I")]))
        colours = {tuple(c) for c in got.reshape(-1, 4)}
        assert colours == {(128,) * 4, (0, 0, 0, 255), (*rgb, 255)}


def _apps():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("BANG_ASSETS_DIR", raising=False)
        mp.setenv("BANG_DISABLE_NATIVE", "1")
        port = Application(assets_root=ASSETS, width=SMALL[0],
                           height=SMALL[1], device="cpu")
        ref = JaxApplication(assets_root=ASSETS, width=SMALL[0],
                             height=SMALL[1])
    return port, ref


def test_standard_hud_lines_match_jax():
    """The same strings as the JAX app's but for line 2, with the toggles
    and axes set and with a ray hit, a ground hit and no hit."""
    port, ref = _apps()
    for app in (port, ref):
        app.wireframe, app.vsync, app.physics_overlay = True, False, True
        app.input.source.press("W", "LEFT_SHIFT")
        app.input.update()
    hits = [None, (2, 2.0499), (rc.GROUND_ENTITY, 0.5), (rc.NO_HIT, 0.0)]
    for hit in hits:
        if hit is None:
            port.last_ray_hit = ref.last_ray_hit = None
        else:
            e, d = hit
            port.last_ray_hit = rc.RaycastHit(
                entity=torch.tensor(e, dtype=torch.int32),
                point=torch.zeros(3), normal=torch.zeros(3),
                distance=torch.tensor(d, dtype=torch.float32))
            ref.last_ray_hit = types.SimpleNamespace(
                entity=np.int32(e), distance=np.float32(d))
        got = hud.standard_hud_lines(port)
        want = jax_hud.standard_hud_lines(ref)
        assert len(got) == len(want) == 10
        assert got[:1] + got[2:] == want[:1] + want[2:], hit
        assert want[1] == (0x0A, "Renderer: jax-tpu-raster")
        assert got[1] == (0x0A, f"Renderer: {hud.RENDERER}")
    assert "Jump=n Sprint=Y" in got[6][1] and "F=+1.00" in got[6][1]


def test_render_current_frame_with_the_hud():
    port, _ = _apps()
    port.state = dataclasses.replace(
        port.state, time=torch.tensor(1.25), step_idx=torch.tensor(
            150, dtype=torch.int32))
    plain = port.render_current_frame()
    with_hud = port.render_current_frame(hud=True)
    assert np.array_equal(
        with_hud, hud.compose_hud(plain, hud.standard_hud_lines(port)))
    assert not np.array_equal(with_hud, plain)
    assert hud.standard_hud_lines(port)[-1] == (0x0F,
                                                "Sim t=1.25s steps=150")
