"""The JAX golden of the app's overlays on the asset tree
``tests/data/app_assets`` (``tests/data/overlay_jax_golden.npz``).

The JAX package's ``Application`` on the default path (one step a fixed
step, the interpolated frame) at 128x32 runs ``examples/play_demo.py``'s
track for its first ``FRAMES`` display frames, then one display frame of
half a fixed step (no step: the frame blends the last two steps half
way), and renders ``render_current_frame()`` three times: the plain frame,
the F3 frame (``physics_overlay``: the collision shapes drawn over it as
depth-tested lines) and the F1 frame (``wireframe``: the mesh edges as
lines over the clear colour).  The golden keeps the three frames, the
inputs they were drawn from (the state and the previous state, the
accumulator, the camera), so a machine without JAX can render the same
frames from the same inputs, and the JAX HUD's lines of that moment.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_overlay_golden.py``
rewrites it; ``test_overlay_golden_is_current`` runs the JAX app again
and requires the same arrays (~35 s on the CPU, nearly all of it JAX's
compiles).  ``tests/test_torch_overlay.py`` and ``test_torch_hud.py``
hold the port to it on the CPU, and ``chip_smoke.py`` phase 18 on the
card.
"""

import dataclasses
import json
import os

import numpy as np

from test_torch_app_golden import ASSETS, DATA, FPS, SMALL, _jax_track
from test_torch_app_golden import assets_env  # noqa: F401 (a fixture)

GOLDEN_NPZ = os.path.join(DATA, "overlay_jax_golden.npz")
FRAMES = 30            # the track's first second: the character has landed


def _golden() -> dict:
    """The JAX app's arrays (see the module docstring)."""
    from banggameengine_tpu.app.application import Application
    from banggameengine_tpu.app.hud import standard_hud_lines

    app = Application(assets_root=ASSETS, width=SMALL[0], height=SMALL[1])
    cj = app.built.find_entity("cj")
    for i in range(FRAMES):
        _jax_track(app, i, cj)
        app.frame(real_dt=1.0 / FPS)
    app.frame(real_dt=0.5 * app.config.fixed_step)
    out = {}
    for prefix, state in (("state_", app.state), ("prev_", app._prev_state)):
        for f in dataclasses.fields(state):
            out[prefix + f.name] = np.asarray(getattr(state, f.name))
    out["accumulator"] = np.float64(app._accumulator)
    out["cam_pos"] = np.asarray(app.camera.position, np.float32)
    out["cam_yaw_pitch"] = np.float64([app.camera.yaw, app.camera.pitch])
    out["base_small"] = np.asarray(app.render_current_frame())
    app.physics_overlay = True
    out["f3_small"] = np.asarray(app.render_current_frame())
    out["hud_lines"] = np.array(json.dumps(standard_hud_lines(app)))
    app.physics_overlay = False
    app.wireframe = True
    out["f1_small"] = np.asarray(app.render_current_frame())
    return out


def test_overlay_golden_is_current(assets_env):
    stored = np.load(GOLDEN_NPZ)
    golden = _golden()
    assert sorted(golden) == sorted(stored.files)
    for k, v in golden.items():
        assert v.dtype == stored[k].dtype and np.array_equal(v, stored[k]), (
            f"{k} is stale: run PYTHONPATH=. JAX_PLATFORMS=cpu python "
            "tests/test_torch_overlay_golden.py")


def test_golden_frames_show_the_overlays():
    """What the golden shows: F3 draws lines over the plain frame, F1
    draws white lines over the sky's clear colour only."""
    g = np.load(GOLDEN_NPZ)
    base, f3, f1 = g["base_small"], g["f3_small"], g["f1_small"]
    assert base.shape == (SMALL[1], SMALL[0], 4)
    assert 0 < int((f3 != base).any(-1).sum()) < base.shape[0] * base.shape[1]
    colours = {tuple(c) for c in f1.reshape(-1, 4)}
    assert colours == {(136, 170, 255, 255), (255, 255, 255, 255)}
    assert json.loads(str(g["hud_lines"]))[1] == [10, "Renderer: jax-tpu-raster"]


if __name__ == "__main__":
    os.environ["BANG_DISABLE_NATIVE"] = "1"
    os.environ.pop("BANG_ASSETS_DIR", None)
    np.savez_compressed(GOLDEN_NPZ, **_golden())
    print(f"wrote {GOLDEN_NPZ}")
