"""The JAX golden of the application shell on the asset tree
``tests/data/app_assets`` (the demo's topology at ``build_demo_like``'s
poses: the character ``cj`` with a child renderer, the ``checkpoint``
trigger, the textured ``ground`` box).

The JAX package's ``Application`` runs ``examples/play_demo.py``'s scripted
track (idle 2 s, walk toward the checkpoint, sprint from 5 s, jump once a
second from 6 s) for 8 s at 30 display frames/s, once on each path:
``fused_tick=True`` (4 substeps and a frame per display frame, rendered at
128x32: the physics reads no image) and the default path (one step a
fixed step).  The golden keeps, for each path, the character's position
and on-ground flag and the step count after every display frame, the
trigger Enter/Exit events with the display frame they reached the bus on,
the status lines and the stats line; and three frames
(``app_jax_golden.npz``): the last fused frame at 128x32, the same state
rendered at 1280x720 by the same call the fused tick makes (with the
world matrices and camera it is drawn from), and the default path's
``render_current_frame()`` at 128x32 after one more display frame of half
a fixed step (so the frame blends the last two steps half way).

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_app_golden.py``
rewrites both files; ``test_app_golden_is_current`` runs the JAX app again
and requires the same numbers and frames (the full-size frame's JAX
render, ~30 s, is held current by ``tests/test_torch_app_frame.py``).
``tests/test_torch_app.py`` holds the port to them on the CPU, and
``chip_smoke.py`` phase 17 on the card.
"""

import json
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ASSETS = os.path.join(DATA, "app_assets")
GOLDEN_JSON = os.path.join(DATA, "app_jax_golden.json")
GOLDEN_NPZ = os.path.join(DATA, "app_jax_golden.npz")
SECONDS, FPS = 8.0, 30
SMALL = (128, 32)      # one 32x128 tile: the CPU runs render every frame
FULL = (1280, 720)
ATOL = 1e-4            # the character, port against JAX (0.0 on the CPU)
REST_Y = 2.94          # the ground box's top 0.99 + the capsule's 1.95


def _jax_track(app, i, cj):
    """``examples/play_demo.py``'s scripted input for display frame i."""
    t = i / FPS
    src = app.input.source
    if t < 2.0:
        src.release("W", "LEFT_SHIFT", "SPACE")
    elif t < 5.0:
        src.press("W")
        d = np.array([5.0, 5.0]) - np.asarray(app.state.pos[cj, [0, 2]])
        app.camera.set_yaw_pitch(float(np.arctan2(d[1], d[0])),
                                 app.camera.pitch)
    elif t < 6.0:
        src.press("LEFT_SHIFT")
    else:
        src.press("SPACE") if (i % FPS) == 0 else src.release("SPACE")


def _jax_run(fused: bool):
    from banggameengine_tpu.app.application import Application
    from banggameengine_tpu.app.events import TriggerEvent, TriggerPhase

    app = Application(assets_root=ASSETS, width=SMALL[0], height=SMALL[1],
                      fused_tick=fused)
    cj = app.built.find_entity("cj")
    rec = dict(char=[], on_ground=[], steps=[], events=[], status=[])

    def on_event(e):
        if e.phase is not TriggerPhase.STAY:
            rec["events"].append([app.frame_count, e.phase.value,
                                  e.trigger_entity, e.other_entity])

    app.bus.subscribe(TriggerEvent, on_event)
    for i in range(int(SECONDS * FPS)):
        _jax_track(app, i, cj)
        app.frame(real_dt=1.0 / FPS)
        rec["char"].append(np.asarray(app.state.pos[cj]).tolist())
        rec["on_ground"].append(bool(app.state.char_on_ground[cj]))
        rec["steps"].append(int(app.state.step_idx))
        if app.last_status and (not rec["status"]
                                or rec["status"][-1] != app.last_status):
            rec["status"].append(app.last_status)
    rec["status_line"] = app.status_line()
    rec["physics_stats"] = app.physics_stats()
    return app, rec


def _golden():
    """(json dict, npz arrays) from the JAX app on both paths, without the
    full-size frame (:func:`full_frame` renders it from these arrays)."""
    out = dict(seconds=SECONDS, fps=FPS, small=list(SMALL), full=list(FULL),
               atol=ATOL, rest_y=REST_Y)
    app, out["fused"] = _jax_run(fused=True)
    # the last fused state and camera, and the frame the fused tick drew
    frames = dict(
        fused_small=np.asarray(app.last_frame_image),
        fused_world=np.asarray(app.state.world),
        fused_view=np.asarray(app.camera.view_matrix()),
        fused_proj_full=np.asarray(app.camera.proj_matrix(FULL[0] / FULL[1])),
        fused_cam_pos=np.asarray(app.camera.position))
    app, out["default"] = _jax_run(fused=False)
    app.frame(real_dt=0.5 * app.config.fixed_step)
    frames["default_small"] = np.asarray(app.render_current_frame())
    return out, frames


def full_frame(frames) -> np.ndarray:
    """The last fused state at full size, through the call the fused tick
    makes (``render_frame`` with the app's bin capacity and the default
    light)."""
    import jax.numpy as jnp

    from banggameengine_tpu.app.application import Application
    from banggameengine_tpu.render.pipeline import render_frame

    app = Application(assets_root=ASSETS, width=FULL[0], height=FULL[1],
                      fused_tick=True)
    return np.asarray(render_frame(
        app.built.render, jnp.asarray(frames["fused_world"]),
        jnp.asarray(frames["fused_view"]),
        jnp.asarray(frames["fused_proj_full"]),
        jnp.asarray(frames["fused_cam_pos"]), app.light,
        width=FULL[0], height=FULL[1], bin_capacity=2048))


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's eager PyTorch on one intra-op thread: the app's
    thousands of tiny ops a step run fastest so (116 against 174 ms a
    128x32 fused display frame on an 8-core CPU), and parallel test
    workers do not crowd each other's thread pools.  Modules that import
    it make it autouse."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def assets_env(monkeypatch):
    """Both packages read the tree through the Python OBJ loader, and the
    tree given, not ``BANG_ASSETS_DIR``."""
    monkeypatch.setenv("BANG_DISABLE_NATIVE", "1")
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)


def test_app_golden_is_current(assets_env):
    with open(GOLDEN_JSON) as f:
        stored = json.load(f)
    stored_frames = np.load(GOLDEN_NPZ)
    golden, frames = _golden()
    assert golden == stored, (
        "tests/data/app_jax_golden.json is stale: run PYTHONPATH=. "
        "JAX_PLATFORMS=cpu python tests/test_torch_app_golden.py")
    assert sorted([*frames, "fused_full"]) == sorted(stored_frames.files)
    for k, v in frames.items():
        assert np.array_equal(v, stored_frames[k]), f"{k} is stale"


def test_golden_track_lands_and_crosses_the_checkpoint():
    """What the golden shows: the character lands at 2.94, and the
    checkpoint sees the ground at the first frame and the character enter
    and leave it once, on both paths at the same frames, along the same
    track."""
    with open(GOLDEN_JSON) as f:
        g = json.load(f)
    for name in ("fused", "default"):
        rec = g[name]
        assert abs(rec["char"][59][1] - REST_Y) < 1e-5 and rec["on_ground"][59]
        assert rec["steps"][-1] == int(SECONDS * 120)
        phases = [(e[1], e[3]) for e in rec["events"]]
        assert phases == [("enter", 2), ("enter", 0), ("exit", 0)]
    assert g["fused"]["events"] == g["default"]["events"]
    # the fused tick's step skips dead stages, the default path's runs
    # them all: the last bit may differ
    np.testing.assert_allclose(g["fused"]["char"], g["default"]["char"],
                               atol=ATOL)


if __name__ == "__main__":
    os.environ["BANG_DISABLE_NATIVE"] = "1"
    os.environ.pop("BANG_ASSETS_DIR", None)
    golden, frames = _golden()
    frames["fused_full"] = full_frame(frames)
    with open(GOLDEN_JSON, "w") as f:
        json.dump(golden, f)
        f.write("\n")
    np.savez_compressed(GOLDEN_NPZ, **frames)
    print(f"wrote {GOLDEN_JSON} and {GOLDEN_NPZ}")
