"""The app's host parts, the port against the JAX package on the CPU: the
cases of ``tests/test_app.py`` (event bus, input, orbit controller, frame
timer) run through both packages' classes with the same scripted inputs,
with the same outputs; then the port's Application on the asset tree:
light keys and hotkeys against the JAX app's, the scene and physics-config
hot reloads, and the parts not ported (the HUD and the physics overlay)
refusing with ROADMAP item 15.
"""

import dataclasses
import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from banggameengine_tpu.app import events as jev
from banggameengine_tpu.app import input as jinput
from banggameengine_tpu.app.orbit import CameraOrbitController as JaxOrbit
from banggameengine_tpu.app.timing import Time as JaxTime
from banggameengine_tpu.render.camera import Camera as JaxCamera
from banggameengine_tpu.state import StepEvents as JaxStepEvents
from banggameengine_tpu_torch.app import events as tev
from banggameengine_tpu_torch.app import input as tinput
from banggameengine_tpu_torch.app.application import Application
from banggameengine_tpu_torch.app.orbit import CameraOrbitController
from banggameengine_tpu_torch.app.timing import Time
from banggameengine_tpu_torch.app.window import HeadlessWindow
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.state import StepEvents
from test_torch_app_golden import ASSETS, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BINDINGS = {
    "axes": {
        "MoveForward": [{"key": "W", "scale": 1.0},
                        {"key": "S", "scale": -1.0}],
        "LookX": [{"mouse": "DeltaX", "scale": 1.0}],
        "LookY": [{"mouse": "DeltaY", "scale": 1.0}],
        "Zoom": [{"scroll": "ScrollY", "scale": -1.0}],
    },
    "actions": {
        "Jump": [{"key": "SPACE"}],
        "OrbitLook": [{"mouseButton": "MOUSE_RIGHT"}],
        "OrbitReset": [{"key": "R"}],
        "OrbitCancel": [{"key": "ESCAPE"}],
    },
    "mouse": {"sensitivity": 0.5, "smoothtype": "ema", "alpha": 0.5},
}


@pytest.fixture
def bindings_file(tmp_path):
    p = tmp_path / "bindings.json"
    p.write_text(json.dumps(BINDINGS))
    return str(p)


# ---------------------------------------------------------------------------
# event bus
# ---------------------------------------------------------------------------

class _Evt:
    def __init__(self, v):
        self.v = v


@pytest.mark.parametrize("mod", [tev, jev], ids=["port", "jax"])
def test_event_bus_publish_subscribe(mod):
    bus = mod.EventBus()
    got = []
    unsub = bus.subscribe(_Evt, lambda e: got.append(e.v))
    bus.publish(_Evt(1))
    bus.publish(_Evt(2))
    unsub()
    unsub()                       # a second unsubscribe is a no-op
    bus.publish(_Evt(3))
    bus.subscribe(_Evt, lambda e: got.append(-e.v))
    bus.clear()
    bus.publish(_Evt(4))
    assert got == [1, 2]


@pytest.mark.parametrize("stay", [True, False])
def test_dispatch_step_events_matches_jax(stay):
    rng = np.random.default_rng(3)
    planes = rng.random((3, 2, 6)) < 0.3
    te = np.array([4, 1], np.int32)
    got = {"port": [], "jax": []}
    for name, mod, ev in (
            ("port", tev, StepEvents(
                *(torch.as_tensor(p) for p in planes),
                contact_overflow=torch.zeros((), dtype=torch.int32))),
            ("jax", jev, JaxStepEvents(*(jnp.asarray(p) for p in planes)))):
        bus = mod.EventBus()
        bus.subscribe(mod.TriggerEvent, lambda e, n=name: got[n].append(
            (e.trigger_entity, e.other_entity, e.phase.value, e.world)))
        trig = torch.as_tensor(te) if name == "port" else jnp.asarray(te)
        n = mod.dispatch_step_events(bus, ev, trig, stay=stay, world=2)
        assert n == len(got[name])
    assert got["port"] == got["jax"]
    assert {p for _, _, p, _ in got["port"]} == (
        {"enter", "stay", "exit"} if stay else {"enter", "exit"})


# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------

_SCRIPT = [
    dict(),
    dict(press=["W"]),
    dict(press=["S"]),
    dict(release=["W"]),
    dict(press=["SPACE"]),
    dict(),
    dict(release=["SPACE"], mouse=(1.0, -2.0), scroll=(0.0, 1.0)),
    dict(mouse=(0.0, 0.0), scroll=(0.0, 0.0), buttons=["MOUSE_RIGHT"]),
    dict(mouse=(3.0, 1.0), press=["X"]),
    dict(release_buttons=["MOUSE_RIGHT"], press=["ESCAPE", "bogus"]),
]
_AXES = ("MoveForward", "LookX", "LookY", "Zoom", "Missing")
_ACTIONS = ("Jump", "OrbitLook", "OrbitCancel", "Missing")


def _drive(src, step):
    src.press(*step.get("press", []))
    src.release(*step.get("release", []))
    src.press_button(*step.get("buttons", []))
    src.release_button(*step.get("release_buttons", []))
    if "mouse" in step:
        src.set_mouse_delta(*step["mouse"])
    if "scroll" in step:
        src.set_scroll(*step["scroll"])


def _input_trace(mod, path):
    src = mod.ScriptedInputSource()
    inp = mod.InputSystem(src)
    assert inp.load_bindings(path)
    out = []
    for step in _SCRIPT:
        _drive(src, step)
        inp.update()
        out.append((
            [inp.get_axis(a) for a in _AXES],
            [dataclasses.astuple(inp.get_action(a)) for a in _ACTIONS],
            [inp.has_axis(a) for a in _AXES]))
    return out


def test_input_system_matches_jax(bindings_file):
    """Axis sums and clamps, action edges, mouse sensitivity and EMA
    smoothing, the scroll axis: the same values step by step."""
    port = _input_trace(tinput, bindings_file)
    assert port == _input_trace(jinput, bindings_file)
    assert port[1][0][0] == 1.0 and port[2][0][0] == 0.0   # W, W + S
    assert port[3][0][0] == -1.0
    assert port[4][1][0] == (True, True, False)            # Jump pressed


def test_input_hot_reload_matches_jax(bindings_file):
    systems = [m.InputSystem(m.ScriptedInputSource()) for m in (tinput,
                                                                jinput)]
    for s in systems:
        s.load_bindings(bindings_file)
        assert not s.reload_if_changed()
    with open(bindings_file, "w") as f:
        json.dump({"axes": {"NewAxis": [{"key": "X"}]}, "actions": {}}, f)
    os.utime(bindings_file, (time.time() + 5, time.time() + 5))
    for s in systems:
        assert s.reload_if_changed()
        assert s.has_axis("NewAxis") and not s.has_axis("MoveForward")
    assert not tinput.InputSystem().load_bindings(bindings_file + ".none")
    assert tinput.normalize_key(" f5 ") == "F5" == jinput.normalize_key("f5")
    assert tinput.normalize_key("nope") is None


# ---------------------------------------------------------------------------
# orbit controller
# ---------------------------------------------------------------------------

def _orbit_pair(path):
    """(port, jax) controllers over their own cameras and inputs."""
    out = []
    for mod, cam, orbit_cls in ((tinput, Camera(), CameraOrbitController),
                                (jinput, JaxCamera(), JaxOrbit)):
        src = mod.ScriptedInputSource()
        inp = mod.InputSystem(src)
        inp.load_bindings(path)
        orbit = orbit_cls(cam, inp)
        out.append((cam, src, inp, orbit))
    return out


_ORBIT_SCRIPT = [
    dict(),
    dict(mouse=(0.5, 0.0)),                        # no RMB: no look
    dict(buttons=["MOUSE_RIGHT"], mouse=(40.0, 0.0)),
    dict(mouse=(0.0, -300.0)),                     # crank the pitch up
    dict(mouse=(0.0, -300.0)),
    dict(mouse=(0.0, 900.0)),                      # and all the way down
    dict(mouse=(0.0, 900.0)),                      # (the axis clamps at 1)
    dict(mouse=(0.0, 900.0)),
    dict(scroll=(0.0, 1.0)),                       # zoom out
    dict(scroll=(0.0, -5.0)),
    dict(release_buttons=["MOUSE_RIGHT"], mouse=(0.0, 0.0),
         scroll=(0.0, 0.0), press=["R"]),          # reset
    dict(release=["R"], target=-1),                # the target is gone
    dict(press=["ESCAPE"]),
]


@pytest.mark.parametrize("smoothing", [False, True])
def test_orbit_controller_matches_jax(tmp_path, smoothing):
    path = tmp_path / "bindings.json"
    path.write_text(json.dumps({**BINDINGS, "mouse": {"sensitivity": 0.01}}))
    cfg = tmp_path / "camera.json"
    cfg.write_text(json.dumps({"targetId": "cj", "yawDeg": 75.0,
                               "pitchDeg": -25.0, "distance": 5.0,
                               "sensLook": 1.0, "sensZoom": 0.5,
                               "smoothing": smoothing, "smoothFactor": 6.0}))
    pair = _orbit_pair(str(path))
    worlds = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    worlds[1, :3, 3] = (1.0, 2.0, -3.0)
    for _, _, _, orbit in pair:
        assert orbit.load_config(str(cfg))
    got = {0: [], 1: []}
    for k, step in enumerate(_ORBIT_SCRIPT):
        for side, (cam, src, inp, orbit) in enumerate(pair):
            _drive(src, step)
            inp.update()
            target = step.get("target", 1)
            # the port reads the world matrix from a tensor, JAX from numpy
            w = torch.as_tensor(worlds) if side == 0 else worlds
            orbit.update(1 / 60, w, target)
            got[side].append((cam.position.tolist(), cam.yaw, cam.pitch,
                              orbit.target_yaw, orbit.target_pitch,
                              orbit.distance, orbit.looking,
                              orbit.hud_line()))
    assert got[0] == got[1]
    port = got[0]
    assert port[1][3] == port[0][3]            # no RMB, no look
    assert port[2][3] != port[1][3]            # RMB: the yaw moves
    assert port[4][4] == pytest.approx(np.deg2rad(-5.0))   # pitch clamps
    assert port[7][4] == pytest.approx(np.deg2rad(-85.0))
    assert port[10][3] == pytest.approx(np.deg2rad(75.0))  # reset
    assert port[11][0] == port[10][0] or smoothing   # the dead target stays


def test_orbit_config_reload_and_scene_reload(tmp_path):
    cfg = tmp_path / "camera.json"
    cfg.write_text(json.dumps({"targetId": "hero", "distance": 4.0}))
    orbit = CameraOrbitController(Camera(), tinput.InputSystem())
    assert orbit.load_config(str(cfg)) and orbit.target_id == "hero"
    assert not orbit.reload_config_if_needed()
    cfg.write_text(json.dumps({"targetId": "cj", "distance": 7.0}))
    os.utime(cfg, (time.time() + 5, time.time() + 5))
    assert orbit.reload_config_if_needed()
    assert orbit.target_id == "cj" and orbit.target_distance == 7.0
    orbit._last_target_pos[:] = 3.0
    orbit.on_scene_reloaded()
    assert not orbit._last_target_pos.any()
    assert not orbit.load_config(str(tmp_path / "missing.json"))


# ---------------------------------------------------------------------------
# timer, window
# ---------------------------------------------------------------------------

def test_time_tick_matches_jax():
    ticks = [0.0, 0.5, 0.5, 0.75, 2.0]
    out = []
    for cls in (Time, JaxTime):
        t = iter(ticks)
        tm = cls(lambda: next(t))
        out.append([(tm.tick(), tm.fps, tm.elapsed_time, tm.delta_time)
                    for _ in ticks[1:]])
    assert out[0] == out[1]
    assert out[0][0] == (0.5, 2.0, 0.5, 0.5) and out[0][1][1] == 0.0


def test_headless_window_writes_png_frames(tmp_path):
    frames = []
    win = HeadlessWindow(8, 4, frame_sink=frames.append,
                         record_dir=str(tmp_path / "rec"))
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (4, 8, 4), dtype=np.uint8) for _ in range(2)]
    for img in imgs:
        win.present(img)
    assert len(frames) == 2 and not win.should_close()
    for i, img in enumerate(imgs):
        with Image.open(tmp_path / "rec" / f"frame_{i:05d}.png") as im:
            np.testing.assert_array_equal(np.asarray(im), img)
    win.set_title("demo")
    assert win.title == "demo"
    assert win.keys_down() == set() and win.mouse_delta() == (0.0, 0.0)


# ---------------------------------------------------------------------------
# the Application's host controls
# ---------------------------------------------------------------------------

@pytest.fixture
def app_env(monkeypatch):
    monkeypatch.setenv("BANG_DISABLE_NATIVE", "1")
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)


def test_light_keys_and_hotkeys_match_jax(app_env):
    """Arrows, Z/X, C/V, B/N and R move the light as the JAX app's; F1,
    F3 and V toggle as its hotkeys do (the frame's input and key handling,
    without its steps)."""
    from banggameengine_tpu.app.application import Application as JaxApp

    apps = [Application(assets_root=ASSETS, width=64, height=32,
                        device="cpu"),
            JaxApp(assets_root=ASSETS, width=64, height=32)]
    script = [["LEFT", "Z"], ["LEFT", "UP", "C", "B"], ["RIGHT", "X", "V"],
              ["DOWN", "N", "F1"], ["F3", "F1"], [], ["R"], ["R"], ["X"],
              []]
    got = {0: [], 1: []}
    for keys in script:
        for side, app in enumerate(apps):
            src = app.input.source
            src.release(*list(src.keys_down()))
            src.press(*keys)
            app.input.update()
            app._handle_hotkeys()
            app._handle_light_keys(0.05)
            lp = app.light
            got[side].append((
                [np.asarray(getattr(lp, f)).tolist() for f in
                 ("yaw", "pitch", "color", "ambient", "shininess",
                  "spec_intensity")],
                app.wireframe, app.physics_overlay, app.vsync))
    assert got[0] == got[1]
    assert got[0][0][0][3] == pytest.approx(0.46)      # Z: ambient down
    assert got[0][-1][0] == got[0][-3][0][:3] + [pytest.approx(0.54)] + \
        got[0][-3][0][4:]                              # X after the reset


def test_unported_overlays_refuse(app_env):
    """The overlays that once refused (ROADMAP item 15) now render: the
    HUD, the physics overlay (F3) and the wireframe (F1) each give a frame
    of the app's size that differs from the plain one."""
    app = Application(assets_root=ASSETS, width=64, height=32, device="cpu")
    plain = app.render_current_frame()
    frames = [app.render_current_frame(hud=True)]
    app.physics_overlay = True
    frames.append(app.render_current_frame())
    app.physics_overlay = False
    app.wireframe = True
    frames.append(app.render_current_frame())
    for img in frames:
        assert img.shape == plain.shape == (32, 64, 4)
        assert img.dtype == np.uint8 and not np.array_equal(img, plain)


def test_scene_and_config_reloads(app_env, tmp_path):
    """F5 rebuilds the scene (the character back at its spawn); a broken
    scene file keeps the current scene; a newer physics.json writes the
    rebuilt static scene into the app's one scene, which the step and the
    fused ticks read."""
    root = tmp_path / "assets"
    shutil.copytree(ASSETS, root)
    app = Application(assets_root=str(root), width=64, height=32,
                      fused_tick=True, device="cpu")
    cj = app.built.find_entity("cj")
    for _ in range(3):
        app.frame(real_dt=1 / 30)
    assert float(app.state.pos[cj, 1]) < 7.0
    app.input.source.press("F5")
    app.frame(real_dt=0.001)
    app.input.source.release("F5")
    assert float(app.state.pos[cj, 1]) == 7.0
    assert app._frame_fns == {}

    app.frame(real_dt=1 / 30)
    old_static = app.built.static
    cfg = root / "config" / "physics.json"
    data = json.loads(cfg.read_text())
    data["gravity"] = -1.0
    cfg.write_text(json.dumps(data))
    os.utime(cfg, (time.time() + 5, time.time() + 5))
    app.frame(real_dt=1 / 30)
    assert app.built.static is old_static
    assert float(app.built.static.gravity) == -1.0
    assert app.config.gravity == -1.0

    (root / "scenes" / "demo.json").write_text("{ not json")
    built = app.built
    assert not app.reload_scene("broken")
    assert app.built is built
