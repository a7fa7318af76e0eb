"""The port's Application against the JAX golden, on the CPU.

``Application(assets_root="tests/data/app_assets", device="cpu")`` runs
the port's ``play_demo`` track (:func:`apply_track`, the JAX package's
``examples/play_demo.py`` track) for 8 s at 30 display frames/s on each
path: the fused tick (``fused_tick=True``, 4 substeps and a 128x32 frame
a display frame) and the default path (one hot-reloadable step a fixed
step, each with its events, its orbit update and its downward raycast).
The golden (``tests/data/app_jax_golden.json``, written by
``tests/test_torch_app_golden.py``) is the JAX package's app on the same
tree and track.

Bars: the bus's Enter and Exit on the golden's display frames; the
character's position within the golden's bar (1e-4; 0.0 measured on the
CPU) and its on-ground flag and the step count equal after every display
frame; it lands at y = 2.94; every status line, the last one and the
stats line equal up to ``fps``; the last fused frame and the default
path's interpolated ``render_current_frame()`` within 1 level of JAX's on
>= 99.9 % of pixels with the sky mask equal elsewhere (the frame bars of
``tests/test_torch_render_frame.py``).
"""

import json
import re

import numpy as np
import pytest

from banggameengine_tpu_torch.app.application import Application
from banggameengine_tpu_torch.app.events import TriggerEvent, TriggerPhase
from banggameengine_tpu_torch.scripts.play_demo import apply_track
from test_torch_app_golden import (
    ASSETS,
    GOLDEN_JSON,
    GOLDEN_NPZ,
    one_torch_thread,  # noqa: F401 (the module's pytestmark uses it)
)
from test_torch_render_frame import SKY, frame_agreement

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _no_fps(line: str) -> str:
    return re.sub(r"fps=[0-9.]+", "fps=", line)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_JSON) as f:
        g = json.load(f)
    return g, np.load(GOLDEN_NPZ)


def _port_run(fused: bool, g: dict):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("BANG_ASSETS_DIR", raising=False)
        app = Application(assets_root=ASSETS, width=g["small"][0],
                          height=g["small"][1], fused_tick=fused,
                          device="cpu")
    cj = app.built.find_entity("cj")
    rec = dict(char=[], on_ground=[], steps=[], events=[], status=[])

    def on_event(e):
        if e.phase is not TriggerPhase.STAY:
            rec["events"].append([app.frame_count, e.phase.value,
                                  e.trigger_entity, e.other_entity])

    app.bus.subscribe(TriggerEvent, on_event)
    fps = g["fps"]
    for i in range(int(g["seconds"] * fps)):
        apply_track(app, i, fps, cj)
        app.frame(real_dt=1.0 / fps)
        rec["char"].append(app.state.pos[cj].tolist())
        rec["on_ground"].append(bool(app.state.char_on_ground[cj]))
        rec["steps"].append(int(app.state.step_idx))
        if app.last_status and (not rec["status"]
                                or rec["status"][-1] != app.last_status):
            rec["status"].append(app.last_status)
    rec["status_line"] = app.status_line()
    rec["physics_stats"] = app.physics_stats()
    return app, rec


@pytest.fixture(scope="module")
def fused_run(golden):
    app, rec = _port_run(True, golden[0])
    return app, rec, app.last_frame_image


@pytest.fixture(scope="module")
def default_run(golden):
    app, rec = _port_run(False, golden[0])
    app.frame(real_dt=0.5 * app.config.fixed_step)
    return app, rec, app.render_current_frame()


@pytest.fixture(params=["fused", "default"])
def run(request, golden):
    g, frames = golden
    app, rec, img = request.getfixturevalue(f"{request.param}_run")
    return request.param, g, frames, app, rec, img


def test_events_on_the_golden_frames(run):
    name, g, _, app, rec, _ = run
    assert rec["events"] == g[name]["events"]
    assert [(e.phase.value, e.trigger_entity, e.other_entity)
            for e in app._trigger_log] == [tuple(e[1:])
                                           for e in g[name]["events"]]


def test_character_track_matches_jax(run):
    name, g, _, _, rec, _ = run
    got = np.asarray(rec["char"], np.float32)
    ref = np.asarray(g[name]["char"], np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err < g["atol"], f"{name}: |char - JAX| = {err}"
    assert rec["on_ground"] == g[name]["on_ground"]
    assert rec["steps"] == g[name]["steps"]
    fps = g["fps"]
    assert abs(got[2 * fps - 1, 1] - g["rest_y"]) < 1e-5   # landed at 2 s


def test_status_and_stats_lines_match_jax(run):
    name, g, _, _, rec, _ = run
    assert [_no_fps(s) for s in rec["status"]] == [
        _no_fps(s) for s in g[name]["status"]]
    assert _no_fps(rec["status_line"]) == _no_fps(g[name]["status_line"])
    assert rec["physics_stats"] == g[name]["physics_stats"]


def test_frame_matches_jax(run):
    name, g, frames, _, _, img = run
    ref = frames[f"{name}_small"]
    assert img.dtype == np.uint8 and img.shape == ref.shape
    off, sky_off = frame_agreement(img, ref)
    assert off <= 0.001 * img.shape[0] * img.shape[1], (
        f"{name}: {off} pixels differ by more than 1 level")
    assert sky_off == 0, f"{name}: sky mask differs at {sky_off} pixels"
    sky = (img == SKY).all(-1)
    assert 0.05 < sky.mean() < 0.95                # sky and scene both there
