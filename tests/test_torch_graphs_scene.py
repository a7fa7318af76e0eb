"""Captured programs and the running scene, on the CPU through the graph
stand-in of ``test_torch_graphs.py``: run-time scene edits
(``ecs/lifecycle.py``) and the application shell.

- A step bound to the scene (``make_step_fn(built.static)``) captures the
  static tensors by reference: a spawn's in-place writes reach the graph
  with no new capture, and the level table's growth (a new tensor of a
  new shape) makes the next call capture anew, as JAX recompiles.  Held
  to the same script run eagerly (bit-equal), and its last step (the
  grown table, the crate) to JAX's traced-scene step on the JAX build
  after the same spawns, from the same state (``test_torch_lifecycle``'s
  bar, 1e-4).
- The app's default path keeps ``_prev_state`` for the interpolated
  frame: the hot step returns clones, so the state survives the next
  step's replay.  Held to the eager app (bit-equal, the interpolated
  frame too) and to the JAX app's golden
  (``tests/data/app_jax_golden.json``: the character within its bar).
- A physics-config hot reload of the fused app writes the rebuilt scene
  into the app's one scene, the captured one (no new capture), and
  changes the motion; a crate spawned after it falls.  Held to the eager
  app with the same reload and spawn, its fused ticks built from scratch
  after the reload.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import (
    make_hot_reloadable_step_fn as jax_hot_step_fn,
)
from banggameengine_tpu.state import InputFrame as JaxInput
from banggameengine_tpu.state import WorldState as JaxWorldState
from banggameengine_tpu_torch import convert, graphs
from banggameengine_tpu_torch.app import Application
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.scripts.play_demo import apply_track
from banggameengine_tpu_torch.state import InputFrame
from test_torch_app_golden import ASSETS, DATA
from test_torch_graphs import (  # noqa: F401
    assert_bit_equal,
    assert_close_to_jax,
    captured,
)
from test_torch_lifecycle import CRATE, _builds, _static_ids

FRAMES = 10


@pytest.fixture(autouse=True)
def no_assets_env(monkeypatch):
    monkeypatch.setenv("BANG_DISABLE_NATIVE", "1")
    monkeypatch.delenv("BANG_ASSETS_DIR", raising=False)


def _script(built, step, zero):
    """Spawn the crate, 3 steps, then a chain under the character's hat
    until the level table grows, a step after each link: the states
    after each step (copies: a bound step donates its state), the state
    before the last step, and the number of links that fitted."""
    rows = built.static.level_nodes.shape[0]
    state, _ = built.spawn(built.initial_state, **CRATE)
    out = []
    for _ in range(3):
        state, _ = step(state, zero, built.static)
        out.append(graphs.clone_tree(state))
    parent = "cj_hat"
    for k in range(rows - 1):
        state, _ = built.spawn(state, name=f"link{k}", parent=parent)
        parent = f"link{k}"
        before = graphs.clone_tree(state)
        state, _ = step(state, zero, built.static)
        out.append(graphs.clone_tree(state))
    return out, before, rows - 2


def test_spawn_writes_and_level_growth_reach_the_graph(captured):
    jb, tb = _builds()
    (te,) = _builds(jax=False)
    ids = _static_ids(tb.static)
    zero = InputFrame.zero("cpu")
    bound = make_step_fn(tb.static)
    seen = []

    def graph_step(state, inp, static):
        assert static is tb.static
        seen.append((bound.program.captures, _static_ids(static)))
        return bound(state, inp)

    got, before, fitted = _script(tb, graph_step, zero)
    # the crate and the links that fitted wrote in place: one capture;
    # the link that outgrew the table made a new level table and a capture
    assert [c for c, _ in seen] == [0] + [1] * (3 + fitted)
    assert all(i == ids for _, i in seen[:3 + fitted])
    grown = _static_ids(tb.static)["level_nodes"][1]
    assert grown[0] == ids["level_nodes"][1][0] + 1
    assert bound.program.captures == 2
    eager = make_step_fn(te.static)
    with graphs.eager():
        want, _, _ = _script(te, lambda s, i, st: eager(s, i), zero)
    assert_bit_equal(got, want, "spawn script")
    # the same spawns on the JAX build give its static scene; one JAX
    # step from the port's state before the last step
    js, _ = jb.spawn(jb.initial_state, **CRATE)
    parent = "cj_hat"
    for k in range(fitted + 1):
        js, _ = jb.spawn(js, name=f"link{k}", parent=parent)
        parent = f"link{k}"
    jstate = JaxWorldState(**{
        k: jnp.asarray(v)
        for k, v in convert.world_state_to_numpy(before).items()})
    jlast, _ = jax_hot_step_fn()(jstate, JaxInput.zero(), jb.static)
    assert_close_to_jax(got[-1], jlast)
    crate = tb.find_entity("crate")
    assert float(got[2].pos[crate, 1]) < CRATE["pos"][1]   # it falls


def _run_app(fused: bool, frames: int, root: str = ASSETS,
             between=None) -> list:
    app = Application(assets_root=root, width=128, height=32,
                      fused_tick=fused, device="cpu")
    cj = app.built.find_entity("cj")
    out = []
    for i in range(frames):
        if between is not None:
            between(app, i)
        apply_track(app, i, 30, cj)
        app.frame(real_dt=1 / 30)
        prev = getattr(app, "_prev_state", None)
        out.append(graphs.clone_tree((app.state, prev)))
    return app, out


def test_app_prev_state_survives_the_next_step(captured):
    app, got = _run_app(False, FRAMES)
    assert app._step.program.captures == 1
    # the interpolation's source is the state before the frame's last step
    for s, prev in got:
        assert int(prev.step_idx) == int(s.step_idx) - 1
        assert bool((prev.pos != s.pos).any())
    img = app.render_current_frame()
    with graphs.eager():
        eapp, want = _run_app(False, FRAMES)
        eimg = eapp.render_current_frame()
    assert_bit_equal(got, want, "default path")
    np.testing.assert_array_equal(img, eimg)
    with open(os.path.join(DATA, "app_jax_golden.json")) as f:
        g = json.load(f)
    cj = app.built.find_entity("cj")
    char = np.stack([s.pos[cj].numpy() for s, _ in got])
    np.testing.assert_allclose(
        char, np.asarray(g["default"]["char"][:FRAMES], np.float32),
        atol=g["atol"], rtol=0)


def test_app_physics_reload_reaches_the_captured_scene(captured, tmp_path):
    """A physics-config hot reload at frame 3, then a crate spawned at
    frame 4: the reload writes the rebuilt scene into the app's one scene
    (the one the fused ticks captured, with no new capture), so the spawn's
    writes to it reach the tick and the crate falls.  Held bit-equal to the
    eager app whose fused ticks are built from scratch after the reload,
    and to the app without a reload up to it (the motion changes after)."""
    root = str(tmp_path / "assets")
    shutil.copytree(ASSETS, root)
    config = os.path.join(root, "config", "physics.json")
    spawned = {}

    def reload_then_spawn(rebuild_ticks):
        def between(app, i):
            if i == 3:
                with open(config) as f:
                    cfg = json.load(f)
                cfg["gravity"] = -25.0
                with open(config, "w") as f:
                    json.dump(cfg, f)
                t = app.config.mtime + 10
                os.utime(config, (t, t))
            if i == 4:
                if rebuild_ticks:
                    app._frame_fns.clear()
                app.state, spawned["crate"] = app.built.spawn(app.state,
                                                              **CRATE)
        return between

    app, got = _run_app(True, 8, root, reload_then_spawn(False))
    captures = sum(p.captures for fn in app._frame_fns.values()
                   for p in fn.programs)
    assert float(app.built.static.gravity) == -25.0
    shutil.copytree(ASSETS, root, dirs_exist_ok=True)
    with graphs.eager():
        _, want = _run_app(True, 8, root, reload_then_spawn(True))
    shutil.copytree(ASSETS, root, dirs_exist_ok=True)
    _, plain = _run_app(True, 6, root)
    assert_bit_equal(got, want, "fused app with a reload and a spawn")
    cj = app.built.find_entity("cj")
    assert torch.equal(got[2][0].pos, plain[2][0].pos)
    assert not torch.equal(got[5][0].pos[cj], plain[5][0].pos[cj])
    crate = spawned["crate"]
    assert float(got[7][0].pos[crate, 1]) < CRATE["pos"][1]     # it falls
    # the reload copied into the captured scene: no frame graph recaptured
    assert captures == sum(len(fn.programs[0]._entries)
                           + len(fn.programs[1]._entries)
                           for fn in app._frame_fns.values())
