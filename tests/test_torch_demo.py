"""The port's demo world (``build_demo_like``) on its default route against
the JAX package's, and the two step factories the demo's loop uses.

The demo: the capsule character spawns at (0, 7, -5) above the static
ground box, falls and lands (480 zero-input steps, 4 s at 120 Hz, as the
verify drive does), then sprints 360 steps toward the checkpoint trigger
at (5, 1, 5), through it and out (at the sprint speed both the Enter and
the Exit fall inside the 360 steps).  Both packages start from the same
numpy state; the JAX package steps in scanned calls of 120 steps, the
port one step a call.

Tolerances: positions within 1e-4 of JAX at every step (the demo has no
dynamic body, so only the character's arithmetic can differ: measured
0.0 on the CPU); trigger events and ``char_on_ground`` exact at every
step.  The port against itself is bit-equal: the events factory against
single steps, the hot-reloadable step against a fresh factory.

The dense world: 200 boxes, a character and a trigger
(``build_falling_boxes(200, seed=1, with_character=True,
with_trigger=True)``) with exact shape triggers, the character sprinting
from its spawn toward the trigger for 300 steps: it lands at step ~130
among the landed boxes, enters the trigger at 163 and leaves it at 252,
and two boxes fall into it (245, 284).  JAX steps it in scanned calls of
50 steps, the port (built by its own builder) one step a call.  Bars:
trigger events exact at every step and ``char_on_ground`` exact every 50
steps; the character's position within 1e-4 every 50 steps (measured
4.1e-5 at most: it is a kinematic ghost, pushed only by the boxes it
meets); the boxes' within 5e-3 every 50 steps through step 250 (measured
9.4e-4 at step 250 on the CPU; the pile is chaotic: 1e-6 noise on the
start gives 7e-4 there, and a near-tie in a resting box's SAT between
steps 290 and 300 moves one box by 1.7e-2, so step 300 holds the
character and the events only).  The events hold under that noise too.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_demo.py``
rewrites the JAX golden (``tests/data/demo_jax_golden.json``) that
``chip_smoke.py`` phase 16 holds the card to: the demo's character and
trigger events, the 12-box world after 60 steps, and the dense world.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import engine_step as jax_engine_step
from banggameengine_tpu.engine import make_step_fn as jax_make_step_fn
from banggameengine_tpu.physics.config import PhysicsConfig
from banggameengine_tpu.physics.step import scene_census as jax_scene_census
from banggameengine_tpu.scene.synthetic import (
    build_demo_like as jax_build_demo_like,
)
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import (
    make_hot_reloadable_step_fn,
    make_step_fn,
    make_step_fn_with_events,
)
from banggameengine_tpu_torch.scene.synthetic import (
    build_demo_like,
    build_falling_boxes,
)
from banggameengine_tpu_torch.state import InputFrame

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "demo_jax_golden.json")
SETTLE, WALK = 480, 360
CHAR, TRIG = 0, 1          # build_demo_like's slots (the ground box is 2)
TARGET = (5.0, 5.0)        # the trigger's (x, z)
POS_ATOL = 1e-4
RECORD_EVERY = 60
BOXES = dict(num_bodies=12, seed=3, spread=4.0)
BOX_STEPS = 60
BOX_ATOL = 1e-4
DENSE = dict(num_bodies=200, seed=1, with_character=True, with_trigger=True)
DENSE_CHAR = 200           # the character's slot (after the boxes)
DENSE_STEPS, DENSE_EVERY = 300, 50
DENSE_BOX_LAST = 250       # the last step whose box positions are held
DENSE_BOX_ATOL = 5e-3
DENSE_CHAR_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file (small ops beside other test
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _walk_input(settled_pos) -> dict:
    """Sprint forward, the camera's yaw aimed from the landing point at
    the trigger."""
    yaw = np.arctan2(TARGET[1] - settled_pos[2], TARGET[0] - settled_pos[0])
    return dict(move_forward=np.float32(1.0), move_right=np.float32(0.0),
                jump=np.bool_(False), sprint=np.bool_(True),
                cam_yaw=np.float32(yaw))


def _zero() -> dict:
    return convert.input_frame_to_numpy(InputFrame.zero("cpu"))


def _jax_in(inp: dict):
    return JaxInputFrame(**{k: jax.numpy.asarray(v) for k, v in inp.items()})


CHUNK = 120       # JAX steps per scanned call (SETTLE and WALK divide by it)


@jax.jit
def _jax_chunk(state, inp, static):
    """CHUNK steps of the JAX package's default step (the census of the
    demo scene, as ``make_step_fn`` reads it), with the character's
    position and flags after each."""
    census = dict(any_char=True, enable_capsule=False, any_trig=True)

    def body(s, _):
        s, ev = jax_engine_step(s, inp, static, **census)
        return s, (s.pos[CHAR], s.char_on_ground[CHAR],
                   ev.trigger_enter[0, CHAR], ev.trigger_exit[0, CHAR])

    return jax.lax.scan(body, state, None, length=CHUNK)


def _jax_demo() -> dict:
    """The JAX demo run: the character's position and on-ground flag, and
    the trigger's Enter/Exit of the character, at every step; the walking
    input; the settled state (numpy)."""
    state, static = jax_build_demo_like()
    assert jax_scene_census(static) == dict(
        any_char=True, enable_capsule=False, any_trig=True)
    out = {"pos": [], "ground": [], "enter": [], "exit": []}
    inp = _zero()
    for i in range(0, SETTLE + WALK, CHUNK):
        if i == SETTLE:
            out["settled"] = _np(state)
            inp = _walk_input(out["settled"]["pos"][CHAR])
            out["walk_input"] = inp
        state, per_step = _jax_chunk(state, _jax_in(inp), static)
        for key, a in zip(("pos", "ground", "enter", "exit"), per_step):
            out[key].extend(np.asarray(a).tolist())
    out["pos"] = [np.asarray(p, np.float32) for p in out["pos"]]
    return out


def _dense_input() -> dict:
    """Sprint from the spawn (0, 7, -5) toward the trigger at (5, 1, 5)."""
    return dict(move_forward=np.float32(1.0), move_right=np.float32(0.0),
                jump=np.bool_(False), sprint=np.bool_(True),
                cam_yaw=np.float32(np.arctan2(10.0, 5.0)))


@jax.jit
def _jax_dense_chunk(state, inp, static):
    """DENSE_EVERY steps of the JAX package's default step with exact
    shape triggers, with every step's trigger events."""
    def body(s, _):
        s, ev = jax_engine_step(s, inp, static, trigger_mode="shape")
        return s, (ev.trigger_enter, ev.trigger_exit)

    return jax.lax.scan(body, state, None, length=DENSE_EVERY)


def _events(enter, exit_, first: int) -> dict:
    """Stacked [steps, T, N] event planes -> {"enter"/"exit": [[step,
    trigger slot, entity], ...]}, steps counted from ``first``."""
    return {name: [[int(i) + first, int(t), int(e)]
                   for i, t, e in zip(*np.nonzero(np.asarray(a)))]
            for name, a in (("enter", enter), ("exit", exit_))}


def _jax_dense() -> dict:
    """The JAX dense run as the golden's ``dense`` entry."""
    state, static = jax_build_falling_boxes(**DENSE)
    inp = _jax_in(_dense_input())
    out = {"char_pos": {}, "box_pos": {}, "char_on_ground": {},
           "enter": [], "exit": []}
    for first in range(1, DENSE_STEPS + 1, DENSE_EVERY):
        state, (enter, exit_) = _jax_dense_chunk(state, inp, static)
        at = first + DENSE_EVERY - 1
        pos = np.asarray(state.pos).astype(float)
        out["char_pos"][str(at)] = pos[DENSE_CHAR].tolist()
        if at <= DENSE_BOX_LAST:
            out["box_pos"][str(at)] = pos[:DENSE_CHAR].tolist()
        out["char_on_ground"][str(at)] = bool(
            np.asarray(state.char_on_ground)[DENSE_CHAR])
        for name, evs in _events(enter, exit_, first).items():
            out[name] += evs
    return {"scene": DENSE, "trigger_mode": "shape",
            "input": {k: np.asarray(v).item()
                      for k, v in _dense_input().items()},
            "steps": DENSE_STEPS, "every": DENSE_EVERY, "char": DENSE_CHAR,
            "box_last": DENSE_BOX_LAST, "box_atol": DENSE_BOX_ATOL,
            "char_atol": DENSE_CHAR_ATOL, **out}


def _jax_boxes() -> np.ndarray:
    state, static = jax_build_falling_boxes(**BOXES)
    step = jax_make_step_fn(static, donate=False)
    for _ in range(BOX_STEPS):
        state, _ = step(state, JaxInputFrame.zero())
    return np.asarray(state.pos)


@pytest.fixture(scope="module")
def runs():
    """The JAX run and the port's, step by step from the same state; the
    port's states at the start of the walk and 5 steps before the
    Enter are kept."""
    jax_run = _jax_demo()
    enter = jax_run["enter"].index(True)
    state, static = build_demo_like(device="cpu")
    step = make_step_fn(static)
    port = {"pos": [], "ground": [], "enter": [], "exit": []}
    inp = InputFrame.zero("cpu")
    with torch.inference_mode():
        for i in range(SETTLE + WALK):
            if i == SETTLE:
                port["settled"] = state
                inp = convert.input_frame_from_numpy(jax_run["walk_input"],
                                                     "cpu")
            if i == enter - 5:
                port["before_enter"] = state
            state, ev = step(state, inp)
            port["pos"].append(state.pos.numpy()[CHAR].copy())
            port["ground"].append(bool(state.char_on_ground.numpy()[CHAR]))
            port["enter"].append(bool(ev.trigger_enter.numpy()[0, CHAR]))
            port["exit"].append(bool(ev.trigger_exit.numpy()[0, CHAR]))
    port["static"], port["walk_input"] = static, inp
    return jax_run, port


def test_build_demo_like_equals_jax():
    js, jst = jax_build_demo_like()
    ts, tst = build_demo_like(device="cpu")
    for ours, theirs in ((convert.world_state_to_numpy(ts), _np(js)),
                         (convert.static_scene_to_numpy(tst), _np(jst))):
        assert ours.keys() == theirs.keys()
        for name, a in theirs.items():
            assert ours[name].dtype == a.dtype, name
            np.testing.assert_array_equal(ours[name], a, err_msg=name)


def test_demo_tracks_jax(runs):
    jax_run, port = runs
    jp, tp = np.stack(jax_run["pos"]), np.stack(port["pos"])
    np.testing.assert_allclose(tp, jp, atol=POS_ATOL, rtol=0)
    for name in ("ground", "enter", "exit"):
        assert port[name] == jax_run[name], name
    # what the demo shows: CJ lands on the ground box (top 0.99 + 1.95)
    # and stays; the sprint enters the trigger, then leaves it
    assert abs(jp[SETTLE - 1, 1] - 2.94) < 0.05 and all(
        jax_run["ground"][SETTLE // 2:])
    enter = [i for i, e in enumerate(jax_run["enter"]) if e]
    leave = [i for i, e in enumerate(jax_run["exit"]) if e]
    assert len(enter) == len(leave) == 1 and SETTLE < enter[0] < leave[0]
    settled = {k: v.numpy() for k, v in dataclasses.asdict(
        port["settled"]).items()}
    for name, a in jax_run["settled"].items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(settled[name], a, atol=POS_ATOL,
                                       err_msg=name)


def test_step_fn_with_events_equals_single_steps(runs):
    """Ten steps across the trigger's Enter: the stacked events of one
    call equal the single steps' events, and the states are bit-equal."""
    _, port = runs
    state, inp, static = port["before_enter"], port["walk_input"], \
        port["static"]
    step = make_step_fn(static)
    multi, events = make_step_fn_with_events(static, 10)(state, inp)
    singles = []
    for _ in range(10):
        state, ev = step(state, inp)
        singles.append(ev)
    assert events.trigger_enter.shape == (10,) + singles[0].trigger_enter.shape
    assert bool(events.trigger_enter[:, 0, CHAR].any())
    for f in dataclasses.fields(events):
        assert torch.equal(getattr(events, f.name), torch.stack(
            [getattr(e, f.name) for e in singles])), f.name
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(multi, f.name), getattr(state, f.name))


def test_hot_reloadable_step_equals_a_fresh_step_fn(runs):
    """The scene rebuilt with another config (a hot reload of
    physics.json) and passed per call steps like a step factory built on
    it: bit-equal over 10 walking steps; so does the original scene."""
    _, port = runs
    hot = make_hot_reloadable_step_fn()
    cfg = PhysicsConfig(walk_speed=5.0, gravity=-12.0, jump_impulse=6.0)
    _, rebuilt = build_demo_like(cfg, device="cpu")
    moved = []
    for static in (port["static"], rebuilt):
        a = b = port["settled"]
        fresh = make_step_fn(static)
        for _ in range(10):
            a, ea = hot(a, port["walk_input"], static)
            b, eb = fresh(b, port["walk_input"])
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                f.name
        assert torch.equal(ea.trigger_stay, eb.trigger_stay)
        moved.append(float(a.pos[CHAR, 2] - port["settled"].pos[CHAR, 2]))
    # the rebuilt scene's walk speed took effect
    assert moved[1] == pytest.approx(moved[0] * 5.0 / 3.6, rel=1e-3)


def test_dense_world_tracks_the_golden(golden):
    """The port's dense world on the CPU, one step a call, against the
    golden at its bars (what phase 16 checks on the card)."""
    gd = golden["dense"]
    state, static = build_falling_boxes(**gd["scene"], device="cpu")
    step = make_step_fn(static, trigger_mode=gd["trigger_mode"])
    inp = convert.input_frame_from_numpy(_dense_input(), "cpu")
    events = {"enter": [], "exit": []}
    c = gd["char"]
    with torch.inference_mode():
        for i in range(1, gd["steps"] + 1):
            state, ev = step(state, inp)
            for name, evs in _events(ev.trigger_enter[None],
                                     ev.trigger_exit[None], i).items():
                events[name] += evs
            if str(i) not in gd["char_pos"]:
                continue
            got = state.pos.numpy()
            np.testing.assert_allclose(got[c], gd["char_pos"][str(i)],
                                       atol=gd["char_atol"], rtol=0,
                                       err_msg=f"character, step {i}")
            if str(i) in gd["box_pos"]:
                np.testing.assert_allclose(got[:c], gd["box_pos"][str(i)],
                                           atol=gd["box_atol"], rtol=0,
                                           err_msg=f"boxes, step {i}")
            assert bool(state.char_on_ground[c]) == \
                gd["char_on_ground"][str(i)], i
    assert events == {"enter": gd["enter"], "exit": gd["exit"]}
    assert [e[2] for e in gd["enter"]] == [c, 137, 67]   # the walk's path
    assert [e[2] for e in gd["exit"]] == [c]


def _golden(jax_run: dict, boxes: np.ndarray, dense: dict) -> dict:
    """The JAX runs as the JSON that chip_smoke.py phase 16 reads."""
    pos = np.stack(jax_run["pos"])
    steps = sorted({SETTLE} | set(range(SETTLE + RECORD_EVERY,
                                        SETTLE + WALK + 1, RECORD_EVERY)))
    return {
        "demo": {
            "settle_steps": SETTLE, "walk_steps": WALK,
            "walk_input": {k: np.asarray(v).item()
                           for k, v in jax_run["walk_input"].items()},
            "char_pos": {str(i): pos[i - 1].astype(float).tolist()
                         for i in steps},
            "enter_steps": [i + 1 for i, e in enumerate(jax_run["enter"])
                            if e],
            "exit_steps": [i + 1 for i, e in enumerate(jax_run["exit"])
                           if e],
            "atol": POS_ATOL,
        },
        "boxes": {"scene": BOXES, "steps": BOX_STEPS,
                  "pos": boxes.astype(float).tolist(), "atol": BOX_ATOL},
        "dense": dense,
        "source": "banggameengine_tpu make_step_fn(static) (the dense "
                  "route) on the CPU, one step a call",
    }


@pytest.fixture(scope="module")
def golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_chip_smoke_golden_is_current(runs, golden):
    assert golden == _golden(runs[0], _jax_boxes(), _jax_dense()), (
        "tests/data/demo_jax_golden.json is stale: run "
        "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_demo.py")


if __name__ == "__main__":
    with open(GOLDEN, "w") as f:
        json.dump(_golden(_jax_demo(), _jax_boxes(), _jax_dense()), f)
        f.write("\n")
    print(f"wrote {GOLDEN}")
