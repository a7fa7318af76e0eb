"""The port's default step (the dense route) against the JAX package's, on
the ``tests/test_physics.py`` scenes, the kinematic platform of
``tests/test_kinematic.py`` and the 12-box world.

Each scene starts from the same numpy state and runs through the JAX
package's step (scanned 10 steps a call, jitted with the static scene as
an argument, so one compilation serves every scene of a capacity) and,
one step a call, the port's ``make_step_fn(static)`` (the census skips
the dead stages; on these scenes that gives the same result); every step
is compared.  The scenes are cut to 60-120 steps by
starting bodies near where the JAX tests' bodies land.

Tolerances: floats within 1e-4 of JAX at every step, velocities and
cached impulses within 1e-3 after step 25 (the manyworld bars,
``tests/test_torch_manyworld.py``: JAX's CPU compiler fuses multiply-adds
and PyTorch does not, and the 10 heavy-ball Jacobi iterations and the
character's depenetration carry the difference); trigger events,
``char_on_ground`` and the trigger state exact at every step.  The contact
cache's feature ids are exact too, but for one case: a box resting flat on
another ties the SAT between a face axis and the cross axes of two
horizontal edges (all vertical), and the last bit picks one or the other,
so the SAT-centre slot (16) may be in one manifold and not the other.  A
row may differ by that slot alone; the impulses (which the solve couples
across rows) are then compared again from the step after next on (the
warm start carries the other manifold's impulses one step).  On the
kinematic platform that happens at 4 of 70 steps, and positions stay
within 1.4e-5 of JAX through it (the other scenes: within 4.8e-7).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import engine_step as jax_engine_step
from banggameengine_tpu.physics import kinematic as jax_kinematic
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.physics import kinematic
from test_kinematic import _platform_world
from test_physics import build_world

ATOL = 1e-4
LATE_ATOL = 1e-3        # velocities after step 25
LATE_STEP = 25
VELOCITIES = ("lin_vel", "ang_vel", "char_vel_y", "contact_imp")
EXACT = ("char_on_ground", "trigger_overlap", "trigger_active", "step_idx",
         "alive")
SAT_CENTRE = 16           # narrowphase slot of the SAT-centre contact
FEAT_STRIDE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file (small ops beside other test
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHUNK = 10    # JAX steps per scanned call


@functools.partial(jax.jit, static_argnames="trigger_mode")
def _jax_chunk(state, inputs, static, trigger_mode="aabb"):
    """CHUNK steps of the JAX package's step over stacked per-step inputs;
    returns the last state and every step's (state, events)."""
    def body(s, inp):
        s, ev = jax_engine_step(s, inp, static, trigger_mode=trigger_mode)
        return s, (s, ev)

    return jax.lax.scan(body, state, inputs)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _inp(forward=0.0, yaw=0.0, jump=False, sprint=False) -> dict:
    return dict(move_forward=np.float32(forward), move_right=np.float32(0),
                jump=np.bool_(jump), sprint=np.bool_(sprint),
                cam_yaw=np.float32(yaw))


IDLE = _inp()
WALK_Z = _inp(1.0, np.pi / 2)           # walk along +z


def _char(pos=(0, 2.0, 0), obstacle=None):
    """Entity 0 a character (build_world's capsule 0.65 / 1.3), with an
    optional static obstacle as entity 1."""
    return ([{"pos": pos}] + ([obstacle] if obstacle else []),)


def _scenes() -> dict:
    """name -> (build_world args, kwargs, steps, inputs per step or one
    input, trigger_mode)."""
    b = lambda **kw: dict(size=(0.5, 0.5, 0.5), **kw)  # noqa: E731
    wall = {"pos": (0, 2.0, 3.0), "size": (3.0, 3.0, 0.5), "type": "static"}
    ledge = {"pos": (0, 0.15, 2.0), "size": (3.0, 0.15, 1.0),
             "type": "static"}
    drop = [{"pos": (0, 3.6, 0), "size": (0.4, 0.4, 0.4), "vel": (0, -5, 0)},
            {"pos": (0, 2, 0), "type": "none"}]
    trig = {"entity": 1, "size": (1.0, 1.0, 1.0)}
    tower = [b(pos=(0, 0.5 + 1.01 * i, 0), euler=(0, 0.35 * (i % 2), 0),
               friction=0.8) for i in range(10)]
    jump = [IDLE] * 4 + [_inp(jump=True)] + [IDLE] * 55   # lands, jumps
    chars = dict(characters=[{"entity": 0}])
    return {
        "free_fall": (([b(pos=(0, 100, 0))],), dict(ground=False), 60,
                      IDLE, "aabb"),
        "box_on_ground": (([b(pos=(0, 1.0, 0))],), {}, 60, IDLE, "aabb"),
        "box_on_static_box": (([b(pos=(0, 3.0, 0)),
                                {"pos": (0, 1.0, 0), "size": (2.0, 1.0, 2.0),
                                 "type": "static"}],), dict(ground=False),
                              60, IDLE, "aabb"),
        "stack": (([b(pos=(0, 0.5, 0)), b(pos=(0, 1.52, 0)),
                    b(pos=(0, 2.54, 0))],), {}, 60, IDLE, "aabb"),
        "rotated_tower": ((tower,), dict(capacity=16), 60, IDLE, "aabb"),
        "restitution": (([b(pos=(0, 1.0, 0), vel=(0, -3, 0),
                            restitution=0.8),
                          {"pos": (0, -0.5, 0), "size": (10, 0.5, 10),
                           "type": "static", "restitution": 1.0}],),
                        dict(ground=False), 60, IDLE, "aabb"),
        "friction": (([b(pos=(0, 0.5, 0), vel=(5, 0, 0), friction=0.8)],),
                     {}, 60, IDLE, "aabb"),
        "frictionless": (([b(pos=(0, 0.5, 0), vel=(5, 0, 0),
                             friction=0.0)],), {}, 60, IDLE, "aabb"),
        "dynamic_hit": (([b(pos=(-1.2, 0.5, 0), vel=(4, 0, 0), friction=0.0),
                          b(pos=(1.2, 0.5, 0), vel=(-4, 0, 0),
                            friction=0.0)],), {}, 60, IDLE, "aabb"),
        "layer_mask": (([b(pos=(0, 1.5, 0), mask=1),
                         {"pos": (0, 1.0, 0), "size": (2, 1, 2),
                          "type": "static", "layer": 2}],),
                       dict(ground=False), 60, IDLE, "aabb"),
        "capsule_on_ground": (([{"pos": (0, 1.8, 0), "shape": "capsule",
                                 "size": (0.5, 0.75, 0)}],), {}, 60, IDLE,
                              "aabb"),
        "trigger_aabb": ((drop,), dict(triggers=[trig], ground=False), 60,
                         IDLE, "aabb"),
        "trigger_shape": ((drop,), dict(triggers=[trig], ground=False), 60,
                          IDLE, "shape"),
        "trigger_one_shot": ((drop,), dict(triggers=[dict(trig,
                                                          one_shot=True)],
                                           ground=False), 60, IDLE, "aabb"),
        "char_falls": (_char((0, 2.6, 0)), chars, 60, IDLE, "aabb"),
        "char_walks": (_char(), chars, 60, WALK_Z, "aabb"),
        "char_sprints": (_char(), chars, 60,
                         _inp(1.0, np.pi / 2, sprint=True), "aabb"),
        "char_jumps": (_char((0, 1.96, 0)), chars, 60, jump, "aabb"),
        "char_blocked_by_wall": (_char((0, 2.0, 1.0), obstacle=wall), chars,
                                 60, WALK_Z, "aabb"),
        "char_steps_up_ledge": (_char(obstacle=ledge), chars, 60, WALK_Z,
                                "aabb"),
    }


SCENES = _scenes()


def _padded_levels(jst):
    """The scene with its level lists padded with -1 to the capacity, so
    scenes of one capacity share one compiled JAX step (every entity here
    is a root, so the padding writes nothing new)."""
    lv = np.asarray(jst.level_nodes)
    pad = np.full((lv.shape[0], jst.parent.shape[0]), -1, np.int32)
    pad[:, :lv.shape[1]] = lv
    return dataclasses.replace(jst, level_nodes=jnp.asarray(pad))


def _run(js, jst, steps, inputs, trigger_mode="aabb", between=None):
    """Step the JAX and the port's worlds side by side from the same numpy
    state; check every step; return both last states and the JAX events
    of every step (numpy).  ``between(i, js, ts)`` may change both states
    before step i, for i at the start of a chunk (i % CHUNK == 1)."""
    jst = _padded_levels(jst)
    ts = convert.world_state_from_numpy(_np(js), "cpu")
    tst = convert.static_scene_from_numpy(_np(jst), "cpu")
    step = make_step_fn(tst, trigger_mode=trigger_mode)
    if isinstance(inputs, dict):
        inputs = [inputs] * steps
    assert len(inputs) % CHUNK == 0
    events, agreed = [], True
    for c in range(0, len(inputs), CHUNK):
        if between is not None:
            js, ts = between(c + 1, js, ts)
        chunk = inputs[c:c + CHUNK]
        js, (jstates, jevs) = _jax_chunk(js, JaxInputFrame(**{
            k: jnp.asarray(np.stack([inp[k] for inp in chunk]))
            for k in chunk[0]}), jst, trigger_mode=trigger_mode)
        jstates, jevs = _np(jstates), _np(jevs)
        with torch.inference_mode():
            for k, inp in enumerate(chunk):
                ts, tev = step(ts, convert.input_frame_from_numpy(inp, "cpu"))
                jev = {n: a[k] for n, a in jevs.items()}
                agreed = _check(c + k + 1, {n: a[k] for n, a in
                                            jstates.items()},
                                convert.world_state_to_numpy(ts), jev, tev,
                                agreed)
                events.append(jev)
    return js, ts, events


def _cache_agrees(i, jf, tf) -> bool:
    """Whether the cached features are equal; where not, each row may
    differ by the SAT-centre slot alone (module docstring)."""
    same = (jf == tf).all(axis=1)
    for r in np.flatnonzero(~same):
        def others(f):
            return sorted(x for x in f if x >= 0 and not (
                x >= FEAT_STRIDE and x % FEAT_STRIDE == SAT_CENTRE))
        assert others(jf[r]) == others(tf[r]), (
            f"contact_feat row {r} at step {i}: {jf[r]} vs {tf[r]}")
    return bool(same.all())


def _check(i, ja, ta, jev=None, tev=None, agreed=True):
    """Hold the port's state (and events) to JAX's at step i; returns
    whether the cached features agree."""
    same = _cache_agrees(i, ja["contact_feat"], ta["contact_feat"])
    for name, a in ja.items():
        if a.dtype.kind != "f" or (name == "contact_imp"
                                   and not (same and agreed)):
            continue
        atol = (LATE_ATOL if name in VELOCITIES and i > LATE_STEP
                else ATOL)
        np.testing.assert_allclose(ta[name], a, atol=atol, rtol=0,
                                   err_msg=f"{name} at step {i}")
    for name in EXACT:
        np.testing.assert_array_equal(ta[name], ja[name],
                                      err_msg=f"{name} at step {i}")
    for name in (("trigger_enter", "trigger_stay", "trigger_exit",
                  "contact_overflow") if jev is not None else ()):
        np.testing.assert_array_equal(getattr(tev, name).numpy(), jev[name],
                                      err_msg=f"{name} at step {i}")
    return same


def _outcome(name: str, js, events) -> None:
    """What the JAX test of the scene checks, held on the JAX run (the
    port tracks it within the bars above)."""
    pos = np.asarray(js.pos)
    enter = sum(int(e["trigger_enter"][0, 0]) for e in events)
    if name.startswith("trigger"):
        exits = sum(int(e["trigger_exit"][0, 0]) for e in events)
        assert enter == 1 and exits == 1, (enter, exits)
        if name == "trigger_one_shot":
            assert not bool(js.trigger_active[0])
    elif name == "char_walks":
        assert 60 / 120 * 3.6 * 0.9 < pos[0, 2] < 60 / 120 * 3.6
    elif name == "char_jumps":
        assert pos[0, 1] > 1.95 + 2.0          # on its way up
    elif name == "char_blocked_by_wall":
        assert 1.2 < pos[0, 2] < 2.5 - 0.6
    elif name == "char_steps_up_ledge":
        assert pos[0, 2] > 1.2 and abs(pos[0, 1] - 2.25) < 0.08
    elif name == "layer_mask":
        assert pos[0, 1] < 1.0                  # fell through the box
    elif name == "capsule_on_ground":
        assert abs(pos[0, 1] - 1.25) < 0.02


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_tracks_jax(name):
    args, kw, steps, inputs, trigger_mode = SCENES[name]
    js, jst = build_world(*args, **kw)
    js, ts, events = _run(js, jst, steps, inputs, trigger_mode)
    _outcome(name, js, events)


def test_kinematic_platform_tracks_jax():
    """The platform world of tests/test_kinematic.py: the box settles on
    the kinematic platform, which then moves sideways (the box rides
    along), is driven toward a target transform one tick away (1.2 m/s
    and 2.4 rad/s, a 0.02 rad turn; the velocity persists), and is
    warped."""
    js, jst = _platform_world()
    dt = float(jst.fixed_dt)
    turn = [0.0, np.sin(0.01), 0.0, np.cos(0.01)]

    def drive(i, js, ts):
        target = (np.asarray(js.pos[1]) + [0.0, 0.005, -0.008], turn)
        if i == 31:
            js = jax_kinematic.set_kinematic_velocity(js, 1, [1.0, 0, 0])
            ts = kinematic.set_kinematic_velocity(ts, 1, [1.0, 0, 0])
        elif i == 51:
            js = jax_kinematic.set_kinematic_target(js, 1, *target, dt=dt)
            ts = kinematic.set_kinematic_target(ts, 1, *target, dt=dt)
        elif i == 61:
            js = jax_kinematic.warp_kinematic(js, 1, [0.5, 1.0, 0.0],
                                              [0, 0, 0, 1.0])
            ts = kinematic.warp_kinematic(ts, 1, [0.5, 1.0, 0.0],
                                          [0, 0, 0, 1.0])
        if i in (31, 51, 61):
            _check(i, _np(js), convert.world_state_to_numpy(ts))
        return js, ts

    js, ts, _ = _run(js, jst, 70, IDLE, between=drive)
    assert float(js.pos[0, 0]) > 0.1           # the box rode along


def test_kinematic_velocity_to_target():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 6, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    p = rng.uniform(-2, 2, (2, 6, 3)).astype(np.float32)
    j = jax_kinematic.velocity_to_target(p[0], q[0], p[1], q[1], 1 / 120)
    t = kinematic.velocity_to_target(*map(torch.from_numpy, (p[0], q[0],
                                                             p[1], q[1])),
                                     1 / 120)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_twelve_box_world_tracks_jax():
    js, jst = jax_build_falling_boxes(12, seed=3, spread=4.0)
    js, ts, _ = _run(js, jst, 60, IDLE)
    assert np.asarray(js.pos)[:12, 1].min() < 1.5      # falling
