"""The port's per-slot character step (``character.step_character`` with
a leading slot axis) against the JAX package's, vmapped over the slots,
on the same numpy inputs; and the per-slot route of the physics step
against the planar step where both apply.

The worlds: C = 5 character capsules among N = 12 entities (boxes and
capsules at random poses around them, some of them not obstacles, one
slot's own entity among them), grounded and airborne, jumping, sprinting
and falling faster than the cap; the capsules start near enough to push
out of boxes and capsules.  Each seed steps JAX 8 times and holds the
port to every step, one step from the JAX state each (``step`` below).

Tolerances: one step within 1e-6 (positions up to ~4, so a few ulp;
JAX's CPU compiler fuses multiply-adds and PyTorch does not); the vertical
speed within 1e-5 (it is (p' - p) / dt's order: the landing zeroes it, a
push does not change it); ``grounded`` exact.  The per-slot route against
the planar one within 1e-5: the same formulas in two layouts, 4
depenetration passes.  The demo golden (``tests/data/demo_jax_golden.json``,
written on the JAX per-slot route) holds the landing at its 1e-4 bar.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.physics import character as jax_character
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.physics import character
from banggameengine_tpu_torch.physics.step import physics_step, scene_census
from banggameengine_tpu_torch.scene.synthetic import build_demo_like
from banggameengine_tpu_torch.state import InputFrame

from test_torch_app_golden import one_torch_thread  # noqa: F401

C, N = 5, 12
STEPS = 8
POS_ATOL = 1e-6
VEL_ATOL = 1e-5
ROUTE_ATOL = 1e-5
SCALARS = dict(gravity=-9.81, dt=1.0 / 120.0, step_height=0.35,
               max_slope_cos=float(np.cos(np.radians(45.0))))
DEMO_CHAR = 0       # build_demo_like's slots: character, trigger, ground
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "demo_jax_golden.json")


def _world(seed: int) -> dict:
    """Characters, inputs and entities as numpy; slot 0's own entity is
    entity 0 (a capsule that must not push it)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    centre = rng.uniform(-1.5, 1.5, (C, 3)).astype(f32)
    centre[:, 1] = rng.uniform(0.3, 2.0, C)
    q = rng.standard_normal((N, 4)).astype(f32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    shape_type = rng.choice(np.array([1, 2], np.int8), N)   # box, capsule
    size = rng.uniform(0.2, 0.8, (N, 3)).astype(f32)
    size[shape_type == 2, 2] = 0.0
    pos = (centre[rng.integers(0, C, N)]
           + rng.uniform(-1.0, 1.0, (N, 3))).astype(f32)
    pos[0], q[0], shape_type[0] = centre[0], (0, 0, 0, 1), 2
    obstacle = rng.random((C, N)) < 0.8
    obstacle[0, 0] = False
    obstacle[:, 1] = False                # an entity no slot collides with
    w = dict(
        c_pos=centre, vel_y=rng.uniform(-40.0, 4.0, C).astype(f32),
        on_ground=rng.random(C) < 0.5,
        radius=rng.uniform(0.3, 0.5, C).astype(f32),
        half_height=rng.uniform(0.4, 0.9, C).astype(f32),
        walk_speed=np.full(C, 3.6, f32), jump_speed=np.full(C, 5.0, f32),
        inp_forward=rng.uniform(-1, 1, C).astype(f32),
        inp_right=rng.uniform(-1, 1, C).astype(f32),
        inp_jump=rng.random(C) < 0.5, inp_sprint=rng.random(C) < 0.5,
        cam_yaw=rng.uniform(-np.pi, np.pi, C).astype(f32),
        pos=pos, quat=q, shape_type=shape_type, size=size,
        obstacle_mask=obstacle)
    w["inp_forward"][1] = w["inp_right"][1] = 0.0    # standing still
    w["on_ground"][2] = w["inp_jump"][2] = True      # a jump
    return w


ORDER = ("c_pos", "vel_y", "on_ground", "radius", "half_height",
         "walk_speed", "jump_speed", "inp_forward", "inp_right", "inp_jump",
         "inp_sprint", "cam_yaw", "pos", "quat", "shape_type", "size",
         "obstacle_mask")
_SHARED = ("pos", "quat", "shape_type", "size")


@pytest.fixture(scope="module")
def jax_step():
    in_axes = tuple(None if k in _SHARED else 0 for k in ORDER) + (None,) * 4
    return jax.jit(jax.vmap(jax_character.step_character, in_axes=in_axes))


def _port_step(w: dict):
    t = {k: torch.from_numpy(np.array(v)) for k, v in w.items()}
    s = {k: torch.tensor(v, dtype=torch.float32) for k, v in SCALARS.items()}
    return character.step_character(*(t[k] for k in ORDER), **s)


@pytest.mark.parametrize("seed", range(6))
def test_step_character_matches_jax(seed, jax_step, one_torch_thread):
    w = _world(seed)
    pushed = grounded_seen = 0
    for i in range(STEPS):
        j_pos, j_vy, j_g = (np.asarray(a) for a in jax_step(
            *(jnp.asarray(w[k]) for k in ORDER),
            *(jnp.float32(v) for v in SCALARS.values())))
        t_pos, t_vy, t_g = _port_step(w)
        np.testing.assert_allclose(t_pos.numpy(), j_pos, atol=POS_ATOL,
                                   rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(t_vy.numpy(), j_vy, atol=VEL_ATOL,
                                   rtol=0, err_msg=f"step {i}")
        np.testing.assert_array_equal(t_g.numpy(), j_g, err_msg=f"step {i}")
        free = w["c_pos"] + np.float32(SCALARS["dt"]) * np.stack(
            [np.zeros(C), j_vy, np.zeros(C)], 1)
        pushed += int((np.abs(j_pos - free)[:, 1] > 1e-3).sum())
        grounded_seen += int(j_g.sum())
        w.update(c_pos=j_pos, vel_y=j_vy, on_ground=j_g)
    # the worlds exercise the depenetration and the ground probe
    assert pushed > 0 and grounded_seen > 0


def _flat_world(seed: int):
    """A flat many-world where each character's candidates are its whole
    world block, so the planar step over them computes what the per-slot
    step over every entity does."""
    from banggameengine_tpu_torch.parallel import manyworld
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes

    state, static = build_falling_boxes(8, seed=seed, with_character=True,
                                        with_trigger=True, device="cpu")
    step = manyworld.make_flat_many_world_step(static, 3, state.comp_mask)
    fs = step.flatten(manyworld.replicate_state(state, 3))
    # start the characters just above the ground, so they land in the run
    st = step.flat_static
    ce = st.char_entity.long()
    fs.pos[ce, 1] = st.char_half_height + st.char_radius + 0.05
    _, nb_idx, nb_val, group, cand, _ = manyworld._flat_static(
        static, 3, state.comp_mask)
    return step.flat_static, fs, (nb_idx, nb_val), group, cand


@pytest.mark.parametrize("seed", [0, 5])
def test_per_slot_route_matches_the_planar_step(seed, one_torch_thread):
    static, state, nb, group, cand = _flat_world(seed)
    inp = convert.input_frame_from_numpy(dict(
        move_forward=np.float32([1, 0, 1]), move_right=np.float32([0, 1, 1]),
        jump=np.array([1, 0, 1], bool), sprint=np.array([0, 1, 1], bool),
        cam_yaw=np.float32([0.3, 2.0, -1.0])), "cpu")
    kw = dict(broadphase="static", static_neighbors=nb, group=group,
              **scene_census(static))
    a = b = state
    for i in range(40):
        a, _ = physics_step(a, inp, static, **kw)
        b, _ = physics_step(b, inp, static, char_candidates=cand, **kw)
        torch.testing.assert_close(a.pos, b.pos, atol=ROUTE_ATOL, rtol=0,
                                   msg=lambda m: f"step {i}: {m}")
        torch.testing.assert_close(a.char_vel_y, b.char_vel_y,
                                   atol=ROUTE_ATOL, rtol=0)
        assert torch.equal(a.char_on_ground, b.char_on_ground), i
        # keep the two routes on one trajectory: the bar is per step
        b = a
    assert bool(a.char_on_ground.any())


def test_demo_landing_holds_the_golden(one_torch_thread):
    """The demo's character on the per-slot route, 480 zero-input steps in
    dispatches of 120, against the JAX golden's landing."""
    with open(GOLDEN) as f:
        demo = json.load(f)["demo"]
    settle = int(demo["settle_steps"])
    state, static = build_demo_like(device="cpu")
    run = make_multi_step_fn(static, settle // 4)
    inp = InputFrame.zero("cpu")
    for _ in range(4):
        state = run(state, inp)
    want = np.asarray(demo["char_pos"][str(settle)], np.float32)
    got = state.pos[DEMO_CHAR].numpy()
    np.testing.assert_allclose(got, want, atol=demo["atol"], rtol=0)
    assert bool(state.char_on_ground[DEMO_CHAR])
