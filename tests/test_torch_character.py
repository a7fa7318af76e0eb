"""The port's planar character step against the JAX package's, on the same
random planes (C = 7 characters, K = 5 candidates each).

The planes hold boxes and capsules at random poses around the capsules,
candidates that are not obstacles, a column whose two boxes penetrate the
capsule by exactly the same depth from opposite sides (the first row must
win, as ``jnp.argmax`` picks it), jumps from the ground and in the air,
sprints, and a fall faster than the cap.

A fault of the reference is pinned here too: an empty character slot
writes row 0 back over a character at entity 0 (ROADMAP §3).

Tolerances: positions and vertical speed atol=1e-5 (values up to ~10;
JAX's CPU compiler fuses multiply-adds and PyTorch does not, and 4
depenetration passes carry the difference: up to 5e-6, about 20 ulp, over
seeds 0-39); ``grounded`` is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.physics import character as jax_character
from banggameengine_tpu_torch.physics import character

C, K = 7, 5
ATOL = 1e-5
SCALARS = dict(gravity=-9.81, dt=1.0 / 120.0, step_height=0.35,
               max_slope_cos=float(np.cos(np.radians(45.0))))


def _planes(seed: int) -> dict:
    """Random character and candidate planes, as numpy, with the edge
    cases of the module docstring in fixed columns."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {
        "cx": rng.uniform(-3, 3, C), "cy": rng.uniform(0.6, 2.5, C),
        "cz": rng.uniform(-3, 3, C),
        "vel_y": rng.uniform(-4, 4, C), "on_ground": rng.random(C) < 0.5,
        "radius": rng.uniform(0.3, 0.5, C),
        "half_height": rng.uniform(0.4, 0.9, C),
        "walk_speed": np.full(C, 3.6), "jump_speed": np.full(C, 5.0),
        "inp_forward": rng.uniform(-1, 1, C),
        "inp_right": rng.uniform(-1, 1, C),
        "inp_jump": rng.random(C) < 0.5, "inp_sprint": rng.random(C) < 0.5,
        "cam_yaw": rng.uniform(-np.pi, np.pi, C),
    }
    q = rng.standard_normal((4, K, C))
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    p.update(bpx=p["cx"] + rng.uniform(-1.2, 1.2, (K, C)),
             bpy=p["cy"] + rng.uniform(-1.2, 1.2, (K, C)),
             bpz=p["cz"] + rng.uniform(-1.2, 1.2, (K, C)),
             bqx=q[0], bqy=q[1], bqz=q[2], bqw=q[3],
             hb0=rng.uniform(0.2, 0.9, (K, C)),
             hb1=rng.uniform(0.2, 0.9, (K, C)),
             hb2=rng.uniform(0.2, 0.9, (K, C)))
    ctype = rng.integers(0, 3, (K, C))          # 0 none, 1 box, 2 capsule
    obstacle = rng.random((K, C)) < 0.8
    p["b_is_box"] = (ctype == 1) & obstacle
    p["b_is_cap"] = (ctype == 2) & obstacle

    # columns 0 and 4: a tie, two equal boxes at +-x, high above the
    # ground; column 4 lists them in the other order
    for col, sign in ((0, 1.0), (4, -1.0)):
        p["cx"][col], p["cy"][col], p["cz"][col] = 0.0, 5.0, 0.0
        p["vel_y"][col] = p["inp_forward"][col] = p["inp_right"][col] = 0.0
        p["radius"][col] = 0.4
        p["b_is_box"][:, col] = p["b_is_cap"][:, col] = False
        for row, x in ((1, 0.6 * sign), (3, -0.6 * sign)):
            p["bpx"][row, col], p["bpy"][row, col] = x, 5.0
            p["bpz"][row, col] = 0.0
            p["bqx"][row, col] = p["bqy"][row, col] = 0.0
            p["bqz"][row, col] = 0.0
            p["bqw"][row, col] = 1.0
            p["hb0"][row, col] = p["hb1"][row, col] = 0.5
            p["hb2"][row, col] = 0.5
            p["b_is_box"][row, col] = True
    # column 1: on the ground, jumping and sprinting, no obstacle
    p["on_ground"][1] = p["inp_jump"][1] = p["inp_sprint"][1] = True
    p["cy"][1] = p["half_height"][1] + p["radius"][1]
    p["b_is_box"][:, 1] = p["b_is_cap"][:, 1] = False
    # column 2: jump pressed in the air (no effect)
    p["on_ground"][2], p["inp_jump"][2] = False, True
    # column 3: falling faster than the cap of 3|g|, far from everything
    p["vel_y"][3], p["cy"][3] = -100.0, 10.0
    p["on_ground"][3] = p["inp_jump"][3] = False
    p["b_is_box"][:, 3] = p["b_is_cap"][:, 3] = False
    out = {}
    for k, v in p.items():
        out[k] = v if v.dtype == bool else np.asarray(v, f32)
    return out


ARGS = ("cx", "cy", "cz", "vel_y", "on_ground", "radius", "half_height",
        "walk_speed", "jump_speed", "inp_forward", "inp_right", "inp_jump",
        "inp_sprint", "cam_yaw", "bpx", "bpy", "bpz", "bqx", "bqy", "bqz",
        "bqw", "b_is_box", "b_is_cap", "hb0", "hb1", "hb2")


def _run_jax(p):
    fn = jax.jit(jax_character.step_characters_t)
    args = [jnp.asarray(p[k]) for k in ARGS]
    scal = [jnp.float32(SCALARS[k]) for k in SCALARS]
    return [np.asarray(a) for a in fn(*args, *scal)]


def _run_torch(p):
    args = [torch.from_numpy(p[k]) for k in ARGS]
    scal = [torch.tensor(SCALARS[k], dtype=torch.float32) for k in SCALARS]
    return [a.numpy() for a in character.step_characters_t(*args, *scal)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_characters_t_matches_jax(seed):
    p = _planes(seed)
    jx, jy, jz, jvy, jg = _run_jax(p)
    tx, ty, tz, tvy, tg = _run_torch(p)
    for name, a, b in (("x", jx, tx), ("y", jy, ty), ("z", jz, tz),
                       ("vel_y", jvy, tvy)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(tg, jg)
    assert tg.dtype == np.bool_
    # the cases did what they are there for: the tie's outcome follows the
    # order of its rows (the first wins), the grounded jumper rose, the
    # fall was capped
    assert abs(tx[0]) > 0.1 and tx[4] == -tx[0] and tz[0] == tz[4] == 0.0
    assert tvy[1] > 4.0 and tvy[2] <= p["vel_y"][2]
    assert tvy[3] == np.float32(-3.0) * np.float32(9.81) and not tg[3]


def test_deepest_contact_picks_the_first_maximum_and_skips_empty_columns():
    # column 0: rows 1 and 2 tie at depth 0.3; column 1: no valid row;
    # column 2: only negative depths (separated)
    dd = torch.tensor([[0.1, 5.0, -0.2], [0.3, 5.0, -0.1], [0.3, 5.0, -0.3]])
    vv = torch.tensor([[True, False, True], [True, False, True],
                       [True, False, True]])
    nx = torch.tensor([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0], [3.0, 3.0, 3.0]])
    ny, nz = nx + 10.0, nx + 20.0
    wx, wy, wz, d = character.deepest_contact(nx, ny, nz, dd, vv)
    np.testing.assert_array_equal(d.numpy(), np.float32([0.3, 0.0, 0.0]))
    assert float(wx[0]) == 2.0 and float(wy[0]) == 12.0
    assert float(wx[2]) == 2.0        # the deepest of the negatives
    ref = np.argmax(np.where(vv.numpy(), dd.numpy(), -np.inf), axis=0)
    assert ref[0] == 1 and float(wx[0]) == float(nx[ref[0], 0])


def _entity0_character_world():
    """``build_falling_boxes(8, with_character=True)`` with the character
    moved to entity 0 (swapped with box 0) and a second, empty character
    slot: ``char_entity == [0, -1]``."""
    from banggameengine_tpu.parallel.manyworld import _flat_static
    from banggameengine_tpu.scene.synthetic import build_falling_boxes

    state, static = build_falling_boxes(8, with_character=True)
    n = state.pos.shape[0]
    perm = np.arange(n)
    perm[[0, 8]] = [8, 0]

    def swapped(obj, keep=()):
        out = {}
        for f in dataclasses.fields(obj):
            a = np.asarray(getattr(obj, f.name))
            per_entity = (a.ndim and a.shape[0] == n and f.name not in keep)
            out[f.name] = a[perm] if per_entity else a
        return out

    s = swapped(state, keep=("trigger_overlap",))
    st = swapped(static, keep=("parent", "level_nodes"))
    for name in ("char_radius", "char_half_height", "char_walk_speed",
                 "char_jump_impulse"):
        st[name] = np.concatenate([st[name], st[name]])
    st["char_entity"] = np.array([0, -1], np.int32)
    jstatic = type(static)(**{k: jnp.asarray(v) for k, v in st.items()})
    nb_idx, nb_val, _, cand, _ = _flat_static(jstatic, 1, s["comp_mask"])[1:]
    cand = np.concatenate([np.asarray(cand)] * 2)          # [2, n]
    return s, st, (np.array(nb_idx), np.array(nb_val)), cand


def test_an_empty_character_slot_drops_entity_0s_move_in_jax():
    """A fault of the reference (ROADMAP §3): the JAX step writes every
    character slot back with ``.at[safe_ce].set``, an empty slot (-1) to
    row 0 with row 0's old values, so when entity 0 is a character its
    own update is lost (XLA's CPU scatter applies the writes in order).
    The port writes only the slots in use, and the character walks."""
    from banggameengine_tpu.physics.step import physics_step as jax_step
    from banggameengine_tpu.state import InputFrame as JaxInputFrame
    from banggameengine_tpu.state import StaticScene as JaxStatic
    from banggameengine_tpu.state import WorldState as JaxState
    from banggameengine_tpu_torch import convert
    from banggameengine_tpu_torch.physics.step import physics_step

    s, st, (nb_idx, nb_val), cand = _entity0_character_world()
    inp = dict(move_forward=np.float32(1.0), move_right=np.float32(0.0),
               jump=np.bool_(False), sprint=np.bool_(False),
               cam_yaw=np.float32(0.0))
    kw = dict(broadphase="static", any_char=True, enable_capsule=False,
              any_trig=False)
    jout, _ = jax.jit(lambda a, b: jax_step(
        a, b, JaxStatic(**{k: jnp.asarray(v) for k, v in st.items()}),
        static_neighbors=(jnp.asarray(nb_idx), jnp.asarray(nb_val)),
        char_candidates=jnp.asarray(cand), **kw))(
        JaxState(**{k: jnp.asarray(v) for k, v in s.items()}),
        JaxInputFrame(**{k: jnp.asarray(v) for k, v in inp.items()}))
    tout, _ = physics_step(
        convert.world_state_from_numpy(s, "cpu"),
        convert.input_frame_from_numpy(inp, "cpu"),
        convert.static_scene_from_numpy(st, "cpu"),
        static_neighbors=(torch.from_numpy(nb_idx), torch.from_numpy(nb_val)),
        char_candidates=torch.from_numpy(cand), **kw)
    start = s["pos"][0]
    # JAX: the character stands still, its fall speed unchanged
    np.testing.assert_array_equal(np.asarray(jout.pos)[0], start)
    assert float(jout.char_vel_y[0]) == 0.0
    # the port: it walks 3.6 m/s along +x and starts to fall
    got = tout.pos[0].numpy()
    np.testing.assert_allclose(got[0] - start[0], 3.6 / 120.0, rtol=1e-5)
    assert got[1] < start[1] and float(tout.char_vel_y[0]) < 0.0
    # every other row agrees
    np.testing.assert_allclose(tout.pos[1:].numpy(),
                               np.asarray(jout.pos)[1:], atol=1e-5)
