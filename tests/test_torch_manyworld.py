"""The port's flat many-world step against the JAX package's.

W worlds of ``build_falling_boxes(8, with_character=True,
with_trigger=True)`` (8 boxes, a capsule character and a trigger in 16
entity slots) go through the JAX package's ``make_flat_many_world_step``
and the port's, one step per call, from the same numpy state and inputs.

Tolerances: float fields within 2e-4, the JAX package's own bar for the
flat layout against the vmapped one over 25 steps
(``tests/test_flat_manyworld.py``); the two differ by f32 rounding (JAX's
CPU compiler fuses multiply-adds, PyTorch does not), carried by 10
heavy-ball Jacobi iterations and the characters' depenetration (up to
1.6e-5 in 25 steps).  Later, once boxes land and tumble (steps 150 and
240), the pose fields keep the 2e-4 bar (up to 3.4e-5) and the
velocities and impulses get 1e-3 (up to 1.9e-4: ang_vel at step 150).
Integer and boolean fields are exact at every step: ``char_on_ground``,
``trigger_overlap``, ``trigger_active``, ``alive``, the contact features.
The flat scene is exact.  The port against itself is bit-equal: world
against world, one-step calls against one multi-step call.

``JAX_PLATFORMS=cpu python tests/test_torch_manyworld.py`` rewrites the
JAX golden that ``chip_smoke.py`` checks the port against on the GPU.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.parallel import manyworld as jax_manyworld
from banggameengine_tpu.physics import contact_t as jax_contact_t
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import engine_step
from banggameengine_tpu_torch.parallel import manyworld
from banggameengine_tpu_torch.physics import contact_t
from banggameengine_tpu_torch.physics.step import scene_census
from banggameengine_tpu_torch.state import FEAT_STRIDE, InputFrame

SCENE = dict(num_bodies=8, with_character=True, with_trigger=True)
WORLDS = 4
ATOL = 2e-4
LATE_ATOL = 1e-3        # velocities and impulses after step 25
LATE_FIELDS = ("lin_vel", "ang_vel", "contact_imp")
CHAR_ROW = 8          # slot order of build_falling_boxes: boxes, char, trigger
# per-world inputs: world 0 idle, the others walk; world 2 holds jump (it
# lands on a box at ~125 and is in the air again at 150), world 3 sprints
# onto a box (~110), then into the trigger (~170 to ~255)
INPUTS = {
    "zero": dict(move_forward=[0.0] * 4, move_right=[0.0] * 4,
                 jump=[False] * 4, sprint=[False] * 4, cam_yaw=[0.0] * 4),
    "per_world": dict(move_forward=[0.0, 1.0, 1.0, 1.0],
                      move_right=[0.0] * 4,
                      jump=[False, False, True, False],
                      sprint=[False, False, False, True],
                      cam_yaw=[0.0, 0.5, 1.0, 1.107]),
}
CHECKED_STEPS = {"zero": (1, 25), "per_world": (1, 25, 150, 240)}
# the port's run also keeps these, for the tests of itself: two boxes of
# every world touch at steps 109-112
PORT_EXTRA_STEPS = (100, 110)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flat4_jax_golden.json")
GOLDEN_INPUT = "per_world"
FLOAT_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y")
BOOL_FIELDS = ("char_on_ground", "trigger_overlap", "trigger_active",
               "alive")
# the solver on the same contacts, as tests/test_torch_step.py holds it
SOLVER_TOL = {"vel": (1e-5, 1e-5), "lambda": (5e-5, 1e-5)}


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _inputs_np(kind: str) -> dict:
    return {k: np.asarray(v, bool if k in ("jump", "sprint") else np.float32)
            for k, v in INPUTS[kind].items()}


def _jax_run(kinds=tuple(INPUTS)) -> dict:
    """JAX flat states (numpy dicts) at CHECKED_STEPS, per input kind: one
    jitted single-step function, called in a loop."""
    state, static = jax_build_falling_boxes(**SCENE)
    step = jax_manyworld.make_flat_many_world_step(
        static, WORLDS, state.comp_mask, num_steps=1)
    out = {}
    for kind in kinds:
        bs = jax.tree.map(jnp.array,
                          jax_manyworld.replicate_state(state, WORLDS))
        bi = JaxInputFrame(**{k: jnp.asarray(v)
                              for k, v in _inputs_np(kind).items()})
        out[kind] = {}
        for i in range(1, max(CHECKED_STEPS[kind]) + 1):
            bs = step(bs, bi)
            if i in CHECKED_STEPS[kind]:
                out[kind][i] = _np(bs)
    return out


def _port_world():
    state, static = jax_build_falling_boxes(**SCENE)
    return (convert.world_state_from_numpy(_np(state), "cpu"),
            convert.static_scene_from_numpy(_np(static), "cpu"))


def _port_input(kind: str) -> InputFrame:
    return convert.input_frame_from_numpy(_inputs_np(kind), "cpu")


@pytest.fixture(scope="module")
def jax_runs():
    return _jax_run()


@pytest.fixture(scope="module")
def port_runs():
    state, static = _port_world()
    step = manyworld.make_flat_many_world_step(static, WORLDS,
                                               state.comp_mask)
    out = {}
    for kind in INPUTS:
        bs, bi = manyworld.replicate_state(state, WORLDS), _port_input(kind)
        out[kind] = {}
        keep = set(CHECKED_STEPS[kind]) | set(PORT_EXTRA_STEPS)
        for i in range(1, max(CHECKED_STEPS[kind]) + 1):
            bs = step(bs, bi)
            if i in keep:
                out[kind][i] = convert.world_state_to_numpy(bs)
    return out


def _atol(step: int, name: str) -> float:
    return LATE_ATOL if step > 25 and name in LATE_FIELDS else ATOL


def _assert_states_equal(a: dict, b: dict):
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ---- the flat scene ---------------------------------------------------------

def _parented_world():
    """3 solid boxes and a bare child transform parented to falling box 0,
    the world of ``test_flat_manyworld._parented_world``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_physics import build_world

    from banggameengine_tpu.ecs.transform import compute_levels

    bodies = [
        {"pos": (0.0, 2.0, 0.0), "size": (0.5, 0.5, 0.5)},
        {"pos": (2.0, 0.5, 0.0), "size": (0.5, 0.5, 0.5), "type": "static"},
        {"pos": (2.0, 2.0, 0.1), "size": (0.4, 0.4, 0.4)},
        {"pos": (0.0, 1.5, 0.0), "type": "none"},  # child transform
    ]
    state, static = build_world(bodies, capacity=8)
    parent = np.asarray(static.parent).copy()
    parent[3] = 0
    static = dataclasses.replace(
        static, parent=jnp.asarray(parent),
        level_nodes=jnp.asarray(
            compute_levels(parent, np.asarray(state.alive))))
    return state, static


@pytest.mark.parametrize("world", ["headline", "parented"])
def test_flat_static_matches_jax(world):
    state, static = (jax_build_falling_boxes(**SCENE) if world == "headline"
                     else _parented_world())
    jflat, *jrest = jax_manyworld._flat_static(static, 3,
                                               np.asarray(state.comp_mask))
    tstatic = convert.static_scene_from_numpy(_np(static), "cpu")
    tcomp = convert.world_state_from_numpy(_np(state), "cpu").comp_mask
    tflat, *trest = manyworld._flat_static(tstatic, 3, tcomp)
    _assert_states_equal(_np(jflat), convert.static_scene_to_numpy(tflat))
    for name, a, b in zip(("nb_idx", "nb_val", "group", "char_cand"),
                          jrest[:4], trest[:4]):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert trest[4] == jrest[4]
    # the solid bodies: boxes 0-7 (headline); 0, 1 and 2 (parented)
    want = (tuple(d for d in range(-7, 8) if d) if world == "headline"
            else (-2, -1, 1, 2))
    assert trest[4] == want


def test_flatten_unflatten_round_trip():
    state, static = _port_world()
    w, b, t1 = 3, static.capacity, static.num_trigger_slots
    step = manyworld.make_flat_many_world_step(static, w, state.comp_mask)
    bs = manyworld.replicate_state(state, w)
    rng = np.random.default_rng(0)
    feats = rng.integers(-1, 4 * FEAT_STRIDE, bs.contact_feat.shape)
    bs.contact_feat = torch.from_numpy(feats.astype(np.int32))
    bs.trigger_overlap = torch.from_numpy(rng.random((w, t1, b)) < 0.5)
    bs.pos = torch.from_numpy(rng.standard_normal((w, b, 3), np.float32))
    fs = step.flatten(bs)
    # pair features move by the world's block offset, ground and empty
    # ones stay
    off = (np.arange(w) * b * FEAT_STRIDE)[:, None, None]
    want = np.where(feats >= FEAT_STRIDE, feats + off, feats)
    np.testing.assert_array_equal(fs.contact_feat.numpy(),
                                  want.reshape(w * b, -1))
    # the overlap plane is block-diagonal, as numpy's ov[di, :, di, :]
    # (the broadcast index dimension first) builds it
    ov = np.zeros((w, t1, w, b), bool)
    ov[np.arange(w), :, np.arange(w), :] = bs.trigger_overlap.numpy()
    np.testing.assert_array_equal(fs.trigger_overlap.numpy(),
                                  ov.reshape(w * t1, w * b))
    assert fs.pos.shape == (w * b, 3) and fs.time.shape == ()
    _assert_states_equal(convert.world_state_to_numpy(bs),
                         convert.world_state_to_numpy(step.unflatten(fs)))


# ---- the port against the JAX package ---------------------------------------

@pytest.mark.parametrize("kind", list(INPUTS))
def test_flat_matches_jax(kind, jax_runs, port_runs):
    for i in CHECKED_STEPS[kind]:
        js, ts = jax_runs[kind][i], port_runs[kind][i]
        assert js.keys() == ts.keys()
        for name, a in js.items():
            b = ts[name]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, atol=_atol(i, name),
                                           rtol=0,
                                           err_msg=f"{name} at step {i}")
            else:
                np.testing.assert_array_equal(b, a,
                                              err_msg=f"{name} at step {i}")
    if kind == "per_world":
        # the inputs moved the characters apart, world 2's jumped and world
        # 3's stands in the trigger
        s150, last = port_runs[kind][150], port_runs[kind][240]
        chars = last["pos"][:, CHAR_ROW]
        assert np.abs(chars[1:] - chars[0]).max(axis=1).min() > 0.5
        assert s150["char_vel_y"][2, CHAR_ROW] > 0.0
        assert last["char_on_ground"][:, CHAR_ROW].tolist() == [
            True, True, False, True]
        assert last["trigger_overlap"][:, 0].sum(axis=1).tolist() == [
            0, 0, 0, 1]


def test_worlds_are_isolated(port_runs):
    # the same input gives the same world, bit for bit, whatever the other
    # worlds do: world 0 is idle in both runs
    zero, driven = port_runs["zero"][25], port_runs["per_world"][25]
    for name, a in zero.items():
        if a.ndim:
            for w in range(1, WORLDS):
                np.testing.assert_array_equal(a[w], a[0], err_msg=name)
            np.testing.assert_array_equal(driven[name][0], a[0],
                                          err_msg=name)


def test_cache_survives_dispatch_boundaries(port_runs):
    """12 one-step calls equal one 12-step call bit for bit, over steps
    101-112, where boxes touch: the contact cache, pair features of every
    world among it, crosses every flatten/unflatten seam."""
    state, static = _port_world()
    start = convert.world_state_from_numpy(port_runs["per_world"][100],
                                           "cpu")
    inp = _port_input("per_world")
    one = manyworld.make_flat_many_world_step(static, WORLDS,
                                              state.comp_mask)
    multi = manyworld.make_flat_many_world_step(
        static, WORLDS, state.comp_mask, num_steps=12)
    s, pair_seams = start, 0
    for _ in range(12):
        s = one(s, inp)
        pair_seams += bool((s.contact_feat >= FEAT_STRIDE).any(
            dim=(1, 2)).all())
    _assert_states_equal(convert.world_state_to_numpy(s),
                         convert.world_state_to_numpy(multi(start, inp)))
    assert pair_seams >= 3
    assert (s.contact_feat >= 0).any(dim=(1, 2)).all()   # every world


def test_parented_child_follows_its_parent():
    jstate, jstatic = _parented_world()
    state = convert.world_state_from_numpy(_np(jstate), "cpu")
    static = convert.static_scene_from_numpy(_np(jstatic), "cpu")
    step = manyworld.make_flat_many_world_step(static, 3, state.comp_mask,
                                               num_steps=25)
    out = step(manyworld.replicate_state(state, 3),
               manyworld.replicate_input(InputFrame.zero("cpu"), 3))
    w = out.world.numpy()
    assert (w[:, 0, 1, 3] < 2.0).all()                  # the parent fell
    np.testing.assert_allclose(w[:, 3, 1, 3], w[:, 0, 1, 3] + 1.5,
                               atol=1e-6)
    np.testing.assert_array_equal(w[1:], np.broadcast_to(w[0], w[1:].shape))


def test_block_route_solver_matches_jax(port_runs):
    """``solve_contacts_t(block_size=...)``: the JAX route reads partners
    by lane rolls (ground slots read 0.0), the port by the gather (ground
    slots read body 0); on the flat world's contacts at step 110 the two
    agree."""
    state, static = _port_world()
    step = manyworld.make_flat_many_world_step(static, WORLDS,
                                               state.comp_mask)
    bs = convert.world_state_from_numpy(port_runs["per_world"][110], "cpu")
    fs, fst = step.flatten(bs), step.flat_static
    nb_idx, nb_val, _, _, shifts = manyworld._flat_static(
        static, WORLDS, state.comp_mask)[1:]
    n = fs.capacity
    *contacts, _, _ = contact_t.box_contacts_t(
        fs.pos, fs.quat, fst.shape_size, nb_idx, nb_val & fs.alive[:, None],
        fs.alive & (fst.body_type == 2), budget=12,
        orig_id=torch.arange(n, dtype=torch.int32))
    c_valid = contacts[8]
    assert (contacts[0][c_valid] >= 0).any() and (contacts[0][c_valid]
                                                  < 0).any()
    rng = np.random.default_rng(1)
    warm = tuple(torch.where(c_valid, torch.from_numpy(
        rng.uniform(0, 0.2, c_valid.shape).astype(np.float32)), 0.0)
        for _ in range(3))
    rng_v = rng.standard_normal((2, n, 3)).astype(np.float32)
    args = [torch.from_numpy(rng_v[0]), torch.from_numpy(rng_v[1]),
            fs.pos, fs.quat, fst.inv_mass, fst.inv_inertia_body, *contacts,
            fst.friction, fst.restitution]
    kw = dict(iterations=10, ground_friction=0.5, return_lambdas=True,
              momentum=0.5)
    dt = fst.fixed_dt
    t_block = contact_t.solve_contacts_t(*args, dt, warm=warm,
                                         block_size=static.capacity,
                                         block_shifts=shifts, **kw)
    t_gather = contact_t.solve_contacts_t(*args, dt, warm=warm, **kw)
    jx = [jnp.asarray(a.numpy()) for a in args]
    j_block = jax_contact_t.solve_contacts_t(
        *jx, jnp.asarray(dt.numpy()),
        warm=tuple(jnp.asarray(a.numpy()) for a in warm),
        block_size=static.capacity, block_shifts=shifts, **kw)
    flat_t = [t_block[0], t_block[1], *t_block[2]]
    for a, b in zip(flat_t, [t_gather[0], t_gather[1], *t_gather[2]]):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip([j_block[0], j_block[1], *j_block[2]],
                                   flat_t)):
        atol, rtol = SOLVER_TOL["vel" if i < 2 else "lambda"]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=rtol)


def test_unported_options_raise():
    state, static = _port_world()
    caps = static.shape_type.clone()
    caps[0] = 2
    capsule_static = dataclasses.replace(static, shape_type=caps)
    # solid capsules run on the flat step (item 5, ported: the capsule
    # slots, tests/test_torch_capsule_slots.py holds them against JAX); the
    # capsule changes the body's contacts, and only in its own world
    bs = manyworld.replicate_state(state, 2)
    binp = manyworld.replicate_input(InputFrame.zero("cpu"), 2)
    cap_out = manyworld.make_flat_many_world_step(
        capsule_static, 2, state.comp_mask, num_steps=30)(bs, binp)
    box_out = manyworld.make_flat_many_world_step(
        static, 2, state.comp_mask, num_steps=30)(bs, binp)
    assert bool(torch.isfinite(cap_out.pos).all())
    assert not torch.equal(cap_out.pos[:, 0], box_out.pos[:, 0])
    assert torch.equal(cap_out.pos[0], cap_out.pos[1])
    # the world mesh (item 20, ported: tests/test_torch_sharded_modes.py
    # holds it on gloo ranks): on one rank the same step bit for bit, and
    # worlds that do not divide over the ranks are refused as in JAX
    class Ranks:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    one_rank = manyworld.make_flat_many_world_step(
        static, 2, state.comp_mask, num_steps=30, mesh=Ranks(1))(bs, binp)
    assert torch.equal(one_rank.pos, box_out.pos)
    with pytest.raises(ValueError, match="divisible"):
        manyworld.make_flat_many_world_step(static, 2, state.comp_mask,
                                            mesh=Ranks(4))
    step = manyworld.make_flat_many_world_step(static, 2, state.comp_mask)
    fs = step.flatten(manyworld.replicate_state(state, 2))
    inp = manyworld.replicate_input(InputFrame.zero("cpu"), 2)
    nb = manyworld._flat_static(static, 2, state.comp_mask)[1:3]
    # without char_candidates the characters take every entity as their
    # candidates (item 6, ported): the same move as over the static
    # candidates, to f32 rounding
    _, _, _, group, cand, _ = manyworld._flat_static(static, 2,
                                                     state.comp_mask)
    per_slot, _ = engine_step(fs, inp, step.flat_static, broadphase="static",
                              static_neighbors=nb, group=group,
                              **scene_census(step.flat_static))
    planar, _ = engine_step(fs, inp, step.flat_static, broadphase="static",
                            static_neighbors=nb, group=group,
                            char_candidates=cand,
                            **scene_census(step.flat_static))
    torch.testing.assert_close(per_slot.pos, planar.pos, atol=1e-5, rtol=0)
    assert torch.equal(per_slot.char_on_ground, planar.char_on_ground)
    with pytest.raises(ValueError, match="static_neighbors"):
        engine_step(fs, inp, step.flat_static, broadphase="static",
                    any_char=False)


# ---- the golden that chip_smoke.py holds the card to ------------------------

def _golden(runs: dict) -> dict:
    at = {}
    for i, s in runs[GOLDEN_INPUT].items():
        at[str(i)] = {name: s[name].astype(float if name in FLOAT_FIELDS
                                           else bool).tolist()
                      for name in FLOAT_FIELDS + BOOL_FIELDS}
    return {"scene": SCENE, "worlds": WORLDS,
            "inputs": INPUTS[GOLDEN_INPUT],
            "steps": list(CHECKED_STEPS[GOLDEN_INPUT]), "at": at,
            "float_fields": list(FLOAT_FIELDS),
            "bool_fields": list(BOOL_FIELDS),
            "atol": {str(i): {name: _atol(i, name) for name in FLOAT_FIELDS}
                     for i in runs[GOLDEN_INPUT]},
            "source": "banggameengine_tpu make_flat_many_world_step("
                      "static, 4, comp_mask) on the CPU, one step a call"}


def test_chip_smoke_golden_is_current(jax_runs):
    with open(GOLDEN) as f:
        stored = json.load(f)
    assert stored == _golden(jax_runs), (
        "tests/data/flat4_jax_golden.json is stale: run "
        "JAX_PLATFORMS=cpu python tests/test_torch_manyworld.py")


if __name__ == "__main__":
    with open(GOLDEN, "w") as f:
        json.dump(_golden(_jax_run((GOLDEN_INPUT,))), f)
        f.write("\n")
    print(f"wrote {GOLDEN}")
