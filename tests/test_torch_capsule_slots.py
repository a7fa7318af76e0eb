"""The capsule slots of the port's transposed contacts
(``contact_t.box_contacts_t(shape_type=...)``) against the JAX package's,
and solid capsules on the flat many-world step against a JAX golden.

The mixed scenes: boxes and capsules at random poses in a small cluster,
every other body listed as a partner (plus padded and invalid slots), so
every slot kind meets: box-box, capsule-box both ways, capsule-capsule,
and the capsules' end spheres on the ground.  Bars: integers and masks
(partners, validity, feature ids, overflow) exact; floats within 1e-6
(f32 rounding; JAX's CPU compiler fuses multiply-adds and PyTorch does
not).

The flat step: the capsule scene of ``tests/test_flat_manyworld.py:226``
(an upright capsule dropping onto the ground, a capsule onto a box, two
crossing capsules, two boxes) in 2 worlds, 50 steps one step a call,
against ``tests/data/capsule_flat_jax_golden.npz`` (JAX's flat step on the
CPU; its bar, 2e-4, the JAX test's flat-against-vmapped bar), every
step.  The golden also holds the scene's arrays, which ``chip_smoke.py``
phase 19 builds the scene from.  ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_capsule_slots.py`` rewrites it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.parallel import manyworld as jax_mw
from banggameengine_tpu.physics import contact_t as jax_contact_t
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.parallel import manyworld
from banggameengine_tpu_torch.physics import contact_t
from banggameengine_tpu_torch.state import InputFrame

from test_torch_app_golden import one_torch_thread  # noqa: F401

NAMES = ("c_prt", "c_ptx", "c_pty", "c_ptz", "c_nx", "c_ny", "c_nz", "c_dep",
         "c_valid", "overflow", "c_feat")
FLOAT_ATOL = 1e-6
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "capsule_flat_jax_golden.npz")
WORLDS, STEPS = 2, 50
FLAT_ATOL = 2e-4
TRACKED = ("pos", "quat", "lin_vel", "ang_vel")
CAPSULE_BODIES = [
    # capsule dropping onto the ground
    {"pos": (0.0, 1.2, 0.0), "shape": "capsule", "size": (0.3, 0.4, 0),
     "friction": 0.6},
    # box under a falling capsule
    {"pos": (2.0, 0.5, 0.0), "size": (0.5, 0.5, 0.5), "friction": 0.6},
    {"pos": (2.0, 2.2, 0.0), "shape": "capsule", "size": (0.3, 0.4, 0),
     "friction": 0.6},
    # two crossing capsules falling onto each other
    {"pos": (-2.0, 0.8, 0.0), "shape": "capsule", "size": (0.3, 0.5, 0),
     "euler": (0, 0, 1.5707), "friction": 0.6},
    {"pos": (-2.0, 2.0, 0.1), "shape": "capsule", "size": (0.3, 0.5, 0),
     "euler": (1.5707, 0, 0), "friction": 0.6},
    # box falling on a box
    {"pos": (4.0, 0.5, 0.0), "size": (0.5, 0.5, 0.5)},
    {"pos": (4.1, 1.8, 0.0), "size": (0.4, 0.4, 0.4)},
]


def _mixed_scene(seed: int, n: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    shape = rng.choice(np.array([1, 2], np.int8), n)        # box, capsule
    half = rng.uniform(0.25, 0.7, (n, 3)).astype(np.float32)
    half[shape == 2, 2] = 0.0
    pos = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(0.0, 1.5, n)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:2] = (0, 0, 0, 1)                 # upright: end spheres on the ground
    # two capsules crossing, and a capsule through a box
    shape[2:6] = (2, 2, 1, 2)
    half[[2, 3, 5], 2] = 0.0
    pos[3] = pos[2] + (0.2, 0.1, 0.0)
    pos[5] = pos[4] + (0.1, 0.3, 0.1)
    k = n + 1
    idx = np.full((n, k), -1, np.int32)
    for i in range(n):
        others = [j for j in range(n) if j != i]
        idx[i, :n - 1] = others
    valid = idx >= 0
    valid[::3, 0] = False                # a listed partner that is not valid
    return dict(pos=pos, quat=q, half=half, nb_idx=idx, nb_valid=valid,
                ground_valid=rng.random(n) < 0.85,
                orig_id=rng.permutation(n).astype(np.int32),
                shape_type=shape)


def _contacts(s, lib, conv, with_feat):
    args = [conv(s[k]) for k in ("pos", "quat", "half", "nb_idx", "nb_valid",
                                 "ground_valid")]
    return lib.box_contacts_t(
        *args, budget=12, shape_type=conv(s["shape_type"]),
        orig_id=conv(s["orig_id"]) if with_feat else None)


@pytest.mark.parametrize("seed,with_feat", [(0, True), (1, True), (2, True),
                                            (3, False)])
def test_box_contacts_capsule_slots_match_jax(seed, with_feat):
    s = _mixed_scene(seed)
    want = _contacts(s, jax_contact_t, jnp.asarray, with_feat)
    got = _contacts(s, contact_t, lambda a: torch.from_numpy(np.array(a)),
                    with_feat)
    assert len(want) == len(got) == (11 if with_feat else 10)
    for name, w, g in zip(NAMES, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=FLOAT_ATOL, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # every slot kind holds a contact somewhere
    if with_feat:
        feat, val = np.asarray(want[10]), np.asarray(want[8])
        slot = np.where(val & (np.asarray(want[0]) >= 0), feat % 64, -1)
        for lo, hi in ((0, 17), (17, 20), (20, 23), (23, 24)):
            assert ((slot >= lo) & (slot < hi)).any(), (seed, lo)


def _capsule_scene():
    """The capsule scene, made by ``tests/test_physics.build_world``:
    (state, static, their numpy dicts)."""
    from test_physics import build_world

    state, static = build_world(CAPSULE_BODIES, capacity=8)
    to_np = lambda o: {f.name: np.asarray(getattr(o, f.name))  # noqa: E731
                       for f in dataclasses.fields(o)}
    return state, static, to_np(state), to_np(static)


def _jax_run() -> dict:
    """JAX's flat step of the capsule scene, one step a call: the tracked
    fields of every step, and the scene."""
    state, static, st_np, sc_np = _capsule_scene()
    step = jax_mw.make_flat_many_world_step(static, WORLDS, state.comp_mask)
    bs = jax.tree.map(jnp.array, jax_mw.replicate_state(state, WORLDS))
    bi = jax_mw.replicate_input(JaxInputFrame.zero(), WORLDS)
    out = {f"state/{k}": v for k, v in st_np.items()}
    out.update({f"static/{k}": v for k, v in sc_np.items()})
    traj = {k: [] for k in TRACKED}
    for _ in range(STEPS):
        bs = step(bs, bi)
        for k in TRACKED:
            traj[k].append(np.asarray(getattr(bs, k)))
    out.update({f"traj/{k}": np.stack(v) for k, v in traj.items()})
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


def test_flat_capsule_step_tracks_the_golden(golden, one_torch_thread):
    state = convert.world_state_from_numpy(
        {k[6:]: v for k, v in golden.items() if k.startswith("state/")},
        "cpu")
    static = convert.static_scene_from_numpy(
        {k[7:]: v for k, v in golden.items() if k.startswith("static/")},
        "cpu")
    step = manyworld.make_flat_many_world_step(static, WORLDS,
                                               state.comp_mask)
    bs = manyworld.replicate_state(state, WORLDS)
    bi = manyworld.replicate_input(InputFrame.zero("cpu"), WORLDS)
    for i in range(STEPS):
        bs = step(bs, bi)
        for k in TRACKED:
            np.testing.assert_allclose(
                getattr(bs, k).numpy(), golden[f"traj/{k}"][i],
                atol=FLAT_ATOL, rtol=0, err_msg=f"{k} at step {i + 1}")
    # the capsules made contacts: a live manifold on the upright capsule
    assert bool((bs.contact_feat[0, 0] >= 0).any())


def test_chip_smoke_golden_is_current(golden):
    fresh = _jax_run()
    assert fresh.keys() == golden.keys()
    for k, v in fresh.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=(
            f"{k}: tests/data/capsule_flat_jax_golden.npz is stale: run "
            "PYTHONPATH=. JAX_PLATFORMS=cpu python "
            "tests/test_torch_capsule_slots.py"))


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    np.savez_compressed(GOLDEN, **_jax_run())
    print(f"wrote {GOLDEN}")
