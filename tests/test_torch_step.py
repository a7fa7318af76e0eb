"""The PyTorch port's stress tick against the JAX package, step by step.

The same 32-box scene goes through the JAX step
(``make_step_fn(static, broadphase="pallas")``, the Pallas broadphase in
interpret mode on the CPU) and the port's step
(``broadphase="allpairs"``, the plain broadphase on the CPU).

Tolerances: JAX's CPU compiler fuses ``a * b + c`` into one fused
multiply-add and PyTorch's eager ops do not, so the two round differently
in the last bit; the Jacobi solve (10 iterations, heavy-ball momentum)
amplifies that, and chaotic piling amplifies it further over many steps.
Integer and bool fields are exact.

``JAX_PLATFORMS=cpu python tests/test_torch_step.py`` rewrites the JAX
golden that ``chip_smoke.py`` checks the port against on the GPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from banggameengine_tpu.engine import make_step_fn as jax_make_step_fn
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_multi_step_fn, make_step_fn
from banggameengine_tpu_torch.state import InputFrame

SCENE = dict(num_bodies=32, seed=11, spread=3.0)
CHECKED_STEPS = (1, 60, 240)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "stress32_jax_golden.json")
GOLDEN_STEPS = (1, 60)

# one step, float fields: atol=1e-5, except what comes out of the solver.
# There the fused multiply-add rounding grows, over 10 heavy-ball Jacobi
# iterations, to ~1e-5 on velocities of up to ~8 m/s (a few ulp): lin_vel
# and ang_vel get rtol=1e-5 on top, and the accumulated impulses
# contact_imp (up to ~0.4, off by up to 1.8e-5) atol=5e-5.
FLOAT_TOL = {"lin_vel": (1e-5, 1e-5), "ang_vel": (1e-5, 1e-5),
             "contact_imp": (5e-5, 1e-5)}


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_run(steps):
    """JAX states (as numpy dicts) and contact overflows at ``steps``."""
    state, static = jax_build_falling_boxes(**SCENE)
    step = jax_make_step_fn(static, donate=False, broadphase="pallas")
    out, inp = {}, JaxInputFrame.zero()
    for i in range(1, max(steps) + 1):
        state, events = step(state, inp)
        if i in steps:
            out[i] = (_np(state), int(events.contact_overflow))
    return out


@pytest.fixture(scope="module")
def trajectories():
    jax_out = _jax_run(CHECKED_STEPS)
    state0, static = jax_build_falling_boxes(**SCENE)
    state = convert.world_state_from_numpy(_np(state0), "cpu")
    static = convert.static_scene_from_numpy(_np(static), "cpu")
    step = make_step_fn(static, broadphase="allpairs")
    torch_out, inp = {}, InputFrame.zero("cpu")
    for i in range(1, max(CHECKED_STEPS) + 1):
        state, events = step(state, inp)
        if i in CHECKED_STEPS:
            torch_out[i] = (convert.world_state_to_numpy(state),
                            int(events.contact_overflow))
    return jax_out, torch_out


def test_one_step_every_field(trajectories):
    jax_out, torch_out = trajectories
    (js, jo), (ts, to) = jax_out[1], torch_out[1]
    assert jo == to
    for name, a in js.items():
        b = ts[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":
            atol, rtol = FLOAT_TOL.get(name, (1e-5, 0.0))
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_sixty_steps_positions(trajectories):
    jax_out, torch_out = trajectories
    (js, jo), (ts, to) = jax_out[60], torch_out[60]
    assert jo == to
    np.testing.assert_allclose(ts["pos"], js["pos"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ts["step_idx"], js["step_idx"])


def test_240_steps_statistical_bound(trajectories):
    jax_out, torch_out = trajectories
    (js, jo), (ts, to) = jax_out[240], torch_out[240]
    assert jo == to
    alive = js["alive"]
    pj, pt = js["pos"][alive], ts["pos"][alive]
    assert np.isfinite(pt).all()
    assert (pt[:, 1] > 0.3).all()      # everything rests on/above the ground
    diff = np.abs(pt - pj)
    assert np.median(diff) < 0.01, np.median(diff)
    assert diff.max() < 0.6, diff.max()


def test_multi_step_equals_repeated_steps():
    state0, static = jax_build_falling_boxes(16, seed=3, spread=2.0)
    state0 = convert.world_state_from_numpy(_np(state0), "cpu")
    static = convert.static_scene_from_numpy(_np(static), "cpu")
    inp = InputFrame.zero("cpu")
    multi = make_multi_step_fn(static, 5, broadphase="allpairs",
                               max_neighbors=8)(state0, inp)
    step = make_step_fn(static, broadphase="allpairs", max_neighbors=8)
    state = state0
    for _ in range(5):
        state, _ = step(state, inp)
    for name, a in convert.world_state_to_numpy(multi).items():
        np.testing.assert_array_equal(
            a, convert.world_state_to_numpy(state)[name], err_msg=name)
    assert int(multi.step_idx) == 5


def test_unported_routes_raise():
    state, static = jax_build_falling_boxes(8, with_character=True)
    state = convert.world_state_from_numpy(_np(state), "cpu")
    static = convert.static_scene_from_numpy(_np(static), "cpu")
    # ported: a character without candidates (the per-slot step, on every
    # route), the dense route (the default) and the grid route
    # (tests/test_torch_grid.py holds it against JAX)
    for kw in (dict(broadphase="allpairs"), dict(broadphase="dense"),
               dict(broadphase="grid"), {}):
        out, _ = make_step_fn(static, **kw)(state, InputFrame.zero("cpu"))
        assert float(out.pos[8, 1]) < float(state.pos[8, 1])  # it falls
    # the JAX package's name of the all-pairs route is not the port's
    with pytest.raises(ValueError, match="ROADMAP"):
        make_step_fn(static, broadphase="pallas", any_char=False)(
            state, InputFrame.zero("cpu"))
    # the static route is ported (tests/test_torch_manyworld.py); it needs
    # its neighbor lists
    with pytest.raises(ValueError, match="static_neighbors"):
        make_step_fn(static, broadphase="static", any_char=False)(
            state, InputFrame.zero("cpu"))


def test_capsule_scene_is_refused():
    state, static = jax_build_falling_boxes(4)
    static = dataclasses.replace(
        static, shape_type=static.shape_type.at[0].set(2))
    state = convert.world_state_from_numpy(_np(state), "cpu")
    static = convert.static_scene_from_numpy(_np(static), "cpu")
    with pytest.raises(ValueError, match="box-only"):
        make_step_fn(static, broadphase="allpairs")(state,
                                                    InputFrame.zero("cpu"))


def _golden(out: dict) -> dict:
    """The JAX package's 32-box trajectory at GOLDEN_STEPS, as JSON, from
    ``_jax_run`` output."""
    at = {}
    for i in GOLDEN_STEPS:
        s = out[i][0]
        rec = {"pos": s["pos"].astype(float).tolist()}
        if i == GOLDEN_STEPS[0]:
            rec["contact_feat"] = s["contact_feat"].tolist()
        at[str(i)] = rec
    return {"scene": SCENE, "steps": list(GOLDEN_STEPS), "at": at,
            "source": "banggameengine_tpu make_step_fn(static, "
                      "broadphase='pallas') on the CPU"}


def test_chip_smoke_golden_is_current(trajectories):
    with open(GOLDEN) as f:
        stored = json.load(f)
    assert stored == _golden(trajectories[0]), (
        "tests/data/stress32_jax_golden.json is stale: run "
        "JAX_PLATFORMS=cpu python tests/test_torch_step.py")


if __name__ == "__main__":
    with open(GOLDEN, "w") as f:
        json.dump(_golden(_jax_run(GOLDEN_STEPS)), f)
        f.write("\n")
    print(f"wrote {GOLDEN}")
