"""The port's fully sharded world step against the JAX package's, on the
falling-box pile and the kinematic push of ``tests/test_sharded_world.py``.

``make_fully_sharded_step`` over an ``("entity",)`` mesh of D gloo ranks
(the port; one spawned process a rank, once for each D) and of D of the
8 virtual CPU devices (JAX), D = 1, 2 and 4, from the same numpy state:
``build_falling_boxes(32, seed=3)`` and ``build_falling_boxes(32,
seed=5)`` with body 3 kinematic at (0, 0.5, 0) moving at 1 m/s, each for
the JAX tests' 25 steps with zero input.

Bars: booleans, the trigger planes and the step count exact; positions,
rotations, velocities and world matrices within 1e-4 of JAX at the same
D (f32 rounding: JAX's CPU compiler fuses multiply-adds, PyTorch does
not, through 10 Jacobi iterations a step).  The port at D = 1, 2 and 4
is bit-equal: a row's arithmetic does not depend on which rank holds it
(the gathers move bits, every reduction runs over a row's own contacts).

The ranks import this module: it imports neither JAX nor the JAX package
at module level.
"""

import dataclasses
import functools
import sys

import numpy as np
import pytest

from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.parallel import ranks
from banggameengine_tpu_torch.state import InputFrame

DS = (1, 2, 4)
ATOL = 1e-4
FLOAT_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y", "world")
EXACT_FIELDS = ("char_on_ground", "trigger_overlap", "trigger_active",
                "alive", "step_idx")
SCENES = {"pile": 25, "kinematic": 25}   # scene -> the JAX test's steps


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def jax_scene(name: str):
    """The scene of ``tests/test_sharded_world.py`` as JAX dataclasses."""
    import jax.numpy as jnp

    from banggameengine_tpu.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu.state import BODY_KINEMATIC

    if name == "pile":
        return build_falling_boxes(32, seed=3)
    if name == "kinematic":
        state, static = build_falling_boxes(32, seed=5)
        static = dataclasses.replace(
            static, body_type=static.body_type.at[3].set(BODY_KINEMATIC))
        state = dataclasses.replace(
            state, pos=state.pos.at[3].set(jnp.asarray([0.0, 0.5, 0.0])),
            lin_vel=state.lin_vel.at[3].set(jnp.asarray([1.0, 0.0, 0.0])))
        return state, static
    if name == "demo":
        return build_demo_like()
    state, static = build_falling_boxes(8, seed=1, with_trigger=True)
    ti = int(np.asarray(static.trig_entity)[0])
    state = dataclasses.replace(
        state,
        pos=(state.pos.at[0].set(jnp.asarray([5.0, 9.0, 5.0]))
             .at[ti].set(jnp.asarray([5.0, 5.0, 5.0]))),
        quat=state.quat.at[0].set(jnp.asarray([0.0, 0.0, 0.0, 1.0])))
    return state, static


@functools.lru_cache(maxsize=None)
def jax_run(name: str, d: int, steps: int) -> dict:
    """The JAX fully sharded step on D virtual devices: the final state
    and the Enter/Exit planes of every step, as numpy."""
    import jax

    from banggameengine_tpu.parallel.sharded_world import (
        make_entity_axis_mesh, make_fully_sharded_step, shard_world)
    from banggameengine_tpu.state import InputFrame as JaxInputFrame

    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} devices")
    state, static = jax_scene(name)
    mesh = make_entity_axis_mesh(d)
    ss, sst = shard_world(state, static, mesh)
    step = make_fully_sharded_step(static, mesh)
    enter, exit_ = [], []
    for _ in range(steps):
        ss, ev = step(ss, JaxInputFrame.zero(), sst)
        enter.append(np.asarray(ev.trigger_enter))
        exit_.append(np.asarray(ev.trigger_exit))
    return dict(state=_np(ss), enter=np.stack(enter), exit=np.stack(exit_))


def world_rank(rank, world_size, scenes):
    """One rank: each scene ``name -> (state, static, steps)`` through the
    port's fully sharded step on ``world_size`` gloo ranks; returns the
    gathered final states, the gathered Enter/Exit planes of every step,
    the rows this rank held, and whether JAX stayed out of the process."""
    from banggameengine_tpu_torch.parallel import sharded_world as sw

    mesh = sw.make_entity_axis_mesh(world_size, "cpu")
    out = {}
    for name, (state_np, static_np, steps) in scenes.items():
        state = convert.world_state_from_numpy(state_np, "cpu")
        static = convert.static_scene_from_numpy(static_np, "cpu")
        ss, sst = sw.shard_world(state, static, mesh)
        step = sw.make_fully_sharded_step(static, mesh)
        enter, exit_ = [], []
        for _ in range(steps):
            ss, ev = step(ss, InputFrame.zero("cpu"), sst)
            enter.append(ranks.replicated(ev.trigger_enter).numpy())
            exit_.append(ranks.replicated(ev.trigger_exit).numpy())
        out[name] = dict(
            state=convert.world_state_to_numpy(ranks.full(ss)),
            enter=np.stack(enter), exit=np.stack(exit_),
            local_rows=int(ss.pos.to_local().shape[0]))
    out["jax_free"] = not any(
        m == "jax" or m.startswith(("jax.", "banggameengine_tpu."))
        or m == "banggameengine_tpu" for m in sys.modules)
    return out


def port_runs(scene_steps: dict, tmp_path_factory) -> dict:
    """``{D: rank 0's results}``: one spawn of D ranks for each D, the
    three groups at once (each rank computes on one thread)."""
    from concurrent.futures import ThreadPoolExecutor

    scenes = {name: (*(_np(o) for o in jax_scene(name)), steps)
              for name, steps in scene_steps.items()}

    # the directories are made here, before the threads: pytest's temp
    # factory is not thread-safe
    dirs = {d: str(tmp_path_factory.mktemp(f"d{d}")) for d in DS}

    def launch(d):
        return ranks.run_ranks(world_rank, d, scenes, device="cpu",
                               store_dir=dirs[d])

    with ThreadPoolExecutor(len(DS)) as pool:
        results = dict(zip(DS, pool.map(launch, DS)))
    for res in results.values():
        for r in res:
            assert r["jax_free"], "a rank imported JAX"
    return {d: res[0] for d, res in results.items()}


def assert_state_match(got: dict, ref: dict, atol: float, what: str):
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                   err_msg=f"{what}: {name}")
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(got[name], ref[name],
                                      err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return port_runs(SCENES, tmp_path_factory)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", list(SCENES))
def test_fully_sharded_matches_jax(name, d, runs):
    got = runs[d][name]
    ref = jax_run(name, d, SCENES[name])
    assert_state_match(got["state"], ref["state"], ATOL,
                       f"{name} at D={d}")
    np.testing.assert_array_equal(got["enter"], ref["enter"])
    np.testing.assert_array_equal(got["exit"], ref["exit"])
    assert got["local_rows"] == got["state"]["pos"].shape[0] // d


def test_kinematic_row_moves_at_its_velocity(runs):
    p3 = runs[4]["kinematic"]["state"]["pos"][3]
    dt = convert.static_scene_from_numpy(
        _np(jax_scene("kinematic")[1]), "cpu").fixed_dt
    assert abs(p3[0] - 25 * float(dt) * 1.0) < 1e-5


@pytest.mark.parametrize("name", list(SCENES))
def test_mesh_sizes_agree_bit_for_bit(name, runs):
    ref = runs[1][name]
    for d in DS[1:]:
        for field, a in runs[d][name]["state"].items():
            np.testing.assert_array_equal(a, ref["state"][field],
                                          err_msg=f"D={d}: {field}")
