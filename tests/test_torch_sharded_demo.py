"""The port's fully sharded world step against the JAX package's, on the
demo topology and the trigger fall-through of ``tests/test_sharded_world.py``.

``build_demo_like`` (the capsule character falling onto the ground box,
the checkpoint trigger) for the JAX test's 120 steps, and
``build_falling_boxes(8, seed=1, with_trigger=True)`` with box 0 dropped
from (5, 9, 5) through the trigger raised to (5, 5, 5) for its 200 steps,
on D = 1, 2 and 4 ranks (the port, gloo) and virtual devices (JAX), with
the bars of ``tests/test_torch_sharded_world.py``: the trigger events of
every step, booleans and the step count exact, floats within 1e-4 of JAX
at the same D, the port bit-equal across D.

``tests/data/sharded_world_jax_golden.json`` holds the JAX package's demo
topology on 4 virtual devices (the Enter/Exit events of every step, the
last state) with the bars ``chip_smoke.py`` holds the port on
the card to: events exact, floats within 2e-3, the JAX test's own bar
for this scene against the dense engine.  A test keeps it equal to the
live JAX run; ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_sharded_demo.py`` rewrites it.
"""

import json
import os

import numpy as np
import pytest

from test_torch_sharded_world import (
    DS, assert_state_match, jax_run, port_runs)

ATOL = 1e-4
SCENES = {"demo": 120, "trigger": 200}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "sharded_world_jax_golden.json")
GOLDEN_D = 4
GOLDEN_FIELDS = ("pos", "quat", "lin_vel", "char_vel_y", "char_on_ground",
                 "trigger_overlap", "trigger_active")
GOLDEN_ATOL = 2e-3    # tests/test_sharded_world.py:134-145


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return port_runs(SCENES, tmp_path_factory)


def _events(planes) -> list:
    """[steps, T, N] -> [[step (1-based), slot, entity], ...]."""
    return [[int(i) + 1, int(t), int(n)]
            for i, t, n in zip(*np.nonzero(planes))]


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", list(SCENES))
def test_fully_sharded_matches_jax(name, d, runs):
    got = runs[d][name]
    ref = jax_run(name, d, SCENES[name])
    assert_state_match(got["state"], ref["state"], ATOL, f"{name} at D={d}")
    np.testing.assert_array_equal(got["enter"], ref["enter"])
    np.testing.assert_array_equal(got["exit"], ref["exit"])


def test_events_fire(runs):
    """The scenes do what the JAX tests check: the trigger box passes
    through (Enter, then Exit) and the character lands."""
    trig = runs[4]["trigger"]
    enters = [e for e in _events(trig["enter"]) if e[1:] == [0, 0]]
    exits = [e for e in _events(trig["exit"]) if e[1:] == [0, 0]]
    assert enters and exits and exits[0][0] > enters[0][0]
    demo = runs[4]["demo"]["state"]
    assert bool(demo["char_on_ground"][0])


@pytest.mark.parametrize("name", list(SCENES))
def test_mesh_sizes_agree_bit_for_bit(name, runs):
    ref = runs[1][name]
    for d in DS[1:]:
        for field, a in runs[d][name]["state"].items():
            np.testing.assert_array_equal(a, ref["state"][field],
                                          err_msg=f"D={d}: {field}")
        np.testing.assert_array_equal(runs[d][name]["enter"], ref["enter"])


def make_golden() -> dict:
    """The JAX demo topology on 4 virtual devices, as the golden holds
    it: the events of every step and the last state."""
    steps = SCENES["demo"]
    ref = jax_run("demo", GOLDEN_D, steps)
    return dict(scene="build_demo_like", devices=GOLDEN_D, steps=steps,
                enter=_events(ref["enter"]), exit=_events(ref["exit"]),
                last={k: ref["state"][k].tolist() for k in GOLDEN_FIELDS},
                atol=GOLDEN_ATOL,
                float_fields=["pos", "quat", "lin_vel", "char_vel_y"],
                exact_fields=["char_on_ground", "trigger_overlap",
                              "trigger_active"])


def test_golden_is_the_jax_run():
    with open(GOLDEN) as f:
        golden = json.load(f)
    live = make_golden()
    assert golden["enter"] == live["enter"]
    assert golden["exit"] == live["exit"]
    for k, v in live["last"].items():
        np.testing.assert_allclose(np.asarray(golden["last"][k]),
                                   np.asarray(v), atol=1e-6, err_msg=k)


def test_port_holds_the_golden(runs):
    """The port's demo run on 4 ranks against the golden at the bars the
    card is held to (here, on the CPU, it is far inside them)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    got = runs[GOLDEN_D]["demo"]
    assert _events(got["enter"]) == golden["enter"]
    assert _events(got["exit"]) == golden["exit"]
    last = golden["last"]
    for k in golden["float_fields"]:
        np.testing.assert_allclose(got["state"][k], np.asarray(last[k]),
                                   atol=golden["atol"], err_msg=k)
    for k in golden["exact_fields"]:
        np.testing.assert_array_equal(got["state"][k], np.asarray(last[k]),
                                      err_msg=k)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(GOLDEN, "w") as f:
        json.dump(make_golden(), f)
    print(f"wrote {GOLDEN}")
