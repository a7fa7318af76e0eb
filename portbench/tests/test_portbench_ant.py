"""CPU runs of the Ant cell (``ant4k.act60``) cut to 4 worlds, in the
style of ``test_portbench_ragdolls.py``: the result line, the faults the
comparison must catch, the control; the census; and the two new metrics'
readers on a hand-made trace.

Run: ``python -m pytest portbench/tests -q`` (from the repo root).
"""

from __future__ import annotations

import os
import shutil
import time

import pytest
import torch

from portbench import run
from portbench.harness import ant, registry
from portbench.tests import tiny

SEED = 2 ** 31 + 24680          # larger than 32 signed bits hold
CELL = "ant4k.act60"
CUT = ({"num_worlds": 4}, {"settle_steps": 4, "sample_worlds": 3,
                           "check_calls": 2, "trace_calls": 2})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark folder holding the tiny Ant cell, named as the real
    one, beside copies of the drivers and metric readers."""
    torch.set_num_threads(1)
    path = os.path.join(str(tmp_path_factory.mktemp("portbench")), "bench")
    for sub in ("drivers", "metrics"):
        shutil.copytree(os.path.join(tiny.HERE, sub),
                        os.path.join(path, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = tiny.load(os.path.join(os.path.dirname(tiny.HERE),
                                   "BENCHMARK.json"))
    w = tiny.load(os.path.join(tiny.HERE, "workloads", CELL + ".json"))
    cfg = tiny.load(os.path.join(tiny.HERE, "configs",
                                 w["config"] + ".json"))
    mix = tiny.load(os.path.join(tiny.HERE, "traffic",
                                 w["traffic"] + ".json"))
    cfg["scene"].update(CUT[0])
    for k, v in CUT[1].items():
        (mix if k in mix else w["measure"])[k] = v
    tiny.save(os.path.join(path, "configs", w["config"] + ".json"), cfg)
    tiny.save(os.path.join(path, "traffic", w["traffic"] + ".json"), mix)
    tiny.save(os.path.join(path, "workloads", CELL + ".json"), w)
    return path, bench


def one_run(root, trace=False, **kw):
    path, bench = root
    return run.run_cell(path, bench, CELL, SEED, 0.2, trace, "cpu",
                        time.perf_counter(), **kw)


def test_tiny_ant_cell_runs_correct(root):
    r = one_run(root)
    assert r["correct"] is True and r["failed"] == 0
    e2e, per_layer = registry.cell_metrics(root[1], CELL)
    assert sorted(r["metrics"]) == sorted(m["name"] for m in e2e) == [
        "setup_s", "world_steps_per_s"]
    assert {m["name"] for m in per_layer} == {
        "device_idle_share.worlds", "kernels_per_step.worlds",
        "step_device_ms.worlds", "host_launches_per_call.worlds",
        "narrowphase_device_ms.worlds", "solver_device_ms.worlds",
        "flatten_device_ms.worlds", "capture_s.setup",
        "motors_device_ms.worlds", "joints_device_ms.worlds"}
    assert set(r["checks"]) == {
        "start_pos_gap_m", "start_quat_gap", "start_step_gap",
        "start_pos_gap_p50_m", "pos_gap_m", "quat_gap", "step_gap",
        "pos_gap_p50_m"}


def test_tiny_ant_cell_traced(root):
    """Traced on the CPU: no device op, so the marker readers find no
    stage and the new metrics are left out; the comparison still runs."""
    r = one_run(root, trace=True)
    assert r["correct"] is True
    assert "motors_device_ms.worlds" not in r["metrics"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_planted_fault_is_not_correct(root, fault):
    r = one_run(root, fault=fault)
    assert r["correct"] is False and r["failed"] >= 1


def test_control_is_not_correct(root):
    """The reference in bfloat16 put in the program's place fails."""
    assert one_run(root, control=True)["correct"] is False


def test_census_of_the_start():
    """The census reads the builder's start: torsos at 0.44 m, upright,
    joints closed, every joint within its range (a clamped ankle on its
    bound), every field finite."""
    cfg = tiny.load(os.path.join(tiny.HERE, "configs",
                                 "isaacgym-ant4k.json"))
    cfg["scene"]["num_worlds"] = 8
    worlds = ant.ant_worlds(cfg, SEED, "cpu")
    c = ant.census(worlds.state, 0, ant.reference_scene(cfg, "cpu")[1],
                   cfg["scene"]["termination_height"])
    assert c["worlds"] == 8 and c["finite"] is True
    assert c["torso_height_m"] == pytest.approx([0.44] * 4, abs=1e-6)
    assert c["anchor_gap_m"][2] < 1e-6
    assert c["past_limit_rad"][2] < 1e-6
    assert c["tilted_past_37deg_share"] == 0.0
    assert c["under_termination_share"] == 0.0


def test_new_metrics_read_their_spans():
    """``motors_device_ms.worlds`` and ``joints_device_ms.worlds`` bind
    their readers: on a hand-made trace each reads its own stage's time
    a step."""
    from portbench.tests.test_portbench_spans import hand_made_trace

    events = hand_made_trace()
    for e in events:
        if e["name"] == "bge_span_ecs_transforms":
            e["name"] = "bge_span_physics_motors"
        elif e["name"] == "bge_span_physics_solver":
            e["name"] = "bge_span_physics_joints"
    ctx = {"events": events, "calls": 2, "steps": 4}
    motors = registry.metric_reader(tiny.HERE, "motors_device_ms.worlds")
    joints = registry.metric_reader(tiny.HERE, "joints_device_ms.worlds")
    assert motors(ctx) == pytest.approx(0.011 / 4)     # k2, copy, fill
    assert joints(ctx) == pytest.approx(0.009 / 4)     # k1 + k4
