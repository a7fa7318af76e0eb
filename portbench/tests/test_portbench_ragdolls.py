"""CPU runs of the ragdoll cell (``ragdolls136.settled``) cut to a tiny
pyramid, in the style of ``test_portbench_runs.py``: the result line, the
faults the comparison must catch, the control; and the port's ragdoll
builder against the benchmark's, both from the configuration.

Run: ``python -m pytest portbench/tests -q`` (from the repo root).
"""

from __future__ import annotations

import os
import shutil
import time

import pytest
import torch

from portbench import run
from portbench.harness import ragdolls, registry
from portbench.tests import tiny

SEED = 2 ** 31 + 54321          # larger than 32 signed bits hold
CELL = "ragdolls136.settled"
CUT = ({"size": 2}, {"steps_per_call": 3, "settle_steps": 6,
                     "check_calls": 2})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark folder holding the tiny ragdoll cell, named as the
    real one, beside copies of the drivers and metric readers."""
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


def test_tiny_ragdoll_cell_runs_correct(root):
    r = one_run(root)
    assert r["correct"] is True and r["failed"] == 0
    e2e, per_layer = registry.cell_metrics(root[1], CELL)
    assert sorted(r["metrics"]) == sorted(m["name"] for m in e2e) == [
        "setup_s", "sim_steps_per_s"]
    assert [m["name"] for m in per_layer] == [
        "kernels_per_step.sim", "step_device_ms.sim",
        "broadphase_device_ms.sim", "narrowphase_device_ms.sim",
        "solver_device_ms.sim", "integrate_device_ms.sim",
        "transforms_device_ms.sim", "capture_s.setup",
        "joints_device_ms.ragdolls"]
    assert set(r["checks"]) == {
        "start_pos_gap_m", "start_quat_gap", "start_step_gap",
        "start_pos_gap_p50_m", "pos_gap_m", "quat_gap", "step_gap",
        "pos_gap_p50_m"}


def test_tiny_ragdoll_cell_traced(root):
    """Traced on the CPU: no device op, so the marker reader finds no
    joint stage and the metric is left out; the comparison still runs."""
    r = one_run(root, trace=True)
    assert r["correct"] is True
    assert "joints_device_ms.ragdolls" not in r["metrics"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_planted_fault_is_not_correct(root, fault):
    r = one_run(root, fault=fault)
    assert r["correct"] is False and r["failed"] >= 1


def test_control_is_not_correct(root):
    """The reference in bfloat16 put in the program's place fails."""
    assert one_run(root, control=True)["correct"] is False


def test_port_builder_is_the_configuration():
    """The port's ``build_ragdoll_pyramid``, given the configuration's
    description with no jitter, builds the scene and the joints that the
    benchmark's own builder makes of it."""
    from banggameengine_tpu_torch.scene.ragdolls import build_ragdoll_pyramid

    cfg = tiny.load(os.path.join(tiny.HERE, "configs",
                                 "bullet-ragdolls136.json"))
    scene = dict(cfg["scene"], size=3, jitter_m=0.0, jitter_yaw_deg=0.0)
    static, state, joints = ragdolls.ragdoll_pyramid(
        scene, cfg["physics"], SEED, "cpu")
    port = build_ragdoll_pyramid(scene, device="cpu")
    assert port.ragdolls == 6 and port.static.capacity == 66
    for k in ("shape_size", "inv_mass", "inv_inertia_body", "friction",
              "restitution", "gravity", "fixed_dt"):
        torch.testing.assert_close(getattr(port.static, k), static[k],
                                   msg=k)
    for k in ("body_type", "shape_type", "layer", "mask"):
        assert torch.equal(getattr(port.static, k), static[k]), k
    torch.testing.assert_close(port.state.pos, state["pos"])
    torch.testing.assert_close(port.state.quat, state["quat"])
    for k in ("body_a", "body_b", "kind", "origin_a", "origin_b",
              "limit_lo", "limit_hi", "lin_damping", "ang_damping"):
        torch.testing.assert_close(getattr(port.joints, k),
                                   joints[k].to(getattr(port.joints, k)
                                                .dtype), msg=k)
    from banggameengine_tpu_torch import math3d
    for side in ("a", "b"):
        torch.testing.assert_close(
            math3d.quat_to_mat3(getattr(port.joints, "frame_" + side)),
            joints["basis_" + side], atol=1e-6, rtol=0)


def test_joints_metric_reads_its_spans_apart_from_the_solver():
    """``joints_device_ms.ragdolls`` binds its reader: on a hand-made trace
    whose joint spans alternate with the solver's (as the solver's
    iterations mark them), each metric reads its own stage's time a
    step."""
    from portbench.tests.test_portbench_spans import hand_made_trace

    events = hand_made_trace()
    for e in events:
        if e["name"] == "bge_span_ecs_transforms":
            e["name"] = "bge_span_physics_joints"
    ctx = {"events": events, "calls": 2, "steps": 4}
    joints = registry.metric_reader(tiny.HERE, "joints_device_ms.ragdolls")
    solver = registry.metric_reader(tiny.HERE, "solver_device_ms.sim")
    assert joints(ctx) == pytest.approx(0.011 / 4)     # k2, copy, fill
    assert solver(ctx) == pytest.approx(0.009 / 4)     # k1 + k4
