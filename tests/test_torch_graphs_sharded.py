"""The sharded modes as captured programs, on D = 1, 2 and 4 gloo ranks,
through a stand-in for the CUDA graph class (:class:`RecordingGraph`).

Each sharded factory of ``banggameengine_tpu_torch/parallel`` is a
``graphs.Program`` over the rank's local tensors, its collectives inside
the program, as the JAX package's ``jax.jit`` over ``shard_map``.  On each
D every rank installs the stand-in and runs, from the same start, the
graph route and the eager route (``graphs.eager()``):

- the fully sharded step, 10 donated steps on ``build_falling_boxes(32,
  with_character=True, with_trigger=True)``, the events of every step
  read before the next (they are the graph's outputs);
- the entity-sharded contact phase on the 24-box scene of
  ``tests/test_torch_sharded_modes.py``, two calls of one signature;
- the flat step with ``mesh=``, 16 worlds, two 5-step calls, also against
  the same step with ``mesh=None``;
- the vmapped step with ``mesh=`` and ``with_metrics``, 4 worlds, two
  3-step calls.

Bars: the two routes bit-equal, events included; one capture a program
for repeated calls of one signature; a donated state passed back costs
no copy (a call copies only its input frame).  The fully sharded demo
topology runs its 120 steps on the graph route against
``tests/data/sharded_world_jax_golden.json`` with the bars
``tests/test_torch_sharded_demo.py`` holds: events exact, the floats
within the golden's ``atol``, the exact fields equal.

The ranks import this module: it imports neither JAX nor the JAX package.
``test_torch_graphs.py`` takes :class:`RecordingGraph` from here.
"""

import contextlib
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import convert, graphs
from banggameengine_tpu_torch.parallel import manyworld as mw
from banggameengine_tpu_torch.parallel import ranks, spatial
from banggameengine_tpu_torch.parallel import sharded_world as sw
from banggameengine_tpu_torch.scene.synthetic import (
    build_demo_like, build_falling_boxes)
from banggameengine_tpu_torch.state import (
    BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame)

DS = (1, 2, 4)
SHARDED_STEPS = 10
FLAT_WORLDS, FLAT_STEPS = 16, 5
VMAP_WORLDS, VMAP_STEPS = 4, 3
CALLS = 2             # calls of the phase and the many-world steps
DT = 1 / 120
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "sharded_world_jax_golden.json")


class RecordingGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``.

    A capture records the program's body, which closes over the captured
    argument objects (the program's buffers), runs it once to make the
    outputs and puts the inputs back as it found them (a capture runs
    nothing); a replay calls the body again on exactly those objects and
    writes the results into the captured outputs.  So a value frozen at
    capture stays frozen, a buffer a caller keeps is overwritten by the
    next replay, and a static tensor replaced rather than written is not
    seen, as on the card.  On gloo ranks the body's collectives run at
    the capture and at every replay, the same on every rank."""

    def capture(self, body, stream, inputs):
        saved = [t.clone() for t in inputs]
        self.body = body
        self.out = body()
        for t, s in zip(inputs, saved):
            t.copy_(s)
        return self.out

    def replay(self):
        new = self.body()
        for o, n in zip(graphs.flatten(self.out)[0], graphs.flatten(new)[0]):
            if o is not n:
                o.copy_(n)


def _route(eager: bool):
    return graphs.eager() if eager else contextlib.nullcontext()


def _full_np(obj) -> dict:
    """A dataclass of DTensors (or tensors) read back whole as numpy
    copies (a collective every rank makes; a donated state is the
    program's buffers, which its next call overwrites)."""
    return {k: v.copy()
            for k, v in convert.world_state_to_numpy(ranks.full(obj)).items()}


def _events_np(ev) -> dict:
    return {k: ranks.replicated(getattr(ev, k)).numpy().copy()
            for k in ("trigger_enter", "trigger_stay", "trigger_exit",
                      "contact_overflow")}


def _fully_sharded(d: int, eager: bool) -> dict:
    """10 steps of the fully sharded step on one route: the events of
    every step, the input copies of every call, the final state."""
    mesh = sw.make_entity_axis_mesh(d, "cpu")
    state, static = build_falling_boxes(32, with_character=True,
                                        with_trigger=True, device="cpu")
    ss, sst = sw.shard_world(state, static, mesh)
    step = sw.make_fully_sharded_step(static, mesh)
    inp = InputFrame.zero("cpu")
    events, copies = [], []
    with _route(eager):
        for _ in range(SHARDED_STEPS):
            c0 = graphs.stats["copies"]
            ss, ev = step(ss, inp, sst)
            copies.append(graphs.stats["copies"] - c0)
            events.append(_events_np(ev))
    return dict(state=_full_np(ss), events=events, copies=copies,
                captures=step.program.captures,
                input_leaves=len(graphs.flatten(inp)[0]))


def _demo(d: int, steps: int) -> dict:
    """The demo topology's steps on the graph route: the Enter and Exit
    planes of every step, the final state."""
    mesh = sw.make_entity_axis_mesh(d, "cpu")
    state, static = build_demo_like(device="cpu")
    ss, sst = sw.shard_world(state, static, mesh)
    step = sw.make_fully_sharded_step(static, mesh)
    inp = InputFrame.zero("cpu")
    enter, exit_ = [], []
    for _ in range(steps):
        ss, ev = step(ss, inp, sst)
        enter.append(ranks.replicated(ev.trigger_enter).numpy().copy())
        exit_.append(ranks.replicated(ev.trigger_exit).numpy().copy())
    return dict(state=_full_np(ss), enter=np.stack(enter),
                exit=np.stack(exit_), captures=step.program.captures)


def _phase_inputs() -> tuple:
    """The contact phase's inputs of ``tests/test_spatial_sharding.py``
    (the bodies lowered to the ground and falling at 1 m/s), and its
    static scene."""
    state, static = build_falling_boxes(24, seed=5, spread=4.0,
                                        device="cpu")
    n = state.capacity
    alive = state.alive
    pos = state.pos.clone()
    pos[:, 1] = torch.where(alive, 0.45 + 0.1 * (torch.arange(n) % 3),
                            pos[:, 1])
    vel = state.lin_vel.clone()
    vel[:, 1] = torch.where(alive, -1.0, 0.0)
    comp = state.comp_mask
    has_col = (comp & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    solid = alive & has_col & ((comp & COMP_CHARACTER) == 0)
    is_dyn = (static.body_type == BODY_DYNAMIC) & alive
    return (pos, state.quat, vel, state.ang_vel, is_dyn, solid), static


def _phase(d: int, eager: bool) -> dict:
    """Two calls of the entity-sharded phase on one route, the second on
    faster bodies (the same signature)."""
    args, static = _phase_inputs()
    mesh = ranks.make_mesh(spatial.AXIS, "cpu")
    phase = spatial.make_entity_sharded_contact_phase(static, mesh)
    outs, copies = [], []
    with _route(eager):
        for k in range(CALLS):
            pos, quat, vel, *rest = args
            c0 = graphs.stats["copies"]
            v, w = phase(pos, quat, vel * (1 + k), *rest, DT)
            copies.append(graphs.stats["copies"] - c0)
            outs.append((v.numpy().copy(), w.numpy().copy()))
    return dict(outs=outs, copies=copies, captures=phase.program.captures)


def _many_world_inputs(worlds: int):
    state, static = build_falling_boxes(8, with_character=True,
                                        with_trigger=True, device="cpu")
    rng = np.random.default_rng(7)
    drive = InputFrame(
        move_forward=torch.as_tensor(
            rng.uniform(0.5, 1.0, worlds).astype(np.float32)),
        move_right=torch.zeros(worlds),
        jump=torch.as_tensor(rng.random(worlds) < 0.3),
        sprint=torch.as_tensor(rng.random(worlds) < 0.3),
        cam_yaw=torch.as_tensor(
            rng.uniform(-np.pi, np.pi, worlds).astype(np.float32)))
    return state, static, mw.replicate_state(state, worlds), drive


def _flat(d: int, eager: bool, with_mesh: bool) -> dict:
    """Two chained calls of the flat step on one route, over the world
    mesh or (every rank all the worlds) without one."""
    state, static, bs, drive = _many_world_inputs(FLAT_WORLDS)
    mesh = mw.make_world_mesh(device_type="cpu") if with_mesh else None
    step = mw.make_flat_many_world_step(static, FLAT_WORLDS, state.comp_mask,
                                        num_steps=FLAT_STEPS, mesh=mesh)
    if with_mesh:
        bs, drive = mw.shard_batched(bs, mesh), mw.shard_batched(drive, mesh)
    outs, copies = [], []
    with _route(eager):
        for _ in range(CALLS):
            c0 = graphs.stats["copies"]
            bs = step(bs, drive)
            copies.append(graphs.stats["copies"] - c0)
            outs.append(_full_np(bs))
    return dict(outs=outs, copies=copies, captures=step.program.captures,
                input_leaves=len(graphs.flatten(drive)[0]))


def _vmapped(d: int, eager: bool) -> dict:
    """Two chained calls of the vmapped step with metrics over the world
    mesh on one route."""
    _, static, bs, drive = _many_world_inputs(VMAP_WORLDS)
    mesh = mw.make_world_mesh(device_type="cpu")
    step = mw.make_sharded_many_world_step(
        static, mesh, num_steps=VMAP_STEPS, with_metrics=True)
    bs, drive = mw.shard_batched(bs, mesh), mw.shard_batched(drive, mesh)
    outs, copies = [], []
    with _route(eager):
        for _ in range(CALLS):
            c0 = graphs.stats["copies"]
            bs, metrics = step(bs, drive)
            copies.append(graphs.stats["copies"] - c0)
            outs.append(dict(state=_full_np(bs), metrics={
                k: v.numpy().copy() for k, v in metrics.items()}))
    return dict(outs=outs, copies=copies,
                captures=(step.program.captures, step.metrics.captures),
                input_leaves=len(graphs.flatten(drive)[0]))


def sharded_rank(rank, world_size, demo_steps):
    """One rank: every sharded factory on both routes, the demo topology
    on the graph route; whether JAX stayed out of the process."""
    graphs.cpu_graph_class = RecordingGraph
    out = {}
    for eager in (False, True):
        key = "eager" if eager else "graph"
        out[key] = dict(
            fully=_fully_sharded(world_size, eager),
            phase=_phase(world_size, eager),
            flat=_flat(world_size, eager, with_mesh=True),
            vmapped=_vmapped(world_size, eager))
    out["flat_no_mesh"] = _flat(world_size, False, with_mesh=False)
    out["demo"] = _demo(world_size, demo_steps)
    out["jax_free"] = not any(
        m == "jax" or m.startswith(("jax.", "banggameengine_tpu."))
        or m == "banggameengine_tpu" for m in sys.modules)
    return out


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(golden, tmp_path_factory):
    """``{D: rank 0's results}``: one spawn of D ranks for each D, the
    three groups at once (each rank computes on one thread)."""
    # the directories are made here, before the threads: pytest's temp
    # factory is not thread-safe
    dirs = {d: str(tmp_path_factory.mktemp(f"d{d}")) for d in DS}

    def launch(d):
        return ranks.run_ranks(sharded_rank, d, golden["steps"],
                               device="cpu", store_dir=dirs[d])

    with ThreadPoolExecutor(len(DS)) as pool:
        results = dict(zip(DS, pool.map(launch, DS)))
    for res in results.values():
        assert all(r["jax_free"] for r in res), "a rank imported JAX"
    return {d: res[0] for d, res in results.items()}


def assert_trees_equal(a, b, what: str):
    """Two trees of numpy arrays (dicts, lists, tuples) bit-equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_trees_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("d", DS)
def test_fully_sharded_graph_equals_eager(d, runs):
    g, e = runs[d]["graph"]["fully"], runs[d]["eager"]["fully"]
    assert_trees_equal(g["state"], e["state"], f"D={d} state")
    assert_trees_equal(g["events"], e["events"], f"D={d} events")


@pytest.mark.parametrize("d", DS)
def test_entity_sharded_phase_graph_equals_eager(d, runs):
    assert_trees_equal(runs[d]["graph"]["phase"]["outs"],
                       runs[d]["eager"]["phase"]["outs"], f"D={d}")


@pytest.mark.parametrize("d", DS)
def test_flat_mesh_graph_equals_eager_and_no_mesh(d, runs):
    g = runs[d]["graph"]["flat"]["outs"]
    assert_trees_equal(g, runs[d]["eager"]["flat"]["outs"], f"D={d} eager")
    assert_trees_equal(g, runs[d]["flat_no_mesh"]["outs"],
                       f"D={d} mesh=None")


@pytest.mark.parametrize("d", DS)
def test_vmapped_mesh_with_metrics_graph_equals_eager(d, runs):
    assert_trees_equal(runs[d]["graph"]["vmapped"]["outs"],
                       runs[d]["eager"]["vmapped"]["outs"], f"D={d}")


@pytest.mark.parametrize("d", DS)
def test_one_capture_per_signature(d, runs):
    """Every program captured once over its repeated calls (the vmapped
    step's metrics are a second program); the eager route captures
    nothing."""
    g, e = runs[d]["graph"], runs[d]["eager"]
    assert g["fully"]["captures"] == 1
    assert g["phase"]["captures"] == 1
    assert g["flat"]["captures"] == 1
    assert g["vmapped"]["captures"] == (1, 1)
    assert runs[d]["flat_no_mesh"]["captures"] == 1
    assert runs[d]["demo"]["captures"] == 1
    assert e["fully"]["captures"] == e["phase"]["captures"] == 0
    assert e["flat"]["captures"] == 0 and e["vmapped"]["captures"] == (0, 0)


@pytest.mark.parametrize("d", DS)
def test_donated_state_passed_back_is_not_copied(d, runs):
    """After the capture a call copies its input frame only: the donated
    state comes back as the program's own buffers, the sharded static is
    captured by reference; the phase (not donated) copies its 7 inputs."""
    g = runs[d]["graph"]
    for name in ("fully", "flat", "vmapped"):
        r = g[name]
        assert r["copies"][1:] == [r["input_leaves"]] * (len(r["copies"])
                                                         - 1), name
    assert g["phase"]["copies"][1:] == [7] * (CALLS - 1)
    assert runs[d]["eager"]["fully"]["copies"] == [0] * SHARDED_STEPS


def _event_list(planes) -> list:
    """[steps, T, N] -> [[step (1-based), slot, entity], ...]."""
    return [[int(i) + 1, int(t), int(n)]
            for i, t, n in zip(*np.nonzero(planes))]


@pytest.mark.parametrize("d", DS)
def test_demo_topology_on_the_graph_route_holds_the_golden(d, runs, golden):
    got = runs[d]["demo"]
    assert _event_list(got["enter"]) == golden["enter"]
    assert _event_list(got["exit"]) == golden["exit"]
    last = golden["last"]
    for k in golden["float_fields"]:
        np.testing.assert_allclose(got["state"][k], np.asarray(last[k]),
                                   atol=golden["atol"], err_msg=k)
    for k in golden["exact_fields"]:
        np.testing.assert_array_equal(got["state"][k], np.asarray(last[k]),
                                      err_msg=k)
