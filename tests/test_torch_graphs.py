"""The port's captured programs (``banggameengine_tpu_torch/graphs.py``) on
the CPU, through a stand-in for the CUDA graph class, against the same
factories run eagerly and against the JAX package's jitted factories.

The stand-in (:class:`RecordingGraph`, from
``test_torch_graphs_sharded.py``) does what a CUDA graph does to a
program, without a card: a capture records the program's body, which
closes over the captured argument objects (the program's buffers), runs
it once to make the outputs and puts the inputs back as it found them (a
capture runs nothing); a replay calls the body again on exactly those
objects and writes the results into the captured outputs.  So a value
frozen at capture stays frozen, a buffer a caller keeps is overwritten by
the next replay, and a static tensor replaced rather than written is not
seen, as on the card.

Here: the donated multi-step on the 32-box scene (default dense route),
the stacked events of the demo world (``build_demo_like``: the ground
box enters the checkpoint at step 1), a hot reload through the
hot-reloadable step, the flat and vmapped many-world steps at 4 worlds,
``graphs.eager()``, and a capture that fails.  Graph and eager runs are
bit-equal; against JAX the floats are held to ``test_torch_dense_step``'s
bar (1e-4) or the flat golden's, events and bools exact.
``test_torch_graphs_scene.py`` and ``test_torch_graphs_render.py`` hold
the scene edits, the app and the frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import (
    make_hot_reloadable_step_fn as jax_hot_step_fn,
)
from banggameengine_tpu.engine import make_multi_step_fn as jax_multi_fn
from banggameengine_tpu.engine import (
    make_step_fn_with_events as jax_events_fn,
)
from banggameengine_tpu.scene.synthetic import (
    build_demo_like as jax_build_demo_like,
)
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInput
from banggameengine_tpu_torch import convert, graphs
from banggameengine_tpu_torch.engine import (
    make_hot_reloadable_step_fn,
    make_multi_step_fn,
    make_step_fn,
    make_step_fn_with_events,
)
from banggameengine_tpu_torch.parallel import manyworld as mw
from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
from banggameengine_tpu_torch.state import InputFrame
from test_torch_graphs_sharded import RecordingGraph

ATOL = 1e-4            # tests/test_torch_dense_step.py's bar
SCENE = dict(num_bodies=32, seed=11, spread=3.0)


@pytest.fixture
def captured(monkeypatch):
    """Programs on CPU tensors capture through :class:`RecordingGraph`."""
    monkeypatch.setattr(graphs, "cpu_graph_class", RecordingGraph)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _port(state, static):
    return (convert.world_state_from_numpy(_np(state), "cpu"),
            convert.static_scene_from_numpy(_np(static), "cpu"))


def assert_bit_equal(a, b, what=""):
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    assert sa == sb, what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: leaf {i} differs"


def assert_close_to_jax(port_state, jax_state, atol=ATOL):
    got = convert.world_state_to_numpy(port_state)
    for name, a in _np(jax_state).items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[name], a, atol=atol, rtol=0,
                                       err_msg=name)
        elif name != "comp_mask":       # uint32 in JAX, int32 here
            np.testing.assert_array_equal(got[name], a, err_msg=name)


def _copy(tree):
    """A JAX tree's own copy (the JAX multi-steps donate their input)."""
    return jax.tree.map(jnp.array, tree)


def test_donated_multi_step(captured):
    """Two 5-step calls: the first captures one step's graph and replays
    it 5 times, the second takes the returned buffers back with no copy
    of the state; the caller's state is untouched, the result bit-equal
    to the eager run and within the bar of JAX's scanned multi-step."""
    js, jst = jax_build_falling_boxes(**SCENE)
    ts, tst = _port(js, jst)
    before = convert.world_state_to_numpy(ts)
    inp = InputFrame.zero("cpu")
    run = make_multi_step_fn(tst, 5)
    s1 = run(ts, inp)
    copies = graphs.stats["copies"]
    replays = graphs.stats["replays"]
    s2 = run(s1, inp)
    assert s2.pos is s1.pos                     # donated: the same buffers
    assert graphs.stats["copies"] - copies == 5     # the input only
    assert graphs.stats["replays"] - replays == 5
    assert run.program.captures == 1
    for name, a in convert.world_state_to_numpy(ts).items():
        np.testing.assert_array_equal(a, before[name], err_msg=name)
    with graphs.eager():
        e2 = run(run(ts, inp), inp)
    assert run.program.captures == 1
    assert_bit_equal(s2, e2, "multi-step")
    assert int(s2.step_idx) == 10
    jrun = jax_multi_fn(jst, 5)
    j2 = jrun(jrun(_copy(js), JaxInput.zero()), JaxInput.zero())
    assert_close_to_jax(s2, j2)


def test_stacked_events(captured):
    """Events of 5 steps stacked by the graph at a device-side index, two
    calls in a row (the index starts at 0 each call): bit-equal to the
    eager stack, and the JAX scan's events exact (the ground box enters
    the checkpoint at step 1 and stays)."""
    jd, jdst = jax_build_demo_like()
    td, tdst = _port(jd, jdst)
    inp = InputFrame.zero("cpu")
    run = make_step_fn_with_events(tdst, 5)
    g1, gev1 = run(td, inp)                     # the events are clones
    g2, gev2 = run(g1, inp)
    with graphs.eager():
        e1, eev1 = run(td, inp)
        e2, eev2 = run(e1, inp)
    assert_bit_equal((g2, gev1, gev2), (e2, eev1, eev2), "events")
    assert gev1.trigger_enter.shape == (5,) + tuple(
        tdst.trig_entity.shape) + (td.capacity,)
    assert bool(gev1.trigger_enter[0].any())
    assert bool(gev1.trigger_stay[1:].any())
    jrun = jax_events_fn(jdst, 5)
    j1, jev1 = jrun(_copy(jd), JaxInput.zero())
    j2, jev2 = jrun(j1, JaxInput.zero())
    for got, want in ((gev1, jev1), (gev2, jev2)):
        for name, a in _np(want).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), a,
                                          err_msg=name)
    assert_close_to_jax(g2, j2)


def test_hot_reload_copies_into_the_captured_scene(captured):
    """The hot-reloadable step with the scene rebuilt half-way (gravity
    halved, the same shapes): one capture, the rebuilt scene copied in;
    the returned state is a clone (the state passed in stays valid);
    bit-equal to eager and within the bar of JAX's traced-scene step."""
    jd, jdst = jax_build_demo_like()
    td, tdst = _port(jd, jdst)
    half = dataclasses.replace(tdst, gravity=tdst.gravity * 0.5)
    jhalf = dataclasses.replace(jdst, gravity=jdst.gravity * 0.5)
    inp = InputFrame.zero("cpu")
    step = make_hot_reloadable_step_fn()

    def run(seq):
        s, out = td, []
        for st in seq:
            prev = s
            s, ev = step(s, inp, st)
            assert s.pos is not prev.pos
            out.append((s, ev, prev))
        return out

    seq = [tdst, tdst, half, half]
    got = run(seq)
    assert step.program.captures == 1
    # each call's input survives the next call (nothing donated)
    for (s, _, _), (_, _, prev) in zip(got, got[1:]):
        assert_bit_equal(s, prev, "a returned state kept across a call")
    with graphs.eager():
        want = run(seq)
    assert_bit_equal([g[:2] for g in got], [w[:2] for w in want],
                     "hot step")
    assert float(got[3][0].pos[0, 1] - got[2][0].pos[0, 1]) != float(
        got[1][0].pos[0, 1] - got[0][0].pos[0, 1])
    jstep = jax_hot_step_fn()
    js = jd
    for st in (jdst, jdst, jhalf, jhalf):
        js, _ = jstep(js, JaxInput.zero(), st)
    assert_close_to_jax(got[3][0], js)


def test_flat_and_vmapped_many_world(captured):
    """4 worlds with per-world inputs (the flat golden's): the flat step's
    graphs (flatten, the flat step replayed, unflatten) and the vmapped
    step's graph, each bit-equal to its eager run; the flat step within
    the JAX golden's bars at step 1 and 25, its bools exact; the vmapped
    step's 4 steps within 2e-4 of the flat step's (JAX's flat-vs-vmapped
    bar)."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "data",
                           "flat4_jax_golden.json")) as f:
        golden = json.load(f)
    state1, static1 = build_falling_boxes(**golden["scene"], device="cpu")
    w = golden["worlds"]
    inp = InputFrame(**{
        k: torch.tensor(v, dtype=torch.bool if k in ("jump", "sprint")
                        else torch.float32)
        for k, v in golden["inputs"].items()})
    b0 = mw.replicate_state(state1, w)
    flat1 = mw.make_flat_many_world_step(static1, w, state1.comp_mask)
    flat24 = mw.make_flat_many_world_step(static1, w, state1.comp_mask,
                                          num_steps=24)
    flat4 = mw.make_flat_many_world_step(static1, w, state1.comp_mask,
                                         num_steps=4)
    vmapped = mw.make_sharded_many_world_step(static1, None, num_steps=4)
    g1 = graphs.clone_tree(flat1(b0, inp))
    replays = graphs.stats["replays"]
    g25 = flat24(g1, inp)
    # three graphs: flatten once, the flat step 24 times, unflatten once
    assert graphs.stats["replays"] - replays == 24 + 2
    v4 = vmapped(b0, inp)
    with graphs.eager():
        e1 = flat1(b0, inp)
        e25 = flat24(e1, inp)
        ev4 = vmapped(b0, inp)
        f4 = flat4(b0, inp)
    assert_bit_equal((g1, g25), (e1, e25), "flat")
    assert_bit_equal(v4, ev4, "vmapped")
    for step, s in ((1, g1), (25, g25)):
        got = convert.world_state_to_numpy(s)
        rec = golden["at"][str(step)]
        for name in golden["float_fields"]:
            np.testing.assert_allclose(
                got[name], np.asarray(rec[name], np.float32), rtol=0,
                atol=golden["atol"][str(step)][name], err_msg=name)
        for name in golden["bool_fields"]:
            np.testing.assert_array_equal(got[name],
                                          np.asarray(rec[name], bool))
    for name in golden["float_fields"]:
        np.testing.assert_allclose(getattr(v4, name).numpy(),
                                   getattr(f4, name).numpy(), rtol=0,
                                   atol=2e-4, err_msg=name)


def test_eager_runs_no_graph(captured):
    """Inside ``graphs.eager()`` a factory captures nothing and copies
    nothing, and returns fresh tensors; without the stand-in the CPU is
    always eager."""
    ts, tst = build_falling_boxes(4, seed=1, device="cpu")
    inp = InputFrame.zero("cpu")
    step = make_step_fn(tst)
    before = dict(graphs.stats)
    with graphs.eager():
        assert graphs.is_eager() and not graphs.enabled(ts)
        a, _ = step(ts, inp)
        b, _ = step(ts, inp)
    assert graphs.stats == before and step.program.captures == 0
    assert a.pos is not b.pos
    assert_bit_equal(a, b)
    g, _ = step(ts, inp)
    assert step.program.captures == 1
    assert_bit_equal(g, a)


def test_cpu_without_stand_in_is_eager():
    ts, tst = build_falling_boxes(4, seed=1, device="cpu")
    assert graphs.cpu_graph_class is None and not graphs.enabled(ts)
    step = make_step_fn(tst)
    step(ts, InputFrame.zero("cpu"))
    assert step.program.captures == 0


class _FailingGraph(RecordingGraph):
    def capture(self, body, stream, inputs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def test_failed_capture_raises(monkeypatch):
    """A capture that fails raises the failure: nothing runs eagerly in
    its place and nothing is cached."""
    monkeypatch.setattr(graphs, "cpu_graph_class", _FailingGraph)
    ts, tst = build_falling_boxes(4, seed=1, device="cpu")
    step = make_step_fn(tst)
    replays = graphs.stats["replays"]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            step(ts, InputFrame.zero("cpu"))
    assert step.program.captures == 0
    assert graphs.stats["replays"] == replays


def test_signature_and_copy_into():
    """The signature is structure, Python values, shapes, dtypes and
    devices; ``copy_into`` writes a tree of the same signature in place
    and refuses another."""
    a = InputFrame.zero("cpu")
    b = InputFrame(move_forward=torch.tensor(1.0), move_right=torch.tensor(
        2.0), jump=torch.tensor(True), sprint=torch.tensor(False),
        cam_yaw=torch.tensor(0.5))
    assert graphs.signature((a, 1.0)) == graphs.signature((b, 1.0))
    assert graphs.signature((a, 1.0)) != graphs.signature((a, 2.0))
    c = dataclasses.replace(a, cam_yaw=torch.zeros(2))
    assert graphs.signature(a) != graphs.signature(c)
    ptr = a.move_right.data_ptr()
    assert graphs.copy_into(a, b)
    assert a.move_right.data_ptr() == ptr and float(a.move_right) == 2.0
    assert not graphs.copy_into(a, c)
    tree = {"x": (a, None, [torch.ones(3)])}
    leaves, spec = graphs.flatten(tree)
    assert len(leaves) == 6
    assert_bit_equal(graphs.unflatten(spec, leaves), tree)
