"""The port's stage spans (``utils/profiling.py`` ``span``) and its
graphs' capture counter (``graphs.stats``), on the CPU.

- Under ``torch.profiler`` the stages of one call come out as host ranges
  in order: the all-pairs step of a few boxes, the dense step of a few
  boxes with a character and a trigger, the flat many-world step of two
  worlds with a character and a trigger each, a small frame; each inside
  its program's ``program:<name>`` range.
- Every span opened is closed before the next opens (spans do not nest).
- Each name of ``DEVICE_SPANS`` has its marker kernel in
  ``utils/csrc/spans.cu``, in the order the launcher indexes them (a
  parse of the source: no card here); the marker logic launches one
  marker at entry and ``bge_span_end`` at exit for a stage on a CUDA
  device, none on the CPU or for another name.
- With no profiler recording a span dispatches no op.
- Through the stand-in graph class: ``capture_s`` grows once a capture.
- A call's outputs are bit-equal with a profiler recording and without.
- ``scripts/trace_summary.py`` splits a hand-made trace's device time by
  its markers and names the program around each idle gap.
"""

import json
import os
import re

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from banggameengine_tpu_torch import graphs
from banggameengine_tpu_torch.engine import make_multi_step_fn, make_step_fn
from banggameengine_tpu_torch.parallel import manyworld as mw
from banggameengine_tpu_torch.render.pipeline import make_render_fn
from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
from banggameengine_tpu_torch.scripts import profile_render as prr
from banggameengine_tpu_torch.scripts import trace_summary as ts
from banggameengine_tpu_torch.state import InputFrame
from banggameengine_tpu_torch.utils import profiling
from test_torch_graphs_sharded import RecordingGraph


ORDER = {
    # the masks and gravity, then the route's own broadphase
    "allpairs": ["program:step", "physics.broadphase", "physics.broadphase",
                 "physics.narrowphase", "physics.solver",
                 "physics.integrate", "ecs.transforms"],
    # the dense route's solve opens its own span, the cache's refresh
    # another
    "dense": ["program:step", "physics.characters", "physics.broadphase",
              "physics.narrowphase", "physics.solver", "physics.solver",
              "physics.integrate", "physics.triggers", "ecs.transforms"],
    "rollout": ["program:flat_many_world_step", "manyworld.flatten",
                "physics.characters", "physics.broadphase",
                "physics.narrowphase", "physics.solver",
                "physics.integrate", "physics.triggers", "ecs.transforms",
                "manyworld.unflatten"],
    "frame": ["program:render", "render.raster", "render.shade"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _call(kind: str):
    """A call of one program on the CPU: ``() -> outputs``."""
    if kind == "allpairs":
        state, static = build_falling_boxes(8, seed=1, device="cpu")
        step = make_step_fn(static, donate=False, broadphase="allpairs",
                            max_neighbors=8)
        return lambda: step(state, InputFrame.zero("cpu"))
    if kind == "dense":
        state, static = build_falling_boxes(6, seed=4, with_character=True,
                                            with_trigger=True, device="cpu")
        step = make_step_fn(static, donate=False)
        inp = InputFrame.zero("cpu")
        inp.move_forward = torch.tensor(1.0)
        return lambda: step(state, inp)
    if kind == "rollout":
        state, static = build_falling_boxes(4, seed=2, with_character=True,
                                            with_trigger=True, device="cpu")
        step = mw.make_flat_many_world_step(static, 2, state.comp_mask)
        bstate = mw.replicate_state(state, 2)
        binp = mw.replicate_input(InputFrame.zero("cpu"), 2)
        binp.move_forward = torch.tensor([0.0, 1.0])
        return lambda: step(graphs.owned(bstate), binp)
    rs, args, (w, h) = prr.showcase("cpu", small=True)
    render = make_render_fn(rs, w, h, bin_capacity=prr.BIN_CAPACITY)
    return lambda: render(*args)


def _traced(fn):
    with torch.profiler.profile() as prof:
        out = fn()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name in profiling.DEVICE_SPANS
                    or e.name.startswith("program:"))
    return out, ranges


@pytest.mark.parametrize("kind", list(ORDER))
def test_stages_come_out_in_order(kind):
    _, ranges = _traced(_call(kind))
    assert [name for _, _, name in ranges] == ORDER[kind]
    (p0, p1, _), stages = ranges[0], ranges[1:]
    for (a0, a1, _), (b0, _, _) in zip(stages, stages[1:]):
        assert a0 <= a1 <= b0                   # one after the other
    assert p0 <= stages[0][0] and stages[-1][1] <= p1


@pytest.mark.parametrize("kind", list(ORDER))
def test_every_span_opened_is_closed(monkeypatch, kind):
    log = []
    enter, exit_ = profiling.span.__enter__, profiling.span.__exit__

    def logged_enter(self):
        log.append(("open", self.name))
        return enter(self)

    def logged_exit(self, *exc):
        log.append(("close", self.name))
        return exit_(self, *exc)

    monkeypatch.setattr(profiling.span, "__enter__", logged_enter)
    monkeypatch.setattr(profiling.span, "__exit__", logged_exit)
    fn = _call(kind)
    log.clear()
    fn()
    program = ORDER[kind][0]
    assert log[0] == ("open", program) and log[-1] == ("close", program)
    inner = log[1:-1]
    assert [n for what, n in inner if what == "open"] == ORDER[kind][1:]
    # each stage closes before the next opens
    assert inner == [(what, n) for n in ORDER[kind][1:]
                     for what in ("open", "close")]


def test_device_spans_match_the_marker_kernels():
    path = os.path.join(os.path.dirname(profiling.__file__), "csrc",
                        "spans.cu")
    with open(path) as f:
        src = f.read()
    kernels = re.findall(r'extern "C" __global__ void (bge_span_\w+)\(\)',
                         src)
    table = re.search(r"kMarkers\[\] = \{(.*?)\};", src, re.S).group(1)
    indexed = re.findall(r"bge_span_\w+", table)
    want = [profiling.marker_kernel(n) for n in profiling.DEVICE_SPANS]
    assert kernels == indexed == want + ["bge_span_end"]
    assert len(set(want)) == len(want)


def test_markers_only_for_device_stages_on_a_card(monkeypatch):
    launched = []
    monkeypatch.setattr(profiling.SPAN_LIBRARY, "launch",
                        lambda device, which: launched.append(which))
    card, end = torch.device("cuda", 0), len(profiling.DEVICE_SPANS)
    for name in profiling.DEVICE_SPANS:
        launched.clear()
        with profiling.span(name, card):
            assert launched == [profiling.DEVICE_SPANS.index(name)]
        assert launched[-1] == end and len(launched) == 2
    launched.clear()
    with profiling.span("physics.solver", torch.device("cpu")), \
            profiling.span("physics.solver"), \
            profiling.span("program:step", card):
        pass
    assert launched == []


def test_span_without_a_profiler_dispatches_no_op():
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as counter:
        with profiling.span("physics.solver", torch.device("cpu")):
            pass
        with profiling.span("ecs.transforms"):
            pass
    assert counter.n == 0 and not profiling.profiler_on()
    with torch.profiler.profile():
        assert profiling.profiler_on()


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(graphs, "cpu_graph_class", RecordingGraph)


def test_capture_s_grows_once_a_capture(captured):
    state, static = build_falling_boxes(4, seed=3, device="cpu")
    run = make_multi_step_fn(static, 3)
    inp = InputFrame.zero("cpu")
    before = dict(graphs.stats)
    state = run(state, inp)
    after = dict(graphs.stats)
    assert after["captures"] == before["captures"] + 1
    assert after["capture_s"] > before["capture_s"]
    run(state, inp)
    assert graphs.stats["capture_s"] == after["capture_s"]
    assert graphs.stats["captures"] == after["captures"]


@pytest.mark.parametrize("kind", list(ORDER))
def test_outputs_bit_equal_under_the_profiler(kind):
    fn = _call(kind)
    plain = graphs.owned(fn())
    traced, _ = _traced(fn)
    a, spec_a = graphs.flatten(plain)
    b, spec_b = graphs.flatten(traced)
    assert spec_a == spec_b and len(a) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_trace_summary_splits_device_time_by_marker(tmp_path):
    """Kernels k1 (stage a), k2 and a copy (stage b), k3 after the end
    marker (no stage); a gap inside ``program:step``'s launch."""
    def x(cat, name, ts_, dur, pid=0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts_, "dur": dur,
                "pid": pid, "tid": 7}

    events = [
        x("cpu_op", "outer", 0.0, 100.0, pid=1),
        x("user_annotation", "program:step", 10.0, 60.0, pid=1),
        x("cuda_runtime", "cudaGraphLaunch", 12.0, 50.0, pid=1),
        x("kernel", "bge_span_physics_solver", 20.0, 1.0),
        x("kernel", "k1", 21.0, 4.0),
        x("kernel", "bge_span_end", 25.0, 1.0),
        x("kernel", "bge_span_ecs_transforms", 26.0, 1.0),
        x("kernel", "k2", 27.0, 3.0),
        x("gpu_memcpy", "Memcpy DtoD", 30.0, 2.0),
        x("kernel", "bge_span_end", 32.0, 1.0),
        x("kernel", "k3", 60.0, 5.0),
    ]
    with open(tmp_path / "t.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    s = ts.summarize(ts.load_trace(str(tmp_path / "t.json")))
    assert s["spans"] == {"physics_solver": pytest.approx(0.004),
                          "ecs_transforms": pytest.approx(0.005)}
    gaps = {round(g["at_ms"], 6): g for g in s["gaps"]}
    assert sorted(gaps) == [0.0, 0.033, 0.065]
    launch, tail = gaps[0.033], gaps[0.065]      # 33..60 us, 65..100 us
    assert launch["ms"] == pytest.approx(0.027)
    assert (launch["host_op"], launch["program"]) == ("cudaGraphLaunch",
                                                      "program:step")
    assert (tail["host_op"], tail["program"]) == ("outer", None)
