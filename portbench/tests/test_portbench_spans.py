"""The stage readers (``harness/span_readers.py``) on hand-made traces,
and the graph counters' readers on hand-set counters.

Run: ``python -m pytest portbench/tests -q`` (from the repo root).
"""

from __future__ import annotations

import json
import os

import pytest

from portbench.harness import registry, span_readers, trace
from portbench.tests import tiny

REPO = os.path.dirname(tiny.HERE)


def x(cat, name, ts, dur, corr=None, pid=0):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": 7}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_made_trace():
    """A traced warm-up, two executions and a cool-down, each one graph
    launch.  Execution 0 marks entry and end (solver: k1; transforms: k2
    and a copy; then k3 after the end marker, in no stage); execution 1
    marks entries only (solver: k4, closed by the transforms marker;
    transforms: a fill, closed by the end marker).  The warm-up's and the
    cool-down's markers and kernels lie outside the executions' marks."""
    launch = "cudaGraphLaunch"
    return [
        x("user_annotation", "warm-up", -40.0, 30.0, pid=1),
        x("cuda_runtime", launch, -38.0, 1.0, corr=1, pid=1),
        x("kernel", "bge_span_physics_solver", -30.0, 1.0, corr=1),
        x("kernel", "w", -29.0, 7.0, corr=1),
        x("user_annotation", "execution 0", 0.0, 25.0, pid=1),
        x("user_annotation", "execution 1", 25.0, 25.0, pid=1),
        x("cuda_runtime", launch, 1.0, 1.0, corr=2, pid=1),
        x("kernel", "bge_span_physics_solver", 100.0, 1.0, corr=2),
        x("kernel", "k1", 101.0, 4.0, corr=2),
        x("kernel", "bge_span_end", 105.0, 1.0, corr=2),
        x("kernel", "bge_span_ecs_transforms", 106.0, 1.0, corr=2),
        x("kernel", "k2", 107.0, 3.0, corr=2),
        x("gpu_memcpy", "Memcpy DtoD", 110.0, 2.0, corr=2),
        x("kernel", "bge_span_end", 112.0, 1.0, corr=2),
        x("kernel", "k3", 113.0, 2.0, corr=2),
        x("cuda_runtime", launch, 26.0, 1.0, corr=3, pid=1),
        x("kernel", "bge_span_physics_solver", 120.0, 1.0, corr=3),
        x("kernel", "k4", 121.0, 5.0, corr=3),
        x("kernel", "bge_span_ecs_transforms", 126.0, 1.0, corr=3),
        x("gpu_memset", "Memset", 127.0, 6.0, corr=3),
        x("kernel", "bge_span_end", 133.0, 1.0, corr=3),
        x("user_annotation", "cool-down", 50.0, 10.0, pid=1),
        x("cuda_runtime", launch, 51.0, 1.0, corr=4, pid=1),
        x("kernel", "bge_span_physics_solver", 150.0, 1.0, corr=4),
        x("kernel", "k5", 151.0, 50.0, corr=4),
        x("cpu_op", "sync", 53.0, 5.0, pid=1),
    ]


def test_each_op_goes_to_the_stage_between_its_markers():
    ms = span_readers.stage_ms(hand_made_trace())
    assert ms == {"physics_solver": pytest.approx(0.009),      # k1 + k4
                  "ecs_transforms": pytest.approx(0.011)}      # k2, copy, fill


def test_ops_outside_the_executions_count_for_nothing():
    events = hand_made_trace()
    # the warm-up's and the cool-down's kernels made 10 times longer and
    # their markers moved: the executions read the same
    for e in events:
        if e["name"] in ("w", "k5"):
            e["dur"] *= 10
    events.append(x("kernel", "bge_span_physics_broadphase", 152.0, 1.0,
                    corr=4))
    assert span_readers.stage_ms(events) == span_readers.stage_ms(
        hand_made_trace())


def test_a_missing_marker_reads_none():
    ctx = {"events": hand_made_trace(), "calls": 2, "steps": 4}
    assert span_readers.per_step("physics_broadphase")(ctx) is None
    assert span_readers.per_step("physics_solver",
                                 "physics_integrate")(ctx) is None
    assert span_readers.per_step("physics_solver")(ctx) == pytest.approx(
        0.009 / 4)
    assert span_readers.per_frame("ecs_transforms")(ctx) == pytest.approx(
        0.011 / 2)
    # no marker at all, as in a trace of a program without them
    bare = [e for e in hand_made_trace()
            if not e["name"].startswith(span_readers.MARKER)]
    assert span_readers.stage_ms(bare) == {}


def test_stage_sums_are_the_device_ms_less_the_markers():
    events = hand_made_trace()
    summary = trace.summarize(events)
    device = sum(k["ms"] for k in summary["kernels"])
    markers = sum(k["ms"] for k in summary["kernels"]
                  if k["name"].startswith(span_readers.MARKER))
    unmarked = trace.kernel_ms(summary, "k3")        # after an end marker
    stages = span_readers.stage_ms(events)
    assert markers == pytest.approx(0.007)
    assert sum(stages.values()) == pytest.approx(device - markers - unmarked)


class _Stats:
    def __init__(self, monkeypatch, stats):
        monkeypatch.setattr(span_readers, "_graph_stats", lambda: stats)


def test_graph_counters(monkeypatch):
    _Stats(monkeypatch, {"captures": 0, "replays": 0, "copies": 0,
                         "clones": 0})           # a program without them
    assert span_readers.capture_s({}) is None
    _Stats(monkeypatch, {"captures": 2, "capture_s": 1.5})
    assert span_readers.capture_s({}) == 1.5


def test_new_metric_files_bind_their_readers(monkeypatch):
    """Every per-layer metric that reads a stage or a graph counter is a
    file under ``metrics/`` whose reader gives a number on the hand-made
    trace, or None where the trace lacks its stage."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)

    def reads_spans(name):
        with open(os.path.join(tiny.HERE, "metrics", name + ".py")) as f:
            return "span_readers" in f.read()

    names = [m["name"] for m in bench["per_layer"]
             if reads_spans(m["name"])]
    assert len(names) == 13
    _Stats(monkeypatch, {"captures": 1, "capture_s": 0.25})
    ctx = {"events": hand_made_trace(), "calls": 2, "steps": 4}
    for name in names:
        v = registry.metric_reader(tiny.HERE, name)(ctx)
        assert v is None or v > 0, name
    assert registry.metric_reader(tiny.HERE, "capture_s.setup")(ctx) == 0.25
