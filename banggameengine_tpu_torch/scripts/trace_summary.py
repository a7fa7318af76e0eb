"""Trace one program with ``torch.profiler`` and summarize its device time.

Counterpart of the JAX repository's ``scripts/trace_summary.py``, with the
idle-gap report of its ``scripts/trace_loop.py`` folded in.  One warm-up
execution, then a trace of one more, a sync, 3 executions, a sync, and one
more execution and a sync; the summary gives, per execution of the 3:

- each device kernel's ms and count, sorted by total time (top 10 printed);
- the kernel launches;
- the share of the traced window in which the card was busy (the union of
  its kernel, copy and fill intervals over the window, from the first
  host op to the last device op);
- the 10 longest idle gaps in that window, each with the innermost host op
  (an op, an annotation, or a CUDA runtime call such as a launch or a
  sync) that spans the gap's midpoint: what the host was doing
  meanwhile, and the innermost ``program:<name>`` span there (the
  captured program being called, ``graphs.Program``);
- the device ms of each stage that ``utils/profiling.span`` marks on the
  card (``DEVICE_SPANS``): the device ops between a ``bge_span_<x>``
  marker kernel and the next marker are stage x's.

Programs: ``stress`` (one 50-step dispatch of the 10k-box world from its
200-step state), ``manyworld`` (one 50-step dispatch of the flat
many-world step, 1,000 worlds of 8 boxes, a character and a trigger, from
their 200-step state), ``demo`` (one 100-step dispatch of the demo world,
``build_demo_like``, on the default dense route, from its 480-step state:
the character on the ground), ``dense`` (one 50-step dispatch of 200 boxes,
a character and a trigger on the dense route with exact shape triggers,
from their 300-step state), ``frame_tiled``, ``frame_fused``, ``frame_flat`` and
``depth`` (the showcase at 1920x1080, as ``profile_render``), ``tick``
(``make_frame_fn`` on the 10k-box world from its 200-step state, seen by the
tick camera), ``app`` and ``overlay`` (one display frame of the app on the
default path at 1280x720, ``app.frame`` and ``render_current_frame``, from
the first second of ``play_demo``'s track: ``overlay`` with the physics
overlay (F3) and the HUD, ``play_demo --overlay``).  Under the profiler every host op costs more than without it,
so the busy share it shows is a lower bound of the untraced one.  Every
program runs on the eager route (``graphs.eager()``), from states
settled through the factories' graphs: the launches, gaps and busy share
are the eager route's.

    python3 -m banggameengine_tpu_torch.scripts.trace_summary frame_tiled [OUTDIR]
    python3 -m banggameengine_tpu_torch.scripts.trace_summary tick --device cpu --small
    python3 -m banggameengine_tpu_torch.scripts.trace_summary manyworld
    python3 -m banggameengine_tpu_torch.scripts.trace_summary demo --device cpu --small
    python3 -m banggameengine_tpu_torch.scripts.trace_summary --parse PATH [REPS]
    python3 -m banggameengine_tpu_torch.scripts.trace_summary demo --device cpu --count-ops
    python3 -m banggameengine_tpu_torch.scripts.trace_summary overlay --device cpu --small --count-ops

``--count-ops`` traces nothing: it counts the ATen ops one execution
dispatches, views left out (each launches about one kernel on the card),
on any device; the count does not depend on the device.

``PATH`` is an exported Chrome trace or a directory of them (the newest is
read).  Without ``OUTDIR`` the trace goes to a new temporary directory.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile

import torch

from banggameengine_tpu_torch import convert, graphs
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.parallel.manyworld import (
    make_flat_many_world_step,
    replicate_input,
    replicate_state,
)
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.render.pipeline import (
    make_frame_fn,
    make_render_fn,
)
from banggameengine_tpu_torch.scene.build import BuiltScene
from banggameengine_tpu_torch.scene.synthetic import (
    TICK_CAMERA_POS,
    TICK_CAMERA_YAW_PITCH,
    build_box_render,
    build_demo_like,
    build_falling_boxes,
)
from banggameengine_tpu_torch.scripts import profile_render
from banggameengine_tpu_torch.state import InputFrame
from banggameengine_tpu_torch.utils.profiling import (
    device_sync,
    span,
    start_trace,
    stop_trace,
)

REPS = 3
TOP = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
CUDA_API = "cuda_"     # the categories of host-side CUDA API calls
PROGRAMS = ("stress", "manyworld", "demo", "dense", "frame_tiled",
            "frame_fused", "frame_flat", "depth", "tick", "app", "overlay")
MAX_NEIGHBORS = 8
FIRST_EXECUTION = "execution 0"
COOL_DOWN = "cool-down"
MARKER = "bge_span_"          # a span's marker kernel: MARKER + stage
MARKER_END = "bge_span_end"
PROGRAM = "program:"          # a captured program's host span


# ---- the programs -------------------------------------------------------

def _stress_state(device, small: bool):
    """The stress world after 200 steps (``small``: 64 boxes, 20 steps),
    its static scene, a zero input and the 50-step (5) dispatch."""
    n, steps = (64, 5) if small else (10_000, 50)
    state, static = build_falling_boxes(n, seed=0, device=device)
    inp = InputFrame.zero(device)
    run = make_multi_step_fn(static, steps, broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)
    for _ in range(4):
        state = run(state, inp)
    return state, static, inp, run


def _manyworld_state(device, small: bool):
    """The flat many-world dispatch (``small``: 4 worlds, 5 steps; else
    1,000 worlds, 50 steps) and its arguments after 4 dispatches: the
    batched state and a zero input."""
    worlds, steps = (4, 5) if small else (1000, 50)
    state, static = build_falling_boxes(8, with_character=True,
                                        with_trigger=True, device=device)
    run = make_flat_many_world_step(static, worlds, state.comp_mask,
                                    num_steps=steps)
    bstate = replicate_state(state, worlds)
    binp = replicate_input(InputFrame.zero(device), worlds)
    for _ in range(4):
        bstate = run(bstate, binp)
    return run, (bstate, binp)


def _dense_route_state(name: str, device, small: bool):
    """The dense route's dispatch and its arguments, from the settled
    state: ``demo`` 100 steps a dispatch after 480 (``small``: 5 after
    20), ``dense`` 200 boxes with a character and a trigger, shape
    triggers, 50 steps a dispatch after 300 (``small``: 12 boxes, 5 after
    20)."""
    if name == "demo":
        state, static = build_demo_like(device=device)
        steps, settle = (5, 20) if small else (100, 480)
        kw = {}
    else:
        state, static = build_falling_boxes(
            12 if small else 200, seed=1, with_character=True,
            with_trigger=True, device=device)
        steps, settle = (5, 20) if small else (50, 300)
        kw = dict(trigger_mode="shape")
    inp = InputFrame.zero(device)
    run = make_multi_step_fn(static, steps, **kw)
    for _ in range(settle // steps):
        state = run(state, inp)
    state = make_multi_step_fn(static, settle % steps, **kw)(state, inp)
    return run, (state, inp)


def _app_frame(name: str, device, small: bool):
    """One display frame of the app on the default path (``small``:
    128x72) after the first second of ``play_demo``'s track (the
    character landed); ``overlay`` with F3 and the HUD.  Each execution
    advances the app by one display frame of the track's idle input."""
    from banggameengine_tpu_torch.app.application import Application
    from banggameengine_tpu_torch.scripts.play_demo import (
        REPO_ASSETS, apply_track)

    fps = 30
    width, height = (128, 72) if small else (1280, 720)
    app = Application(assets_root=REPO_ASSETS, width=width, height=height,
                      device=device)
    app.physics_overlay = name == "overlay"
    cj = app.built.find_entity("cj")
    for i in range(fps):
        apply_track(app, i, fps, cj)
        app.frame(real_dt=1.0 / fps)

    def display_frame():
        app.frame(real_dt=1.0 / fps)
        return app.render_current_frame(hud=name == "overlay"), app.state

    return display_frame, ()


def build(name: str, device="cuda", small: bool = False):
    """The program ``name`` as (function, its arguments on ``device``).
    The function runs eagerly (inside ``graphs.eager()``): the trace reads
    the eager route's launches, device time and gaps.  The states are
    settled through the factories' graphs, and the arguments are copies
    of them, so every execution repeats the same dispatch."""
    fn, args = _build(name, device, small)
    return graphs.eager()(fn), graphs.owned(args)


def _build(name: str, device, small: bool):
    if name == "stress":
        state, _, inp, run = _stress_state(device, small)
        return run, (state, inp)
    if name == "manyworld":
        return _manyworld_state(device, small)
    if name in ("demo", "dense"):
        return _dense_route_state(name, device, small)
    if name in ("app", "overlay"):
        return _app_frame(name, device, small)
    if name == "tick":
        state, static, inp, _ = _stress_state(device, small)
        width, height = (profile_render.SMALL_WH if small
                         else profile_render.FULL_WH)
        built = BuiltScene(static=static, initial_state=state,
                           render=convert.render_scene_from_numpy(
                               build_box_render(static), device))
        tick = make_frame_fn(built, width, height, broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)
        cam = Camera()
        cam.position[:] = TICK_CAMERA_POS
        cam.set_yaw_pitch(*TICK_CAMERA_YAW_PITCH)
        return tick, (state, inp, cam.view_matrix(device),
                      cam.proj_matrix(width / height, device),
                      torch.as_tensor(cam.position, device=device))
    if name == "depth":
        kw = {"depth_only": True}
    elif name.startswith("frame_") and name[6:] in profile_render.ROUTES:
        kw = profile_render.ROUTES[name[6:]]
    else:
        raise ValueError(f"unknown program {name!r}; one of {PROGRAMS}")
    rs, frame_args, (width, height) = profile_render.showcase(device, small)
    return make_render_fn(rs, width, height,
                          bin_capacity=profile_render.BIN_CAPACITY,
                          **kw), frame_args


# ---- the trace ----------------------------------------------------------

def load_trace(path: str) -> list:
    """The events of an exported Chrome trace, or of the newest one in a
    directory."""
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "*.json")),
                       key=os.path.getmtime)
        if not paths:
            raise FileNotFoundError(f"no Chrome trace (*.json) in {path}")
        path = paths[-1]
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, keep):
    """(start, end, event) of the complete events whose category
    ``keep`` accepts."""
    return [(e["ts"], e["ts"] + e["dur"], e) for e in events
            if e.get("ph") == "X" and keep(e.get("cat", "")) and "dur" in e]


def _is_host(cat: str) -> bool:
    return cat in HOST_CATS or cat.startswith(CUDA_API)


def _launched_at(events) -> dict:
    """Host time of each launch (a CUDA API call) by correlation id."""
    return {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("cat", "").startswith(CUDA_API)
            and "correlation" in e.get("args", {})}


def span_ms(dev) -> dict:
    """Device ms of each marked stage over the device ops ``dev`` ((start,
    end, event), in time order): a marker ``bge_span_<x>`` closes the
    open stage and opens x, ``bge_span_end`` closes it, every other op
    adds its time to the open stage; markers add to none."""
    total, stage = collections.Counter(), None
    for t0, t1, e in dev:
        name = e["name"]
        if name.startswith(MARKER):
            stage = None if name == MARKER_END else name[len(MARKER):]
        elif stage is not None:
            total[stage] += (t1 - t0) / 1e3
    return dict(total)


def summarize(events: list, reps: int = 1) -> dict:
    """Per-execution kernel times and counts, launches, busy share, device
    ms by marked stage and the longest idle gaps of a trace of ``reps``
    executions (times in ms).

    Where the trace marks its first execution and the cool-down after the
    last (:func:`trace_and_summarize` does), what was launched before the
    one or from the other on is left out.  A device op is placed by the
    host time of its launch: the card's timestamps in a trace may sit a
    few hundred microseconds off the host's, so a gap's host op is as
    exact as that, and device time before the first host op is left out
    of the busy share."""
    def marked(name):
        return [e["ts"] for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e.get("name") == name]

    first, last = marked(FIRST_EXECUTION), marked(COOL_DOWN)
    if first:
        t_first = min(first)
        t_last = min(last) if last else float("inf")
        launched = _launched_at(events)

        def placed(e):
            if e.get("cat") in DEVICE_CATS:
                return launched.get(e.get("args", {}).get("correlation"),
                                    e["ts"])
            return e.get("ts", t_first)

        events = [e for e in events if t_first <= placed(e) < t_last]
    dev = sorted(_spans(events, DEVICE_CATS.__contains__),
                 key=lambda s: s[0])
    host = _spans(events, _is_host)
    if not host:
        raise ValueError("the trace holds no host op")
    w0 = min(s[0] for s in host)
    w1 = max(s[1] for s in host + dev)

    total, count = collections.Counter(), collections.Counter()
    for t0, t1, e in dev:
        total[e["name"]] += t1 - t0
        count[e["name"]] += 1
    kernels = [{"name": k, "ms": total[k] / 1e3 / reps,
                "count": count[k] / reps} for k, _ in total.most_common()]

    busy, idle, end = 0.0, [], w0
    for t0, t1, _ in dev:
        if t0 > end:
            idle.append((end, t0))
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    if w1 > end:
        idle.append((end, w1))

    def host_op(mid, keep=lambda name: True, default="(no op)"):
        inside = [s for s in host if s[0] <= mid <= s[1]
                  and keep(s[2]["name"])]
        if not inside:
            return default
        return max(inside, key=lambda s: (s[0], -s[1]))[2]["name"]

    def program(mid):
        return host_op(mid, lambda name: name.startswith(PROGRAM), None)

    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:TOP]
    n_kernels = sum(1 for s in dev if s[2].get("cat") == "kernel")
    return {
        "window_ms": (w1 - w0) / 1e3 / reps,
        "busy_ms": busy / 1e3 / reps,
        "busy_share": busy / (w1 - w0) if w1 > w0 else 0.0,
        "launches": n_kernels / reps,
        "kernels": kernels,
        "spans": {k: v / reps for k, v in sorted(span_ms(dev).items())},
        "gaps": [{"ms": (g1 - g0) / 1e3, "at_ms": (g0 - w0) / 1e3,
                  "host_op": host_op((g0 + g1) / 2),
                  "program": program((g0 + g1) / 2)} for g0, g1 in gaps],
    }


def print_summary(s: dict) -> None:
    print(f"{'ms/exec':>10}  {'count':>7}  kernel")
    for k in s["kernels"][:TOP]:
        print(f"{k['ms']:10.4f}  x{k['count']:<6g} {k['name'][:96]}")
    print(f"{s['launches']:g} launches per execution; the card busy "
          f"{100 * s['busy_share']:.1f} % of the window "
          f"({s['busy_ms']:.3f} of {s['window_ms']:.3f} ms per execution)")
    for name, ms in s["spans"].items():
        print(f"{ms:10.4f}  ms in stage {name}")
    for g in s["gaps"]:
        where = f" in {g['program']}" if g["program"] else ""
        print(f"   gap {g['ms']:8.3f} ms at +{g['at_ms']:.3f} ms during "
              f"[{g['host_op'][:70]}]{where}")


def parse_trace(path: str, reps: int = 1) -> dict:
    """Summarize (and print) an exported Chrome trace of ``reps``
    executions; ``path`` is the trace or a directory of traces."""
    s = summarize(load_trace(path), reps)
    print_summary(s)
    return s


def trace_and_summarize(fn, args, outdir: str | None = None) -> dict:
    """Warm ``fn(*args)`` up, then trace one more warm-up execution and a
    sync, ``REPS`` executions and a sync, and a cool-down execution and a
    sync into ``outdir`` (a new temporary directory if None), and
    summarize the ``REPS`` executions.  (A kernel launched just after the
    profiler starts, or just before it stops, can be missing from its
    record; the traced warm-up and cool-down take those places.)"""
    device_sync(fn(*args))
    outdir = outdir or tempfile.mkdtemp(prefix="trace_")
    start_trace(outdir)
    try:
        with span("warm-up"):
            device_sync(fn(*args))
        for i in range(REPS):
            with span(f"execution {i}"):
                out = fn(*args)
        device_sync(out)
        with span(COOL_DOWN):
            device_sync(fn(*args))
    finally:
        path = stop_trace()
    print(f"trace -> {path}")
    return parse_trace(path, REPS)


def count_ops(fn, args) -> int:
    """The ATen ops one execution of ``fn(*args)`` dispatches, views
    left out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count() as counter:
        fn(*args)
    return counter.n


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--parse"]:
        return parse_trace(argv[1], int(argv[2]) if len(argv) > 2 else 1)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("program", choices=PROGRAMS)
    ap.add_argument("outdir", nargs="?")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a 128x64 frame, 64 boxes, 4 worlds, short "
                         "dispatches (CPU-cheap)")
    ap.add_argument("--count-ops", action="store_true",
                    help="count one execution's ops instead of tracing")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    fn, fn_args = build(args.program, device, args.small)
    if args.count_ops:
        n = count_ops(fn, fn_args)
        print(f"{args.program}: {n} ops per execution (views left out)")
        return {"ops": n}
    return trace_and_summarize(fn, fn_args, args.outdir)


if __name__ == "__main__":
    main()
