"""A ``torch.profiler`` trace of a fixed count of calls, and its summary.

:func:`summarize` is a copy of the port's
``scripts/trace_summary.summarize`` (the busy share as the union of the
card's kernel, copy and fill intervals over the traced window, kernels by
name, the longest idle gaps with the host op that spans each), kept here
so that a change to the program cannot change how it is measured.  The
port's script runs its programs eagerly; here the trace is of the calls
the window makes, on the graph route.
"""

from __future__ import annotations

import collections
import json
import os

import torch

TOP = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
CUDA_API = "cuda_"     # the categories of host-side CUDA API calls
FIRST_EXECUTION = "execution 0"
COOL_DOWN = "cool-down"


def _spans(events, keep):
    return [(e["ts"], e["ts"] + e["dur"], e) for e in events
            if e.get("ph") == "X" and keep(e.get("cat", "")) and "dur" in e]


def _is_host(cat: str) -> bool:
    return cat in HOST_CATS or cat.startswith(CUDA_API)


def _launched_at(events) -> dict:
    """Host time of each launch (a CUDA API call) by correlation id."""
    return {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("cat", "").startswith(CUDA_API)
            and "correlation" in e.get("args", {})}


def window_events(events: list) -> list:
    """The events of the traced executions: those placed (a device op by
    the host time of its launch) from the first execution's mark to the
    cool-down's."""
    def marked(name):
        return [e["ts"] for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e.get("name") == name]

    first, last = marked(FIRST_EXECUTION), marked(COOL_DOWN)
    if not first:
        return events
    t_first = min(first)
    t_last = min(last) if last else float("inf")
    launched = _launched_at(events)

    def placed(e):
        if e.get("cat") in DEVICE_CATS:
            return launched.get(e.get("args", {}).get("correlation"),
                                e["ts"])
        return e.get("ts", t_first)

    return [e for e in events if t_first <= placed(e) < t_last]


def summarize(events: list) -> dict:
    """Kernel times and counts, launches, busy share and the longest idle
    gaps of the traced executions (times in ms, totals over them)."""
    events = window_events(events)
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
    kernels = [{"name": k, "ms": total[k] / 1e3, "count": count[k]}
               for k, _ in total.most_common()]

    busy, idle, end = 0.0, [], w0
    for t0, t1, _ in dev:
        if t0 > end:
            idle.append((end, t0))
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    if w1 > end:
        idle.append((end, w1))

    def host_op(mid):
        inside = [s for s in host if s[0] <= mid <= s[1]]
        if not inside:
            return "(no op)"
        return max(inside, key=lambda s: (s[0], -s[1]))[2]["name"]

    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:TOP]
    n_kernels = sum(1 for s in dev if s[2].get("cat") == "kernel")
    return {
        "window_ms": (w1 - w0) / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / (w1 - w0) if w1 > w0 else 0.0,
        "launches": n_kernels,
        "device_ops": len(dev),
        "kernels": kernels,
        "gaps": [{"ms": (g1 - g0) / 1e3, "at_ms": (g0 - w0) / 1e3,
                  "host_op": host_op((g0 + g1) / 2)} for g0, g1 in gaps],
    }


def kernel_ms(summary: dict, *names: str) -> float | None:
    """Total ms of the device ops whose name contains one of ``names``
    (None where there is none)."""
    hits = [k["ms"] for k in summary["kernels"]
            if any(n in k["name"] for n in names)]
    return sum(hits) if hits else None


def graph_kernel_ms(events: list, launch_index, of_call) -> float | None:
    """Device ms of the kernels that graph launches replayed: the
    ``cudaGraphLaunch`` calls inside each traced execution's mark are
    numbered in time order, ``launch_index(n)`` picks one of the ``n``, and
    the kernels whose correlation id is that launch's are summed (None
    where no execution holds a graph launch).  ``of_call(name)`` says
    whether a mark names a traced execution."""
    events = window_events(events)
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and of_call(e.get("name", ""))]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat", "").startswith(CUDA_API)
                      and e.get("name", "").startswith("cudaGraphLaunch")
                      and "correlation" in e.get("args", {}))
    picked = set()
    for t0, t1 in marks:
        inside = [c for ts, c in launches if t0 <= ts <= t1]
        if inside:
            picked.add(inside[launch_index(len(inside))])
    if not picked:
        return None
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in picked) / 1e3


def traced(run_call, calls: int, sync, before=None, after=None):
    """Trace ``calls`` calls of ``run_call(i)`` (``i`` counts the traced
    ones), each inside an ``execution i`` mark, between a traced warm-up
    call and a cool-down call, each followed by ``sync()``; ``before()``
    and ``after()`` run just before the first execution and just after
    the last.  Returns the stopped profiler (:func:`events`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with torch.profiler.record_function("warm-up"):
            run_call(-1)
            sync()
        if before is not None:
            before()
        for i in range(calls):
            with torch.profiler.record_function(f"execution {i}"):
                run_call(i)
        if after is not None:
            after()
        sync()
        with torch.profiler.record_function(COOL_DOWN):
            run_call(calls)
            sync()
    finally:
        prof.stop()
    return prof


def events(prof, out_dir: str) -> list:
    """The trace's events: its Chrome trace is written to ``out_dir``, read
    and deleted."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
