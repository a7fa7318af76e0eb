"""The per-layer metrics of the stages that the program marks inside its
captured graphs, and of its graphs' capture time; each file under
``metrics/`` names one metric and binds one of these.

The program launches an empty kernel ``bge_span_<stage>`` on its stream
where a marked stage begins and ``bge_span_end`` where it ends, into the
graph it captures, so every replay runs them and the trace of the
window's replays shows them in place among the stage's kernels.  They
are matched here by their literal names (nothing of the program is
imported for the stage times), so a change to the program cannot change
how they are read:

- the traced executions' device ops (kernels, copies, fills), placed as
  :func:`trace.window_events` places them, are walked in the card's time
  order;
- ``bge_span_<x>`` closes the open stage and opens x, ``bge_span_end``
  closes the open stage; each other op adds its time to the open stage,
  and a marker adds to none (so an entry marker alone, closing the stage
  before it, reads the same);
- a stage whose marker never appears reads None, and so does a metric
  of it.

The host counter is the program's ``graphs.stats``, read at the end of
the run (set-up and window); a program without it reads None.
"""

from __future__ import annotations

import collections

from portbench.harness import trace

MARKER = "bge_span_"
MARKER_END = "bge_span_end"


def stage_ms(events: list) -> dict:
    """Device ms of each marked stage over the traced executions, by the
    stage's marker name less ``bge_span_`` (``physics_solver``)."""
    ops = sorted(((e["ts"], e["dur"], e["name"])
                  for e in trace.window_events(events)
                  if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS
                  and "dur" in e), key=lambda op: op[0])
    total, seen, stage = collections.Counter(), set(), None
    for _, dur, name in ops:
        if name.startswith(MARKER):
            stage = None if name == MARKER_END else name[len(MARKER):]
            if stage is not None:
                seen.add(stage)
        elif stage is not None:
            total[stage] += dur / 1e3
    return {s: total[s] for s in seen}


def _stages(ctx) -> dict:
    if "stage_ms" not in ctx:
        ctx["stage_ms"] = stage_ms(ctx["events"])
    return ctx["stage_ms"]


def _of(ctx, stages, per: str):
    ms = _stages(ctx)
    if any(s not in ms for s in stages):
        return None
    return sum(ms[s] for s in stages) / ctx[per]


def per_step(*stages):
    """A reader: the device ms of ``stages`` together ÷ steps traced."""
    return lambda ctx: _of(ctx, stages, "steps")


def per_frame(*stages):
    """A reader: the device ms of ``stages`` together ÷ frames (calls)
    traced."""
    return lambda ctx: _of(ctx, stages, "calls")


def _graph_stats() -> dict:
    from banggameengine_tpu_torch import graphs

    return graphs.stats


def capture_s(ctx):
    """The host's seconds in the graphs' captures, each with its eager
    warm-up."""
    stats = _graph_stats()
    if not stats.get("captures") or "capture_s" not in stats:
        return None
    return stats["capture_s"]
