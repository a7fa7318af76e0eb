"""The per-layer metrics' arithmetic, one function a kind; each file under
``metrics/`` names one metric and binds one of these.

A reader takes the traced run's context (``ctx``: ``summary``, the
copied ``summarize`` of the traced calls; ``events``, the trace;
``calls`` and ``steps`` traced; ``host_launches`` over them, from the
port's ``graphs.stats``; ``driver``, the traffic driver with the traced
calls' inputs) and returns a number, or None where the trace holds
nothing to read (no device op, a kernel that did not run).
"""

from __future__ import annotations

import types

from portbench.harness import roofline, trace
from portbench.reference.physics import broadphase_kernel as bk
from portbench.reference.render import raster_walk as ref_walk
from portbench.reference.render import resolve as ref_resolve

BROADPHASE_KERNELS = ("neighbor_lists_kernel", "group_bounds_kernel")
WALK_KERNEL = "raster_walk_kernel"
RESOLVE_KERNEL = "resolve_wide_kernel"


def _device(ctx) -> bool:
    return ctx["summary"]["device_ops"] > 0


def idle_share(ctx):
    """% of the traced window in which no kernel, copy or fill ran."""
    if not _device(ctx):
        return None
    return 100.0 * (1.0 - ctx["summary"]["busy_share"])


def kernels_per_step(ctx):
    if not _device(ctx):
        return None
    return ctx["summary"]["launches"] / ctx["steps"]


def step_device_ms(ctx):
    """Device ms (kernels, copies, fills) a step."""
    if not _device(ctx):
        return None
    return sum(k["ms"] for k in ctx["summary"]["kernels"]) / ctx["steps"]


def host_launches_per_call(ctx):
    """Graph replays, input copies and output clones a call."""
    return ctx["host_launches"] / ctx["calls"]


def frame_device_ms(ctx):
    """Device ms a frame of the kernels the frame graph's replay launched
    (the last graph launch of each traced call)."""
    ms = trace.graph_kernel_ms(ctx["events"], lambda n: n - 1,
                               lambda name: name.startswith("execution "))
    return None if ms is None else ms / ctx["calls"]


def _share(bound_ms, kernel_ms):
    if kernel_ms is None or kernel_ms <= 0:
        return None
    return 100.0 * bound_ms / kernel_ms


def broadphase_roofline(ctx):
    """Kernel #1's least time over its traced time, the work counted step
    by step (:func:`broadphase_work`)."""
    kernel = trace.kernel_ms(ctx["summary"], *BROADPHASE_KERNELS)
    if kernel is None:
        return None
    return _share(sum(broadphase_work(ctx)), kernel)


def broadphase_work(ctx) -> list[float]:
    """The least time (ms) of kernel #1's work in each traced step, from
    that step's sorted AABBs: the reference steps each traced call from
    the program's state before it, and each of its steps' broadphase
    inputs is counted as it goes."""
    drv = ctx["driver"]
    bounds = []
    plain = bk.neighbor_lists_aabb

    def counted(mn, mx, *args, max_neighbors=8, **kw):
        bounds.append(roofline.broadphase_bound(mn, mx, max_neighbors))
        return plain(mn, mx, *args, max_neighbors=max_neighbors, **kw)

    bk.neighbor_lists_aabb = counted
    try:
        for pre in drv.traced_pre:
            drv.ref_steps(pre)
    finally:
        bk.neighbor_lists_aabb = plain
    return bounds


def _frame_inputs(ctx):
    """The walk's and the resolve's inputs in each traced frame, worked
    out by the reference's plain frame from the frame's own inputs (its
    world matrices and camera)."""
    drv = ctx["driver"]
    walks, resolves = [], []
    walk, resolve = ref_walk.raster_walk, ref_resolve.resolve_tiles_wide

    def rec_walk(counts, pack, tiles_x):
        walks.append((counts, pack, tiles_x))
        return walk(counts, pack, tiles_x)

    def rec_resolve(slot, table):
        resolves.append((slot, table))
        return resolve(slot, table)

    ref_walk.raster_walk, ref_resolve.resolve_tiles_wide = (rec_walk,
                                                            rec_resolve)
    try:
        for frame in drv.traced_frames:
            drv.ref_frame(*frame)
    finally:
        ref_walk.raster_walk, ref_resolve.resolve_tiles_wide = walk, resolve
    return types.SimpleNamespace(walks=walks, resolves=resolves)


def _frames(ctx):
    if "frame_inputs" not in ctx:
        ctx["frame_inputs"] = _frame_inputs(ctx)
    return ctx["frame_inputs"]


def walk_roofline(ctx):
    kernel = trace.kernel_ms(ctx["summary"], WALK_KERNEL)
    if kernel is None:
        return None
    bound = sum(roofline.walk_bound(*a) for a in _frames(ctx).walks)
    return _share(bound, kernel)


def resolve_roofline(ctx):
    kernel = trace.kernel_ms(ctx["summary"], RESOLVE_KERNEL)
    if kernel is None:
        return None
    bound = sum(roofline.resolve_bound(*a) for a in _frames(ctx).resolves)
    return _share(bound, kernel)
