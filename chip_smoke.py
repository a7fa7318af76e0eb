#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

Drives ``banggameengine_tpu_torch`` through its main path, the 10,000-box
stress tick, and checks it.  Phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles ``physics/csrc/neighbor_lists.cu`` for sm_90a;
3. kernel vs plain: the broadphase kernel against its plain PyTorch
   version, exactly equal (idx, count, overflow) on the stress scene at
   step 0 and after 200 steps, a saturated 96-box pile and random cases;
4. slice: 200 steps of the 10k-box scene through
   ``make_multi_step_fn(static, 50, broadphase="allpairs", max_neighbors=8)``
   with the kernel, with no host synchronisation (CUDA sync debug mode
   "error"); the kernel launches are counted; the state is finite,
   above the ground and bit-equal to the same 200 steps taken with the
   plain broadphase; a 32-box scene tracks the JAX package's trajectory
   (``tests/data/stress32_jax_golden.json``);
5. times: CUDA events, 2 warm-up and the median of 3 timed dispatches.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Without a CUDA device it exits 1.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_STRESS = 10_000
STEPS_PER_DISPATCH = 50
DISPATCHES = 4                 # 200 steps
MAX_NEIGHBORS = 8
KERNEL_SOURCE = "banggameengine_tpu_torch/physics/csrc/neighbor_lists.cu"
TPU_KERNEL = "banggameengine_tpu/physics/broadphase_pallas.py:40"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "data", "stress32_jax_golden.json")
GOLDEN_ATOL = 1e-3   # port on the card vs JAX on the CPU after 60 steps


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sorted_broadphase_inputs(state, static):
    """The broadphase inputs of one stress step, in Morton order, as
    ``physics_step`` builds them: (mn, mx, dyn, layer, mask)."""
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.physics.broadphase_kernel import (
        morton_key_xz)
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER)

    order = torch.argsort(morton_key_xz(state.pos), stable=True)
    mn, mx = shapes.shape_aabb(state.pos, state.quat, static.shape_type,
                               static.shape_size)
    alive = state.alive
    solid = alive & ((state.comp_mask & COMP_COLLIDER) != 0) & (
        (state.comp_mask & COMP_CHARACTER) == 0)
    is_dyn = (static.body_type == BODY_DYNAMIC) & alive
    dyn = torch.where(solid, is_dyn.to(torch.int32), -1)
    return (mn[order], mx[order], dyn[order], static.layer[order],
            static.mask[order])


def random_inputs(n: int, seed: int, device):
    """Random AABBs in a small box, random layer/mask bits, some rows not
    solid (dyn = -1) and some static (dyn = 0)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    half = rng.uniform(0.1, 0.8, (n, 3)).astype(np.float32)
    dyn = rng.choice(np.array([-1, 0, 1], np.int32), n, p=[0.1, 0.3, 0.6])
    layer = rng.integers(0, 4, n).astype(np.int32)
    mask = np.where(rng.random(n) < 0.5, -1,
                    rng.integers(0, 4, n)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(center - half), t(center + half), t(dyn), t(layer), t(mask))


def packed_pile(device):
    """96 unit boxes packed 4x4x6 at 0.98 spacing: every interior box
    overlaps more than 8 others, so the K = 8 lists overflow."""
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
    from banggameengine_tpu_torch.state import tree_replace

    state, static = build_falling_boxes(96, seed=4, spread=1.5,
                                        device=device)
    grid = [(x * 0.98, 0.49 + y * 0.98, z * 0.98)
            for y in range(6) for x in range(4) for z in range(4)]
    pos = torch.tensor(grid, dtype=torch.float32, device=device)
    quat = torch.zeros_like(state.quat)
    quat[:, 3] = 1.0
    return tree_replace(state, pos=pos, quat=quat), static


def cuda_ms(fn, warmup: int, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dispatch_ms(run, state, inp, warmup: int = 2, timed: int = 3):
    """Median ms of one dispatch (CUDA events) after ``warmup`` dispatches;
    each dispatch continues from the state the previous one left."""
    for _ in range(warmup):
        state = run(state, inp)
    times = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = run(state, inp)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_broadphase():
    """Route the step's broadphase through the plain PyTorch version, for
    the comparison runs only."""
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk

    kernel = bk.neighbor_lists_aabb
    bk.neighbor_lists_aabb = bk.neighbor_lists_aabb_reference
    try:
        yield
    finally:
        bk.neighbor_lists_aabb = kernel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from banggameengine_tpu_torch.engine import (
        make_multi_step_fn, make_step_fn)
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
    from banggameengine_tpu_torch.state import InputFrame

    # TF32 would round the f32 payload moves; keep every product in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {kind}")
    card = f"({smi})"

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    bk.load_kernel_library()
    print(f"[build] {KERNEL_SOURCE} for sm_90a built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel vs plain ---------------------------------------------
    state0, static = build_falling_boxes(N_STRESS, seed=0, device=dev)
    inp = InputFrame.zero(dev)
    run = make_multi_step_fn(static, STEPS_PER_DISPATCH,
                             broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)

    # the 200-step run with the plain broadphase, for case (b) and for the
    # bit-equality check of phase 4
    with plain_broadphase():
        plain_state = state0
        for _ in range(DISPATCHES):
            plain_state = run(plain_state, inp)
    torch.cuda.synchronize()

    cases = [
        (f"a: stress {N_STRESS}, step 0",
         sorted_broadphase_inputs(state0, static)),
        (f"b: stress {N_STRESS}, step {DISPATCHES * STEPS_PER_DISPATCH}",
         sorted_broadphase_inputs(plain_state, static)),
        ("c: packed 96-box pile", sorted_broadphase_inputs(*packed_pile(dev))),
    ] + [(f"d: random n={n}", random_inputs(n, seed=n, device=dev))
         for n in (1, 33, 1025)]
    max_abs_err = 0
    for name, (mn, mx, dyn, layer, mask) in cases:
        nl_k = bk.neighbor_lists_aabb(mn, mx, dyn, layer, mask,
                                      max_neighbors=MAX_NEIGHBORS)
        nl_p = bk.neighbor_lists_aabb_reference(mn, mx, dyn, layer, mask,
                                                max_neighbors=MAX_NEIGHBORS)
        lo, hi = bk.with_margin(mn, mx)
        _, count_k = bk.cuda_idx_count(lo, hi, dyn, layer, mask,
                                       MAX_NEIGHBORS)
        _, count_p = bk.plain_idx_count(lo, hi, dyn, layer, mask,
                                        MAX_NEIGHBORS)
        torch.cuda.synchronize()
        err = int((nl_k.idx - nl_p.idx).abs().max())
        max_abs_err = max(max_abs_err, err,
                          int((count_k - count_p).abs().max()))
        check(torch.equal(nl_k.idx, nl_p.idx), f"{name}: idx differs")
        check(torch.equal(count_k, count_p), f"{name}: count differs")
        check(torch.equal(nl_k.nbr_overflow, nl_p.nbr_overflow),
              f"{name}: overflow differs")
        if name.startswith("c"):
            check(int(nl_k.nbr_overflow) > 0, "pile: K = 8 not saturated")
        print(f"[kernel-vs-plain] {name}: idx, count, overflow exactly "
              f"equal (pairs kept {int(nl_k.valid.sum())}, all passing "
              f"{int(count_k.sum())}, overflow {int(nl_k.nbr_overflow)})")

    # ---- 4. the slice ---------------------------------------------------
    bk.neighbor_lists_aabb.launches = 0
    state = state0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")   # a host sync in a step raises
    try:
        for _ in range(DISPATCHES):
            state = run(state, inp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = bk.neighbor_lists_aabb.launches
    steps = DISPATCHES * STEPS_PER_DISPATCH
    check(launches == steps,
          f"kernel launched {launches} times in {steps} steps")
    alive = state.alive
    check(bool(torch.isfinite(state.pos).all())
          and bool(torch.isfinite(state.lin_vel).all())
          and bool(torch.isfinite(state.ang_vel).all()),
          f"non-finite state after {steps} steps")
    corners = shapes.box_corners(state.pos, state.quat, static.shape_size)
    lowest = float(corners[alive][..., 1].min())
    check(lowest > -0.08, f"a box corner went through the ground: {lowest}")
    check(int(state.step_idx) == steps, f"step_idx {int(state.step_idx)}")
    for field in ("pos", "quat", "lin_vel", "ang_vel", "contact_feat",
                  "contact_imp"):
        check(torch.equal(getattr(state, field), getattr(plain_state, field)),
              f"slice with the kernel differs from the plain run in {field}")
    _, events = make_step_fn(static, broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)(state, inp)
    print(f"[slice] {N_STRESS} boxes, {steps} steps in {DISPATCHES} "
          f"dispatches of {STEPS_PER_DISPATCH} ({slice_s:.1f} s wall, no "
          f"host sync): "
          f"{launches} kernel launches, state finite, lowest corner "
          f"{lowest:.4f} > -0.08, step_idx {int(state.step_idx)}, "
          f"contact_overflow of step {steps + 1}: "
          f"{int(events.contact_overflow)}")
    print(f"[slice] pos, quat, lin_vel, ang_vel, contact cache bit-equal to "
          f"the same {steps} steps with the plain broadphase")

    with open(GOLDEN) as f:
        golden = json.load(f)
    g_state, g_static = build_falling_boxes(**golden["scene"], device=dev)
    step = make_step_fn(g_static, broadphase="allpairs")
    for i in range(1, golden["steps"][-1] + 1):
        g_state, g_events = step(g_state, inp)
        rec = golden["at"].get(str(i))
        if rec is None:
            continue
        if "contact_feat" in rec:
            check(g_state.contact_feat.cpu().tolist() == rec["contact_feat"],
                  f"32-box scene: contact features differ from JAX at "
                  f"step {i}")
        err = float((g_state.pos.cpu()
                     - torch.tensor(rec["pos"])).abs().max())
        check(err < GOLDEN_ATOL,
              f"32-box scene: |pos - JAX| = {err} at step {i}")
        feats = ("contact features equal, " if "contact_feat" in rec
                 else "")
        print(f"[reference] 32 boxes vs the JAX package at step {i}: "
              f"{feats}max |pos - JAX| {err:.3g} (< {GOLDEN_ATOL})")

    # ---- 5. times -------------------------------------------------------
    mn, mx, dyn, layer, mask = cases[0][1]
    plain_ms = cuda_ms(lambda: bk.neighbor_lists_aabb_reference(
        mn, mx, dyn, layer, mask, max_neighbors=MAX_NEIGHBORS), 3, 10)
    kernel_ms = cuda_ms(lambda: bk.neighbor_lists_aabb(
        mn, mx, dyn, layer, mask, max_neighbors=MAX_NEIGHBORS), 3, 10)
    print(f"[times] broadphase alone at N={N_STRESS}, K={MAX_NEIGHBORS}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms {card}")
    with plain_broadphase():
        plain_dispatch = dispatch_ms(run, state, inp)
    kernel_dispatch = dispatch_ms(run, state, inp)
    rate_k = STEPS_PER_DISPATCH / (kernel_dispatch / 1e3)
    rate_p = STEPS_PER_DISPATCH / (plain_dispatch / 1e3)
    print(f"[times] stress {N_STRESS} boxes, {STEPS_PER_DISPATCH} steps per "
          f"dispatch: {rate_k:.2f} steps/s with the kernel "
          f"({kernel_dispatch:.1f} ms/dispatch), {rate_p:.2f} steps/s with "
          f"the plain broadphase ({plain_dispatch:.1f} ms/dispatch) {card}")

    print(json.dumps({"kernels": [{
        "name": "neighbor_lists", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
