#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

Drives ``banggameengine_tpu_torch`` through its slices, the 10,000-box
stress tick, the shaded 1080p frame, its fused and full-carry routes, the
profiling path, the flat many-world step, the default dense route, the
application shell and its overlays and runtime scene editing, the grid
route, solid capsules on the flat step, the tiled shade over the tile
raster, the vmapped many-world step and the sharded modes on one rank,
the native OBJ loader and the windows, and checks them.  Phases, one line
each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the six kernels for sm_90a, all at once
   (``physics/csrc/neighbor_lists.cu``, ``render/csrc/raster_walk.cu``,
   ``render/csrc/resolve_wide.cu``, ``render/csrc/raster_resolve.cu``,
   ``render/csrc/raster_tile.cu``, ``scripts/csrc/gather_rows.cu``);
3. kernel vs plain: the broadphase kernel against its plain PyTorch
   version, exactly equal (idx, count, overflow; through the wrapper and
   on the raw boxes) on the stress scene at step 0 and after 200 steps, a
   saturated 96-box pile, random cases with n below a group of 32, and
   not a multiple of it or of a band of 64, and the edge cases of
   ``kernel_cases.broadphase_edge_cases``: touching boxes, NaN and +-inf
   bounds, a group of non-solid and one of static rows, two far
   clusters; beside each, the share of (band, group) pairs the block
   unions keep (``band_group_kept``): all on the pile and the random
   cases, under 0.1 on the far clusters;
4. slice: 200 steps of the 10k-box scene through
   ``make_multi_step_fn(static, 50, broadphase="allpairs", max_neighbors=8)``
   with the kernel, with no host synchronisation (CUDA sync debug mode
   "error"); the kernel launches are counted; the state is finite,
   above the ground and bit-equal to the same 200 steps taken with the
   plain broadphase; a 32-box scene tracks the JAX package's trajectory
   (``tests/data/stress32_jax_golden.json``);
5. times: the broadphase kernel alone on stress cases a and b (its union
   pre-pass and main kernel, two launches a call), the card's own time
   through ``cuda_idx_count`` (see below) and one call by CUDA events,
   with the share its unions keep; through ``neighbor_lists_aabb`` (CUDA
   events over 10 queued calls, host work included, as earlier ports
   timed it) beside the plain version and the all-pairs bound; steps/s by
   CUDA events, 2 warm-up and the median of 3 timed dispatches;
6. render build: the build times of the walk and the resolve;
7. render kernels vs plain: the walk (depth, slot) and the resolve against
   their plain PyTorch versions, exactly equal, on the inputs the showcase
   frame and the 10k-box frame give them at 1920x1080, on random packs
   with counts 0..272 over a tile count that is not a multiple of 8, and
   on random slots with -1, slots >= KL and all-sky tiles; the walk also
   on ``kernel_cases.walk_edge_case``: zero-area rows (collinear, a repeated
   corner), corners on pixel centres, slivers along a pixel row,
   triangles far larger than the tile, ties, counts 0, 1 and 272 over 13
   tiles, and a zero-area line that covers a pixel outside its box;
8. render slice, no host synchronisation: the showcase shaded and
   depth-only frames through ``make_render_fn`` (u8 1080x1920x4, sky
   0x88AAFF, bit-equal with the plain versions, within tolerance of the
   JAX package's frame ``tests/data/showcase_jax_golden.npz``), then 10
   ticks of ``make_frame_fn`` (step + frame) on the 10k-box world from its
   200-step state, seen from the ground looking up into the falling boxes,
   each kernel launched once per tick, one tick bit-equal with the plain
   versions;
9. render times: the walk kernel alone on both views, with the share of
   (warp, slot) pairs its cover boxes skip, and the resolve kernel alone
   beside its library call (one ``torch.gather``): each the card's own
   time and one call by CUDA events, beside the plain version and the
   bound; the frames and the tick by CUDA events, 2 warm-up and the
   median of 5;
10. route kernels vs plain: the fused walk + resolve (with tables and
   depth-only) and the full-carry tile raster (light and heavy passes)
   against their plain versions, exactly equal, on the inputs the fused
   and flat frames of both views give them at 1920x1080, on random cases
   and on the walk's edge rows (``kernel_cases.walk_edge_case``, and
   ``tile_edge_case``: the same rows as full-carry arguments over 13
   tiles listed in a shuffled order), where the zero-area line keeps its
   pixel outside its box in both kernels; the fused kernel's depth and
   slot equal to the walk kernel's and its planes to the resolve
   kernel's; the full-carry raster's depth and slot equal to the walk's
   on every tile its light or heavy pass covers, and on the edge rows;
11. route slice, no host synchronisation: ``shade_mode="fused"`` and
   ``shade_mode="flat"`` (``raster_backend="tile"``) frames of both views,
   each path's launches counted; the fused frames and the showcase's flat
   frame bit-equal to the tiled frames, the flat route's dropped pairs
   equal to the walk's on the showcase (printed, with the pixels that
   differ, on the 10k-box view, where the top-64 heavy cap drops more);
   every frame bit-equal with the plain versions;
12. route times: both route kernels alone, the card's own time and one
   call by CUDA events, beside the walk then the resolve kernels, their
   plain versions and bounds, with the share of (warp, slot) pairs the
   cover boxes skip in the fused walk and in each tile-raster pass (the
   three kernels share one banded walk, ``render/csrc/tile_walk.cuh``);
   then the frames of each view by CUDA events: tiled, fused, flat,
   tiled again;
13. gather kernel vs plain: the u8 row gather against its plain version,
   exactly equal, on the shade-parts probe's inputs (u8[524288, 16] at
   1920x1080 rows) and on random cases (row counts that are no power of
   two, row counts that are no multiple of the block, indices below -R,
   at -R, -1, R and beyond, 16-byte rows on an unaligned table, widths 7
   and 33), and equal to ``torch.index_select`` and ``table[idx]`` on the
   indices in [0, R);
14. the profiling path: every probe of ``scripts/profile_shade_parts`` and
   every stage of ``scripts/profile_render`` run once with host syncs
   raising, each probe within 1e-5 of its f64 sum; then both scripts'
   timers (what their ``main`` runs) on those probes and stages (the
   gather's launches counted in the probe's),
   ``scripts/trace_summary`` on ``frame_tiled`` and ``tick`` (kernels,
   launches, busy share, longest gaps) and on the gather alone; the
   gather kernel and its two library calls by the card's own time.  Every
   timer is ``banggameengine_tpu_torch/utils/profiling.py``'s;
15. the many-world slice, no hand kernel on it:
   ``parallel.make_flat_many_world_step`` at 1,000 worlds of 8 boxes, a
   character and a trigger (16,000 entities in one flat world): 200 steps
   in 4 dispatches of 50 with zero input and again with per-world input
   (seeded), no host synchronisation and no hand-kernel launch; the
   states finite and above the ground; the zero-input worlds bit-equal
   to world 0, the per-world characters apart; 50 one-step dispatches
   bit-equal to one 50-step dispatch; a 4-world run against the JAX
   package's flat step with per-world inputs
   (``tests/data/flat4_jax_golden.json``: floats within the bars it
   stores, bools exact); world-steps/s by CUDA events (2 warm-up, median
   of 5), the peak memory, and one flat step's device time by part
   (characters, contacts + solve, integrate + the trigger planes);
16. the default route (``broadphase="dense"``: all-pairs AABB neighbor
   lists, the narrowphase manifolds, the unified solver, the character
   step against every entity), no hand kernel on it: ``build_demo_like``
   (the character, the checkpoint trigger and the static ground box), 480
   zero-input steps through ``make_multi_step_fn(static, 100)`` (4
   dispatches and one of 80) and 360 steps sprinting toward the trigger
   through ``make_step_fn_with_events`` (6 dispatches of 60), no host
   synchronisation, no hand-kernel launch: the character's position
   within the JAX golden's bar (``tests/data/demo_jax_golden.json``) after
   the landing and every 60 walking steps, the trigger's Enter and Exit
   on the golden's steps; demo steps/s by CUDA events over the settling
   run's 100-step dispatches (the first the warm-up, the median of the
   other 3); then 200 boxes and a character sprinting into an exact shape
   trigger (``trigger_mode="shape"``) for 300 steps in 6 events
   dispatches of 50, held to the same golden: trigger events exact at
   every step, the character's position and on-ground flag every 50
   steps, the boxes' positions every 50 steps through step 250, each
   within the bar the golden stores; finite, every box above y = 0.2,
   ``contact_overflow`` and the neighbor lists' ``nbr_overflow`` printed;
   steps/s over those dispatches (the first the warm-up, the median of
   5) and the peak memory; the 12-box world after 60 steps against the
   golden; one demo step and one 200-box step traced (launches, device
   time, busy share);
17. the application shell (``app.Application`` on the asset tree
   ``tests/data/app_assets``, ``play_demo``'s scripted track), no hand
   kernel of its own: the fused tick (``fused_tick=True``, 4 substeps
   and a 1280x720 frame a display frame) through the whole 8-s track,
   240 display frames, and the default path (a hot-reloadable step a
   fixed step, with its events, orbit update and downward raycast, and
   ``render_current_frame()``, interpolated, every display frame) through
   the track's first ``APP_DEFAULT_SECONDS``; both held to the JAX
   golden (``tests/data/app_jax_golden.json``): the bus's Enter/Exit on
   the golden's display frames, the character within its bar after every
   display frame, at rest at y = 2.94; the last fused frame within 1
   level of the golden's 1280x720 frame on >= 99.9 % of pixels with the
   sky mask equal elsewhere; the walk and the resolve launched once a
   rendered frame; one state of each run rendered bit-equal with the
   kernels and with their plain versions; display frames/s and fixed
   steps/s of each path by the host clock, the host synchronisations a
   display frame (CUDA sync debug mode "warn") and, from the run's last
   frame traced, the launches and device time a display frame;
18. the app's overlays and the runtime scene, no hand kernel of their
   own: the default-path app at 1280x720 with the physics overlay (F3)
   and ``render_current_frame(hud=True)`` every display frame through the
   track's first ``OVERLAY_SECONDS`` (``play_demo --overlay``), held to
   the app golden as phase 17's default run; the last frame's line pass
   on the card against the same pass on the CPU (at most
   ``LINE_OFF_SHARE`` of the line pixels differ), the app's F3 frame
   equal to it and its HUD frame equal to the HUD composed on it,
   bit-equal with the plain walk and resolve; one F1 frame (no raster
   kernel); the walk and the resolve launched once a rendered frame;
   display frames/s, blocking host syncs and, from the last frame traced,
   launches and device time a display frame; the JAX app's inputs
   (``tests/data/overlay_jax_golden.npz``) rendered at 128x32, plain, F3
   and F1, each within 1 level of the JAX app's frame on >= 99.9 % of
   pixels; then ``build_scene(capacity=16, max_trigger_slots=2)`` on the
   app's tree: a crate spawned at (3, 5, 3), 300 hot-reloadable steps
   with no host sync, its track within the JAX golden's bar
   (``tests/data/lifecycle_jax_golden.json``) and at rest at y = 1.49; a
   checkpoint of step 150 saved, loaded and run to step 300 bit-equal to
   the uninterrupted run; the crate despawned, a trigger spawned into
   its recycled id around the character and its Enter on the golden's
   entity, a child reparented under a new parent; no static tensor's
   storage or shape changed; the checked step passing on the healthy
   state and raising on a NaN position with no host sync inside the
   step;
19. the grid route, solid capsules on the flat step and the tiled shade
   over the tile raster, no new kernel: the 10k-box world
   on ``broadphase="grid"`` (``GRID_KW``: a table of at least N cells)
   for 200 steps in 4 dispatches of 50 with no host sync and no hand
   kernel, its neighbor lists on the card equal to the same function's
   on the CPU on the same inputs at steps 0 and 200 (differing pairs and
   their AABB gaps to the margin printed before the check fails), both
   overflows printed, finite and above the ground, its trajectory within
   the JAX test's bars (``tests/test_contact_t.py:193-199``) of phase 4's
   all-pairs run (kernel #1), the 32-box grid golden
   (``tests/data/grid32_jax_golden.json``), steps/s by CUDA events and
   one traced step of each route; 1,000 worlds of the capsule scene
   (``tests/data/capsule_flat_jax_golden.npz``) on the flat static route
   for 240 steps: every world equal to world 0 within 1e-6, world 0
   within 2e-4 of JAX's flat step over the golden's 50 steps, the
   upright capsule at rest at hh + r +- 0.1, world-steps/s; the tiled
   shade over the tile raster on both 1080p views (launches counted, no
   host sync, bit-equal to the plain versions, the showcase bit-equal to
   the tiled frame over the walk, the pixels apart on the 10k-box view
   printed), its row-gather fallback at a resolve of 80 slots (the pixels
   that take it counted, the frame bit-equal to the full resolve), the
   256x160 frame against ``tests/data/tiled_tile_jax_golden.npz``, and
   the frames' times.  Phase 16 prints the demo's launches a step beside
   the planar character step's;
20. the sharded modes, the native loader and the windows, no hand kernel
   on them, on a one-rank NCCL group (``parallel.ranks.init_rank``): (a)
   ``make_sharded_many_world_step`` (``torch.func.vmap`` of the engine
   step) on the world mesh at 1,000 worlds of phase 15's scene, 100
   steps in dispatches of 50 with zero and with per-world input, no host
   sync, no functorch BatchedFallback warning, finite and above the
   ground, within 2e-4 of the flat step after 25 steps (bools exact), its
   ``with_metrics`` means finite, world-steps/s by CUDA events beside the
   flat step's (dispatches of 10, median of 3 after 2 warm-up), the peak
   memory of each and the vmapped step's launches (a trace of one step;
   the flat step's are phase 15's); (b) the router's layout
   on the one-rank mesh (``"flat"``) and the flat step with ``mesh=``
   bit-equal to ``mesh=None``; (c) one fully sharded step of phase 4's
   10k-box state within the JAX test's bars of the dense route from the
   same state (``warm_start=False``: the sharded solve starts cold, and
   the state's contact cache is the all-pairs route's), and the demo
   topology's 120 steps against ``tests/data/sharded_world_jax_golden.json``
   (events exact, floats within the bar it stores), with steps/s; (d) the
   entity-sharded contact phase on the 10k-box state, within 1e-5 of the
   same phase on the CPU (a gloo group); (e) the native library built with
   g++ into ``banggameengine_tpu_torch/_build/``, every mesh of
   ``tests/data/app_assets`` loaded natively within
   ``tests/test_native.py``'s bars of the Python loader,
   ``ResourceManager.load_mesh`` on the native route, and without
   ``DISPLAY`` ``XcbWindow`` raising and ``create_window`` headless; (f)
   ``dryrun_multichip(1)`` on the card.

Every kernel's ``ms`` and ``library_ms`` in the JSON line is the card's
own time for one call through the kernel's launcher (``cuda_*``, the
function its wrapper calls on CUDA tensors): ``measure_device_trials``,
the median of 5 windows of 10 calls queued behind a sleep kernel, so the
host's per-call work stays out.  ``plain_ms`` is by CUDA events (the
plain versions take milliseconds).  Each kernel's bound is the larger
of its bytes (each input read once, each output written once) over 3.35
TB/s and its f32 operations over 67 TFLOP/s, counted from this run's
inputs.  The line before the last is the kernel table as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the run exits non-zero and prints no result.  Without a CUDA device it
exits 1.  Phases 16 to 20 print their own times.

    python3 chip_smoke.py

``banggameengine_tpu_torch/scripts/compare_kernels.py`` times these
kernels against another tree's, such as the parent commit's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from banggameengine_tpu_torch import convert, kernel_cases
from banggameengine_tpu_torch.kernel_cases import (
    recorded_render_inputs,
    render_kernel_modules,
    sorted_broadphase_inputs,
)
from banggameengine_tpu_torch.scene.synthetic import (
    TICK_CAMERA_POS,
    TICK_CAMERA_YAW_PITCH,
)
from banggameengine_tpu_torch.state import FEAT_STRIDE
from banggameengine_tpu_torch.utils.profiling import (
    bound_ms,
    measure_device_trials,
    measure_throughput,
    measure_trials,
    measure_trials_chained,
)

N_STRESS = 10_000
STEPS_PER_DISPATCH = 50
DISPATCHES = 4                 # 200 steps
MAX_NEIGHBORS = 8
KERNEL_SOURCE = "banggameengine_tpu_torch/physics/csrc/neighbor_lists.cu"
TPU_KERNEL = "banggameengine_tpu/physics/broadphase_pallas.py:40"
WALK_SOURCE = "banggameengine_tpu_torch/render/csrc/raster_walk.cu"
WALK_TPU_KERNEL = "banggameengine_tpu/render/raster_resolve_pallas.py:291"
RESOLVE_SOURCE = "banggameengine_tpu_torch/render/csrc/resolve_wide.cu"
RESOLVE_TPU_KERNEL = "banggameengine_tpu/render/resolve_pallas.py:117"
FUSED_SOURCE = "banggameengine_tpu_torch/render/csrc/raster_resolve.cu"
FUSED_TPU_KERNEL = "banggameengine_tpu/render/raster_resolve_pallas.py:68"
TILE_SOURCE = "banggameengine_tpu_torch/render/csrc/raster_tile.cu"
TILE_TPU_KERNEL = "banggameengine_tpu/render/raster_pallas.py:27"
GATHER_SOURCE = "banggameengine_tpu_torch/scripts/csrc/gather_rows.cu"
GATHER_TPU_KERNEL = "scripts/profile_shade_parts.py:93"
# a probe's f32 sum against the same sum in f64: within this share of the
# sum of its terms' magnitudes (up to 2 M terms, summed in another order)
PROBE_RTOL = 1e-5
# f32 operations per (pixel, used slot) of the walk and the tile raster:
# edge functions 15, coverage compares 6, barycentric weights 4, depth 5,
# depth tests 3
RASTER_OPS = 33
# operations per (row, column) pair of the broadphase: 6 float compares,
# 8 integer tests of solidity, layer and mask, j != i, 10 ands
BROADPHASE_OPS = 25
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                    "data")
GOLDEN = os.path.join(DATA, "stress32_jax_golden.json")
GOLDEN_ATOL = 1e-3   # port on the card vs JAX on the CPU after 60 steps
FRAME_GOLDEN = os.path.join(DATA, "showcase_jax_golden.npz")
RENDER_W, RENDER_H = 1920, 1080
WALK_WARP_ROWS = 4   # a walk warp's pixels: 32 x kRows of raster_walk.cu
FRAME_TICKS = 10
SKY = (0x88, 0xAA, 0xFF, 0xFF)
# port on the card vs the JAX frame on the CPU: channels within 1 level on
# >= 99.9 % of pixels, depth within 1e-6 on >= 99.9 % (JAX's CPU compiler
# fuses multiply-adds; the card's inverse and rsqrt round differently)
FRAME_OFF_SHARE = 1e-3
DEPTH_ATOL = 1e-6
MW_WORLDS = 1000
MW_SCENE = dict(num_bodies=8, with_character=True, with_trigger=True)
MW_CHAR_ROW = 8      # build_falling_boxes' slots: boxes, character, trigger
MW_SEED = 7          # the per-world inputs
MW_GOLDEN = os.path.join(DATA, "flat4_jax_golden.json")
DEMO_GOLDEN = os.path.join(DATA, "demo_jax_golden.json")
DEMO_DISPATCH = 100   # bench_demo's steps per dispatch (bench.py:161)
DEMO_CHAR = 0         # build_demo_like's slots: character, trigger, ground
WALK_CHUNK = 60       # walking steps per events dispatch (the golden's grid)
DENSE_FLOOR = 0.2     # every box's centre above it after the dense run
APP_ASSETS = os.path.join(DATA, "app_assets")
APP_GOLDEN = os.path.join(DATA, "app_jax_golden.json")
APP_FRAMES = os.path.join(DATA, "app_jax_golden.npz")
# the default path's run: the track's first 1.0 s (the character has landed
# by frame 27; 2.5 s and 1.5 s took phase 17 over its 60 s on the H100),
# frames after the first 5 timed
APP_DEFAULT_SECONDS = 1.0
APP_DEFAULT_WARMUP = 5
OVERLAY_GOLDEN = os.path.join(DATA, "overlay_jax_golden.npz")
LIFECYCLE_GOLDEN = os.path.join(DATA, "lifecycle_jax_golden.json")
# the overlay run: the track's first second (the least phase 18 asks),
# frames after the first 5 timed
OVERLAY_SECONDS = 1.0
# the line pass on the card vs on the CPU, same inputs: differing pixels
# at most this share of the line pixels (the card's matrix products may
# round a sample across a pixel border)
LINE_OFF_SHARE = 1e-3
RESUME_AT = 150       # the runtime scene's checkpoint, of its 300 steps
# phase 19: the grid route on the stress world, its table at least N so
# that hash collisions do not decide pairs
GRID_KW = dict(broadphase="grid", grid_cell_size=2.5, grid_table_size=16384,
               grid_cell_capacity=8, max_neighbors=MAX_NEIGHBORS)
GRID_GOLDEN = os.path.join(DATA, "grid32_jax_golden.json")
CAPSULE_GOLDEN = os.path.join(DATA, "capsule_flat_jax_golden.npz")
CAPSULE_WORLDS = 1000
CAPSULE_STEPS = 240   # one-step dispatches over the golden's 50, then 38s
CAPSULE_CHUNK = 38
CAPSULE_WORLD_ATOL = 1e-6   # every world against world 0
CAPSULE_ATOL = 2e-4         # world 0 against JAX's flat step (its bar)
TILED_TILE_GOLDEN = os.path.join(DATA, "tiled_tile_jax_golden.npz")
NARROW_SLOTS = dict(shade_slots=64, heavy_shade_slots=80)
PLANAR_DEMO_LAUNCHES = 2624  # a demo step on the planar character step
#                              over every entity (PERF.md §5)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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

    state, static = build_falling_boxes(96, seed=4, spread=1.5)
    grid = [(x * 0.98, 0.49 + y * 0.98, z * 0.98)
            for y in range(6) for x in range(4) for z in range(4)]
    pos = torch.tensor(grid, dtype=torch.float32, device=device)
    quat = torch.zeros_like(state.quat)
    quat[:, 3] = 1.0
    return tree_replace(state, pos=pos, quat=quat), static


def build_in_parallel(loaders) -> list[float]:
    """Call every kernel loader at once, one thread each (each ``nvcc`` is
    its own process, each library has its own build directory), and
    return the seconds each took; the first failure raises."""
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        return list(pool.map(timed, loaders))


def median_ms(fn, warmup: int = 2, timed: int = 5) -> float:
    """Median ms of single calls of ``fn`` by CUDA events, after warm-up."""
    return statistics.median(measure_trials(
        fn, calls=1, warmup=warmup, trials=timed)) * 1e3


def device_ms(fn, calls: int = 10, trials: int = 5) -> float:
    """Median ms of the card's own work per call of ``fn`` (windows of
    queued calls held behind a sleep kernel: no host time inside)."""
    return statistics.median(measure_device_trials(
        fn, calls=calls, trials=trials)) * 1e3


def dispatch_ms(run, state, inp, warmup: int = 2, timed: int = 3):
    """Median ms of one dispatch (CUDA events) after ``warmup`` dispatches;
    each dispatch continues from the state the previous one left."""
    times, _ = measure_trials_chained(run, state, inp, calls=1,
                                      warmup=warmup, trials=timed)
    return statistics.median(times) * 1e3


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


def launch_counts() -> dict:
    return {k: getattr(m, w).launches
            for k, (m, w, _, _) in render_kernel_modules().items()}


def reset_launch_counts() -> None:
    for m, w, _, _ in render_kernel_modules().values():
        getattr(m, w).launches = 0


def hand_launches() -> int:
    """Launches of every hand kernel since the counts were last set to 0."""
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk
    from banggameengine_tpu_torch.scripts import gather_rows as gr

    return (bk.neighbor_lists_aabb.launches + gr.gather_rows_u8.launches
            + sum(launch_counts().values()))


def reset_hand_launches() -> None:
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk
    from banggameengine_tpu_torch.scripts import gather_rows as gr

    bk.neighbor_lists_aabb.launches = 0
    gr.gather_rows_u8.launches = 0
    reset_launch_counts()


@contextlib.contextmanager
def no_host_sync():
    """A host synchronisation inside raises (CUDA sync debug mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def plain_render_kernels():
    """Route the frame's render kernels through their plain PyTorch
    versions, for the comparison runs only."""
    mods = render_kernel_modules()
    saved = {k: getattr(m, w) for k, (m, w, _, _) in mods.items()}
    for m, w, _, plain in mods.values():
        setattr(m, w, plain)
    try:
        yield
    finally:
        for k, (m, w, _, _) in mods.items():
            setattr(m, w, saved[k])


def walk_work(counts, pack) -> tuple[int, int, int]:
    """(walked rows, used rows, pixel-row pairs of the used rows) of one
    walk: rows below each tile's count, and those with ok set."""
    k_pad = pack.shape[1]
    in_count = torch.arange(k_pad, device=pack.device)[None, :] < counts[:,
                                                                         None]
    walked = int(in_count.sum())
    used = int((in_count & (pack[..., 9] > 0)).sum())
    return walked, used, used * 4096


def walk_bound(counts, pack) -> tuple[float, str]:
    walked, _, pairs = walk_work(counts, pack)
    n = pack.shape[0]
    return bound_ms(4 * n + 40 * walked + 8 * n * 4096, RASTER_OPS * pairs)


def walk_skip_share(counts, pack, tiles_x: int, tile_ids=None,
                    rows: int = WALK_WARP_ROWS) -> float:
    """The share of (warp footprint, walked used slot) pairs whose cover box
    misses the footprint of 32 x ``rows`` pixels: the banded walk's skipped
    work, from the plain cover boxes.  Row i of ``pack`` lies over screen
    tile ``tile_ids[i]`` (default i)."""
    from banggameengine_tpu_torch.render import raster_walk as rwk

    box = rwk.cover_boxes(pack)                        # [tiles, K, 4]
    if tile_ids is None:
        tile_ids = torch.arange(pack.shape[0], device=pack.device)
    t = tile_ids.to(torch.int64)[:, None, None]
    wx0 = (t % tiles_x) * 128 + torch.arange(0, 128, 32,
                                             device=pack.device) + 0.5
    wy0 = (t // tiles_x) * 32 + torch.arange(0, 32, rows,
                                             device=pack.device) + 0.5
    miss_x = (wx0 + 31 < box[..., 0:1]) | (wx0 > box[..., 1:2])
    miss_y = (wy0 + rows - 1 < box[..., 2:3]) | (wy0 > box[..., 3:4])
    miss = miss_x[..., :, None] | miss_y[..., None, :]
    walked = ((torch.arange(pack.shape[1], device=pack.device)[None]
               < counts[:, None]) & (pack[..., 9] > 0))
    return float(miss[walked].float().mean())


def tile_skip_share(args) -> float:
    """:func:`walk_skip_share` of a full-carry raster pass (its arguments:
    tile_idx, x, y, z, oid, cb1, cb2, ok, tiles_x), which walks every slot
    of each listed tile."""
    tile_idx, x, y, z, _, _, _, ok, tiles_x = args
    counts = torch.full_like(tile_idx, ok.shape[1])
    return walk_skip_share(counts, kernel_cases.carry_pack(x, y, z, ok),
                           tiles_x, tile_ids=tile_idx)


def resolve_bound(slot, table) -> tuple[float, str]:
    n, c, kl = table.shape
    return bound_ms(
        4 * slot.numel() + 4 * n * c * kl + 4 * c * slot.numel(), 0)


def fused_bound(counts, pack, table) -> tuple[float, str]:
    """The walk's bytes and operations, the table columns below each
    tile's count and the resolved planes."""
    walked, _, pairs = walk_work(counts, pack)
    n = pack.shape[0]
    n_bytes = 4 * n + 40 * walked + 8 * n * 4096
    if table is not None:
        c, kl = table.shape[1:]
        cols = int(torch.clamp(counts, 0, min(kl, pack.shape[1])).sum())
        n_bytes += 4 * c * cols + 4 * c * n * 4096
    return bound_ms(n_bytes, RASTER_OPS * pairs)


def tile_bound(passes) -> tuple[float, str]:
    """Full-carry raster passes: per pass every ok flag and tile index, the
    corners, barycentric columns and id of the used slots, five planes."""
    n_bytes = ops = 0
    for args in passes:
        n, k = args[7].shape
        used = int((args[7] != 0).sum())
        n_bytes += 4 * n + 4 * n * k + 64 * used + 20 * n * 4096
        ops += RASTER_OPS * used * 4096
    return bound_ms(n_bytes, ops)


def random_walk_case(n_tiles: int, k_pad: int, tiles_x: int, seed: int,
                     device):
    """Random triangles over each tile, counts 0..k_pad, rows at and past
    the count unused (``ok = 0``), some unused rows inside too."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k_pad + 1, n_tiles).astype(np.int32)
    counts[:2] = (0, k_pad)
    shape = (n_tiles, k_pad)
    ox = (np.arange(n_tiles) % tiles_x)[:, None] * 128.0
    oy = (np.arange(n_tiles) // tiles_x)[:, None] * 32.0
    pack = np.zeros(shape + (16,), np.float32)
    pack[..., 0:3] = ((ox + rng.uniform(-10, 138, shape))[..., None]
                      + rng.uniform(-60, 60, shape + (3,)))
    pack[..., 3:6] = ((oy + rng.uniform(-10, 42, shape))[..., None]
                      + rng.uniform(-30, 30, shape + (3,)))
    pack[..., 6:9] = rng.uniform(-0.2, 1.2, shape + (3,))
    pack[..., 9] = ((np.arange(k_pad)[None, :] < counts[:, None])
                    & (rng.random(shape) < 0.9))
    return (torch.as_tensor(counts, device=device),
            torch.as_tensor(pack, device=device), tiles_x)


def random_resolve_case(n_tiles: int, c: int, kl: int, seed: int, device):
    """Random slots from -1 to KL + 39 (slots >= KL resolve to 0), two
    all-sky tiles, a finite random table."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(-1, kl + 40, (n_tiles, 4096)).astype(np.int32)
    slot[[0, n_tiles // 2]] = -1
    table = rng.standard_normal((n_tiles, c, kl)).astype(np.float32)
    return (torch.as_tensor(slot, device=device),
            torch.as_tensor(table, device=device))


def frame_front(rs, world, view, proj):
    """The frame's cull and vertex transform: (clip, tri_valid)."""
    from banggameengine_tpu_torch.render import raster as rz
    from banggameengine_tpu_torch.render.cull import entity_frustum_mask

    vis = entity_frustum_mask(rs.ent_aabb_min, rs.ent_aabb_max,
                              rs.ent_has_mesh, world, view, proj)
    tri_valid = rs.tri_valid & vis[rs.v_entity[::3].long()]
    _, clip = rz.transform_vertices(rs.v_pos, rs.v_entity, world, view, proj)
    return clip, tri_valid


def frame_overflow(rs, world, view, proj, backend: str = "walk") -> int:
    """Triangle-tile pairs the frame's binning and raster dropped (the frame
    itself does not return the count)."""
    from banggameengine_tpu_torch.render import raster as rz

    _, overflow = rz.rasterize(*frame_front(rs, world, view, proj),
                               RENDER_W, RENDER_H, bin_capacity=2048,
                               backend=backend)
    return int(overflow)


def random_tile_case(n: int, k: int, tiles_x: int, seed: int, device):
    """Random triangles over n listed tiles, a random subset of a
    tiles_x-wide grid in random order, some slots unused, random ids and
    barycentric columns: the full-carry raster's arguments."""
    rng = np.random.default_rng(seed)
    counts, pack, _ = random_walk_case(n, k, tiles_x, seed, "cpu")
    tile_idx = rng.permutation(max(n, 3 * tiles_x))[:n].astype(np.int32)
    pack = pack.numpy()
    dx = (tile_idx % tiles_x - np.arange(n) % tiles_x)[:, None, None] * 128.0
    dy = (tile_idx // tiles_x - np.arange(n) // tiles_x)[:, None, None] * 32.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(tile_idx), t((pack[..., 0:3] + dx).astype(np.float32)),
            t((pack[..., 3:6] + dy).astype(np.float32)), t(pack[..., 6:9]),
            t(rng.integers(0, 10**6, (n, k)).astype(np.int32)),
            t(rng.uniform(0, 1, (n, k, 3)).astype(np.float32)),
            t(rng.uniform(0, 1, (n, k, 3)).astype(np.float32)),
            t(pack[..., 9].astype(np.int32)), tiles_x)


def render_phases(dev, card: str, stress_state, static,
                  build_s) -> tuple[list[dict], dict]:
    """Phases 6-9: the render slice.  Returns the walk's and the resolve's
    entries of the kernel table, and the scenes, renderers and recorded
    kernel inputs the route phases reuse."""
    from banggameengine_tpu_torch import convert
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk
    from banggameengine_tpu_torch.render import raster_walk as rwk
    from banggameengine_tpu_torch.render import resolve as rsv
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.pipeline import (
        make_frame_fn, make_render_fn)
    from banggameengine_tpu_torch.scene.build import BuiltScene
    from banggameengine_tpu_torch.scene.synthetic import (
        build_box_render, build_showcase_render)
    from banggameengine_tpu_torch.state import InputFrame

    # ---- 6. build -------------------------------------------------------
    print(f"[render-build] {WALK_SOURCE} built and loaded in "
          f"{build_s[0]:.1f} s, {RESOLVE_SOURCE} in {build_s[1]:.1f} s, "
          f"{FUSED_SOURCE} in {build_s[2]:.1f} s, {TILE_SOURCE} in "
          f"{build_s[3]:.1f} s (in phase 2, in parallel with the "
          f"broadphase)")

    sc = build_showcase_render(0)
    show_rs = convert.render_scene_from_numpy(sc.render)
    cam = sc.camera
    view = cam.view_matrix()
    proj = cam.proj_matrix(RENDER_W / RENDER_H)
    cam_pos = torch.as_tensor(cam.position, device=dev)
    show_args = (torch.as_tensor(sc.world, device=dev), view, proj, cam_pos)
    tick_cam = Camera()
    tick_cam.position[:] = TICK_CAMERA_POS
    tick_cam.set_yaw_pitch(*TICK_CAMERA_YAW_PITCH)
    tick_args = (tick_cam.view_matrix(),
                 tick_cam.proj_matrix(RENDER_W / RENDER_H),
                 torch.as_tensor(tick_cam.position, device=dev))
    box_args = (stress_state.world,) + tick_args
    render = make_render_fn(show_rs, RENDER_W, RENDER_H, bin_capacity=2048,
                            return_depth=True)
    render_depth = make_render_fn(show_rs, RENDER_W, RENDER_H,
                                  bin_capacity=2048, depth_only=True)
    t0 = time.perf_counter()
    box_rs = convert.render_scene_from_numpy(build_box_render(static))
    box_render = make_render_fn(box_rs, RENDER_W, RENDER_H, bin_capacity=2048)
    print(f"[render] scenes: showcase {int(show_rs.tri_valid.sum())} "
          f"triangles, 10k-box world {int(box_rs.tri_valid.sum())} "
          f"triangles (built in {time.perf_counter() - t0:.1f} s)")

    # ---- 7. kernels vs plain --------------------------------------------
    with recorded_render_inputs() as show_in:
        render(*show_args)
    with recorded_render_inputs() as box_in:
        box_render(*box_args)
    for name, rec in (("showcase", show_in), ("10k-box world", box_in)):
        local = rec["walk"][0][0] - 16
        hist = torch.histc(local.float(), bins=9, min=0,
                           max=288).long().tolist()
        print(f"[render] {name} {RENDER_W}x{RENDER_H}: local triangles "
              f"walked per tile, max {int(local.max())}, tiles > 48: "
              f"{int((local > 48).sum())}, histogram over 0..288 in 9 "
              f"bins: {hist}")
    edge_counts, edge_pack = (torch.as_tensor(a, device=dev)
                              for a in kernel_cases.walk_edge_case())
    walk_cases = [("a: showcase 1920x1080", show_in["walk"][0]),
                  ("b: 10k-box world 1920x1080", box_in["walk"][0]),
                  ("c: random, 37 tiles, K 272",
                   random_walk_case(37, 272, 15, seed=1, device=dev)),
                  ("c: random, 510 tiles, K 13",
                   random_walk_case(510, 13, 15, seed=2, device=dev)),
                  ("e: edge rows (zero area, corners on pixel centres, "
                   "slivers, huge triangles, ties), 13 tiles, K 272",
                   (edge_counts, edge_pack, 5))]
    walk_err = 0.0
    for name, (counts, pack, tiles_x) in walk_cases:
        dep_k, slot_k = rwk.cuda_raster_walk(counts, pack, tiles_x)
        dep_p, slot_p = rwk.raster_walk_reference(counts, pack, tiles_x)
        torch.cuda.synchronize()
        walk_err = max(walk_err, float((dep_k - dep_p).abs().max()),
                       float((slot_k - slot_p).abs().max()))
        check(torch.equal(slot_k, slot_p), f"walk {name}: slot differs")
        check(torch.equal(dep_k, dep_p), f"walk {name}: depth differs")
        if name.startswith("e"):
            r, c = kernel_cases.WALK_LINE_PIXEL
            check(int(slot_k[kernel_cases.WALK_LINE_TILE, r * 128 + c]) == 0,
                  "walk edge rows: the zero-area line lost its pixel")
        print(f"[render-kernel-vs-plain] walk {name}: depth and slot "
              f"exactly equal ({int((slot_k >= 0).sum())} covered pixels, "
              f"counts {int(counts.min())} to {int(counts.max())})")
    resolve_cases = [("a: showcase 1920x1080", show_in["resolve"][0]),
                     ("b: 10k-box world 1920x1080", box_in["resolve"][0]),
                     ("d: random, 510 tiles",
                      random_resolve_case(510, 40, 272, seed=3, device=dev)),
                     ("d: random, 37 tiles",
                      random_resolve_case(37, 40, 272, seed=4, device=dev))]
    resolve_err = 0.0
    for name, (slot, table) in resolve_cases:
        check(bool(torch.isfinite(table).all()), f"resolve {name}: table "
              "not finite (the one-hot contract needs it)")
        out_k = rsv.cuda_resolve_tiles_wide(slot, table)
        out_p = rsv.resolve_tiles_wide_reference(slot, table)
        torch.cuda.synchronize()
        resolve_err = max(resolve_err, float((out_k - out_p).abs().max()))
        check(torch.equal(out_k, out_p), f"resolve {name}: differs")
        print(f"[render-kernel-vs-plain] resolve {name}: exactly equal "
              f"({tuple(out_k.shape)}, slots up to {int(slot.max())}, "
              f"KL {table.shape[2]})")

    # ---- 8. the render slice --------------------------------------------
    rwk.raster_walk.launches = rsv.resolve_tiles_wide.launches = 0
    torch.cuda.set_sync_debug_mode("error")   # a host sync raises
    try:
        frame, depth = render(*show_args)
        depth_only = render_depth(*show_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    walks, resolves = rwk.raster_walk.launches, rsv.resolve_tiles_wide.launches
    check((walks, resolves) == (2, 1),
          f"showcase frames: walk launched {walks}, resolve {resolves} times")
    check(frame.dtype == torch.uint8
          and tuple(frame.shape) == (RENDER_H, RENDER_W, 4),
          f"frame {frame.dtype}{tuple(frame.shape)}")
    sky_px = depth == 1.0
    sky = torch.tensor(SKY, dtype=torch.uint8, device=dev)
    check(bool((frame[sky_px] == sky).all()), "a background pixel is not sky")
    sky_share = float(sky_px.float().mean())
    check(0.2 < sky_share < 0.8, f"sky share {sky_share}")
    check(torch.equal(depth, depth_only), "depth-only frame differs")
    with plain_render_kernels():
        frame_p, depth_p = render(*show_args)
    torch.cuda.synchronize()
    check(torch.equal(frame, frame_p) and torch.equal(depth, depth_p),
          "showcase frame with the kernels differs from the plain versions")
    print(f"[render-slice] showcase {RENDER_W}x{RENDER_H} shaded + "
          f"depth-only frames (no host sync): walk launched {walks}x, "
          f"resolve {resolves}x; u8 {tuple(frame.shape)}, sky 0x88AAFF on "
          f"{sky_share:.4f} of pixels; bit-equal to the plain versions; "
          f"{frame_overflow(show_rs, show_args[0], view, proj)} pairs "
          f"dropped")

    g = np.load(FRAME_GOLDEN)
    gw, gh = int(g["width"]), int(g["height"])
    gsc = build_showcase_render(int(g["seed"]))
    g_frame, g_depth = make_render_fn(
        convert.render_scene_from_numpy(gsc.render), gw, gh,
        return_depth=True)(
        torch.as_tensor(gsc.world, device=dev),
        *(torch.as_tensor(g[k], device=dev)
          for k in ("view", "proj", "cam_pos")))
    g_frame, g_depth = g_frame.cpu().numpy(), g_depth.cpu().numpy()
    off = np.abs(g_frame.astype(np.int32)
                 - g["frame"].astype(np.int32)).max(-1) > 1
    sky_diff = (((g_frame == SKY).all(-1) != (g["frame"] == SKY).all(-1))
                & ~off)
    depth_off = np.abs(g_depth - g["depth"]) > DEPTH_ATOL
    check(off.mean() <= FRAME_OFF_SHARE,
          f"golden frame: {off.sum()} pixels differ by more than 1 level")
    check(not sky_diff.any(), f"golden frame: sky differs at "
          f"{sky_diff.sum()} other pixels")
    check(depth_off.mean() <= FRAME_OFF_SHARE,
          f"golden depth: {depth_off.sum()} pixels differ by > {DEPTH_ATOL}")
    print(f"[reference] showcase {gw}x{gh} vs the JAX package's frame: "
          f"{off.sum()} of {off.size} pixels off by more than 1 level, "
          f"{int((g_frame != g['frame']).any(-1).sum())} off at all, sky "
          f"mask equal elsewhere; depth off by > {DEPTH_ATOL} at "
          f"{depth_off.sum()} pixels")

    built = BuiltScene(static=static, initial_state=stress_state,
                       render=box_rs)
    tick = make_frame_fn(built, RENDER_W, RENDER_H, broadphase="allpairs",
                         max_neighbors=MAX_NEIGHBORS)
    inp = InputFrame.zero()
    state = stress_state
    bk.neighbor_lists_aabb.launches = 0
    rwk.raster_walk.launches = rsv.resolve_tiles_wide.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(FRAME_TICKS):
            state, img, events = tick(state, inp, *tick_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    launches = {"neighbor_lists": bk.neighbor_lists_aabb.launches,
                "raster_walk": rwk.raster_walk.launches,
                "resolve_wide": rsv.resolve_tiles_wide.launches}
    check(all(n == FRAME_TICKS for n in launches.values()),
          f"{FRAME_TICKS} ticks launched {launches}")
    check(tuple(img.shape) == (RENDER_H, RENDER_W, 4)
          and bool(torch.isfinite(state.pos).all()),
          "tick: bad frame or non-finite state")
    s_k, img_k, _ = tick(state, inp, *tick_args)
    with plain_broadphase(), plain_render_kernels():
        s_p, img_p, _ = tick(state, inp, *tick_args)
    torch.cuda.synchronize()
    check(torch.equal(img_k, img_p), "tick frame differs from the plain one")
    for field in ("pos", "quat", "lin_vel", "ang_vel", "world"):
        check(torch.equal(getattr(s_k, field), getattr(s_p, field)),
              f"tick state differs from the plain one in {field}")
    print(f"[render-slice] {FRAME_TICKS} ticks of make_frame_fn "
          f"(step + {RENDER_W}x{RENDER_H} frame) on the 10k-box world "
          f"from step {int(stress_state.step_idx)}, camera at "
          f"{TICK_CAMERA_POS} looking up ({tick_s:.2f} s wall, no "
          f"host sync): launches {launches}; one more tick bit-equal to the "
          f"plain versions; frame overflow "
          f"{frame_overflow(box_rs, state.world, *tick_args[:2])} pairs, "
          f"contact_overflow {int(events.contact_overflow)}, "
          f"{int((img != sky).any(-1).sum())} non-sky pixels")

    # ---- 9. times ---------------------------------------------------------
    # each kernel: the card's own time through its launcher (the JSON
    # line's ms), and one call through it by CUDA events, host work in
    walk_t = {}
    for view, (c_v, p_v, tx_v) in (("showcase", show_in["walk"][0]),
                                   ("10k-box", box_in["walk"][0])):
        walk_t[view] = w = dict(
            ms=device_ms(lambda: rwk.cuda_raster_walk(c_v, p_v, tx_v)),
            host=median_ms(lambda: rwk.cuda_raster_walk(c_v, p_v, tx_v)),
            plain=median_ms(lambda: rwk.raster_walk_reference(c_v, p_v,
                                                              tx_v)),
            bound=walk_bound(c_v, p_v))
        print(f"[times] {view} {RENDER_W}x{RENDER_H}, walk kernel alone "
              f"({tuple(p_v.shape)}): {w['ms']:.4f} ms of device time, "
              f"where the cover boxes skip "
              f"{walk_skip_share(c_v, p_v, tx_v):.4f} of (warp, slot) "
              f"pairs; one call through cuda_raster_walk {w['host']:.4f} ms "
              f"(events, host work included); plain {w['plain']:.4f} ms; "
              f"bound {w['bound'][0]:.4f} ms ({w['bound'][1]}) {card}")
    walk_ms, walk_plain_ms = walk_t["showcase"]["ms"], walk_t["showcase"][
        "plain"]
    walk_b = walk_t["showcase"]["bound"]
    slot, table = show_in["resolve"][0]
    resolve_ms = device_ms(lambda: rsv.cuda_resolve_tiles_wide(slot, table))
    resolve_host_ms = median_ms(
        lambda: rsv.cuda_resolve_tiles_wide(slot, table))
    resolve_plain_ms = median_ms(
        lambda: rsv.resolve_tiles_wide_reference(slot, table))
    # the library call: one gather from the table with a zero column
    # appended for the slots outside [0, KL)
    n_t, c_t, kl_t = table.shape
    table_z = torch.cat([table, table.new_zeros((n_t, c_t, 1))], dim=2)
    idx = torch.where((slot >= 0) & (slot < kl_t), slot, kl_t).long()
    idx = idx[:, None, :].expand(n_t, c_t, slot.shape[1])
    check(torch.equal(torch.gather(table_z, 2, idx).permute(1, 0, 2),
                      rsv.cuda_resolve_tiles_wide(slot, table)),
          "the resolve's library call differs from the kernel")
    resolve_lib_ms = device_ms(lambda: torch.gather(table_z, 2, idx))
    resolve_lib_host_ms = median_ms(lambda: torch.gather(table_z, 2, idx))
    resolve_b = resolve_bound(slot, table)
    print(f"[times] showcase {RENDER_W}x{RENDER_H}, resolve alone "
          f"({tuple(table.shape)}), device time: kernel {resolve_ms:.4f} ms, "
          f"torch.gather {resolve_lib_ms:.4f} ms; one call by events: kernel "
          f"{resolve_host_ms:.4f} ms, torch.gather {resolve_lib_host_ms:.4f}"
          f" ms, plain {resolve_plain_ms:.4f} ms; bound {resolve_b[0]:.4f} "
          f"ms ({resolve_b[1]}) {card}")
    slot_b, table_b = box_in["resolve"][0]
    box_resolve_ms = device_ms(
        lambda: rsv.cuda_resolve_tiles_wide(slot_b, table_b))
    print(f"[times] 10k-box {RENDER_W}x{RENDER_H}, resolve alone: kernel "
          f"{box_resolve_ms:.4f} ms of device time {card}")
    frame_ms = median_ms(lambda: render(*show_args))
    depth_ms = median_ms(lambda: render_depth(*show_args))
    with plain_render_kernels():
        frame_plain_ms = median_ms(lambda: render(*show_args))
    print(f"[times] showcase {RENDER_W}x{RENDER_H}: shaded frame "
          f"{frame_ms:.3f} ms ({1e3 / frame_ms:.1f} frames/s), depth-only "
          f"{depth_ms:.3f} ms ({1e3 / depth_ms:.1f} frames/s); shaded frame "
          f"with the plain versions {frame_plain_ms:.3f} ms {card}")

    def run_ticks():
        nonlocal state
        state, _, _ = tick(state, inp, *tick_args)
        return state

    with plain_broadphase(), plain_render_kernels():
        tick_plain_ms = median_ms(run_ticks)
    tick_ms = median_ms(run_ticks)
    print(f"[times] 10k-box tick (step + {RENDER_W}x{RENDER_H} frame): "
          f"{tick_ms:.2f} ms ({1e3 / tick_ms:.2f} ticks/s) with the kernels, "
          f"{tick_plain_ms:.2f} ms ({1e3 / tick_plain_ms:.2f} ticks/s) with "
          f"the plain versions {card}")

    entries = [
        {"name": "raster_walk", "route": "cuda", "source": WALK_SOURCE,
         "replaces": WALK_TPU_KERNEL, "launches": launches["raster_walk"],
         "max_abs_err": walk_err, "ms": walk_ms, "plain_ms": walk_plain_ms,
         "bound_ms": walk_b[0], "bound_by": walk_b[1], "library_ms": None},
        {"name": "resolve_wide", "route": "cuda", "source": RESOLVE_SOURCE,
         "replaces": RESOLVE_TPU_KERNEL,
         "launches": launches["resolve_wide"], "max_abs_err": resolve_err,
         "ms": resolve_ms, "plain_ms": resolve_plain_ms,
         "bound_ms": resolve_b[0], "bound_by": resolve_b[1],
         "library_ms": resolve_lib_ms},
    ]
    views = {"showcase": (show_rs, show_args, show_in),
             "10k-box": (box_rs, box_args, box_in)}
    return entries, views


def route_phases(dev, card: str, views: dict) -> list[dict]:
    """Phases 10-12: the fused and the full-carry frame routes on both
    views.  Returns the fused kernel's and the tile raster's entries of the
    kernel table."""
    from banggameengine_tpu_torch.render import raster as rz
    from banggameengine_tpu_torch.render import raster_resolve as rr
    from banggameengine_tpu_torch.render import raster_tile as rt
    from banggameengine_tpu_torch.render import raster_walk as rwk
    from banggameengine_tpu_torch.render import resolve as rsv
    from banggameengine_tpu_torch.render.pipeline import make_render_fn

    def renderer(rs, **kw):
        return make_render_fn(rs, RENDER_W, RENDER_H, bin_capacity=2048,
                              return_depth=True, **kw)

    routes = {"tiled": {}, "fused": {}, "flat": {}}
    rec = {}
    for name, (rs, args, _) in views.items():
        routes["tiled"][name] = renderer(rs)
        routes["fused"][name] = renderer(rs, shade_mode="fused")
        routes["flat"][name] = renderer(rs, shade_mode="flat",
                                        raster_backend="tile")
        with recorded_render_inputs() as r_fused:
            routes["fused"][name](*args)
        with recorded_render_inputs() as r_flat:
            routes["flat"][name](*args)
        check(len(r_fused["fused"]) == 1 and len(r_flat["tile"]) == 2,
              f"{name}: the fused frame launched {len(r_fused['fused'])} "
              f"fused kernels, the flat frame {len(r_flat['tile'])} tile "
              f"rasters")
        rec[name] = (r_fused["fused"][0], r_flat["tile"])

    # ---- 10. route kernels vs plain -------------------------------------
    rng = np.random.default_rng(5)
    fused_cases = []
    for name in views:
        counts, pack, tables, tiles_x = rec[name][0]
        fused_cases += [
            (f"{name} {RENDER_W}x{RENDER_H}", (counts, pack, tables, tiles_x)),
            (f"{name} {RENDER_W}x{RENDER_H} depth-only",
             (counts, pack, None, tiles_x))]
    for n_t, k, kl, seed in ((37, 272, 260, 6), (510, 13, 13, 7)):
        counts, pack, tiles_x = random_walk_case(n_t, k, 15, seed=seed,
                                                 device=dev)
        table = torch.as_tensor(rng.standard_normal(
            (n_t, 40, kl)).astype(np.float32), device=dev)
        fused_cases += [
            (f"random, {n_t} tiles, K {k}, KL {kl}",
             (counts, pack, table, tiles_x)),
            (f"random, {n_t} tiles, K {k}, depth-only",
             (counts, pack, None, tiles_x))]
    edge_counts, edge_pack = (torch.as_tensor(a, device=dev)
                              for a in kernel_cases.walk_edge_case())
    edge_table = torch.as_tensor(rng.standard_normal(
        (edge_pack.shape[0], 40, edge_pack.shape[1])).astype(np.float32),
        device=dev)
    edge_name = ("edge rows (zero area, corners on pixel centres, slivers, "
                 "huge triangles, ties), 13 tiles, K 272")
    fused_cases += [(f"{edge_name}, KL 272",
                     (edge_counts, edge_pack, edge_table, 5)),
                    (f"{edge_name}, depth-only",
                     (edge_counts, edge_pack, None, 5))]
    line_r, line_c = kernel_cases.WALK_LINE_PIXEL
    fused_err = 0.0
    for name, (counts, pack, tables, tiles_x) in fused_cases:
        dep_k, slot_k, res_k = rr.cuda_raster_resolve_tiles(counts, pack,
                                                            tables, tiles_x)
        dep_p, slot_p, res_p = rr.raster_resolve_tiles_reference(
            counts, pack, tables, tiles_x)
        dep_w, slot_w = rwk.cuda_raster_walk(counts, pack, tiles_x)
        torch.cuda.synchronize()
        fused_err = max(fused_err, float((dep_k - dep_p).abs().max()),
                        float((slot_k - slot_p).abs().max()))
        check(torch.equal(dep_k, dep_p) and torch.equal(slot_k, slot_p),
              f"fused {name}: depth or slot differs from the plain version")
        check(torch.equal(dep_k, dep_w) and torch.equal(slot_k, slot_w),
              f"fused {name}: depth or slot differs from the walk kernel's")
        if name.startswith("edge"):
            check(int(slot_k[kernel_cases.WALK_LINE_TILE,
                             line_r * 128 + line_c]) == 0,
                  f"fused {name}: the zero-area line lost its pixel")
        if tables is None:
            check(res_k is None, f"fused {name}: planes without tables")
            what, also = "depth and slot", "the walk kernel"
        else:
            fused_err = max(fused_err, float((res_k - res_p).abs().max()))
            check(torch.equal(res_k, res_p),
                  f"fused {name}: planes differ from the plain version")
            check(torch.equal(res_k, rsv.cuda_resolve_tiles_wide(slot_w,
                                                                 tables)),
                  f"fused {name}: planes differ from the resolve kernel's")
            what = f"depth, slot and {tables.shape[1]} resolved planes"
            also = "the walk and resolve kernels"
        print(f"[route-kernel-vs-plain] fused {name}: {what} exactly equal "
              f"to the plain version and to {also} "
              f"({int((slot_k >= 0).sum())} covered pixels, counts up to "
              f"{int(counts.max())})")

    tile_cases = []
    for name in views:
        light, heavy = rec[name][1]
        tile_cases += [(f"{name} light pass", light),
                       (f"{name} heavy pass", heavy)]
    tile_cases += [
        ("random, 64 listed of 510 tiles, K 272",
         random_tile_case(64, 272, 15, seed=8, device=dev)),
        ("random, 37 listed tiles, K 13",
         random_tile_case(37, 13, 15, seed=9, device=dev)),
        (f"{edge_name} as full-carry arguments, listed shuffled",
         tuple(torch.as_tensor(a, device=dev) if i < 8 else a
               for i, a in enumerate(kernel_cases.tile_edge_case())))]
    tile_err = 0.0
    for name, (*args, tiles_x) in tile_cases:
        out_k = rt.cuda_raster_tiles(*args, tiles_x)
        out_p = rt.raster_tiles_reference(*args, tiles_x)
        torch.cuda.synchronize()
        for plane, a, b in zip(("depth", "tri_id", "b1", "b2", "slot"),
                               out_k, out_p):
            tile_err = max(tile_err, float((a - b).abs().max()))
            check(torch.equal(a, b), f"tile raster {name}: {plane} differs")
        if name.startswith("edge"):
            order = args[0].long()
            dep_w, slot_w = rwk.cuda_raster_walk(edge_counts, edge_pack,
                                                 tiles_x)
            item = int((args[0] == kernel_cases.WALK_LINE_TILE).nonzero()[0,
                                                                         0])
            check(torch.equal(out_k[4].flatten(1), slot_w[order])
                  and torch.equal(out_k[0].flatten(1), dep_w[order]),
                  f"tile raster {name}: depth or slot differs from the "
                  f"walk kernel's on the same rows")
            check(int(out_k[4][item, line_r, line_c]) == 0,
                  f"tile raster {name}: the zero-area line lost its pixel")
        print(f"[route-kernel-vs-plain] tile raster {name}: depth, tri_id, "
              f"b1, b2 and slot exactly equal ({args[7].shape[0]} tiles x "
              f"{args[7].shape[1]} slots, {int((out_k[4] >= 0).sum())} "
              f"covered pixels)")

    for name, (rs, args, rec_in) in views.items():
        clip, tri_valid = frame_front(rs, *args[:3])
        _, _, walk_t = rz.rasterize(clip, tri_valid, RENDER_W, RENDER_H,
                                    bin_capacity=2048, return_tiled=True)
        _, _, tile_t = rz.rasterize(clip, tri_valid, RENDER_W, RENDER_H,
                                    bin_capacity=2048, backend="tile",
                                    return_tiled=True)
        # a tile is covered when the light pass walked all its locals or
        # the heavy pass re-rastered it
        local = rec_in["walk"][0][0] - rz.K_GLOBAL
        covered = local <= rz.LIGHT_CAPACITY
        covered[rec[name][1][1][0].long()] = True
        same = ((walk_t.depth == tile_t.depth)
                & (walk_t.slot == tile_t.slot)).flatten(1).all(1)
        check(bool(same[covered].all()), f"{name}: the full-carry raster's "
              f"depth or slot differs from the walk's on a covered tile")
        if name == "showcase":
            check(bool(covered.all()), "showcase: a tile is not covered")
        print(f"[route-kernel-vs-plain] {name} full-carry raster vs walk: "
              f"depth and slot equal on all {int(covered.sum())} covered "
              f"tiles of {covered.numel()} ({int(same.sum())} tiles equal "
              f"in all)")

    # ---- 11. the route slice ---------------------------------------------
    frames, launches = {}, {}
    for mode in ("fused", "flat"):
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")   # a host sync raises
        try:
            frames[mode] = {name: routes[mode][name](*args)
                            for name, (_, args, _) in views.items()}
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches[mode] = launch_counts()
        want = {"walk": 0, "resolve": 0,
                "fused": 2 if mode == "fused" else 0,
                "tile": 4 if mode == "flat" else 0}
        check(launches[mode] == want,
              f"{mode} frames: launches {launches[mode]}, expected {want}")
    frames["tiled"] = {name: routes["tiled"][name](*args)
                       for name, (_, args, _) in views.items()}
    with plain_render_kernels():
        plain = {mode: {name: routes[mode][name](*args)
                        for name, (_, args, _) in views.items()}
                 for mode in routes}
    torch.cuda.synchronize()
    sky = torch.tensor(SKY, dtype=torch.uint8, device=dev)
    for name, (rs, args, _) in views.items():
        t_frame, t_depth = frames["tiled"][name]
        for mode in routes:
            check(all(torch.equal(a, b) for a, b in
                      zip(frames[mode][name], plain[mode][name])),
                  f"{name} {mode} frame with the kernels differs from the "
                  f"plain versions")
        f_frame, f_depth = frames["fused"][name]
        check(torch.equal(f_frame, t_frame) and torch.equal(f_depth, t_depth),
              f"{name}: the fused frame differs from the tiled frame")
        l_frame, l_depth = frames["flat"][name]
        # the flat shade's background is the pixels no triangle covers; a
        # triangle that crosses the far plane covers some at depth 1.0
        vis, over_tile = rz.rasterize(*frame_front(rs, *args[:3]), RENDER_W,
                                      RENDER_H, bin_capacity=2048,
                                      backend="tile", slim=False)
        check(tuple(l_frame.shape) == (RENDER_H, RENDER_W, 4)
              and torch.equal(vis.depth, l_depth)
              and bool((l_frame[vis.tri_id < 0] == sky).all()),
              f"{name}: flat frame shape, depth or sky")
        far_px = int(((vis.tri_id >= 0) & (l_depth == 1.0)).sum())
        over_walk = frame_overflow(rs, *args[:3])
        over_tile = int(over_tile)
        diff = int((l_frame != t_frame).any(-1).sum())
        if name == "showcase":
            check(torch.equal(l_frame, t_frame)
                  and torch.equal(l_depth, t_depth),
                  "showcase: the flat frame differs from the tiled frame")
            check(over_walk == over_tile, f"showcase: the full-carry "
                  f"raster dropped {over_tile} pairs, the walk {over_walk}")
        print(f"[route-slice] {name} {RENDER_W}x{RENDER_H} (no host sync): "
              f"fused frame bit-equal to the tiled frame; flat frame differs "
              f"from it at {diff} pixels, sky where no triangle covers "
              f"({far_px} covered pixels at depth 1.0); pairs dropped: walk "
              f"{over_walk}, full-carry {over_tile}; every route bit-equal "
              f"to the plain versions")
    print(f"[route-slice] launches: fused frames of both views "
          f"{launches['fused']}, flat frames {launches['flat']}")

    # ---- 12. route times --------------------------------------------------
    t = {}
    for name in views:
        counts, pack, tables, tiles_x = rec[name][0]
        light, heavy = rec[name][1]
        runs = dict(
            fused=lambda: rr.cuda_raster_resolve_tiles(counts, pack, tables,
                                                       tiles_x),
            split=lambda: rsv.cuda_resolve_tiles_wide(
                rwk.cuda_raster_walk(counts, pack, tiles_x)[1], tables),
            light=lambda: rt.cuda_raster_tiles(*light),
            heavy=lambda: rt.cuda_raster_tiles(*heavy))
        t[name] = {k: device_ms(f) for k, f in runs.items()}
        t[name].update({f"{k}_host": median_ms(f) for k, f in runs.items()},
                       fused_b=fused_bound(counts, pack, tables),
                       tile_b=tile_bound([light[:-1], heavy[:-1]]),
                       fused_skip=walk_skip_share(counts, pack, tiles_x),
                       light_skip=tile_skip_share(light),
                       heavy_skip=tile_skip_share(heavy))
        if name == "showcase":
            t[name].update(
                fused_plain=median_ms(
                    lambda: rr.raster_resolve_tiles_reference(
                        counts, pack, tables, tiles_x)),
                light_plain=median_ms(
                    lambda: rt.raster_tiles_reference(*light)),
                heavy_plain=median_ms(
                    lambda: rt.raster_tiles_reference(*heavy)))
        r = t[name]
        print(f"[times] {name} {RENDER_W}x{RENDER_H}, device time (one call "
              f"by events, host work included): fused walk + resolve alone "
              f"{r['fused']:.4f} ({r['fused_host']:.4f}) ms, its cover boxes "
              f"skip {r['fused_skip']:.4f} of (warp, slot) pairs; walk then "
              f"resolve kernels {r['split']:.4f} ({r['split_host']:.4f}) "
              f"ms, bound {r['fused_b'][0]:.4f} ms ({r['fused_b'][1]}); tile"
              f" raster light pass ({tuple(light[7].shape)}) "
              f"{r['light']:.4f} ({r['light_host']:.4f}) ms, skip "
              f"{r['light_skip']:.4f}, heavy pass ({tuple(heavy[7].shape)}) "
              f"{r['heavy']:.4f} ({r['heavy_host']:.4f}) ms, skip "
              f"{r['heavy_skip']:.4f}, bound of both {r['tile_b'][0]:.4f} ms "
              f"({r['tile_b'][1]}) {card}")
    r = t["showcase"]
    print(f"[times] showcase plain versions: fused {r['fused_plain']:.3f} ms,"
          f" tile raster light {r['light_plain']:.3f} ms, heavy "
          f"{r['heavy_plain']:.3f} ms {card}")
    for name, (_, args, _) in views.items():
        # tiled, fused, flat, tiled: the tiled frame before and after shows
        # how far the host's load moved between the runs
        ms = [median_ms(lambda: routes[mode][name](*args))
              for mode in ("tiled", "fused", "flat", "tiled")]
        print(f"[times] {name} {RENDER_W}x{RENDER_H} frames: tiled "
              f"{ms[0]:.3f} ms, fused {ms[1]:.3f} ms, flat {ms[2]:.3f} ms, "
              f"tiled again {ms[3]:.3f} ms {card}")

    return [
        {"name": "raster_resolve", "route": "cuda", "source": FUSED_SOURCE,
         "replaces": FUSED_TPU_KERNEL,
         "launches": launches["fused"]["fused"], "max_abs_err": fused_err,
         "ms": r["fused"], "plain_ms": r["fused_plain"],
         "bound_ms": r["fused_b"][0], "bound_by": r["fused_b"][1],
         "library_ms": None},
        {"name": "raster_tile", "route": "cuda", "source": TILE_SOURCE,
         "replaces": TILE_TPU_KERNEL, "launches": launches["flat"]["tile"],
         "max_abs_err": tile_err, "ms": r["light"] + r["heavy"],
         "plain_ms": r["light_plain"] + r["heavy_plain"],
         "bound_ms": r["tile_b"][0], "bound_by": r["tile_b"][1],
         "library_ms": None},
    ]


def random_gather_case(r: int, w: int, p: int, seed: int, device,
                       offset: int = 0):
    """A random u8 table of r rows of w bytes whose data starts ``offset``
    bytes into its storage (1: not 16-byte aligned), and p indices from
    [-r - 7, r + 3], the ends and both wraps included."""
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.integers(0, 256, r * w + offset).astype(
        np.uint8), device=device)
    idx = rng.integers(-r - 7, r + 4, p).astype(np.int32)
    idx[:8] = (-r - 7, -r - 1, -r, -1, 0, r - 1, r, r + 3)
    return base[offset:].view(r, w), torch.as_tensor(idx, device=device)


def probe_reference(name: str, args) -> tuple:
    """A shade-parts probe's sum in f64 by plain indexing, and the same sum
    of its terms' magnitudes."""
    if name == "onehot_mm":
        slots, tabs = args
        terms = torch.take_along_dim(tabs.double(),
                                     slots.long()[..., None], dim=1)
        dims = (0, 2)
    elif name in ("attr_take", "texel_take"):
        terms, dims = args[0].double()[:, args[1].long()], 1
    else:
        terms, dims = args[0].double()[args[1].long()], 0
    return terms.sum(dims), terms.abs().sum(dims)


def profiling_phases(dev, card: str, build_s: float) -> list[dict]:
    """Phases 13-14: the u8 row gather against its plain version, then the
    profiling path: the shade-parts probe, the frame stage timer and the
    trace summary.  Returns the gather's entry of the kernel table."""
    from banggameengine_tpu_torch.scripts import gather_rows as gr
    from banggameengine_tpu_torch.scripts import profile_render as prr
    from banggameengine_tpu_torch.scripts import profile_shade_parts as psp
    from banggameengine_tpu_torch.scripts import trace_summary as ts

    # ---- 13. gather kernel vs plain ---------------------------------------
    print(f"[profile-build] {GATHER_SOURCE} built and loaded in "
          f"{build_s:.1f} s (in phase 2, in parallel with the others)")
    probes = psp.probes(dev)
    table, idx = probes["pl_gather"][1]
    cases = [
        (f"a: shade-parts probe, u8{list(table.shape)} at {idx.numel()} "
         f"rows", (table, idx)),
        ("b: random, R 12345, W 16, P 100003",
         random_gather_case(12345, 16, 100_003, seed=10, device=dev)),
        ("c: random, R 999, W 16 not 16-byte aligned, P 4097",
         random_gather_case(999, 16, 4097, seed=11, device=dev, offset=1)),
        ("d: random, R 1001, W 7, P 4099",
         random_gather_case(1001, 7, 4099, seed=12, device=dev)),
        ("e: random, R 257, W 33, P 513",
         random_gather_case(257, 33, 513, seed=13, device=dev)),
    ]
    gather_err = 0
    for name, (t, i) in cases:
        out_k = gr.cuda_gather_rows_u8(t, i)
        out_p = gr.gather_rows_u8_reference(t, i)
        torch.cuda.synchronize()
        gather_err = max(gather_err, int((out_k.int() - out_p.int()).abs()
                                         .max()))
        check(torch.equal(out_k, out_p), f"gather {name}: differs")
        r = t.shape[0]
        in_range = i[(i >= 0) & (i < r)]
        out_r = gr.cuda_gather_rows_u8(t, in_range)
        check(torch.equal(out_r, torch.index_select(t, 0, in_range))
              and torch.equal(out_r, t[in_range]),
              f"gather {name}: differs from index_select or table[idx] in "
              f"range")
        print(f"[gather-kernel-vs-plain] {name}: exactly equal "
              f"({int(((i < -r) | (i >= r)).sum())} indices out of range, "
              f"{int(((i < 0) & (i >= -r)).sum())} wrapped); equal to "
              f"index_select and table[idx] on the {in_range.numel()} indices in "
              f"[0, R)")

    # ---- 14. the profiling path -------------------------------------------
    # every function a window times runs once here with host syncs raising:
    # a window queues calls and syncs only at its end
    stages = prr.stages(dev)
    runs = {**{f"probe {k}": v for k, v in probes.items()},
            **{f"stage {k}": v for k, v in stages.items()}}
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {k: fn(*args) for k, (fn, args) in runs.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for name in probes:
        ref, mag = probe_reference(name, probes[name][1])
        err = float(((outs[f"probe {name}"].double() - ref).abs()
                     / mag.clamp_min(1.0)).max())
        check(err <= PROBE_RTOL, f"probe {name}: off its f64 sum by {err} "
              f"of the terms' magnitude")
    check(torch.equal(outs["probe pl_gather"], outs["probe texel_rows"]),
          "probe pl_gather differs from texel_rows (index_select)")
    print(f"[profile] {len(runs)} timed functions ({len(probes)} probes, "
          f"{len(runs) - len(probes)} stages) run without a host sync; each "
          f"probe within {PROBE_RTOL} of its f64 sum; pl_gather equal to "
          f"texel_rows")

    # the timers of profile_shade_parts.main and profile_render.main, on
    # the probes and stages built above
    gr.gather_rows_u8.launches = 0
    probe_ms = psp.time_probes(probes, dev)
    launches = gr.gather_rows_u8.launches
    check(launches > 0, "the shade-parts probe did not launch the gather")
    stage_ms = prr.time_stages(stages, dev)
    check(all(np.isfinite(v) and v > 0 for v in
              list(probe_ms.values()) + list(stage_ms.values())),
          f"a probe or stage time is not positive: {probe_ms} {stage_ms}")
    print(f"[profile] the shade-parts probe launched the gather "
          f"{launches}x; the stage timer timed {len(stage_ms)} stages "
          f"{card}")

    want = {"frame_tiled": ("raster_walk_kernel", "resolve_wide_kernel"),
            "tick": ("group_bounds_kernel", "neighbor_lists_kernel",
                     "raster_walk_kernel", "resolve_wide_kernel")}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kernels in want.items():
            print(f"[profile] trace_summary {name} {card}:")
            fn, args = ts.build(name, dev)
            s = ts.trace_and_summarize(fn, args, os.path.join(tmp, name))
            check(s["launches"] > 0 and 0.0 < s["busy_share"] <= 1.0,
                  f"trace {name}: {s['launches']} launches, busy share "
                  f"{s['busy_share']}")
            counts = {k: sum(e["count"] for e in s["kernels"]
                             if k in e["name"]) for k in kernels}
            check(all(c == 1 for c in counts.values()),
                  f"trace {name}: launches per execution {counts}")
        # the kernels of the gather's two library calls, which explain
        # their times
        for lib, fn in (("index_select",
                         lambda: torch.index_select(table, 0, idx)),
                        ("advanced_index", lambda: table[idx])):
            print(f"[profile] trace of {lib} alone at the probe's shape "
                  f"{card}:")
            ts.trace_and_summarize(fn, (), os.path.join(tmp, lib))
        # a trace of a few microseconds of work now and then records the
        # kernel in 2 of its 3 executions (as it did index_select's once):
        # trace it again, up to 3 times in all, and print each miss; the
        # time per launch is taken over the launches the trace recorded
        for attempt in range(3):
            s = ts.trace_and_summarize(
                lambda: gr.gather_rows_u8(table, idx), (),
                os.path.join(tmp, f"gather{attempt}"))
            found = [e for e in s["kernels"]
                     if "gather_rows_kernel" in e["name"]]
            if len(found) == 1 and found[0]["count"] == 1:
                break
            print(f"[profile] trace {attempt + 1} of the gather alone "
                  f"recorded {found}; tracing again")
    check(len(found) == 1 and 0 < found[0]["count"] <= 1,
          f"trace of the gather alone: {found}")
    g = found[0]
    b_ms, b_by = psp.gather_bound(table, idx)
    dev_ms = {"kernel": device_ms(lambda: gr.cuda_gather_rows_u8(table, idx)),
              "index_select": device_ms(
                  lambda: torch.index_select(table, 0, idx)),
              "advanced_index": device_ms(lambda: table[idx])}
    print(f"[times] gather alone at the probe's shape, device time: kernel "
          f"{dev_ms['kernel']:.4f} ms, index_select "
          f"{dev_ms['index_select']:.4f} ms, table[idx] "
          f"{dev_ms['advanced_index']:.4f} ms; {g['ms'] / g['count']:.4f} "
          f"ms per launch in the trace; by the probe's timer (CUDA events, "
          f"20 queued): kernel {probe_ms['gather_rows_u8']:.4f} ms, plain "
          f"{probe_ms['gather_rows_u8_reference']:.4f} ms, index_select "
          f"{probe_ms['index_select']:.4f} ms, table[idx] "
          f"{probe_ms['advanced_index']:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}) {card}")
    return [{"name": "gather_rows_u8", "route": "cuda",
             "source": GATHER_SOURCE, "replaces": GATHER_TPU_KERNEL,
             "launches": launches, "max_abs_err": gather_err,
             "ms": dev_ms["kernel"],
             "plain_ms": probe_ms["gather_rows_u8_reference"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": min(dev_ms["index_select"],
                               dev_ms["advanced_index"])}]


def manyworld_phase(dev, card: str, w: int = MW_WORLDS) -> None:
    """Phase 15: the flat many-world step at 1,000 worlds of 8 boxes, a
    character and a trigger (no hand kernel on this path)."""
    from banggameengine_tpu_torch.parallel.manyworld import (
        make_flat_many_world_step, replicate_input, replicate_state)
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
    from banggameengine_tpu_torch.state import SHAPE_BOX, InputFrame

    # ---- 15. the many-world slice ---------------------------------------
    state1, static1 = build_falling_boxes(**MW_SCENE, device=dev)
    t0 = time.perf_counter()
    run = make_flat_many_world_step(static1, w, state1.comp_mask,
                                    num_steps=STEPS_PER_DISPATCH)
    one = make_flat_many_world_step(static1, w, state1.comp_mask)
    build_s = time.perf_counter() - t0
    bstate0 = replicate_state(state1, w)
    zero_inp = replicate_input(InputFrame.zero(dev), w)
    rng = np.random.default_rng(MW_SEED)
    drive = InputFrame(
        move_forward=torch.as_tensor(
            rng.uniform(0.5, 1.0, w).astype(np.float32), device=dev),
        move_right=torch.zeros(w, device=dev),
        jump=torch.as_tensor(rng.random(w) < 0.3, device=dev),
        sprint=torch.as_tensor(rng.random(w) < 0.3, device=dev),
        cam_yaw=torch.as_tensor(
            rng.uniform(-np.pi, np.pi, w).astype(np.float32), device=dev))
    box = (static1.shape_type == SHAPE_BOX) & state1.alive
    flat_box = box.repeat(w)

    def checked(bs, what: str) -> float:
        for field in ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y"):
            check(bool(torch.isfinite(getattr(bs, field)).all()),
                  f"{what}: {field} not finite")
        corners = shapes.box_corners(
            bs.pos.reshape(-1, 3), bs.quat.reshape(-1, 4),
            static1.shape_size.repeat(w, 1))
        lowest = float(corners[flat_box][..., 1].min())
        check(lowest > -0.08,
              f"{what}: a box corner went through the ground: {lowest}")
        return lowest

    # the run: 200 steps, 4 dispatches of 50, no host sync, no hand kernel
    reset_hand_launches()
    steps = DISPATCHES * STEPS_PER_DISPATCH
    t0 = time.perf_counter()
    with no_host_sync():
        state = bstate0
        for _ in range(DISPATCHES):
            state = run(state, zero_inp)
        driven = bstate0
        for i in range(DISPATCHES):
            driven = run(driven, drive)
            if i == 1:
                driven_mid = driven    # step 100: boxes touch at 109-112
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    hand = hand_launches()
    check(hand == 0, f"the many-world path launched {hand} hand kernels")
    lowest = checked(state, "zero input")
    check(state.step_idx.tolist() == [steps] * w,
          "step_idx not in lockstep")
    _, events = one.flat_step(one.flatten(state), zero_inp)
    grounded = int(state.char_on_ground[:, MW_CHAR_ROW].sum())
    print(f"[manyworld] {w} worlds x {static1.capacity} entities "
          f"({w * static1.capacity} in one flat world; 8 boxes, a "
          f"character and a trigger each), factory built in {build_s:.2f} s; "
          f"{steps} steps in {DISPATCHES} dispatches of "
          f"{STEPS_PER_DISPATCH}, zero input, then again with per-world "
          f"input ({slice_s:.1f} s wall for both, no host sync, no hand "
          f"kernel launched): state finite, lowest box corner "
          f"{lowest:.4f} > -0.08, characters on the ground {grounded} of "
          f"{w}, contact_overflow of step {steps + 1}: "
          f"{int(events.contact_overflow)}")

    # isolation: worlds driven by the same input equal world 0 bit for bit
    def bits(a):     # [W, ...] -> the bytes of each world's entries
        return np.ascontiguousarray(a).reshape(a.shape[0], -1).view(np.uint8)

    for name, a in convert.world_state_to_numpy(state).items():
        check(bool((bits(a) == bits(a[:1])).all()),
              f"zero input: worlds differ from world 0 in {name}")
    # per-world input: the characters went their own ways
    lowest_d = checked(driven, "per-world input")
    chars = driven.pos[:, MW_CHAR_ROW]
    apart = int(((chars[1:] - chars[0]).abs().amax(dim=1) > 0.5).sum())
    check(apart >= 0.99 * (w - 1),
          f"per-world input: only {apart} characters left world 0's")
    spread = float(chars[:, [0, 2]].std())
    print(f"[manyworld] zero input: every field of every world bit-equal "
          f"to world 0; per-world input (move_forward in [0.5, 1], yaw "
          f"uniform, jump and sprint on 30 %): {apart} of {w - 1} "
          f"characters more than 0.5 from world 0's, xz spread {spread:.2f}, "
          f"lowest box corner {lowest_d:.4f}, on the ground "
          f"{int(driven.char_on_ground[:, MW_CHAR_ROW].sum())}")

    # dispatch boundaries: 50 one-step dispatches equal one 50-step one,
    # over steps 101-150, where pair features cross the seams
    mid = 2 * STEPS_PER_DISPATCH
    pair_seams = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        s1 = driven_mid
        for _ in range(STEPS_PER_DISPATCH):
            s1 = one(s1, drive)
            pair_seams += (s1.contact_feat >= FEAT_STRIDE).any()
        s50 = run(driven_mid, drive)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    a1 = convert.world_state_to_numpy(s1)
    for name, a in convert.world_state_to_numpy(s50).items():
        check(a.dtype == a1[name].dtype
              and np.array_equal(bits(a), bits(a1[name])),
              f"dispatch boundaries: {name} differs")
    pair_seams = int(pair_seams)
    check(pair_seams > 0, "dispatch boundaries: no pair feature crossed a "
          "seam")
    ground = int(((s1.contact_feat >= 0)
                  & (s1.contact_feat < FEAT_STRIDE)).sum())
    print(f"[manyworld] steps {mid + 1}-{mid + STEPS_PER_DISPATCH} with "
          f"per-world input: {STEPS_PER_DISPATCH} one-step dispatches "
          f"bit-equal to one {STEPS_PER_DISPATCH}-step dispatch in every "
          f"field; pair features in the cache at {pair_seams} of the "
          f"seams, ground features {ground} at the end")

    # the JAX golden: 4 worlds with per-world inputs
    with open(MW_GOLDEN) as f:
        golden = json.load(f)
    g1, gst = build_falling_boxes(**golden["scene"], device=dev)
    gw = golden["worlds"]
    gstep = make_flat_many_world_step(gst, gw, g1.comp_mask)
    ginp = InputFrame(**{
        k: torch.tensor(v, dtype=torch.bool if k in ("jump", "sprint")
                        else torch.float32, device=dev)
        for k, v in golden["inputs"].items()})
    gs = replicate_state(g1, gw)
    for i in range(1, golden["steps"][-1] + 1):
        gs = gstep(gs, ginp)
        rec = golden["at"].get(str(i))
        if rec is None:
            continue
        got = convert.world_state_to_numpy(gs)
        errs = {}
        for name in golden["float_fields"]:
            errs[name] = float(np.abs(got[name] - np.asarray(
                rec[name], np.float32)).max())
        for name in golden["bool_fields"]:
            check(np.array_equal(got[name], np.asarray(rec[name], bool)),
                  f"4 worlds: {name} differs from JAX at step {i}")
        print(f"[reference] 4 worlds vs the JAX flat step at step {i}: "
              f"{', '.join(golden['bool_fields'])} equal; max |port - JAX| "
              + ", ".join(f"{k} {v:.3g} (< {golden['atol'][str(i)][k]:g})"
                          for k, v in errs.items()))
        for name, err in errs.items():
            check(err < golden["atol"][str(i)][name],
                  f"4 worlds: |{name} - JAX| = {err} at step {i}")

    # the time: world-steps/s, 2 warm-up dispatches, median of 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**20
    times, _ = measure_trials_chained(run, state, zero_inp, calls=1,
                                      warmup=2, trials=5)
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = statistics.median(times) * 1e3
    rate = w * STEPS_PER_DISPATCH / (ms / 1e3)
    print(f"[times] many-world {w} worlds, {STEPS_PER_DISPATCH} steps per "
          f"dispatch: {rate:.0f} world-steps/s ({ms:.1f} ms/dispatch, "
          f"median of 5 after 2 warm-up; dispatches "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; "
          f"{rate / w:.2f} steps/s), peak memory {peak:.0f} MiB "
          f"({peak - before:.0f} MiB over the {before:.0f} MiB allocated "
          f"before) {card}")
    parts = manyworld_parts(one, static1, state1.comp_mask, state, zero_inp)
    print(f"[times] one flat step at {w} worlds, device time by part "
          f"(trace_summary: the card busy, ms per execution; launches): "
          + ", ".join(f"{k} {v['busy_ms']:.3f} ms ({v['launches']:g})"
                      for k, v in parts.items())
          + f" {card}")


def manyworld_parts(one, static1, comp_mask, state, inp) -> dict:
    """``trace_summary``'s summary of one flat step and of its parts,
    called as the step calls them on its flattened 200-step state: the
    character step, the box contacts with the solve, and the integration
    with the trigger sweep over the ``[W*T, W*B]`` planes.  (A step
    queues far more launches than the card's launch queue holds, so a
    window held behind a sleep kernel cannot time it: the trace's kernel
    intervals do.)"""
    from banggameengine_tpu_torch.scripts import trace_summary as ts
    from banggameengine_tpu_torch.parallel.manyworld import _flat_static
    from banggameengine_tpu_torch.physics import step as ps
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, BODY_KINEMATIC, COMP_CHARACTER, COMP_COLLIDER)

    fst, nb_idx, nb_val, group, cand, shifts = _flat_static(
        static1, state.alive.shape[0], comp_mask)
    fs = one.flatten(state)
    alive = fs.alive
    has_col = (fs.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    dyn = (fst.body_type == BODY_DYNAMIC) & alive
    moving = dyn | ((fst.body_type == BODY_KINEMATIC) & alive)
    solid = alive & has_col & ((fs.comp_mask & COMP_CHARACTER) == 0)
    zero = torch.zeros((), dtype=torch.int32, device=alive.device)
    fns = {
        "whole step": lambda: one.flat_step(fs, inp)[0].pos,
        "characters": lambda: ps._step_characters(
            fs, inp, fst, fs.pos, fs.quat, alive & has_col, cand,
            group)[0],
        "contacts + solve": lambda: ps._contacts_static(
            fs, fst, fs.pos, fs.quat, fs.lin_vel, fs.ang_vel, solid, dyn,
            (nb_idx, nb_val), False, static1.capacity, shifts,
            iterations=10, warm_start=True,
            momentum=ps.SOLVER_MOMENTUM)[0],
        "integrate + triggers": lambda: ps._finish_step(
            fs, fst, fs.pos, fs.quat, fs.lin_vel, fs.ang_vel,
            fs.char_vel_y, fs.char_on_ground, moving, alive, has_col,
            fst.fixed_dt, True, (fs.contact_feat, fs.contact_imp), zero,
            group=group)[0].trigger_overlap,
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, fn in fns.items():
            print(f"[profile] trace_summary of {k}, one flat step:")
            out[k] = ts.trace_and_summarize(fn, (), os.path.join(
                tmp, k.replace(" ", "_")))
    return out


def _timed(fn, *args):
    """``fn(*args)`` between two CUDA events, with no host sync: (its
    result, the events); read the events' elapsed time after a sync."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    return out, (start, end)


def _event_list(planes, first: int) -> list:
    """[steps, T, N] event planes -> [[step, trigger slot, entity], ...],
    steps counted from ``first`` (as the golden stores them)."""
    return [[i + first, t, e] for i, t, e in planes.nonzero().tolist()]


def dense_phase(dev, card: str) -> None:
    """Phase 16: the JAX package's default route (``broadphase="dense"``)
    on the demo world, the 200-box world and the 12-box world (no hand
    kernel on this path).  Every rate is timed over the checked runs' own
    dispatches (the port is eager: nothing compiles, so the first
    dispatch alone is the warm-up), so no step runs only to be timed."""
    from banggameengine_tpu_torch.engine import (
        make_multi_step_fn, make_step_fn, make_step_fn_with_events)
    from banggameengine_tpu_torch.physics.broadphase import (
        build_neighbor_lists_dense)
    from banggameengine_tpu_torch.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu_torch.scripts import trace_summary as ts
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame)

    def input_frame(values: dict) -> InputFrame:
        return InputFrame(**{
            k: torch.tensor(v, dtype=torch.bool if k in ("jump", "sprint")
                            else torch.float32, device=dev)
            for k, v in values.items()})

    # ---- 16. the demo world and the dense route ---------------------------
    t_phase = time.perf_counter()
    with open(DEMO_GOLDEN) as f:
        golden = json.load(f)
    gd = golden["demo"]
    settle, walk_steps = gd["settle_steps"], gd["walk_steps"]
    state0, static = build_demo_like(device=dev)
    zero = InputFrame.zero(dev)
    walk_inp = input_frame(gd["walk_input"])
    run = make_multi_step_fn(static, DEMO_DISPATCH)
    tail = make_multi_step_fn(static, settle % DEMO_DISPATCH)
    walk = make_step_fn_with_events(static, WALK_CHUNK)

    def char_err(s, step: int) -> float:
        got = s.pos[DEMO_CHAR].cpu().numpy()
        return float(np.abs(got - np.asarray(gd["char_pos"][str(step)],
                                             np.float32)).max())

    # the run: 480 zero-input steps, then 360 sprinting toward the trigger
    reset_hand_launches()
    t0 = time.perf_counter()
    with no_host_sync():
        state, settle_events = state0, []
        for _ in range(settle // DEMO_DISPATCH):
            state, ev = _timed(run, state, zero)
            settle_events.append(ev)
        state = tail(state, zero)
        settled = state
        chunks = []
        for _ in range(walk_steps // WALK_CHUNK):
            state, events = walk(state, walk_inp)
            chunks.append((state, events))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    hand = hand_launches()
    check(hand == 0, f"the demo launched {hand} hand kernels")
    rest = settled.pos[DEMO_CHAR].cpu().numpy()
    err = char_err(settled, settle)
    check(err < gd["atol"],
          f"demo: character at {rest} after {settle} steps, |pos - JAX| "
          f"{err}")
    check(bool(settled.char_on_ground[DEMO_CHAR]),
          "demo: the character is not on the ground")
    errs, enter, leave = [err], [], []
    for c, (s, ev) in enumerate(chunks):
        at = settle + (c + 1) * WALK_CHUNK
        errs.append(char_err(s, at))
        check(errs[-1] < gd["atol"],
              f"demo: |pos - JAX| = {errs[-1]} at step {at}")
        first = at - WALK_CHUNK + 1
        enter += (ev.trigger_enter[:, 0, DEMO_CHAR].nonzero()[:, 0]
                  + first).tolist()
        leave += (ev.trigger_exit[:, 0, DEMO_CHAR].nonzero()[:, 0]
                  + first).tolist()
    check(enter == gd["enter_steps"] and leave == gd["exit_steps"],
          f"demo: trigger Enter at {enter}, Exit at {leave}; the JAX "
          f"golden's {gd['enter_steps']}, {gd['exit_steps']}")
    print(f"[demo] build_demo_like on the default route: {settle} "
          f"zero-input steps ({settle // DEMO_DISPATCH} dispatches of "
          f"{DEMO_DISPATCH} and one of {settle % DEMO_DISPATCH}), then "
          f"{walk_steps} sprinting toward the trigger "
          f"({walk_steps // WALK_CHUNK} events dispatches of {WALK_CHUNK}); "
          f"{run_s:.1f} s wall, no host sync, no hand kernel launched")
    print(f"[demo] the character rests at y = {rest[1]:.6f} on the ground "
          f"box (on the ground: True); trigger Enter at step {enter}, Exit "
          f"at {leave} (the JAX golden's {gd['enter_steps']}, "
          f"{gd['exit_steps']}); max |pos - JAX| at steps {settle}, "
          f"{settle + WALK_CHUNK}, ..., {settle + walk_steps}: "
          f"{max(errs):.3g} (< {gd['atol']:g})")

    # the rate: demo steps/s over the settling run's 100-step dispatches
    # (bench_demo's size), the first the warm-up: the median of the rest
    times = [a.elapsed_time(b) for a, b in settle_events[1:]]
    demo_ms = statistics.median(times)
    print(f"[times] demo: {DEMO_DISPATCH / (demo_ms / 1e3):.1f} steps/s "
          f"({demo_ms:.2f} ms per {DEMO_DISPATCH}-step dispatch, median of "
          f"the {len(times)} settling dispatches after the first; "
          f"dispatches {', '.join(f'{t:.2f}' for t in times)} ms; real "
          f"time is 120 steps/s) {card}")

    # ---- the 200-box world on the dense route, exact shape triggers ------
    gdn = golden["dense"]
    every, dchar = gdn["every"], gdn["char"]
    b0, bstatic = build_falling_boxes(**gdn["scene"], device=dev)
    bwalk = input_frame(gdn["input"])
    brun = make_step_fn_with_events(bstatic, every,
                                    trigger_mode=gdn["trigger_mode"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**20
    reset_hand_launches()
    t0 = time.perf_counter()
    with no_host_sync():
        bstate, bchunks = b0, []
        for _ in range(gdn["steps"] // every):
            (bstate, bev), tev = _timed(brun, bstate, bwalk)
            bchunks.append((bstate, bev, tev))
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    hand = hand_launches()
    check(hand == 0, f"the 200-box world launched {hand} hand kernels")
    for field in ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y"):
        check(bool(torch.isfinite(getattr(bstate, field)).all()),
              f"200 boxes: {field} not finite")
    lowest = float(bstate.pos[:dchar, 1].min())
    check(lowest > DENSE_FLOOR,
          f"200 boxes: a box centre at y = {lowest} <= {DENSE_FLOOR}")
    # against the JAX golden: events exact at every step, the character's
    # position and on-ground flag every 50 steps, the boxes' positions
    # every 50 steps through the golden's last held step
    got_ev = {"enter": [], "exit": []}
    char_errs, box_errs = [], []
    for c, (s, ev, _) in enumerate(bchunks):
        at = (c + 1) * every
        got_ev["enter"] += _event_list(ev.trigger_enter, at - every + 1)
        got_ev["exit"] += _event_list(ev.trigger_exit, at - every + 1)
        pos = s.pos.cpu().numpy()
        char_errs.append(float(np.abs(
            pos[dchar] - np.asarray(gdn["char_pos"][str(at)],
                                    np.float32)).max()))
        check(char_errs[-1] < gdn["char_atol"],
              f"200 boxes: the character's |pos - JAX| = {char_errs[-1]} "
              f"at step {at}")
        check(bool(s.char_on_ground[dchar])
              == gdn["char_on_ground"][str(at)],
              f"200 boxes: char_on_ground differs from JAX at step {at}")
        if str(at) in gdn["box_pos"]:
            box_errs.append(float(np.abs(
                pos[:dchar] - np.asarray(gdn["box_pos"][str(at)],
                                         np.float32)).max()))
            check(box_errs[-1] < gdn["box_atol"],
                  f"200 boxes: |pos - JAX| = {box_errs[-1]} at step {at}")
    check(got_ev == {"enter": gdn["enter"], "exit": gdn["exit"]},
          f"200 boxes: trigger events {got_ev}; the JAX golden's "
          f"{gdn['enter']}, {gdn['exit']}")
    landed = int((bstate.lin_vel[:dchar, 1].abs() < 0.05).sum())
    overflow = max(int(ev.contact_overflow.max()) for _, ev, _ in bchunks)
    alive = bstate.alive
    has_col = (bstate.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    solid = alive & has_col & ((bstate.comp_mask & COMP_CHARACTER) == 0)
    dyn = (bstatic.body_type == BODY_DYNAMIC) & alive
    layer_ok = (((bstatic.layer[:, None] & bstatic.mask[None, :]) != 0)
                & ((bstatic.layer[None, :] & bstatic.mask[:, None]) != 0))
    nl = build_neighbor_lists_dense(
        bstate.pos, bstate.quat, bstatic.shape_type, bstatic.shape_size,
        solid[:, None] & solid[None, :] & layer_ok
        & (dyn[:, None] | dyn[None, :]), max_neighbors=8)
    print(f"[dense] {dchar} boxes, a character sprinting toward a shape "
          f"trigger ({bstatic.capacity} entity slots) on the default "
          f"route, trigger_mode='shape': {gdn['steps']} steps in "
          f"{gdn['steps'] // every} events dispatches of {every} "
          f"({dense_s:.1f} s wall, no host sync, no hand kernel): state "
          f"finite, lowest box centre {lowest:.4f} > {DENSE_FLOOR}, "
          f"{landed} boxes at rest (|v_y| < 0.05); trigger Enter "
          f"{got_ev['enter']}, Exit {got_ev['exit']} ([step, trigger, "
          f"entity], as the JAX golden's); character on the ground at "
          f"steps {every}, ..., {gdn['steps']}: "
          f"{[bool(s.char_on_ground[dchar]) for s, _, _ in bchunks]} (as "
          f"the golden's); max |pos - JAX| every {every} steps: character "
          f"{max(char_errs):.3g} (< {gdn['char_atol']:g}), boxes through "
          f"step {gdn['box_last']} {max(box_errs):.3g} "
          f"(< {gdn['box_atol']:g}); contact_overflow {overflow} (the most "
          f"in a step), nbr_overflow {int(nl.nbr_overflow)} after step "
          f"{gdn['steps']}")
    times = [a.elapsed_time(b) for _, _, (a, b) in bchunks[1:]]
    dense_ms = statistics.median(times)
    print(f"[times] dense 200: {every / (dense_ms / 1e3):.1f} steps/s "
          f"({dense_ms:.2f} ms per {every}-step events dispatch, median of "
          f"the {len(times)} after the first; dispatches "
          f"{', '.join(f'{t:.2f}' for t in times)} ms), peak memory "
          f"{peak:.1f} MiB ({peak - before:.1f} MiB over the {before:.1f} "
          f"MiB allocated before the run) {card}")

    # ---- the 12-box world against the JAX golden ---------------------------
    gb = golden["boxes"]
    s12, st12 = build_falling_boxes(**gb["scene"], device=dev)
    step12 = make_step_fn(st12)
    with no_host_sync():
        for _ in range(gb["steps"]):
            s12, _ = step12(s12, zero)
    err12 = float(np.abs(s12.pos.cpu().numpy()
                         - np.asarray(gb["pos"], np.float32)).max())
    check(err12 < gb["atol"],
          f"12 boxes: |pos - JAX| = {err12} after {gb['steps']} steps")
    print(f"[reference] 12 boxes vs the JAX package's dense route after "
          f"{gb['steps']} steps: max |pos - JAX| {err12:.3g} "
          f"(< {gb['atol']:g})")

    # ---- one step of each, traced: launches and device time --------------
    one_demo = make_step_fn(static)
    bstep = make_step_fn(bstatic, trigger_mode=gdn["trigger_mode"])
    with tempfile.TemporaryDirectory() as tmp:
        print("[profile] trace_summary of one demo step:")
        tr_demo = ts.trace_and_summarize(
            lambda: one_demo(settled, zero)[0].pos, (),
            os.path.join(tmp, "demo"))
        print("[profile] trace_summary of one 200-box step:")
        tr_dense = ts.trace_and_summarize(
            lambda: bstep(bstate, bwalk)[0].pos, (),
            os.path.join(tmp, "dense"))
    print(f"[times] one demo step on the per-slot character step: "
          f"{tr_demo['launches']:g} launches, against "
          f"{PLANAR_DEMO_LAUNCHES:,} on the planar step over every entity "
          f"(PERF.md §5) {card}")
    for name, tr in (("demo", tr_demo), ("dense 200", tr_dense)):
        print(f"[times] one {name} step, traced: {tr['launches']:g} launches, "
              f"{tr['busy_ms']:.3f} ms of device time in a "
              f"{tr['window_ms']:.3f} ms window (busy "
              f"{100 * tr['busy_share']:.1f} %); top kernels: "
              + "; ".join(f"{k['name'][:60]} {k['ms']:.4f} ms x{k['count']:g}"
                          for k in tr["kernels"][:4]) + f" {card}")
    print(f"[dense] phase 16 took {time.perf_counter() - t_phase:.1f} s")


def _app_run(app, frames: int, fps: int, render: bool = False,
             trace_dir: str | None = None, hud: bool = False):
    """Drive ``app`` through the first ``frames`` display frames of
    ``play_demo``'s track.  Returns the record the golden keeps (the
    character, on-ground flag and step count after each frame, the bus's
    Enter/Exit with their frames), each frame's wall seconds, the host
    synchronisations the app made (CUDA sync debug mode "warn", counted
    inside ``app.frame`` and ``render_current_frame`` only: the track's
    own read of the character is not the app's), the last
    ``render_current_frame(hud=hud)`` when ``render``, and the trace summary
    (``scripts/trace_summary.py``) of the last frame, traced alone (each
    frame starts with host work and ends in a blocking read, so no kernel
    of it sits at the trace's edges), so no frame runs only to be traced
    and the phase keeps within its 60 s."""
    import warnings

    from banggameengine_tpu_torch.app.events import TriggerEvent, TriggerPhase
    from banggameengine_tpu_torch.scripts import trace_summary as ts
    from banggameengine_tpu_torch.scripts.play_demo import apply_track
    from banggameengine_tpu_torch.utils.profiling import (
        device_sync, start_trace, stop_trace, trace_annotation)

    cj = app.built.find_entity("cj")
    rec = dict(char=[], on_ground=[], steps=[], events=[])

    def on_event(e):
        if e.phase is not TriggerPhase.STAY:
            rec["events"].append([app.frame_count, e.phase.value,
                                  e.trigger_entity, e.other_entity])

    unsubscribe = app.bus.subscribe(TriggerEvent, on_event)
    walls, syncs, img = [], 0, None
    for i in range(frames):
        apply_track(app, i, fps, cj)
        if i == frames - 1:
            start_trace(trace_dir)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught, \
                trace_annotation(ts.FIRST_EXECUTION if i == frames - 1
                                 else "frame"):
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                app.frame(real_dt=1.0 / fps)
                if render:
                    img = app.render_current_frame(hud=hud)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        walls.append(time.perf_counter() - t0)
        syncs += sum("synchronizing" in str(w.message) for w in caught)
        rec["char"].append(app.state.pos[cj].tolist())
        rec["on_ground"].append(bool(app.state.char_on_ground[cj]))
        rec["steps"].append(int(app.state.step_idx))
    device_sync(app.state.pos)
    t0 = time.perf_counter()
    trace = ts.parse_trace(stop_trace(), 1)
    trace["seconds"] = time.perf_counter() - t0
    unsubscribe()
    return rec, walls, syncs, img, trace


def _app_check(name: str, rec: dict, g: dict, frames: int) -> float:
    """Hold one app run to the JAX golden's first ``frames`` display
    frames: events exact, the character within the bar, on-ground flags
    and step counts equal; returns the largest |char - JAX|."""
    gp = g[name]
    events = [e for e in gp["events"] if e[0] < frames]
    check(rec["events"] == events,
          f"app ({name}): bus events {rec['events']}, the JAX golden's "
          f"{events}")
    err = float(np.abs(np.asarray(rec["char"], np.float32) - np.asarray(
        gp["char"][:frames], np.float32)).max())
    check(err < g["atol"], f"app ({name}): |char - JAX| = {err}")
    check(rec["on_ground"] == gp["on_ground"][:frames],
          f"app ({name}): char_on_ground differs from JAX")
    check(rec["steps"] == gp["steps"][:frames],
          f"app ({name}): fixed steps per display frame differ from JAX")
    rest = rec["char"][min(frames, 2 * g["fps"]) - 1][1]   # landed by 1 s
    check(abs(rest - g["rest_y"]) < 1e-4,
          f"app ({name}): the character rests at y = {rest}")
    return err


def app_phase(dev, card: str) -> None:
    """Phase 17: the application shell on the card (no hand kernel of its
    own: the walk and the resolve render its frames).  The fused app at
    1280x720 through play_demo's whole 8-s track, the default-path app
    through its first ``APP_DEFAULT_SECONDS`` with
    ``render_current_frame()`` (interpolated) every display frame; the
    last frame of each run traced; both held to the JAX golden
    (``tests/data/app_jax_golden.json``), the last fused frame to the
    golden's 1280x720 frame, one state of each rendered bit-equal with the
    kernels and with their plain versions."""
    from banggameengine_tpu_torch.app.application import Application
    from banggameengine_tpu_torch.render.pipeline import make_render_fn
    from banggameengine_tpu_torch.render.shading import LightParams

    t_phase = time.perf_counter()
    with open(APP_GOLDEN) as f:
        g = json.load(f)
    gframes = np.load(APP_FRAMES)
    fps = g["fps"]
    width, height = g["full"]
    os.environ.pop("BANG_ASSETS_DIR", None)

    # ---- the fused tick through the whole track --------------------------
    app = Application(assets_root=APP_ASSETS, width=width, height=height,
                      fused_tick=True, device=dev)
    frames = int(g["seconds"] * fps)
    tmp = tempfile.mkdtemp(prefix="app_trace_")
    reset_launch_counts()
    t0 = time.perf_counter()
    rec, walls, syncs, _, tr_f = _app_run(app, frames, fps,
                                          trace_dir=os.path.join(tmp, "fused"))
    fused_s = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["walk"] == frames and counts["resolve"] == frames,
          f"app (fused): {counts} launches in {frames} rendered frames")
    check(counts["fused"] == 0 and counts["tile"] == 0,
          f"app (fused): other render kernels launched: {counts}")
    err_f = _app_check("fused", rec, g, frames)
    img = app.last_frame_image
    ref = gframes["fused_full"]
    check(img.shape == ref.shape == (height, width, 4),
          f"app (fused): frame {img.shape}, golden {ref.shape}")
    off = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(-1) > 1
    sky_diff = ((img == SKY).all(-1) != (ref == SKY).all(-1)) & ~off
    check(off.mean() <= FRAME_OFF_SHARE,
          f"app (fused): {off.sum()} pixels differ from JAX by more than 1 "
          f"level")
    check(not sky_diff.any(),
          f"app (fused): the sky differs from JAX at {sky_diff.sum()} pixels")
    # the last state again, through the kernels and their plain versions
    render = make_render_fn(app.built.render, width, height,
                            bin_capacity=2048)
    args = (app.state.world, app.camera.view_matrix("cpu").to(dev),
            app.camera.proj_matrix(width / height, "cpu").to(dev),
            torch.as_tensor(app.camera.position, device=dev),
            LightParams.default(dev))
    k_img = render(*args)
    with plain_render_kernels():
        p_img = render(*args)
    check(torch.equal(k_img, p_img),
          "app (fused): the last frame differs between the kernels and "
          "their plain versions")
    check(np.array_equal(k_img.cpu().numpy(), img),
          "app (fused): the app's last frame is not the kernels' frame")
    steady = walls[fps:-1]         # after the warm-up, before the trace
    steady_steps = rec["steps"][-2] - rec["steps"][fps - 1]
    print(f"[app] fused tick (Application(fused_tick=True), "
          f"{width}x{height}): play_demo's {g['seconds']:g}-s track, "
          f"{frames} display frames of {rec['steps'][0]} fixed steps "
          f"({rec['steps'][-1]} steps), {fused_s:.1f} s (the last frame "
          f"traced); bus events "
          f"{rec['events']} ([frame, phase, trigger, other], as the JAX "
          f"golden's); max |char - JAX| {err_f:.3g} (< {g['atol']:g}); the "
          f"character rests at y = {rec['char'][2 * fps - 1][1]:.6f}; walk "
          f"and resolve launched {counts['walk']} and {counts['resolve']} "
          f"times in {frames} frames")
    print(f"[app] fused: the last frame vs the JAX golden's {width}x{height}"
          f" frame: {int(off.sum())} of {off.size} pixels off by more than "
          f"1 level, {int((img != ref).any(-1).sum())} off at all, sky "
          f"equal elsewhere; bit-equal with the kernels and with their "
          f"plain versions, and to the app's own frame")
    print(f"[times] app fused: {len(steady) / sum(steady):.2f} display "
          f"frames/s, {steady_steps / sum(steady):.1f} fixed steps/s "
          f"(frames {fps}..{frames - 2}, {1e3 * statistics.median(steady):.1f}"
          f" ms median a frame); {syncs / frames:.2f} blocking host syncs a "
          f"display frame ({syncs} in all) {card}")

    # ---- the default path, rendering every display frame ----------------
    dframes = int(APP_DEFAULT_SECONDS * fps)
    dapp = Application(assets_root=APP_ASSETS, width=width, height=height,
                       device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    drec, dwalls, dsyncs, dimg, tr_d = _app_run(
        dapp, dframes, fps, render=True,
        trace_dir=os.path.join(tmp, "default"))
    default_s = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["walk"] == dframes and counts["resolve"] == dframes,
          f"app (default): {counts} launches in {dframes} rendered frames")
    err_d = _app_check("default", drec, g, dframes)
    check(dimg.shape == (height, width, 4) and (dimg == SKY).all(-1).any(),
          "app (default): no sky in the interpolated frame")
    with plain_render_kernels():
        p_dimg = dapp.render_current_frame()
    check(np.array_equal(dimg, p_dimg),
          "app (default): the interpolated frame differs between the "
          "kernels and their plain versions")
    dsteady = dwalls[APP_DEFAULT_WARMUP:-1]
    dsteady_steps = drec["steps"][-2] - drec["steps"][APP_DEFAULT_WARMUP - 1]
    steps_a_frame = drec["steps"][-1] / dframes
    print(f"[app] default path (Application(), {width}x{height}): the first"
          f" {APP_DEFAULT_SECONDS:g} s of the track, {dframes} display "
          f"frames, each {steps_a_frame:g} hot-reloadable steps (events, "
          f"orbit and raycast each step) and render_current_frame() "
          f"(interpolated), {default_s:.1f} s (the last frame traced); "
          f"bus events {drec['events']}"
          f"; max |char - JAX| {err_d:.3g}; walk and resolve launched "
          f"{counts['walk']} and {counts['resolve']} times; the last frame "
          f"bit-equal with the plain versions")
    print(f"[times] app default: {len(dsteady) / sum(dsteady):.2f} display "
          f"frames/s, {dsteady_steps / sum(dsteady):.1f} "
          f"fixed steps/s (frames {APP_DEFAULT_WARMUP}..{dframes - 2}, "
          f"{1e3 * statistics.median(dsteady):.1f} ms median a frame); "
          f"{dsyncs / dframes:.2f} blocking host syncs a display frame "
          f"({dsyncs} in all) {card}")

    shutil.rmtree(tmp, ignore_errors=True)
    for name, tr in (("fused", tr_f), ("default", tr_d)):
        print(f"[times] app {name}, one display frame traced: "
              f"{tr['launches']:g} launches, {tr['busy_ms']:.3f} ms of device"
              f" time in a {tr['window_ms']:.3f} ms window (busy "
              f"{100 * tr['busy_share']:.1f} %); top kernels: "
              + "; ".join(f"{k['name'][:48]} {k['ms']:.4f} ms x{k['count']:g}"
                          for k in tr["kernels"][:3]) + f" {card}")
    print(f"[app] phase 17 took {time.perf_counter() - t_phase:.1f} s: the "
          f"fused run {fused_s:.1f} (its trace's export and summary "
          f"{tr_f['seconds']:.1f}), the default run {default_s:.1f} (its "
          f"trace's {tr_d['seconds']:.1f}), the rest (loads, checks, plain "
          f"frames) {time.perf_counter() - t_phase - fused_s - default_s:.1f}")


def _golden_app(dev, gz):
    """An app at the overlay golden's size holding the golden's inputs:
    the state and the previous state, the accumulator, the camera (the JAX
    app's after its track, so its frames are drawn from the same inputs
    as the golden's)."""
    from banggameengine_tpu_torch.app.application import Application

    width, height = gz["base_small"].shape[1], gz["base_small"].shape[0]
    app = Application(assets_root=APP_ASSETS, width=width, height=height,
                      device=dev)

    def state(prefix):
        return convert.world_state_from_numpy(
            {k[len(prefix):]: gz[k] for k in gz.files
             if k.startswith(prefix)}, dev)

    app.state, app._prev_state = state("state_"), state("prev_")
    app._accumulator = float(gz["accumulator"])
    app.camera.position = gz["cam_pos"].copy()
    app.camera.set_yaw_pitch(*gz["cam_yaw_pitch"].tolist())
    return app


def _static_ids(static) -> dict:
    return {f: (getattr(static, f).data_ptr(), tuple(getattr(static, f).shape))
            for f in static.__dataclass_fields__}


def overlay_phase(dev, card: str) -> None:
    """Phase 18: the app's overlays and the runtime scene on the card (no
    hand kernel of their own: the walk and the resolve render the
    frames).  The default-path app at 1280x720 with the physics overlay
    (F3) and the HUD through play_demo's first ``OVERLAY_SECONDS``, one F1
    frame; the line pass against itself on the CPU, the golden's F3 and
    F1 frames at 128x32 against the JAX app's
    (``tests/data/overlay_jax_golden.npz``); the runtime scene (spawn,
    300 hot-reloadable steps, despawn, a trigger in the recycled slot,
    reparent) against ``tests/data/lifecycle_jax_golden.json`` with the
    static tensors in place; a checkpoint's resume; the checked step."""
    from banggameengine_tpu_torch.app.application import Application
    from banggameengine_tpu_torch.app.hud import (
        compose_hud, standard_hud_lines)
    from banggameengine_tpu_torch.engine import make_hot_reloadable_step_fn
    from banggameengine_tpu_torch.physics.config import load_physics_config
    from banggameengine_tpu_torch.physics.debugdraw import (
        collision_shape_lines)
    from banggameengine_tpu_torch.render.lines import draw_lines
    from banggameengine_tpu_torch.render.pipeline import make_interp_render_fn
    from banggameengine_tpu_torch.render.shading import LightParams
    from banggameengine_tpu_torch.scene.build import build_scene
    from banggameengine_tpu_torch.scene.resources import ResourceManager
    from banggameengine_tpu_torch.scene.schema import parse_scene_json
    from banggameengine_tpu_torch.state import InputFrame
    from banggameengine_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    from banggameengine_tpu_torch.utils.debug import (
        CheckError, make_checked_step_fn)

    t_phase = time.perf_counter()
    with open(APP_GOLDEN) as f:
        g = json.load(f)
    fps = g["fps"]
    width, height = g["full"]
    os.environ.pop("BANG_ASSETS_DIR", None)
    tmp = tempfile.mkdtemp(prefix="overlay_")

    # ---- the overlay app: default path, F3 and the HUD ------------------
    frames = int(OVERLAY_SECONDS * fps)
    app = Application(assets_root=APP_ASSETS, width=width, height=height,
                      device=dev)
    app.physics_overlay = True
    reset_launch_counts()
    t0 = time.perf_counter()
    rec, walls, syncs, img, tr = _app_run(
        app, frames, fps, render=True, hud=True,
        trace_dir=os.path.join(tmp, "trace"))
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["walk"] == frames and counts["resolve"] == frames,
          f"overlay: {counts} launches in {frames} rendered frames")
    check(counts["fused"] == 0 and counts["tile"] == 0,
          f"overlay: other render kernels launched: {counts}")
    err = _app_check("default", rec, g, frames)

    # the last frame's line pass, on the card and on the CPU, same inputs
    fixed = app.config.fixed_step
    alpha = torch.tensor(min(max(app._accumulator / fixed, 0.0), 1.0),
                         dtype=torch.float32, device=dev)
    view = app.camera.view_matrix("cpu").to(dev)
    proj = app.camera.proj_matrix(width / height, "cpu").to(dev)
    cam = torch.as_tensor(app.camera.position, device=dev)
    render = make_interp_render_fn(app.built.render, width, height,
                                   bin_capacity=2048, return_depth=True)
    base, depth = render(app._prev_state, app.state, alpha, app.built.static,
                         view, proj, cam, LightParams.default(dev))
    lines = collision_shape_lines(app.state, app.built.static)
    on_card = draw_lines(base, depth, *lines, view, proj).cpu()
    on_cpu = draw_lines(base.cpu(), depth.cpu(), *(t.cpu() for t in lines),
                        view.cpu(), proj.cpu())
    line_px = int((on_cpu != base.cpu()).any(-1).sum())
    line_off = int((on_card != on_cpu).any(-1).sum())
    check(line_px > 0, "overlay: the line pass drew nothing")
    check(line_off <= LINE_OFF_SHARE * line_px,
          f"overlay: the card's line pass differs from the CPU's at "
          f"{line_off} of {line_px} line pixels")
    f3 = app.render_current_frame()
    check(np.array_equal(f3, on_card.numpy()),
          "overlay: the app's F3 frame is not the line pass over its frame")
    with_hud = app.render_current_frame(hud=True)
    check(np.array_equal(with_hud, img)
          and np.array_equal(with_hud,
                             compose_hud(f3, standard_hud_lines(app))),
          "overlay: the HUD frame is not the HUD composed on the F3 frame")
    with plain_render_kernels():
        plain_hud = app.render_current_frame(hud=True)
    check(np.array_equal(plain_hud, with_hud),
          "overlay: the HUD frame differs between the kernels and their "
          "plain versions")
    app.wireframe = True
    reset_launch_counts()
    t0 = time.perf_counter()
    f1 = app.render_current_frame(hud=True)
    f1_ms = 1e3 * (time.perf_counter() - t0)
    check(sum(launch_counts().values()) == 0,
          "overlay: the F1 frame launched a raster kernel")
    sky = (f1[..., :3] == SKY[:3]).all(-1)
    check(sky.mean() > 0.5 and ((f1 == 255).all(-1) & ~sky).any(),
          "overlay: the F1 frame is not white lines over the clear colour")
    app.wireframe = False
    steady = walls[APP_DEFAULT_WARMUP:-1]
    steady_steps = rec["steps"][-2] - rec["steps"][APP_DEFAULT_WARMUP - 1]
    print(f"[overlay] default path with F3 and the HUD "
          f"(render_current_frame(hud=True)), {width}x{height}: the first "
          f"{OVERLAY_SECONDS:g} s of play_demo's track, {frames} display "
          f"frames, {run_s:.1f} s (the last frame traced); bus events "
          f"{rec['events']}; max |char - JAX| {err:.3g}; walk and resolve "
          f"launched {counts['walk']} and {counts['resolve']} times; the "
          f"line pass on the card vs the CPU: {line_off} of {line_px} line "
          f"pixels differ (<= {LINE_OFF_SHARE:g}); the app's F3 frame is "
          f"the card's line pass, its HUD frame the HUD on it, bit-equal "
          f"with the plain kernels; F1 frame {f1_ms:.1f} ms, no raster "
          f"kernel")
    print(f"[times] overlay app: {len(steady) / sum(steady):.2f} display "
          f"frames/s, {steady_steps / sum(steady):.1f} fixed steps/s "
          f"(frames {APP_DEFAULT_WARMUP}..{frames - 2}, "
          f"{1e3 * statistics.median(steady):.1f} ms median a frame); "
          f"{syncs / frames:.2f} blocking host syncs a display frame "
          f"({syncs} in all); one display frame traced: "
          f"{tr['launches']:g} launches, {tr['busy_ms']:.3f} ms of device "
          f"time in a {tr['window_ms']:.3f} ms window (busy "
          f"{100 * tr['busy_share']:.1f} %) {card}")

    # ---- the golden's F3 and F1 frames at 128x32 -------------------------
    gz = np.load(OVERLAY_GOLDEN)
    small = _golden_app(dev, gz)
    got = {"base_small": small.render_current_frame()}
    small.physics_overlay = True
    got["f3_small"] = small.render_current_frame()
    small.physics_overlay = False
    small.wireframe = True
    got["f1_small"] = small.render_current_frame()
    report = []
    for k, frame in got.items():
        ref = gz[k]
        off = np.abs(frame.astype(np.int32)
                     - ref.astype(np.int32)).max(-1) > 1
        check(frame.shape == ref.shape and off.mean() <= FRAME_OFF_SHARE,
              f"overlay: {k}: {int(off.sum())} pixels differ from JAX by "
              f"more than 1 level")
        report.append(f"{k[:2]} {int(off.sum())} off by > 1 level, "
                      f"{int((frame != ref).any(-1).sum())} off at all")
    lines_ref = (gz["f3_small"] != gz["base_small"]).any(-1)
    lines_got = (got["f3_small"] != got["base_small"]).any(-1)
    print(f"[overlay] the golden's inputs rendered at {small.width}x"
          f"{small.height} vs the JAX app's frames (of "
          f"{lines_ref.size} pixels): " + "; ".join(report)
          + f"; line pixels {int(lines_got.sum())} (JAX "
          f"{int(lines_ref.sum())}, {int((lines_got != lines_ref).sum())} "
          f"differ)")

    # ---- the runtime scene -------------------------------------------------
    with open(LIFECYCLE_GOLDEN) as f:
        lg = json.load(f)
    built = build_scene(
        parse_scene_json(os.path.join(APP_ASSETS, "scenes", "demo.json")),
        ResourceManager(APP_ASSETS),
        load_physics_config(os.path.join(APP_ASSETS, "config",
                                         "physics.json")),
        capacity=lg["capacity"], max_trigger_slots=lg["trigger_slots"],
        device=dev)
    ids = _static_ids(built.static)
    step = make_hot_reloadable_step_fn()
    zero = InputFrame.zero(dev)
    t0 = time.perf_counter()
    state, crate = built.spawn(built.initial_state, **lg["crate_spawn"])
    track = []
    with no_host_sync():
        for k in range(1, lg["steps"] + 1):
            state, _ = step(state, zero, built.static)
            if k % lg["every"] == 0:
                track.append(state.pos[crate])
            if k == RESUME_AT:
                mid = state
    track = torch.stack(track).cpu().numpy()
    run_steps_s = time.perf_counter() - t0
    crate_err = float(np.abs(track - np.asarray(lg["crate_track"])).max())
    rest = float(track[-1, 1])
    check(crate == lg["crate"], f"runtime: crate id {crate}")
    check(crate_err < lg["atol"], f"runtime: |crate - JAX| = {crate_err}")
    check(abs(rest - lg["rest_y"]) < 0.05, f"runtime: the crate rests at "
          f"y = {rest}")

    # checkpoint at step RESUME_AT, resumed to the end: bit-equal
    path = os.path.join(tmp, "mid")
    save_checkpoint(path, mid, metadata={"step": RESUME_AT})
    resumed, meta = load_checkpoint(path, device=dev)
    check(meta == {"step": RESUME_AT} and resumed.pos.device == state.pos.device,
          "checkpoint: metadata or device")
    with no_host_sync():
        for _ in range(lg["steps"] - RESUME_AT):
            resumed, _ = step(resumed, zero, built.static)
    for f in state.__dataclass_fields__:
        check(torch.equal(getattr(resumed, f), getattr(state, f)),
              f"checkpoint: the resumed run differs in {f}")

    # despawn; a trigger in the recycled slot around the character
    state = built.despawn(state, crate)
    state, zone = built.spawn(state, **lg["zone_spawn"])
    slot = int(torch.nonzero(built.static.trig_entity == zone)[0, 0])
    state, ev = step(state, zero, built.static)
    enter = torch.nonzero(ev.trigger_enter[slot])[:, 0].tolist()
    check(zone == crate == lg["zone"] and slot == lg["zone_slot"],
          f"runtime: the trigger took id {zone}, slot {slot}")
    check(enter == lg["zone_enter"], f"runtime: trigger Enter of {enter}, "
          f"the JAX golden's {lg['zone_enter']}")
    state, anchor = built.spawn(state, **lg["anchor_spawn"])
    state, gadget = built.spawn(state, **lg["gadget_spawn"])
    built.reparent(state, gadget, "anchor")
    state, _ = step(state, zero, built.static)
    gw = state.world[gadget, :3, 3].cpu().numpy()
    check([anchor, gadget] == [lg["anchor"], lg["gadget"]]
          and np.abs(gw - np.asarray(lg["gadget_world"])).max() < 1e-5,
          f"runtime: reparented child at {gw.tolist()}")
    check(_static_ids(built.static) == ids,
          "runtime: a static tensor changed storage or shape")

    # the checked step: healthy, then a NaN position
    checked = make_checked_step_fn(built.static)
    bad_pos = state.pos.clone()
    bad_pos[0, 0] = float("nan")
    bad = dataclasses.replace(state, pos=bad_pos)
    with no_host_sync():
        err_ok, (s_ok, _) = checked(state, zero)
        err_bad, _ = checked(bad, zero)
    err_ok.throw()
    message = None
    try:
        err_bad.throw()
    except CheckError as e:
        message = str(e)
    step_no = int(s_ok.step_idx)
    check(message == f"non-finite position at step {step_no} (`check` "
          f"failed)", f"checked step: {message!r}")
    rt_s = time.perf_counter() - t0
    print(f"[runtime] build_scene(capacity={lg['capacity']}, "
          f"max_trigger_slots={lg['trigger_slots']}): a crate spawned at "
          f"{lg['crate_spawn']['pos']}, {lg['steps']} hot-reloadable steps "
          f"(no host sync, {run_steps_s:.1f} s, "
          f"{lg['steps'] / run_steps_s:.1f} steps/s): max |crate - JAX| "
          f"{crate_err:.3g} (< {lg['atol']:g}), at rest y = {rest:.6f}; "
          f"checkpoint at step {RESUME_AT} resumed {lg['steps'] - RESUME_AT} "
          f"steps: bit-equal; despawned, the trigger took id {zone} and "
          f"saw {enter} enter; the child reparented at {gw.tolist()}; no "
          f"static tensor moved; the checked step passed, then raised "
          f"{message!r} (no host sync in the step) {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[overlay] phase 18 took {time.perf_counter() - t_phase:.1f} s: "
          f"the overlay run {run_s:.1f} (its trace's export and summary "
          f"{tr['seconds']:.1f}), the runtime scene {rt_s:.1f}, the rest "
          f"{time.perf_counter() - t_phase - run_s - rt_s:.1f}")


def _grid_inputs(state, static):
    """The grid broadphase's inputs as the step makes them."""
    from banggameengine_tpu_torch.state import COMP_CHARACTER, COMP_COLLIDER

    has_collider = (state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    is_char = (state.comp_mask & COMP_CHARACTER) != 0
    return (state.pos, state.quat, static.shape_type, static.shape_size,
            state.alive & has_collider & ~is_char)


def grid_lists_check(name: str, state, static) -> tuple[int, int]:
    """The card's grid lists against the same function on the CPU, on the
    same inputs: idx, valid and both overflows equal.  Where they differ,
    the differing pairs and each pair's AABB gap to the margin are printed
    before the check fails.  Returns (cell_overflow, nbr_overflow)."""
    from banggameengine_tpu_torch.physics import broadphase as bp
    from banggameengine_tpu_torch.physics import shapes

    kw = dict(cell_size=GRID_KW["grid_cell_size"],
              table_size=GRID_KW["grid_table_size"],
              cell_capacity=GRID_KW["grid_cell_capacity"],
              max_neighbors=GRID_KW["max_neighbors"])
    args = _grid_inputs(state, static)
    card = bp.build_neighbor_lists(*args, **kw)
    host = bp.build_neighbor_lists(*(a.cpu() for a in args), **kw)
    same = all(torch.equal(getattr(card, f).cpu(), getattr(host, f))
               for f in ("idx", "valid", "cell_overflow", "nbr_overflow"))
    if not same:
        mn, mx = shapes.shape_aabb(*(a.cpu() for a in args[:4]))
        ci = torch.where(card.valid, card.idx, -1).cpu()
        hi = torch.where(host.valid, host.idx, -1)
        rows = (ci != hi).any(1).nonzero()[:, 0].tolist()
        for i in rows[:10]:
            a, b = set(ci[i].tolist()) - {-1}, set(hi[i].tolist()) - {-1}
            for j in sorted(a ^ b):
                gap = torch.maximum(mn[j] - mx[i], mn[i] - mx[j]).max()
                print(f"[grid] {name}: pair ({i}, {j}) only on the "
                      f"{'card' if j in a else 'CPU'}; AABB gap "
                      f"{float(gap):.9g}, {float(gap) - 0.04:.3g} past the "
                      f"0.04 margin")
        print(f"[grid] {name}: {len(rows)} rows differ; overflows card "
              f"{int(card.cell_overflow)}/{int(card.nbr_overflow)}, CPU "
              f"{int(host.cell_overflow)}/{int(host.nbr_overflow)}")
    check(same, f"grid lists, {name}: the card's differ from the CPU's")
    cell_o, nbr_o = int(host.cell_overflow), int(host.nbr_overflow)
    print(f"[grid] {name}: the card's lists equal the CPU's on the same "
          f"inputs ({int(host.valid.sum())} pairs listed; cell_overflow "
          f"{cell_o}, nbr_overflow {nbr_o})")
    return cell_o, nbr_o


def _tiled_tile_parts(rs, world, view, proj, cam_pos, width, height):
    """The tile raster's tiled visibility of a frame and the tiled shade's
    other arguments, as ``render_frame`` makes them."""
    from banggameengine_tpu_torch import math3d
    from banggameengine_tpu_torch.render import raster as rz
    from banggameengine_tpu_torch.render.shading import LightParams

    clip, tri_valid = frame_front(rs, world, view, proj)
    _, _, tiled = rz.rasterize(clip, tri_valid, width, height,
                               bin_capacity=2048, return_tiled=True,
                               backend="tile")
    nrm = rz.transform_normals(rs.v_nrm, rs.v_entity,
                               math3d.normal_matrix(world))
    w = clip[:, 3]
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, 1e-9)
    return tiled, (width, height, nrm, rs.v_uv, inv_w, rs.tri_material,
                   rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_color,
                   rs.mat_tex, rs.textures, rs.tex_size, rs.textures_quad_t,
                   cam_pos, LightParams.default(world.device), view, proj)


def new_routes_phase(dev, card: str, state0, allpairs_state, static,
                     views: dict) -> None:
    """Phase 19: the grid route at full size against phase 4's all-pairs
    run, solid capsules on the flat many-world step, and the tiled shade
    over the tile raster."""
    from banggameengine_tpu_torch.engine import (
        make_multi_step_fn, make_step_fn)
    from banggameengine_tpu_torch.parallel import manyworld
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.render import raster as rz
    from banggameengine_tpu_torch.render import shading
    from banggameengine_tpu_torch.render.pipeline import make_render_fn
    from banggameengine_tpu_torch.scene.synthetic import (
        build_falling_boxes, build_showcase_render)
    from banggameengine_tpu_torch.scripts import trace_summary as ts
    from banggameengine_tpu_torch.state import InputFrame

    t_phase = time.perf_counter()
    inp = InputFrame.zero()

    # ---- the grid route at full size -------------------------------------
    over0 = grid_lists_check("step 0", state0, static)
    run = make_multi_step_fn(static, STEPS_PER_DISPATCH, **GRID_KW)
    reset_hand_launches()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(DISPATCHES + 1)]
    state = state0
    with no_host_sync():
        events[0].record()
        for i in range(DISPATCHES):
            state = run(state, inp)
            events[i + 1].record()
    torch.cuda.synchronize()
    check(hand_launches() == 0, "the grid route launched a hand kernel")
    steps = DISPATCHES * STEPS_PER_DISPATCH
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(DISPATCHES)]
    grid_rate = STEPS_PER_DISPATCH / (statistics.median(ms[1:]) / 1e3)
    check(bool(torch.isfinite(state.pos).all())
          and bool(torch.isfinite(state.lin_vel).all())
          and bool(torch.isfinite(state.ang_vel).all()),
          f"grid route: non-finite state after {steps} steps")
    alive = state.alive
    corners = shapes.box_corners(state.pos, state.quat, static.shape_size)
    lowest = float(corners[alive][..., 1].min())
    check(lowest > -0.08, f"grid route: a box corner went through the "
          f"ground: {lowest}")
    over1 = grid_lists_check(f"step {steps}", state, static)
    _, ev = make_step_fn(static, **GRID_KW)(state, inp)
    pg = state.pos[alive].cpu().numpy()
    pa = allpairs_state.pos[alive].cpu().numpy()
    diff = np.abs(pg - pa)
    mean_y = abs(float(pg[:, 1].mean() - pa[:, 1].mean()))
    check(bool((pg[:, 1] > 0.3).all()), "grid route: a box below y = 0.3")
    check(np.median(diff) < 0.01 and diff.max() < 0.6 and mean_y < 0.05,
          f"grid route vs all-pairs after {steps} steps: median "
          f"{np.median(diff)}, max {diff.max()}, mean y {mean_y}")
    print(f"[grid] {N_STRESS} boxes, {steps} steps of broadphase='grid' in "
          f"{DISPATCHES} dispatches (no host sync, no hand kernel): finite, "
          f"lowest corner {lowest:.4f} > -0.08; overflows step 0 "
          f"{over0[0]}/{over0[1]}, step {steps} {over1[0]}/{over1[1]} "
          f"(cell/neighbor); contact_overflow of step {steps + 1} "
          f"{int(ev.contact_overflow)}; against phase 4's all-pairs run "
          f"(kernel #1): |pos| diff median {np.median(diff):.3g} (< 0.01), "
          f"max {diff.max():.3g} (< 0.6), mean y {mean_y:.3g} (< 0.05)")
    with open(GRID_GOLDEN) as f:
        golden = json.load(f)
    g_state, g_static = build_falling_boxes(**golden["scene"])
    g_step = make_step_fn(g_static, **golden["grid"])
    for i in range(1, golden["steps"][-1] + 1):
        g_state, _ = g_step(g_state, inp)
        rec = golden["at"].get(str(i))
        if rec is None:
            continue
        if "contact_feat" in rec:
            check(g_state.contact_feat.cpu().tolist() == rec["contact_feat"],
                  f"32-box grid scene: contact features differ from JAX at "
                  f"step {i}")
        err = float((g_state.pos.cpu() - torch.tensor(rec["pos"])).abs().max())
        check(err < GOLDEN_ATOL,
              f"32-box grid scene: |pos - JAX| = {err} at step {i}")
        print(f"[reference] 32 boxes on the grid route vs the JAX package at "
              f"step {i}: max |pos - JAX| {err:.3g} (< {GOLDEN_ATOL})")
    grid_one = make_step_fn(static, **GRID_KW)
    ap_one = make_step_fn(static, broadphase="allpairs",
                          max_neighbors=MAX_NEIGHBORS)
    reset_hand_launches()
    with tempfile.TemporaryDirectory() as tmp:
        tr_grid = ts.trace_and_summarize(
            lambda: grid_one(state, inp)[0].pos, (),
            os.path.join(tmp, "grid"))
        tr_ap = ts.trace_and_summarize(
            lambda: ap_one(allpairs_state, inp)[0].pos, (),
            os.path.join(tmp, "allpairs"))
    ap_launches = bk.neighbor_lists_aabb.launches
    check(ap_launches > 0, "the all-pairs steps did not launch kernel #1")
    print(f"[times] {N_STRESS} boxes: grid route {grid_rate:.2f} steps/s "
          f"(CUDA events, median of dispatches 2-{DISPATCHES} of "
          f"{STEPS_PER_DISPATCH} steps), one traced step "
          f"{tr_grid['launches']:g} launches, {tr_grid['busy_ms']:.3f} ms "
          f"of device time; all-pairs route (phase 5 times its steps/s) one "
          f"traced step {tr_ap['launches']:g} launches, "
          f"{tr_ap['busy_ms']:.3f} ms of device time, kernel #1 launched "
          f"{ap_launches} times in those steps {card}")

    # ---- solid capsules on the flat many-world step ----------------------
    with np.load(CAPSULE_GOLDEN) as z:
        g = dict(z)
    c_state = convert.world_state_from_numpy(
        {k[6:]: v for k, v in g.items() if k.startswith("state/")}, dev)
    c_static = convert.static_scene_from_numpy(
        {k[7:]: v for k, v in g.items() if k.startswith("static/")}, dev)
    one = manyworld.make_flat_many_world_step(c_static, CAPSULE_WORLDS,
                                              c_state.comp_mask)
    chunk = manyworld.make_flat_many_world_step(
        c_static, CAPSULE_WORLDS, c_state.comp_mask,
        num_steps=CAPSULE_CHUNK)
    bs = manyworld.replicate_state(c_state, CAPSULE_WORLDS)
    bi = manyworld.replicate_input(InputFrame.zero(), CAPSULE_WORLDS)
    g_steps = g["traj/pos"].shape[0]
    n_chunks = (CAPSULE_STEPS - g_steps) // CAPSULE_CHUNK
    check(g_steps + n_chunks * CAPSULE_CHUNK == CAPSULE_STEPS,
          "capsule run: the dispatches do not add up")
    fields = ("pos", "quat", "lin_vel", "ang_vel")
    track = []
    c_events = [torch.cuda.Event(enable_timing=True)
                for _ in range(n_chunks + 1)]
    reset_hand_launches()
    t0 = time.perf_counter()
    with no_host_sync():
        for _ in range(g_steps):
            bs = one(bs, bi)
            track.append([getattr(bs, f)[0].clone() for f in fields])
        c_events[0].record()
        for i in range(n_chunks):
            bs = chunk(bs, bi)
            c_events[i + 1].record()
    torch.cuda.synchronize()
    capsule_s = time.perf_counter() - t0
    check(hand_launches() == 0, "the capsule run launched a hand kernel")
    err_g = 0.0
    for i, rec in enumerate(track):
        for f, a in zip(fields, rec):
            err = float(np.abs(a.cpu().numpy() - g[f"traj/{f}"][i][0]).max())
            check(err < CAPSULE_ATOL, f"capsule world 0: |{f} - JAX| = {err} "
                  f"at step {i + 1}")
            err_g = max(err_g, err)
    err_w = max(float((getattr(bs, f) - getattr(bs, f)[:1]).abs().max())
                for f in fields)
    check(err_w < CAPSULE_WORLD_ATOL,
          f"capsule worlds differ from world 0 by {err_w}")
    r, hh = (float(v) for v in c_static.shape_size[0, :2].cpu())
    rest = float(bs.pos[0, 0, 1])
    check(abs(rest - (hh + r)) < 0.1,
          f"the upright capsule rests at y = {rest}, not {hh + r} +- 0.1")
    check(bool(torch.isfinite(bs.pos).all()), "capsule run: non-finite")
    live = bool((bs.contact_feat[0, 0] >= 0).any())
    check(live, "the upright capsule has no live ground manifold")
    c_ms = [c_events[i].elapsed_time(c_events[i + 1])
            for i in range(n_chunks)]
    c_rate = CAPSULE_WORLDS * CAPSULE_CHUNK / (statistics.median(c_ms) / 1e3)
    print(f"[capsules] {CAPSULE_WORLDS} worlds of the capsule scene on the "
          f"flat static route, {CAPSULE_STEPS} steps ({g_steps} one-step "
          f"dispatches, then {n_chunks} of {CAPSULE_CHUNK}; no host sync, no "
          f"hand kernel, {capsule_s:.1f} s wall): world 0 within "
          f"{err_g:.3g} of JAX's flat step over its {g_steps} steps (< "
          f"{CAPSULE_ATOL:g}), every world within {err_w:.3g} of world 0 (< "
          f"{CAPSULE_WORLD_ATOL:g}), the upright capsule at rest at y = "
          f"{rest:.4f} (hh + r = {hh + r:.2f} +- 0.1), a live ground "
          f"manifold; {c_rate:.0f} world-steps/s (CUDA events, median of "
          f"the {CAPSULE_CHUNK}-step dispatches) {card}")

    # ---- the tiled shade over the tile raster ----------------------------
    def renderer(rs, **kw):
        return make_render_fn(rs, RENDER_W, RENDER_H, bin_capacity=2048,
                              return_depth=True, **kw)

    tile_r = {name: renderer(rs, raster_backend="tile")
              for name, (rs, _, _) in views.items()}
    walk_r = {name: renderer(rs) for name, (rs, _, _) in views.items()}
    reset_hand_launches()
    with no_host_sync():
        frames = {name: tile_r[name](*args)
                  for name, (_, args, _) in views.items()}
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"walk": 0, "resolve": 2, "fused": 0, "tile": 4}
    check(launches == want, f"tiled frames over the tile raster: launches "
          f"{launches}, expected {want}")
    with plain_render_kernels():
        plain = {name: tile_r[name](*args)
                 for name, (_, args, _) in views.items()}
    walk = {name: walk_r[name](*args) for name, (_, args, _) in views.items()}
    torch.cuda.synchronize()
    for name in views:
        check(all(torch.equal(a, b) for a, b in zip(frames[name],
                                                    plain[name])),
              f"{name}: the tiled frame over the tile raster with the "
              f"kernels differs from the plain versions")
        diff = int((frames[name][0] != walk[name][0]).any(-1).sum())
        if name == "showcase":
            check(diff == 0 and torch.equal(frames[name][1], walk[name][1]),
                  "showcase: the tiled frame over the tile raster differs "
                  "from the tiled frame over the walk")
        print(f"[tiled-tile] {name} {RENDER_W}x{RENDER_H} (no host sync): "
              f"bit-equal to the plain versions; differs from the tiled "
              f"frame over the walk at {diff} pixels (the heavy pass's "
              f"{rz.HEAVY_TILES}-tile cap); 0 pixels take the row gather "
              f"(the resolve covers the heavy walk width)")
    print(f"[tiled-tile] launches of both frames: {launches}")
    # the row-gather fallback on the card: a resolve narrower than the heavy
    # pass's walk width
    name = "showcase"
    rs, args, _ = views[name]
    tiled, sargs = _tiled_tile_parts(rs, *args, RENDER_W, RENDER_H)
    covered = shading.tiled_resolve_width(tiled, **NARROW_SLOTS)
    n_fb = int((tiled.slot >= covered).sum())
    reset_hand_launches()
    with no_host_sync():
        narrow = shading.shade_visibility_tiled(tiled, *sargs, **NARROW_SLOTS)
    torch.cuda.synchronize()
    fb_launches = launch_counts()
    wide = shading.shade_visibility_tiled(
        tiled, *sargs, shade_slots=NARROW_SLOTS["shade_slots"],
        heavy_shade_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY)
    with plain_render_kernels():
        narrow_p = shading.shade_visibility_tiled(tiled, *sargs,
                                                  **NARROW_SLOTS)
    check(n_fb > 0, f"{name}: no winner beyond slot {covered}")
    check(fb_launches == {"walk": 0, "resolve": 1, "fused": 0, "tile": 0},
          f"narrow shade: launches {fb_launches}, expected one resolve")
    check(torch.equal(narrow, wide) and torch.equal(narrow, narrow_p),
          f"{name}: the narrow shade with its fallback differs from the "
          f"wide resolve or from the plain versions")
    full = rz.K_GLOBAL + rz.HEAVY_CAPACITY
    print(f"[tiled-tile] {name} {RENDER_W}x{RENDER_H}, resolve at {covered} "
          f"slots: {n_fb} pixels take the row gather (no host sync); the "
          f"frame bit-equal to the resolve at {full} slots and to the plain "
          f"versions")
    gz = np.load(TILED_TILE_GOLDEN)
    gw, gh = int(gz["width"]), int(gz["height"])
    gsc = build_showcase_render(int(gz["seed"]))
    g_frame = make_render_fn(
        convert.render_scene_from_numpy(gsc.render), gw, gh,
        raster_backend="tile")(
        torch.as_tensor(gsc.world, device=dev),
        *(torch.as_tensor(gz[k], device=dev)
          for k in ("view", "proj", "cam_pos"))).cpu().numpy()
    off = np.abs(g_frame.astype(np.int32)
                 - gz["frame"].astype(np.int32)).max(-1) > 1
    sky_diff = (((g_frame == SKY).all(-1) != (gz["frame"] == SKY).all(-1))
                & ~off)
    check(off.mean() <= FRAME_OFF_SHARE, f"tiled-tile golden: {off.sum()} "
          f"pixels differ by more than 1 level")
    check(not sky_diff.any(), "tiled-tile golden: the sky mask differs")
    print(f"[reference] showcase {gw}x{gh}, tiled over the tile raster, vs "
          f"the JAX package's light/heavy scan: {off.sum()} of {off.size} "
          f"pixels off by more than 1 level, "
          f"{int((g_frame != gz['frame']).any(-1).sum())} off at all, sky "
          f"mask equal elsewhere")
    for name, (_, args, _) in views.items():
        ms = [median_ms(lambda: r[name](*args))
              for r in (walk_r, tile_r, tile_r, walk_r)]
        print(f"[times] {name} {RENDER_W}x{RENDER_H} tiled frames: over the "
              f"walk {ms[0]:.3f} ms, over the tile raster {ms[1]:.3f} / "
              f"{ms[2]:.3f} ms, over the walk again {ms[3]:.3f} ms {card}")
    print(f"[new-routes] phase 19 took {time.perf_counter() - t_phase:.1f} s")


SHARDED_GOLDEN = os.path.join(DATA, "sharded_world_jax_golden.json")
SW_WORLDS = 1000
SW_STEPS = 50          # steps a vmapped dispatch
SW_RUN = 100           # steps of each vmapped run (zero, per-world input)
SW_TIMED = 10          # steps a timed dispatch
SW_ATOL = 2e-4         # flat against vmapped (tests/test_flat_manyworld.py)
SW_DENSE_ATOL = dict(pos=2e-4, quat=2e-4, lin_vel=2e-3)  # test_sharded_world
SW_CPU_ATOL = 1e-5     # the entity-sharded phase, card against CPU


def _sync_free(what: str, fn, *args):
    """``fn(*args)`` with host syncs and functorch's BatchedFallback
    warning raised as errors, and no hand-kernel launch allowed."""
    import warnings

    reset_hand_launches()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        with no_host_sync():
            out = fn(*args)
    torch.cuda.synchronize()
    hand = hand_launches()
    check(hand == 0, f"{what}: {hand} hand-kernel launches")
    return out


def sharded_phase(dev, card: str, stress_state, stress_static) -> None:
    """Phase 20: the vmapped many-world step, the router and the flat
    step's world mesh, the fully sharded world, the entity-sharded
    contact phase, all on a one-rank NCCL group; the native OBJ loader and
    the windows; ``dryrun_multichip(1)`` (no hand kernel on these paths)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from banggameengine_tpu_torch.app.window import (
        HeadlessWindow, XcbWindow, create_window)
    from banggameengine_tpu_torch.engine import make_step_fn
    from banggameengine_tpu_torch.native import LIB_PATH, build_native
    from banggameengine_tpu_torch.native import load_obj_native
    from banggameengine_tpu_torch.parallel import dryrun_multichip, ranks
    from banggameengine_tpu_torch.parallel import manyworld as mw
    from banggameengine_tpu_torch.parallel import sharded_world as sw
    from banggameengine_tpu_torch.parallel import spatial
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.scene.obj_loader import load_obj
    from banggameengine_tpu_torch.scene.resources import ResourceManager
    from banggameengine_tpu_torch.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, SHAPE_BOX, InputFrame)

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="bang_store_")
    ranks.init_rank(0, 1, os.path.join(store, "store"), "cuda")
    try:
        # ---- 20a. the vmapped many-world step ---------------------------
        t0 = time.perf_counter()
        mesh = mw.make_world_mesh()
        w = SW_WORLDS
        state1, static1 = build_falling_boxes(**MW_SCENE, device=dev)
        bs0 = mw.replicate_state(state1, w)
        zero = mw.replicate_input(InputFrame.zero(dev), w)
        rng = np.random.default_rng(MW_SEED)
        drive = InputFrame(
            move_forward=torch.as_tensor(
                rng.uniform(0.5, 1.0, w).astype(np.float32), device=dev),
            move_right=torch.zeros(w, device=dev),
            jump=torch.as_tensor(rng.random(w) < 0.3, device=dev),
            sprint=torch.as_tensor(rng.random(w) < 0.3, device=dev),
            cam_yaw=torch.as_tensor(
                rng.uniform(-np.pi, np.pi, w).astype(np.float32),
                device=dev))
        vstep = mw.make_sharded_many_world_step(static1, mesh,
                                                num_steps=SW_STEPS)
        sharded = {k: mw.shard_batched(v, mesh)
                   for k, v in (("state", bs0), ("zero", zero),
                                ("drive", drive))}
        # warm-up, one step: the communicator and the first launches,
        # outside the checked runs
        v1 = mw.make_sharded_many_world_step(static1, mesh)
        v1(sharded["state"], sharded["zero"])
        torch.cuda.synchronize()

        def run(inp):
            s = sharded["state"]
            for _ in range(SW_RUN // SW_STEPS):
                s = vstep(s, inp)
            return s

        outs = {k: _sync_free(f"vmapped, {k} input", run, sharded[k])
                for k in ("zero", "drive")}
        box = ((static1.shape_type == SHAPE_BOX) & state1.alive).repeat(w)
        for k, s in outs.items():
            full = ranks.full(s)
            for f in ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y"):
                check(bool(torch.isfinite(getattr(full, f)).all()),
                      f"vmapped, {k} input: {f} not finite")
            corners = shapes.box_corners(
                full.pos.reshape(-1, 3), full.quat.reshape(-1, 4),
                static1.shape_size.repeat(w, 1))
            lowest = float(corners[box][..., 1].min())
            check(lowest > -0.08, f"vmapped, {k} input: a box corner went "
                  f"through the ground: {lowest}")
            check(full.step_idx.tolist() == [SW_RUN] * w,
                  f"vmapped, {k} input: step_idx not in lockstep")
            print(f"[sharded] vmapped {w} worlds on a one-rank NCCL world "
                  f"mesh, {k} input: {SW_RUN} steps in "
                  f"{SW_RUN // SW_STEPS} dispatches of {SW_STEPS}, no host "
                  f"sync, no BatchedFallback warning, no hand kernel; "
                  f"finite, lowest box corner {lowest:.4f} > -0.08, "
                  f"characters on the ground "
                  f"{int(full.char_on_ground[:, MW_CHAR_ROW].sum())}")
        # the flat step on the same inputs, 25 steps: JAX's flat-vs-vmapped
        # bar
        v25 = mw.make_sharded_many_world_step(static1, mesh, num_steps=25)(
            sharded["state"], sharded["drive"])
        flat25 = mw.make_flat_many_world_step(
            static1, w, state1.comp_mask, num_steps=25)
        f25 = flat25(bs0, drive)
        vn = convert.world_state_to_numpy(ranks.full(v25))
        fn_ = convert.world_state_to_numpy(f25)
        errs = {}
        for f in ("pos", "quat", "lin_vel", "ang_vel", "char_vel_y"):
            errs[f] = float(np.abs(vn[f] - fn_[f]).max())
            check(errs[f] < SW_ATOL, f"vmapped vs flat after 25 steps: "
                  f"|{f}| = {errs[f]}")
        for f in ("char_on_ground", "trigger_overlap", "trigger_active",
                  "alive", "step_idx"):
            check(np.array_equal(vn[f], fn_[f]),
                  f"vmapped vs flat after 25 steps: {f} differs")
        print(f"[sharded] vmapped vs flat, {w} worlds, per-world input, 25 "
              f"steps: bools equal; max |vmapped - flat| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (< {SW_ATOL})")
        metrics = mw.make_sharded_many_world_step(
            static1, mesh, with_metrics=True)(outs["drive"], sharded["drive"])[1]
        mvals = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in mvals.values()),
              f"with_metrics: {mvals}")
        print(f"[sharded] with_metrics over the {w} worlds (a sum over the "
              f"ranks / W): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in mvals.items()))

        # world-steps/s: the vmapped and the flat step, one call
        v_t = mw.make_sharded_many_world_step(static1, mesh,
                                              num_steps=SW_TIMED)
        f_t = mw.make_flat_many_world_step(static1, w, state1.comp_mask,
                                           num_steps=SW_TIMED)
        rates, peaks = {}, {}
        for name, fn in (
                ("vmapped", lambda: v_t(outs["zero"], sharded["zero"])),
                ("flat", lambda: f_t(bs0, zero))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = median_ms(lambda: ranks.local(fn().pos), timed=3)
            peaks[name] = torch.cuda.max_memory_allocated() / 2**20
            rates[name] = w * SW_TIMED / (ms / 1e3)
        from banggameengine_tpu_torch.scripts import trace_summary as tsum

        with tempfile.TemporaryDirectory() as tmp:
            print("[profile] trace_summary of one vmapped step:")
            launches = tsum.trace_and_summarize(
                lambda: ranks.local(v1(outs["zero"], sharded["zero"]).pos),
                (), tmp)["launches"]
        print(f"[times] many-world {w} worlds, dispatches of {SW_TIMED} "
              f"steps (CUDA events, median of 3 after 2 warm-up): vmapped "
              f"{rates['vmapped']:.0f} world-steps/s ({launches:g} launches "
              f"a step, peak {peaks['vmapped']:.0f} MiB), flat "
              f"{rates['flat']:.0f} world-steps/s (its launches: phase 15's "
              f"trace; peak {peaks['flat']:.0f} MiB); flat / vmapped "
              f"{rates['flat'] / rates['vmapped']:.2f} {card}")
        print(f"[sharded] 20a took {time.perf_counter() - t0:.1f} s")

        # ---- 20b. the router and the one-rank flat mesh= ----------------
        _, layout = mw.make_many_world_step(static1, mesh, state1.comp_mask,
                                            w)
        check(layout == "flat", f"router on one rank: {layout}")
        fm = mw.make_flat_many_world_step(static1, w, state1.comp_mask,
                                          num_steps=25, mesh=mesh)(
            sharded["state"], sharded["drive"])
        for name, a in convert.world_state_to_numpy(ranks.full(fm)).items():
            check(np.array_equal(a, fn_[name]),
                  f"flat mesh= vs mesh=None: {name} differs")
        print(f"[sharded] make_many_world_step on the one-rank mesh: "
              f"{layout!r}; the flat step with mesh= bit-equal to "
              f"mesh=None after 25 steps of per-world input")

        # ---- 20c. the fully sharded world on one rank -------------------
        t0 = time.perf_counter()
        emesh = sw.make_entity_axis_mesh()
        inp = InputFrame.zero(dev)
        ss, sst = sw.shard_world(stress_state, stress_static, emesh)
        fstep = sw.make_fully_sharded_step(stress_static, emesh)
        fstep(ss, inp, sst)                   # warm-up
        torch.cuda.synchronize()
        out, ev_t = _sync_free("fully sharded 10k step", _timed, fstep, ss,
                               inp, sst)
        one_ms = ev_t[0].elapsed_time(ev_t[1])
        got = ranks.full(out[0])
        dense = make_step_fn(stress_static, broadphase="dense",
                             max_neighbors=MAX_NEIGHBORS, warm_start=False)
        ref, _ = dense(stress_state, inp)
        errs = {}
        for f, tol in SW_DENSE_ATOL.items():
            errs[f] = float((getattr(got, f) - getattr(ref, f)).abs().max())
            check(errs[f] < tol, f"fully sharded vs dense at N={N_STRESS}: "
                  f"|{f}| = {errs[f]}")
        check(bool(torch.isfinite(got.pos).all()), "fully sharded: NaN")
        print(f"[sharded] fully sharded step, one rank, {N_STRESS} boxes "
              f"from phase 4's {DISPATCHES * STEPS_PER_DISPATCH}-step "
              f"state: no host sync, no hand kernel; max |sharded - dense "
              f"route (warm_start=False: the sharded solve starts cold)| "
              + ", ".join(f"{k} {v:.3g} (< {SW_DENSE_ATOL[k]:g})"
                          for k, v in errs.items())
              + f"; one step {one_ms:.1f} ms (events) {card}")
        with open(SHARDED_GOLDEN) as f:
            golden = json.load(f)
        dstate, dstatic = build_demo_like(device=dev)
        ds, dst = sw.shard_world(dstate, dstatic, emesh)
        dstep = sw.make_fully_sharded_step(dstatic, emesh)

        def demo_run(s):
            enter, exit_ = [], []
            for _ in range(golden["steps"]):
                s, ev = dstep(s, inp, dst)
                enter.append(ranks.local(ev.trigger_enter))
                exit_.append(ranks.local(ev.trigger_exit))
            return s, torch.stack(enter), torch.stack(exit_)

        (ds_out, enter, exit_), ev_t = _sync_free(
            "fully sharded demo topology", _timed, demo_run, ds)
        demo_ms = ev_t[0].elapsed_time(ev_t[1])
        check(_event_list(enter, 1) == golden["enter"],
              f"demo topology: Enter {_event_list(enter, 1)} vs JAX "
              f"{golden['enter']}")
        check(_event_list(exit_, 1) == golden["exit"],
              f"demo topology: Exit {_event_list(exit_, 1)} vs JAX "
              f"{golden['exit']}")
        dn = convert.world_state_to_numpy(ranks.full(ds_out))
        derr = {}
        for f in golden["float_fields"]:
            derr[f] = float(np.abs(dn[f] - np.asarray(
                golden["last"][f], np.float32)).max())
            check(derr[f] < golden["atol"],
                  f"demo topology: |{f} - JAX| = {derr[f]}")
        for f in golden["exact_fields"]:
            check(np.array_equal(dn[f], np.asarray(golden["last"][f])),
                  f"demo topology: {f} differs from JAX")
        print(f"[sharded] demo topology fully sharded, {golden['steps']} "
              f"steps: events equal to the JAX golden "
              f"({len(golden['enter'])} Enter, {len(golden['exit'])} Exit), "
              f"{', '.join(golden['exact_fields'])} equal; max |port - JAX| "
              + ", ".join(f"{k} {v:.3g}" for k, v in derr.items())
              + f" (< {golden['atol']:g}); "
              f"{golden['steps'] / (demo_ms / 1e3):.1f} steps/s {card}")
        print(f"[sharded] 20c took {time.perf_counter() - t0:.1f} s")

        # ---- 20d. the entity-sharded contact phase -----------------------
        alive = stress_state.alive
        has_col = (stress_state.comp_mask
                   & (COMP_COLLIDER | COMP_CHARACTER)) != 0
        solid = alive & has_col & (
            (stress_state.comp_mask & COMP_CHARACTER) == 0)
        is_dyn = (stress_static.body_type == BODY_DYNAMIC) & alive
        args = (stress_state.pos, stress_state.quat, stress_state.lin_vel,
                stress_state.ang_vel, is_dyn, solid, stress_static.fixed_dt)
        pmesh = ranks.make_mesh(spatial.AXIS)
        phase = spatial.make_entity_sharded_contact_phase(stress_static,
                                                          pmesh)
        phase(*args)                          # warm-up
        (v_g, w_g), ev_t = _sync_free("entity-sharded phase", _timed,
                                      phase, *args)
        phase_ms = ev_t[0].elapsed_time(ev_t[1])
        cpu_group = dist.new_group(ranks=[0], backend="gloo")
        cmesh = DeviceMesh.from_group(cpu_group, "cpu",
                                      mesh_dim_names=(spatial.AXIS,))
        cpu_static = dataclasses.replace(stress_static, **{
            f.name: getattr(stress_static, f.name).cpu()
            for f in dataclasses.fields(stress_static)})
        v_c, w_c = spatial.make_entity_sharded_contact_phase(
            cpu_static, cmesh)(*(a.cpu() for a in args))
        perr = max(float((v_g.cpu() - v_c).abs().max()),
                   float((w_g.cpu() - w_c).abs().max()))
        check(bool(torch.isfinite(v_g).all() and torch.isfinite(w_g).all()),
              "entity-sharded phase: not finite")
        check(perr < SW_CPU_ATOL,
              f"entity-sharded phase, card vs CPU: {perr}")
        print(f"[sharded] entity-sharded contact phase, one rank, "
              f"{N_STRESS} boxes: finite, max |card - CPU| {perr:.3g} "
              f"(< {SW_CPU_ATOL:g}); {phase_ms:.1f} ms (events) {card}")

        # ---- 20e. the native OBJ loader and the windows ------------------
        t0 = time.perf_counter()
        path = build_native(force=True)
        check(path == LIB_PATH and os.path.isfile(LIB_PATH),
              f"native library did not build: {path}")
        meshes = sorted(os.listdir(os.path.join(APP_ASSETS, "meshes")))
        objs = [m for m in meshes if m.endswith(".obj")]
        for m in objs:
            p = os.path.join(APP_ASSETS, "meshes", m)
            nat, py = load_obj_native(p), load_obj(p)
            check(nat is not None, f"native loader: nothing for {m}")
            check(nat.num_vertices == py.num_vertices
                  and np.allclose(nat.positions, py.positions, atol=1e-6)
                  and np.allclose(nat.normals, py.normals, atol=1e-5)
                  and np.allclose(nat.uvs, py.uvs, atol=1e-6)
                  and [(s.start_index, s.index_count, s.material_index)
                       for s in nat.submeshes]
                  == [(s.start_index, s.index_count, s.material_index)
                      for s in py.submeshes]
                  and [x.name for x in nat.materials]
                  == [x.name for x in py.materials],
                  f"native loader: {m} differs from the Python loader")
        os.environ.pop("BANG_DISABLE_NATIVE", None)
        res = ResourceManager(assets_root=APP_ASSETS)
        for m in objs:
            res.load_mesh(f"meshes/{m}")
        routes = sorted(set(res.mesh_routes.values()))
        check(routes == ["native"], f"load_mesh routes: {routes}")
        display = os.environ.pop("DISPLAY", None)
        try:
            try:
                XcbWindow(320, 200)
                check(False, "XcbWindow opened without a display")
            except RuntimeError:
                pass
            check(isinstance(create_window(320, 200), HeadlessWindow),
                  "create_window without a display is not headless")
        finally:
            if display is not None:
                os.environ["DISPLAY"] = display
        print(f"[native] {os.path.relpath(LIB_PATH)} built with g++ in "
              f"{time.perf_counter() - t0:.1f} s; {len(objs)} meshes of "
              f"tests/data/app_assets loaded natively, each within "
              f"tests/test_native.py's bars of the Python loader; "
              f"load_mesh took the native route; without DISPLAY XcbWindow "
              f"raises RuntimeError and create_window is headless")

        # ---- 20f. the dry run on the card --------------------------------
        lines = dryrun_multichip(1)
        check(len(lines) == 5, f"dryrun_multichip(1): {lines}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"[sharded] phase 20 took {time.perf_counter() - t_phase:.1f} s "
          f"{card}")


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
    from banggameengine_tpu_torch.scripts import gather_rows as gr
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

    # ---- 2. build: every kernel at once, one nvcc each -----------------
    t0 = time.perf_counter()
    render_mods = render_kernel_modules()
    build_s = build_in_parallel([bk.load_kernel_library] + [
        render_mods[k][0].load_kernel_library
        for k in ("walk", "resolve", "fused", "tile")]
        + [gr.load_kernel_library])
    print(f"[build] {KERNEL_SOURCE} for sm_90a built and loaded in "
          f"{build_s[0]:.1f} s ({len(build_s)} libraries in parallel, "
          f"{time.perf_counter() - t0:.1f} s in all)")

    # ---- 3. kernel vs plain ---------------------------------------------
    state0, static = build_falling_boxes(N_STRESS, seed=0)
    inp = InputFrame.zero()
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
         for n in (1, 20, 33, 65, 1025)] + [
        (f"e: {name}", tuple(torch.as_tensor(a, device=dev) for a in case))
        for name, case in kernel_cases.broadphase_edge_cases().items()]
    max_abs_err = 0
    kept_share = {}
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
        # the raw boxes as the kernel's lo/hi: the touching case touches
        raw_k = bk.cuda_idx_count(mn, mx, dyn, layer, mask, MAX_NEIGHBORS)
        raw_p = bk.plain_idx_count(mn, mx, dyn, layer, mask, MAX_NEIGHBORS)
        kept = bk.band_group_kept(lo, hi)
        torch.cuda.synchronize()
        err = int((nl_k.idx - nl_p.idx).abs().max())
        max_abs_err = max(max_abs_err, err,
                          int((count_k - count_p).abs().max()))
        check(torch.equal(nl_k.idx, nl_p.idx), f"{name}: idx differs")
        check(torch.equal(count_k, count_p), f"{name}: count differs")
        check(torch.equal(nl_k.nbr_overflow, nl_p.nbr_overflow),
              f"{name}: overflow differs")
        check(torch.equal(raw_k[0], raw_p[0])
              and torch.equal(raw_k[1], raw_p[1]),
              f"{name}: idx or count differs on the raw boxes")
        share = float(kept.float().mean())
        if name[0] in "ab":
            kept_share[name[0]] = share
        if name.startswith("c"):
            check(int(nl_k.nbr_overflow) > 0, "pile: K = 8 not saturated")
        if name[0] in "cd":
            check(bool(kept.all()), f"{name}: the unions skip a pair")
        if name == "e: far_clusters":
            check(share < 0.1, f"{name}: the unions keep {share}")
        print(f"[kernel-vs-plain] {name}: idx, count, overflow exactly "
              f"equal, and on the raw boxes (pairs kept "
              f"{int(nl_k.valid.sum())}, all passing {int(count_k.sum())}, "
              f"overflow {int(nl_k.nbr_overflow)}; (band, group) pairs "
              f"the unions keep: {int(kept.sum())} of {kept.numel()}, "
              f"{share:.4f})")

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
    g_state, g_static = build_falling_boxes(**golden["scene"])
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
    plain_ms = measure_throughput(
        lambda: bk.neighbor_lists_aabb_reference(
            mn, mx, dyn, layer, mask, max_neighbors=MAX_NEIGHBORS),
        calls=10, warmup=3) * 1e3
    wrapper_ms = measure_throughput(
        lambda: bk.neighbor_lists_aabb(
            mn, mx, dyn, layer, mask, max_neighbors=MAX_NEIGHBORS),
        calls=10, warmup=3) * 1e3
    n_bp = mn.shape[0]
    bp_bound = bound_ms(36 * n_bp + 4 * (MAX_NEIGHBORS + 1) * n_bp,
                        BROADPHASE_OPS * n_bp * n_bp)
    bp_ms = {}
    for name, (mn_c, mx_c, *rest) in cases[:2]:
        lo, hi = bk.with_margin(mn_c, mx_c)
        key = name[0]
        bp_ms[key] = device_ms(
            lambda: bk.cuda_idx_count(lo, hi, *rest, MAX_NEIGHBORS))
        one_ms = median_ms(
            lambda: bk.cuda_idx_count(lo, hi, *rest, MAX_NEIGHBORS))
        print(f"[times] broadphase kernel alone, case {key} (N={N_STRESS}, "
              f"K={MAX_NEIGHBORS}; union pre-pass + main kernel): "
              f"{bp_ms[key]:.4f} ms of device time, one call through "
              f"cuda_idx_count {one_ms:.4f} ms (events, host work "
              f"included); the unions keep {kept_share[key]:.4f} of (band, "
              f"group) pairs {card}")
    kernel_ms = bp_ms["a"]
    print(f"[times] broadphase at N={N_STRESS}, K={MAX_NEIGHBORS}: "
          f"kernel {kernel_ms:.4f} ms (device time), through "
          f"neighbor_lists_aabb {wrapper_ms:.4f} ms a call (events, 10 "
          f"queued, host work included), plain {plain_ms:.4f} ms, bound "
          f"{bp_bound[0]:.4f} ms ({bp_bound[1]}, all pairs) {card}")
    with plain_broadphase():
        plain_dispatch = dispatch_ms(run, state, inp)
    kernel_dispatch = dispatch_ms(run, state, inp)
    rate_k = STEPS_PER_DISPATCH / (kernel_dispatch / 1e3)
    rate_p = STEPS_PER_DISPATCH / (plain_dispatch / 1e3)
    print(f"[times] stress {N_STRESS} boxes, {STEPS_PER_DISPATCH} steps per "
          f"dispatch: {rate_k:.2f} steps/s with the kernel "
          f"({kernel_dispatch:.1f} ms/dispatch), {rate_p:.2f} steps/s with "
          f"the plain broadphase ({plain_dispatch:.1f} ms/dispatch) {card}")

    render, views = render_phases(dev, card, state, static, build_s[1:])
    routes = route_phases(dev, card, views)
    profiling = profiling_phases(dev, card, build_s[5])
    manyworld_phase(dev, card)
    dense_phase(dev, card)
    app_phase(dev, card)
    overlay_phase(dev, card)
    new_routes_phase(dev, card, state0, state, static, views)
    sharded_phase(dev, card, state, static)

    print(json.dumps({"kernels": [{
        "name": "neighbor_lists", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bp_bound[0], "bound_by": bp_bound[1], "library_ms": None,
    }] + render + routes + profiling}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
