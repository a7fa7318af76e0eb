#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

Drives ``banggameengine_tpu_torch`` through its slices, the 10,000-box
stress tick, the shaded 1080p frame, its fused and full-carry routes, the
profiling path, the flat many-world step, the default dense route, the
application shell and its overlays and runtime scene editing, the grid
route, solid capsules on the flat step, the tiled shade over the tile
raster, the vmapped many-world step and the sharded modes on one rank,
the native OBJ loader and the windows, and checks them.  Every factory
runs as the JAX package's jitted programs do, one dispatch a call: on the
card it replays CUDA graphs (``banggameengine_tpu_torch/graphs.py``), so
a launch count below counts each kernel a replay ran, and the count a
phase checks leaves out the launches of each capture's eager warm-up
(``graphs.warmup_launches``).  The hand kernels are those of the
registry (``cuda_build.KERNELS``, every one entered by
``kernel_cases.hand_kernels``), and the comparisons route them to their
plain twins and run eagerly (``kernel_cases.plain_twins``).  The script
checks and prints no time: ``scripts/compare_kernels.py`` times a kernel
change against another tree on the card, and ``portbench/`` measures.
Phases 5, 6, 9 and 12 timed kernels, frames and builds and are retired;
the others keep their numbers.  Phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: builds every hand kernel of the registry for sm_90a, all at
   once;
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
   "error"); the launches of kernels #1, #8 (the box contacts) and #9
   (the contact solve) are counted, one each a step; the state is finite,
   above the ground and bit-equal to the same 200 steps taken with the
   plain broadphase, box contacts and contact solve; a 32-box scene
   tracks the JAX package's trajectory
   (``tests/data/stress32_jax_golden.json``); then kernels #8 and #9
   against their plain versions, every output exactly equal, on the
   inputs that eager steps hand them (``kernel_cases.recorded_inputs``):
   the stress step at step 0 and after 200 steps (N=10,000, K=8), the
   packed pile and the flat many-world step at ``ROLLOUT_WORLDS`` worlds
   after 200 steps, their launches counted there too (N=65,536, K=7);
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
   timers (what their ``main`` runs) on those probes and stages, each
   time positive and the gather launched by the probe's (no time
   printed); ``scripts/trace_summary`` on ``frame_tiled`` and ``tick``:
   each of their hand kernels once an execution, a busy share in (0, 1];
15. the many-world slice, kernels #8 and #9 its only hand kernels:
   ``parallel.make_flat_many_world_step`` at 1,000 worlds of 8 boxes, a
   character and a trigger (16,000 entities in one flat world): 200 steps
   in 4 dispatches of 50 with zero input and again with per-world input
   (seeded), no host synchronisation and one launch of kernels #8 and #9 a
   step; the
   states finite and above the ground; the zero-input worlds bit-equal
   to world 0, the per-world characters apart; 50 one-step dispatches
   bit-equal to one 50-step dispatch; a 4-world run against the JAX
   package's flat step with per-world inputs
   (``tests/data/flat4_jax_golden.json``: floats within the bars it
   stores, bools exact);
16. the default route (``broadphase="dense"``: all-pairs AABB neighbor
   lists, the narrowphase manifolds, the unified solver, the character
   step against every entity), kernel #10 alone on it (the unified
   solve: its set-up and 10 sweeps, 11 launches a step): ``build_demo_like``
   (the character, the checkpoint trigger and the static ground box), 480
   zero-input steps through ``make_multi_step_fn(static, 100)`` (4
   dispatches and one of 80) and 360 steps sprinting toward the trigger
   through ``make_step_fn_with_events`` (6 dispatches of 60), no host
   synchronisation, no other hand-kernel launch: the character's position
   within the JAX golden's bar (``tests/data/demo_jax_golden.json``) after
   the landing and every 60 walking steps, the trigger's Enter and Exit
   on the golden's steps; then 200 boxes and a character sprinting into
   an exact shape trigger (``trigger_mode="shape"``) for 300 steps in 6
   events dispatches of 50, held to the same golden: trigger events exact at
   every step, the character's position and on-ground flag every 50
   steps, the boxes' positions every 50 steps through step 250, each
   within the bar the golden stores; finite, every box above y = 0.2,
   ``contact_overflow`` and the neighbor lists' ``nbr_overflow`` printed;
   the 12-box world after 60 steps against the golden;
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
   kernels and with their plain versions; the host synchronisations a
   display frame (CUDA sync debug mode "warn");
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
   the blocking host syncs a display frame; the JAX app's inputs
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
   over the tile raster: the 10k-box world
   on ``broadphase="grid"`` (``GRID_KW``: a table of at least N cells)
   for 200 steps in 4 dispatches of 50 with no host sync and no hand
   kernel, its neighbor lists on the card equal to the same function's
   on the CPU on the same inputs at steps 0 and 200 (differing pairs and
   their AABB gaps to the margin printed before the check fails), both
   overflows printed, finite and above the ground, its trajectory within
   the JAX test's bars (``tests/test_contact_t.py:193-199``) of phase 4's
   all-pairs run (kernel #1), the 32-box grid golden
   (``tests/data/grid32_jax_golden.json``); 1,000 worlds of the capsule scene
   (``tests/data/capsule_flat_jax_golden.npz``) on the flat static route
   for 240 steps, kernel #9 its only hand kernel (the mixed scene's
   contacts take the plain version): every world equal to world 0 within
   1e-6, world 0
   within 2e-4 of JAX's flat step over the golden's 50 steps, the
   upright capsule at rest at hh + r +- 0.1; the tiled
   shade over the tile raster on both 1080p views (launches counted, no
   host sync, bit-equal to the plain versions, the showcase bit-equal to
   the tiled frame over the walk, the pixels apart on the 10k-box view
   printed), its row-gather fallback at a resolve of 80 slots (the pixels
   that take it counted, the frame bit-equal to the full resolve), the
   256x160 frame against ``tests/data/tiled_tile_jax_golden.npz``;
20. the sharded modes, the native loader and the windows, no hand kernel
   on them but kernels #8 and #9 on the flat step's and #10 on the
   vmapped step's (the worlds' rows folded into one solve), on a one-rank
   NCCL group
   (``parallel.ranks.init_rank``); each
   sharded program runs as a CUDA graph with its collectives inside, and
   through ``graphs.eager()`` from the same start, every output of every
   call bit-equal between the two routes with no host sync in a call,
   with its host launches a call on both routes: (a)
   ``make_sharded_many_world_step`` (``torch.func.vmap`` of the engine
   step) on the world mesh at 1,000 worlds of phase 15's scene, 100
   steps in dispatches of 50 with zero and with per-world input, no host
   sync, no functorch BatchedFallback warning, finite and above the
   ground, within 2e-4 of the flat step after 25 steps (bools exact), its
   ``with_metrics`` form (two 10-step calls on both routes, the means
   finite); (b) the router's layout on the one-rank mesh
   (``"flat"``), the flat step with ``mesh=`` bit-equal to ``mesh=None``
   and two 10-step calls on both routes; (c) ``SW_SHARDED_STEPS``
   donated fully sharded steps of phase 4's 10k-box state on both
   routes, the first within the JAX test's bars of the dense route from
   the same state (``warm_start=False``: the sharded solve starts cold,
   and the state's contact cache is the all-pairs route's), and the demo
   topology's 120 steps on both routes, the graph route's against
   ``tests/data/sharded_world_jax_golden.json`` (events exact, floats
   within the bar it stores); (d) the entity-sharded
   contact phase on the 10k-box state on both routes, within 1e-5 of the
   same phase on the CPU (a gloo group); (e) the native library built with
   g++ into ``banggameengine_tpu_torch/_build/``, every mesh of
   ``tests/data/app_assets`` loaded natively within
   ``tests/test_native.py``'s bars of the Python loader,
   ``ResourceManager.load_mesh`` on the native route, and without
   ``DISPLAY`` ``XcbWindow`` raising and ``create_window`` headless; (f)
   ``dryrun_multichip(1)`` on the card;
21. graphs: every factory of the JAX package's one-dispatch programs,
   through its graphs and through ``graphs.eager()`` from the same start
   in this run, every output bit-equal between the two routes and the
   hand kernels' launches through the replays equal to the eager
   launches: the 10k-box stress multi-step (kernel #1, one step's graph
   replayed 50 times a call), the tick (#1, #3, #2; a step graph then a
   frame graph) and its ``merged=True`` form (one graph), the fused (#4)
   and flat (#5) showcase frames at 1920x1080, the flat and vmapped
   many-world steps at 1,000 worlds with per-world input, the demo step,
   the app's fused and default display frames at 1280x720 through the
   track's first ``G_APP_FRAMES``, a hot reload (the hot-reloadable step
   with the scene rebuilt half-way: copied in, one capture) and spawns
   that grow the level table (the next step captures anew); each with
   its host launches a call (graph: replays, input copies and output
   clones, at most ``G_STRESS_HOST_MAX`` for the stress dispatch; eager:
   ATen ops and hand kernels); and a one-step flat many-world call
   (flatten, the flat step and unflatten: three graphs) traced, its
   kernels in the trace;
22. kernel #10 vs plain: the unified solve against its plain twin, every
   output bit-equal (the joints' impulses and ``limit_rows`` included),
   on the solves eager steps of the main path hand it: the demo world and
   300 boxes on the dense route (no joints, 11 launches a solve), the
   benchmark's 136 ragdolls (the dense route, each side's split) at
   their start and after 60 steps, and its 4,096 Ant worlds on the flat
   step (the static route with joints, mass splitting, 36,864 bodies: the
   serial sweeps) after 24 steps of random commands (22 launches a
   solve); the jointed runs through their graphs, no host sync, 22
   launches a step through the replays.

The line before the last is the registry as JSON: each hand kernel's
key, library, source and the TPU kernel it stands for; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Without a CUDA device it exits 1.

    python3 chip_smoke.py

:func:`broadphase_bound`, :func:`walk_bound` and :func:`resolve_bound`
are the kernels' rooflines that ``portbench/harness/roofline.py`` froze;
``portbench/tests/test_portbench_roofline.py`` holds the copies to them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from banggameengine_tpu_torch import convert, graphs, kernel_cases
from banggameengine_tpu_torch.kernel_cases import (
    hand_kernels,
    plain_twins,
    recorded_inputs,
    sorted_broadphase_inputs,
)
from banggameengine_tpu_torch.scene.synthetic import (
    TICK_CAMERA_POS,
    TICK_CAMERA_YAW_PITCH,
)
from banggameengine_tpu_torch.state import FEAT_STRIDE
from banggameengine_tpu_torch.utils.profiling import bound_ms

N_STRESS = 10_000
STEPS_PER_DISPATCH = 50
DISPATCHES = 4                 # 200 steps
MAX_NEIGHBORS = 8
ROLLOUT_WORLDS = 4096   # the flat step of the rollout cell: 65,536 rows
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
# operations of the broadphase's union pre-pass: per body the margins (6)
# and its 6 bounds into its band's and its group's unions (24); per
# (band, group) pair 6 compares and 5 ands
UNION_BODY_OPS, UNION_PAIR_OPS = 30, 11
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
# by frame 27; 2.5 s and 1.5 s took phase 17 over its 60 s on the H100)
APP_DEFAULT_SECONDS = 1.0
OVERLAY_GOLDEN = os.path.join(DATA, "overlay_jax_golden.npz")
LIFECYCLE_GOLDEN = os.path.join(DATA, "lifecycle_jax_golden.json")
# the overlay run: the track's first second (the least phase 18 asks)
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


def build_in_parallel(loaders) -> None:
    """Call every kernel loader at once, one thread each (each ``nvcc`` is
    its own process, each library has its own build directory); the first
    failure raises."""
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        list(pool.map(lambda load: load(), loaders))


def reset_launches() -> None:
    """Set every hand kernel's launch count, and the captures' warm-up
    counts, to 0."""
    for kernel in hand_kernels().values():
        kernel.launches = 0
    graphs.warmup_launches.clear()


def launch_counts(warm: bool = False) -> dict:
    """The hand kernels' launches since :func:`reset_launches`, by the
    registry's key, those with any; with ``warm``, those the captures'
    eager warm-ups made (which the count without holds too)."""
    counts = (graphs.warmup_launches if warm else
              {k: v.launches for k, v in hand_kernels().items()})
    return {k: n for k, n in counts.items() if n}


# kernel #10's launches a step of the dense and grid routes without joints:
# the contacts' set-up and one launch a sweep of the step's 10 iterations
DENSE_UNIFIED = 11


def without_unified(counts: dict) -> dict:
    """``counts`` less kernel #10's, which the app's physics on the dense
    route launches ``DENSE_UNIFIED`` times a step."""
    n = counts.get("unified", 0)
    check(n % DENSE_UNIFIED == 0, f"kernel #10 launched {n} times, not "
          f"{DENSE_UNIFIED} a step")
    return {k: v for k, v in counts.items() if k != "unified"}


def dense_only(what: str, steps: int | None = None) -> None:
    """Check that kernel #10 is the only hand kernel launched since
    :func:`reset_launches`, ``DENSE_UNIFIED`` times a step of the dense
    route: ``steps`` steps through the replays, or a whole number of steps
    where ``steps`` is None."""
    hand, replayed = launch_counts(), replayed_counts()
    n = replayed.get("unified", 0)
    check(set(hand) == {"unified"}
          and (n == DENSE_UNIFIED * steps if steps is not None
               else n > 0 and n % DENSE_UNIFIED == 0),
          f"{what}: hand-kernel launches {hand} "
          f"({launch_counts(warm=True)} in the captures' warm-ups), kernel "
          f"#10 alone, {DENSE_UNIFIED} a step"
          + (f" of {steps}" if steps is not None else "") + ", expected")


# kernel #10's launches a step with joints: the rows' set-up, the contacts'
# set-up and two launches a sweep of the step's 10 iterations
JOINTED_UNIFIED = 22
UNIFIED_ANT_CALLS = 12   # phase 22: the Ant's calls of random commands


def replayed_counts() -> dict:
    """:func:`launch_counts` less the captures' warm-ups."""
    warm = launch_counts(warm=True)
    return {k: n - warm.get(k, 0) for k, n in launch_counts().items()
            if n != warm.get(k, 0)}


@contextlib.contextmanager
def no_host_sync():
    """A host synchronisation inside raises (CUDA sync debug mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def walk_work(counts, pack) -> tuple[int, int, int]:
    """(walked rows, used rows, pixel-row pairs of the used rows) of one
    walk: rows below each tile's count, and those with ok set."""
    k_pad = pack.shape[1]
    in_count = torch.arange(k_pad, device=pack.device)[None, :] < counts[:,
                                                                         None]
    walked = int(in_count.sum())
    used = int((in_count & (pack[..., 9] > 0)).sum())
    return walked, used, used * 4096


def walk_bound(counts, pack, tiles_x: int) -> tuple[float, str]:
    """The walk's bytes, and the operations of the (pixel, used slot)
    pairs in the (warp, slot) pairs its cover boxes keep: what these
    inputs need (the cover-box tests, under 1 % of that, left out)."""
    walked, _, pairs = walk_work(counts, pack)
    n = pack.shape[0]
    kept = 1.0 - walk_skip_share(counts, pack, tiles_x)
    return bound_ms(4 * n + 40 * walked + 8 * n * 4096,
                    RASTER_OPS * pairs * kept)


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


def resolve_bound(slot, table) -> tuple[float, str]:
    n, c, kl = table.shape
    return bound_ms(
        4 * slot.numel() + 4 * n * c * kl + 4 * c * slot.numel(), 0)


def broadphase_bound(mn, mx) -> tuple[float, str]:
    """Kernel #1's bound from what these inputs need: its bytes (each
    box, flag, layer and mask read once, K + 1 ints a row written), the
    union pre-pass and the pair tests of the (band, group) pairs the
    unions keep."""
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk

    n = mn.shape[0]
    kept = bk.band_group_kept(*bk.with_margin(mn, mx))
    ops = (UNION_BODY_OPS * n + UNION_PAIR_OPS * kept.numel()
           + BROADPHASE_OPS * int(kept.sum()) * bk.BAND_ROWS
           * bk.GROUP_COLS)
    return bound_ms(36 * n + 4 * (MAX_NEIGHBORS + 1) * n, ops)


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


def contacts_phase(dev, static, state0, state, inp) -> None:
    """Phase 4's check of kernel #8, the box contacts, on the inputs that
    eager steps of the main path hand it: the stress step at step 0 and
    after 200 steps (N=10,000, K=8; few boxes touch yet), phase 3's
    packed pile (N=96, every box in contact) and the flat many-world step
    of ``ROLLOUT_WORLDS`` worlds after 200 steps of its own, whose
    launches are counted (N=65,536, K=7).  Every output of the kernel
    exactly equal to its plain version's."""
    from banggameengine_tpu_torch.engine import make_step_fn
    from banggameengine_tpu_torch.parallel.manyworld import (
        make_flat_many_world_step, replicate_input, replicate_state)
    from banggameengine_tpu_torch.physics import contacts_kernel as ck
    from banggameengine_tpu_torch.physics import solve_kernel as sk
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
    from banggameengine_tpu_torch.state import InputFrame

    step = make_step_fn(static, broadphase="allpairs",
                        max_neighbors=MAX_NEIGHBORS)
    pile, pile_static = packed_pile(dev)
    with recorded_inputs("contacts", "solve") as rec:
        step(state0, inp)
        step(state, inp)
        make_step_fn(pile_static, broadphase="allpairs",
                     max_neighbors=MAX_NEIGHBORS)(pile, inp)
    calls, solves = rec["contacts"], rec["solve"]

    # the rollout's flat step: 200 steps through its graphs, then one
    # eager step recorded
    w = ROLLOUT_WORLDS
    state1, static1 = build_falling_boxes(**MW_SCENE, device=dev)
    run = make_flat_many_world_step(static1, w, state1.comp_mask,
                                    num_steps=STEPS_PER_DISPATCH)
    one = make_flat_many_world_step(static1, w, state1.comp_mask)
    zero = replicate_input(InputFrame.zero(dev), w)
    reset_launches()
    steps = DISPATCHES * STEPS_PER_DISPATCH
    with no_host_sync():
        flat = replicate_state(state1, w)
        for _ in range(DISPATCHES):
            flat = run(flat, zero)
    torch.cuda.synchronize()
    flat_launches = ck.KERNEL.launches
    flat_warm = graphs.warmup_launches["contacts"]
    check(flat_launches - flat_warm == steps,
          f"the flat step at {w} worlds launched kernel #8 {flat_launches} "
          f"times ({flat_warm} in the capture's warm-up) in {steps} steps")
    check(replayed_counts() == {"contacts": steps, "solve": steps},
          f"the flat step at {w} worlds launched {launch_counts()} "
          f"({launch_counts(warm=True)} in the capture's warm-up) in "
          f"{steps} steps")
    with recorded_inputs("contacts", "solve") as rec:
        one(flat, zero)
    calls += rec["contacts"]
    solves += rec["solve"]
    print(f"[contacts] the flat many-world step at {w} worlds: {steps} "
          f"steps in {DISPATCHES} dispatches of {STEPS_PER_DISPATCH} (no "
          f"host sync), kernel #8 launched {flat_launches} times "
          f"({flat_warm} in the capture's warm-up)")

    names = (f"stress {N_STRESS}, step 0", f"stress {N_STRESS}, step {steps}",
             "packed 96-box pile", f"flat {w} worlds, step {steps}")
    check(len(calls) == len(names),
          f"kernel #8: {len(calls)} box_contacts calls recorded")
    for name, args in zip(names, calls):
        *_, budget, orig = args
        n, k = args[3].shape
        got = ck.box_contacts(*args)
        want = ck.box_contacts_reference(*args)
        torch.cuda.synchronize()
        check(len(got) == len(want)
              and all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(got, want)),
              f"kernel #8, {name}: differs from the plain version")
        prt, valid = want[0], want[8]
        print(f"[contacts] kernel #8 vs plain, {name} (N={n}, K={k}, "
              f"budget {budget}, feature ids "
              f"{'on' if orig is not None else 'off'}): every output exactly "
              f"equal ({int(args[4].sum())} listed pairs, "
              f"{int((valid & (prt >= 0)).sum())} pair and "
              f"{int((valid & (prt < 0)).sum())} ground contacts, overflow "
              f"{int(want[9])})")

    # kernel #9, the contact solve, on the same steps' solves
    check(len(solves) == len(names),
          f"kernel #9: {len(solves)} solve_contacts calls recorded")
    for name, args in zip(names, solves):
        got = sk.solve_contacts(*args)
        want = sk.solve_contacts_reference(*args)
        torch.cuda.synchronize()
        got = (*got[:2], *got[2]) if len(got) == 3 else got
        want = (*want[:2], *want[2]) if len(want) == 3 else want
        check(len(got) == len(want)
              and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, want)),
              f"kernel #9, {name}: differs from the plain version")
        c, n = args[6].shape
        valid = args[14]
        print(f"[solve] kernel #9 vs plain, {name} (N={n}, C={c}, "
              f"{args[18]} iterations, momentum {args[22]}, contact cache "
              f"{'on' if args[23] is not None else 'off'}): every output "
              f"bit-equal ({int(valid.sum())} valid slots)")


def render_phases(dev, stress_state, static) -> dict:
    """Phases 7 and 8: the render slice.  Returns the scenes, renderers
    and recorded kernel inputs the route phases reuse."""
    from banggameengine_tpu_torch import convert
    from banggameengine_tpu_torch.render import raster_walk as rwk
    from banggameengine_tpu_torch.render import resolve as rsv
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.pipeline import (
        make_frame_fn, make_render_fn)
    from banggameengine_tpu_torch.scene.build import BuiltScene
    from banggameengine_tpu_torch.scene.synthetic import (
        build_box_render, build_showcase_render)
    from banggameengine_tpu_torch.state import InputFrame

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
    box_rs = convert.render_scene_from_numpy(build_box_render(static))
    box_render = make_render_fn(box_rs, RENDER_W, RENDER_H, bin_capacity=2048)
    print(f"[render] scenes: showcase {int(show_rs.tri_valid.sum())} "
          f"triangles, 10k-box world {int(box_rs.tri_valid.sum())} "
          f"triangles")

    # ---- 7. kernels vs plain --------------------------------------------
    with recorded_inputs() as show_in:
        render(*show_args)
    with recorded_inputs() as box_in:
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
    for name, (counts, pack, tiles_x) in walk_cases:
        dep_k, slot_k = rwk.cuda_raster_walk(counts, pack, tiles_x)
        dep_p, slot_p = rwk.raster_walk_reference(counts, pack, tiles_x)
        torch.cuda.synchronize()
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
    for name, (slot, table) in resolve_cases:
        check(bool(torch.isfinite(table).all()), f"resolve {name}: table "
              "not finite (the one-hot contract needs it)")
        out_k = rsv.cuda_resolve_tiles_wide(slot, table)
        out_p = rsv.resolve_tiles_wide_reference(slot, table)
        torch.cuda.synchronize()
        check(torch.equal(out_k, out_p), f"resolve {name}: differs")
        print(f"[render-kernel-vs-plain] resolve {name}: exactly equal "
              f"({tuple(out_k.shape)}, slots up to {int(slot.max())}, "
              f"KL {table.shape[2]})")

    # ---- 8. the render slice --------------------------------------------
    reset_launches()
    with no_host_sync():
        frame, depth = render(*show_args)
        depth_only = render_depth(*show_args)
    torch.cuda.synchronize()
    walks, resolves = rwk.KERNEL.launches, rsv.KERNEL.launches
    check(replayed_counts() == {"walk": 2, "resolve": 1},
          f"showcase frames: walk launched {walks}, resolve {resolves} times "
          f"({launch_counts(warm=True)} in the captures' warm-ups)")
    check(frame.dtype == torch.uint8
          and tuple(frame.shape) == (RENDER_H, RENDER_W, 4),
          f"frame {frame.dtype}{tuple(frame.shape)}")
    sky_px = depth == 1.0
    sky = torch.tensor(SKY, dtype=torch.uint8, device=dev)
    check(bool((frame[sky_px] == sky).all()), "a background pixel is not sky")
    sky_share = float(sky_px.float().mean())
    check(0.2 < sky_share < 0.8, f"sky share {sky_share}")
    check(torch.equal(depth, depth_only), "depth-only frame differs")
    with plain_twins():
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
    reset_launches()
    with no_host_sync():
        for _ in range(FRAME_TICKS):
            state, img, events = tick(state, inp, *tick_args)
        # the step graph's buffers
        state, events = graphs.owned(state), graphs.owned(events)
    torch.cuda.synchronize()
    launches, warm = launch_counts(), launch_counts(warm=True)
    check(replayed_counts() == dict.fromkeys(
        ("broadphase", "contacts", "solve", "walk", "resolve"), FRAME_TICKS),
          f"{FRAME_TICKS} ticks launched {launches} ({warm} in the "
          f"captures' warm-ups)")
    check(tuple(img.shape) == (RENDER_H, RENDER_W, 4)
          and bool(torch.isfinite(state.pos).all()),
          "tick: bad frame or non-finite state")
    s_k, img_k, _ = tick(state, inp, *tick_args)
    with plain_twins():
        s_p, img_p, _ = tick(state, inp, *tick_args)
    torch.cuda.synchronize()
    check(torch.equal(img_k, img_p), "tick frame differs from the plain one")
    for field in ("pos", "quat", "lin_vel", "ang_vel", "world"):
        check(torch.equal(getattr(s_k, field), getattr(s_p, field)),
              f"tick state differs from the plain one in {field}")
    print(f"[render-slice] {FRAME_TICKS} ticks of make_frame_fn "
          f"(step + {RENDER_W}x{RENDER_H} frame) on the 10k-box world "
          f"from step {int(stress_state.step_idx)}, camera at "
          f"{TICK_CAMERA_POS} looking up (no host sync; a step graph and "
          f"a frame graph a tick): launches "
          f"{launches} ({warm} in the captures' warm-ups); one more tick "
          f"bit-equal to the plain versions; frame overflow "
          f"{frame_overflow(box_rs, state.world, *tick_args[:2])} pairs, "
          f"contact_overflow {int(events.contact_overflow)}, "
          f"{int((img != sky).any(-1).sum())} non-sky pixels")

    views = {"showcase": (show_rs, show_args, show_in),
             "10k-box": (box_rs, box_args, box_in)}
    return views


def route_phases(dev, views: dict) -> None:
    """Phases 10 and 11: the fused and the full-carry frame routes on both
    views."""
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
        with recorded_inputs() as r_fused:
            routes["fused"][name](*args)
        with recorded_inputs() as r_flat:
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
    for name, (counts, pack, tables, tiles_x) in fused_cases:
        dep_k, slot_k, res_k = rr.cuda_raster_resolve_tiles(counts, pack,
                                                            tables, tiles_x)
        dep_p, slot_p, res_p = rr.raster_resolve_tiles_reference(
            counts, pack, tables, tiles_x)
        dep_w, slot_w = rwk.cuda_raster_walk(counts, pack, tiles_x)
        torch.cuda.synchronize()
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
    for name, (*args, tiles_x) in tile_cases:
        out_k = rt.cuda_raster_tiles(*args, tiles_x)
        out_p = rt.raster_tiles_reference(*args, tiles_x)
        torch.cuda.synchronize()
        for plane, a, b in zip(("depth", "tri_id", "b1", "b2", "slot"),
                               out_k, out_p):
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
        reset_launches()
        with no_host_sync():
            frames[mode] = {name: routes[mode][name](*args)
                            for name, (_, args, _) in views.items()}
        torch.cuda.synchronize()
        launches[mode] = launch_counts()
        want = {"fused": 2} if mode == "fused" else {"tile": 4}
        check(replayed_counts() == want,
              f"{mode} frames: launches {launches[mode]} ("
              f"{launch_counts(warm=True)} in the captures' warm-ups), "
              f"expected {want} in the replays")
    frames["tiled"] = {name: routes["tiled"][name](*args)
                       for name, (_, args, _) in views.items()}
    with plain_twins():
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
          f"{launches['fused']}, flat frames {launches['flat']} (each "
          f"frame's graph replayed once; the counts include each capture's "
          f"eager warm-up)")


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


def profiling_phases(dev) -> None:
    """Phases 13 and 14: the u8 row gather against its plain version,
    then the profiling path: the shade-parts probe, the frame stage timer
    and the trace summary."""
    from banggameengine_tpu_torch.scripts import gather_rows as gr
    from banggameengine_tpu_torch.scripts import profile_render as prr
    from banggameengine_tpu_torch.scripts import profile_shade_parts as psp
    from banggameengine_tpu_torch.scripts import trace_summary as ts

    # ---- 13. gather kernel vs plain ---------------------------------------
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
    for name, (t, i) in cases:
        out_k = gr.cuda_gather_rows_u8(t, i)
        out_p = gr.gather_rows_u8_reference(t, i)
        torch.cuda.synchronize()
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
    with no_host_sync():
        outs = {k: fn(*args) for k, (fn, args) in runs.items()}
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

    # the timers of profile_shade_parts.main and profile_render.main run
    # on the card, on the probes and stages built above; their printout
    # (the times) is left out
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        probe_ms = psp.time_probes(probes, dev)
        launches = gr.KERNEL.launches
        stage_ms = prr.time_stages(stages, dev)
    check(launches > 0, "the shade-parts probe did not launch the gather")
    check(all(np.isfinite(v) and v > 0 for v in
              list(probe_ms.values()) + list(stage_ms.values())),
          "a probe or stage time is not positive")
    print(f"[profile] the shade-parts probe's timer ran and launched the "
          f"gather {launches}x; the stage timer ran {len(stage_ms)} stages")

    want = {"frame_tiled": ("raster_walk_kernel", "resolve_wide_kernel"),
            "tick": ("group_bounds_kernel", "neighbor_lists_kernel",
                     "raster_walk_kernel", "resolve_wide_kernel")}
    for name, kernels in want.items():
        s = _traced(*ts.build(name, dev))
        check(s["launches"] > 0 and 0.0 < s["busy_share"] <= 1.0,
              f"trace {name}: {s['launches']} launches, busy share "
              f"{s['busy_share']}")
        counts = {k: sum(e["count"] for e in s["kernels"]
                         if k in e["name"]) for k in kernels}
        check(all(c == 1 for c in counts.values()),
              f"trace {name}: launches per execution {counts}")
        print(f"[profile] trace_summary {name}: {s['launches']:g} launches "
              f"an execution, each of {', '.join(kernels)} once")


def _traced(fn, args=()) -> dict:
    """``trace_summary``'s summary of ``fn(*args)``, its printout (kernel
    times) left out."""
    from banggameengine_tpu_torch.scripts import trace_summary as ts

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        return ts.trace_and_summarize(fn, args, tmp)


def manyworld_phase(dev, w: int = MW_WORLDS) -> None:
    """Phase 15: the flat many-world step at 1,000 worlds of 8 boxes, a
    character and a trigger (kernels #8 and #9 the only hand kernels on
    this path, once a step each)."""
    from banggameengine_tpu_torch.parallel.manyworld import (
        make_flat_many_world_step, replicate_input, replicate_state)
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
    from banggameengine_tpu_torch.state import SHAPE_BOX, InputFrame

    # ---- 15. the many-world slice ---------------------------------------
    state1, static1 = build_falling_boxes(**MW_SCENE, device=dev)
    run = make_flat_many_world_step(static1, w, state1.comp_mask,
                                    num_steps=STEPS_PER_DISPATCH)
    one = make_flat_many_world_step(static1, w, state1.comp_mask)
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

    # the run: 200 steps, 4 dispatches of 50, no host sync, kernels #8 and
    # #9 the only hand kernels
    reset_launches()
    steps = DISPATCHES * STEPS_PER_DISPATCH
    with no_host_sync():
        state = bstate0
        for _ in range(DISPATCHES):
            state = run(state, zero_inp)
        # run's buffers: the driven run reuses them
        state = graphs.owned(state)
        driven = bstate0
        for i in range(DISPATCHES):
            driven = run(driven, drive)
            if i == 1:
                # step 100: boxes touch at 109-112
                driven_mid = graphs.owned(driven)
    torch.cuda.synchronize()
    hand = launch_counts()
    box_warm = launch_counts(warm=True).get("contacts", 0)
    check(set(hand) == {"contacts", "solve"}
          and replayed_counts() == {"contacts": 2 * steps,
                                    "solve": 2 * steps},
          f"the many-world path launched {hand} hand kernels "
          f"({box_warm} of kernel #8 in the capture's warm-up) in "
          f"{2 * steps} steps")
    lowest = checked(state, "zero input")
    check(state.step_idx.tolist() == [steps] * w,
          "step_idx not in lockstep")
    _, events = one.flat_step(one.flatten(state), zero_inp)
    grounded = int(state.char_on_ground[:, MW_CHAR_ROW].sum())
    print(f"[manyworld] {w} worlds x {static1.capacity} entities "
          f"({w * static1.capacity} in one flat world; 8 boxes, a "
          f"character and a trigger each): {steps} steps in {DISPATCHES} "
          f"dispatches of {STEPS_PER_DISPATCH}, zero input, then again with "
          f"per-world input (no host sync, kernels #8 and #9 the only hand "
          f"kernels, {2 * steps} launches each through the replays): state "
          f"finite, lowest "
          f"box corner "
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
    with no_host_sync():
        s1 = driven_mid
        for _ in range(STEPS_PER_DISPATCH):
            s1 = one(s1, drive)
            pair_seams += (s1.contact_feat >= FEAT_STRIDE).any()
        s50 = run(driven_mid, drive)
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


def _event_list(planes, first: int) -> list:
    """[steps, T, N] event planes -> [[step, trigger slot, entity], ...],
    steps counted from ``first`` (as the golden stores them)."""
    return [[i + first, t, e] for i, t, e in planes.nonzero().tolist()]


def dense_phase(dev) -> None:
    """Phase 16: the JAX package's default route (``broadphase="dense"``)
    on the demo world, the 200-box world and the 12-box world (no hand
    kernel on this path)."""
    from banggameengine_tpu_torch.engine import (
        make_multi_step_fn, make_step_fn, make_step_fn_with_events)
    from banggameengine_tpu_torch.physics.broadphase import (
        build_neighbor_lists_dense)
    from banggameengine_tpu_torch.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame)

    def input_frame(values: dict) -> InputFrame:
        return InputFrame(**{
            k: torch.tensor(v, dtype=torch.bool if k in ("jump", "sprint")
                            else torch.float32, device=dev)
            for k, v in values.items()})

    # ---- 16. the demo world and the dense route ---------------------------
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
    reset_launches()
    with no_host_sync():
        state = state0
        for _ in range(settle // DEMO_DISPATCH):
            state = run(state, zero)
        state = tail(state, zero)
        settled = graphs.owned(state)
        chunks = []
        for _ in range(walk_steps // WALK_CHUNK):
            state, events = walk(state, walk_inp)
            # walk's buffers
            chunks.append((graphs.owned(state), events))
    torch.cuda.synchronize()
    dense_only("the demo", settle + walk_steps)
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
          f"no host sync, kernel #10 alone launched ({DENSE_UNIFIED} a "
          f"step)")
    print(f"[demo] the character rests at y = {rest[1]:.6f} on the ground "
          f"box (on the ground: True); trigger Enter at step {enter}, Exit "
          f"at {leave} (the JAX golden's {gd['enter_steps']}, "
          f"{gd['exit_steps']}); max |pos - JAX| at steps {settle}, "
          f"{settle + WALK_CHUNK}, ..., {settle + walk_steps}: "
          f"{max(errs):.3g} (< {gd['atol']:g})")

    # ---- the 200-box world on the dense route, exact shape triggers ------
    gdn = golden["dense"]
    every, dchar = gdn["every"], gdn["char"]
    b0, bstatic = build_falling_boxes(**gdn["scene"], device=dev)
    bwalk = input_frame(gdn["input"])
    brun = make_step_fn_with_events(bstatic, every,
                                    trigger_mode=gdn["trigger_mode"])
    reset_launches()
    with no_host_sync():
        bstate, bchunks = b0, []
        for _ in range(gdn["steps"] // every):
            bstate, bev = brun(bstate, bwalk)
            bchunks.append((graphs.owned(bstate), bev))   # brun's buffers
    torch.cuda.synchronize()
    dense_only("the 200-box world", gdn["steps"] // every * every)
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
    for c, (s, ev) in enumerate(bchunks):
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
    overflow = max(int(ev.contact_overflow.max()) for _, ev in bchunks)
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
          f"(no host sync, kernel #10 alone): state "
          f"finite, lowest box centre {lowest:.4f} > {DENSE_FLOOR}, "
          f"{landed} boxes at rest (|v_y| < 0.05); trigger Enter "
          f"{got_ev['enter']}, Exit {got_ev['exit']} ([step, trigger, "
          f"entity], as the JAX golden's); character on the ground at "
          f"steps {every}, ..., {gdn['steps']}: "
          f"{[bool(s.char_on_ground[dchar]) for s, _ in bchunks]} (as "
          f"the golden's); max |pos - JAX| every {every} steps: character "
          f"{max(char_errs):.3g} (< {gdn['char_atol']:g}), boxes through "
          f"step {gdn['box_last']} {max(box_errs):.3g} "
          f"(< {gdn['box_atol']:g}); contact_overflow {overflow} (the most "
          f"in a step), nbr_overflow {int(nl.nbr_overflow)} after step "
          f"{gdn['steps']}")

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


def _app_run(app, frames: int, fps: int, render: bool = False,
             hud: bool = False):
    """Drive ``app`` through the first ``frames`` display frames of
    ``play_demo``'s track.  Returns the record the golden keeps (the
    character, on-ground flag and step count after each frame, the bus's
    Enter/Exit with their frames), the host synchronisations the app made
    (CUDA sync debug mode "warn", counted inside ``app.frame`` and
    ``render_current_frame`` only: the track's own read of the character
    is not the app's) and the last ``render_current_frame(hud=hud)`` when
    ``render``."""
    import warnings

    from banggameengine_tpu_torch.app.events import TriggerEvent, TriggerPhase
    from banggameengine_tpu_torch.scripts.play_demo import apply_track

    cj = app.built.find_entity("cj")
    rec = dict(char=[], on_ground=[], steps=[], events=[])

    def on_event(e):
        if e.phase is not TriggerPhase.STAY:
            rec["events"].append([app.frame_count, e.phase.value,
                                  e.trigger_entity, e.other_entity])

    unsubscribe = app.bus.subscribe(TriggerEvent, on_event)
    syncs, img = 0, None
    for i in range(frames):
        apply_track(app, i, fps, cj)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                app.frame(real_dt=1.0 / fps)
                if render:
                    img = app.render_current_frame(hud=hud)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs += sum("synchronizing" in str(w.message) for w in caught)
        rec["char"].append(app.state.pos[cj].tolist())
        rec["on_ground"].append(bool(app.state.char_on_ground[cj]))
        rec["steps"].append(int(app.state.step_idx))
    unsubscribe()
    return rec, syncs, img


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


def app_phase(dev) -> None:
    """Phase 17: the application shell on the card (no hand kernel of its
    own: the walk and the resolve render its frames).  The fused app at
    1280x720 through play_demo's whole 8-s track, the default-path app
    through its first ``APP_DEFAULT_SECONDS`` with
    ``render_current_frame()`` (interpolated) every display frame; both
    held to the JAX golden
    (``tests/data/app_jax_golden.json``), the last fused frame to the
    golden's 1280x720 frame, one state of each rendered bit-equal with the
    kernels and with their plain versions."""
    from banggameengine_tpu_torch.app.application import Application
    from banggameengine_tpu_torch.render.pipeline import make_render_fn
    from banggameengine_tpu_torch.render.shading import LightParams

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
    reset_launches()
    rec, syncs, _ = _app_run(app, frames, fps)
    counts = launch_counts()
    check(without_unified(replayed_counts()) == {"walk": frames,
                                                 "resolve": frames}
          and set(counts) == {"walk", "resolve", "unified"},
          f"app (fused): {counts} launches ({launch_counts(warm=True)} in "
          f"the captures' warm-ups) in {frames} rendered frames")
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
    with plain_twins():
        p_img = render(*args)
    check(torch.equal(k_img, p_img),
          "app (fused): the last frame differs between the kernels and "
          "their plain versions")
    check(np.array_equal(k_img.cpu().numpy(), img),
          "app (fused): the app's last frame is not the kernels' frame")
    print(f"[app] fused tick (Application(fused_tick=True), "
          f"{width}x{height}): play_demo's {g['seconds']:g}-s track, "
          f"{frames} display frames of {rec['steps'][0]} fixed steps "
          f"({rec['steps'][-1]} steps); bus events "
          f"{rec['events']} ([frame, phase, trigger, other], as the JAX "
          f"golden's); max |char - JAX| {err_f:.3g} (< {g['atol']:g}); the "
          f"character rests at y = {rec['char'][2 * fps - 1][1]:.6f}; walk "
          f"and resolve launched {counts['walk']} and {counts['resolve']} "
          f"times in {frames} frames; {syncs / frames:.2f} blocking host "
          f"syncs a display frame ({syncs} in all)")
    print(f"[app] fused: the last frame vs the JAX golden's {width}x{height}"
          f" frame: {int(off.sum())} of {off.size} pixels off by more than "
          f"1 level, {int((img != ref).any(-1).sum())} off at all, sky "
          f"equal elsewhere; bit-equal with the kernels and with their "
          f"plain versions, and to the app's own frame")

    # ---- the default path, rendering every display frame ----------------
    dframes = int(APP_DEFAULT_SECONDS * fps)
    dapp = Application(assets_root=APP_ASSETS, width=width, height=height,
                       device=dev)
    reset_launches()
    drec, dsyncs, dimg = _app_run(dapp, dframes, fps, render=True)
    counts = launch_counts()
    check(without_unified(replayed_counts()) == {"walk": dframes,
                                                 "resolve": dframes},
          f"app (default): {counts} launches ({launch_counts(warm=True)} "
          f"in the captures' warm-ups) in {dframes} rendered frames")
    err_d = _app_check("default", drec, g, dframes)
    check(dimg.shape == (height, width, 4) and (dimg == SKY).all(-1).any(),
          "app (default): no sky in the interpolated frame")
    with plain_twins():
        p_dimg = dapp.render_current_frame()
    check(np.array_equal(dimg, p_dimg),
          "app (default): the interpolated frame differs between the "
          "kernels and their plain versions")
    steps_a_frame = drec["steps"][-1] / dframes
    print(f"[app] default path (Application(), {width}x{height}): the first"
          f" {APP_DEFAULT_SECONDS:g} s of the track, {dframes} display "
          f"frames, each {steps_a_frame:g} hot-reloadable steps (events, "
          f"orbit and raycast each step) and render_current_frame() "
          f"(interpolated); bus events {drec['events']}; max |char - JAX| "
          f"{err_d:.3g}; walk and resolve launched {counts['walk']} and "
          f"{counts['resolve']} times; the last frame bit-equal with the "
          f"plain versions; {dsyncs / dframes:.2f} blocking host syncs a "
          f"display frame ({dsyncs} in all)")


def unified_phase(dev) -> None:
    """Phase 22: kernel #10, the unified solve, against its plain twin on
    the solves that eager steps of the main path hand it
    (``kernel_cases.recorded_inputs``): the demo world after 200 steps and
    300 boxes after 120 steps on the dense route (no joints), the
    benchmark's ragdoll pile (136 ragdolls, the dense route, each side's
    split) at its start and after 60 steps, and the benchmark's Ant worlds
    on the flat step (the static route with joints, mass splitting; 36,864
    bodies, so the narrow set-up and the serial sweeps) after
    ``UNIFIED_ANT_CALLS`` calls of random commands.  The jointed runs go
    through their graphs with no host sync, kernel #10 launched
    ``JOINTED_UNIFIED`` times a step through the replays; each recorded
    solve launches it 22 or 11 times, and every output equals the plain
    twin's bit for bit, the joints' impulses and ``limit_rows``
    included."""
    from banggameengine_tpu_torch.engine import make_multi_step_fn
    from banggameengine_tpu_torch.parallel.manyworld import (
        make_many_world_step)
    from banggameengine_tpu_torch.physics import joints as jt
    from banggameengine_tpu_torch.physics import unified_kernel as uk
    from banggameengine_tpu_torch.scene.ant import build_ant_worlds
    from banggameengine_tpu_torch.scene.ragdolls import build_ragdoll_pyramid
    from banggameengine_tpu_torch.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu_torch.state import InputFrame

    root = os.path.dirname(os.path.abspath(__file__))
    zero = InputFrame.zero(dev)

    def counted(what: str, run, steps: int):
        """``run()`` through the graphs with no host sync, kernel #10
        launched ``JOINTED_UNIFIED`` times a step of ``steps`` through the
        replays; its result owned."""
        reset_launches()
        with no_host_sync():
            out = graphs.owned(run())
        torch.cuda.synchronize()
        n = replayed_counts().get("unified", 0)
        check(n == JOINTED_UNIFIED * steps,
              f"{what}: kernel #10 launched {n} times through the replays "
              f"({launch_counts(warm=True)} in the captures' warm-ups), "
              f"not {JOINTED_UNIFIED} a step of {steps}")
        print(f"[unified] {what}: {steps} steps through the graphs (no host "
              f"sync), kernel #10 launched {n} times through the replays "
              f"({JOINTED_UNIFIED} a step); hand kernels {launch_counts()}")
        return out

    # the dense route without joints: the demo world and 300 boxes
    demo, demo_static = build_demo_like(device=dev)
    demo_run = make_multi_step_fn(demo_static, DEMO_DISPATCH)
    for _ in range(2):
        demo = demo_run(demo, zero)
    boxes, box_static = build_falling_boxes(300, seed=5, spread=6.0,
                                            device=dev)
    boxes = make_multi_step_fn(box_static, 120, broadphase="dense")(boxes,
                                                                    zero)
    with recorded_inputs("unified") as rec:
        make_multi_step_fn(demo_static, 1)(demo, zero)
        make_multi_step_fn(box_static, 1, broadphase="dense")(boxes, zero)
    solves = list(zip((f"demo, step {2 * DEMO_DISPATCH}",
                       "300 boxes, step 120"), rec["unified"]))

    # the ragdoll pile of the benchmark
    with open(os.path.join(root, "portbench", "configs",
                           "bullet-ragdolls136.json")) as f:
        sc = build_ragdoll_pyramid(json.load(f)["scene"], device=dev)
    js0 = jt.make_joint_state(sc.joints)
    kw = dict(joints=sc.joints, broadphase="dense", max_neighbors=8)
    run = make_multi_step_fn(sc.static, 60, **kw)
    state, js = counted("the ragdoll pile", lambda: run(sc.state, zero, js0),
                        60)
    one = make_multi_step_fn(sc.static, 1, **kw)
    with recorded_inputs("unified") as rec:
        one(sc.state, zero, js0)
        one(state, zero, js)
    solves += zip(("ragdolls, step 0", "ragdolls, step 60"), rec["unified"])

    # the Ant worlds of the benchmark on the flat step, two steps a call
    with open(os.path.join(root, "portbench", "configs",
                           "isaacgym-ant4k.json")) as f:
        cfg = json.load(f)
    w = cfg["scene"]["num_worlds"]
    aw = build_ant_worlds(cfg["scene"], cfg["physics"], num_worlds=w, seed=7,
                          device=dev)
    step, layout = make_many_world_step(aw.static, None,
                                        aw.state.comp_mask[0], w,
                                        num_steps=2, joints=aw.joints,
                                        verbose=False)
    check(layout == "flat", f"the Ant worlds took the {layout} layout")
    gen = torch.Generator(device="cpu").manual_seed(3)
    commands = [torch.randn(w, 8, generator=gen).clamp(-1, 1).to(dev)
                for _ in range(UNIFIED_ANT_CALLS)]
    ant_js = jt.make_joint_state(aw.joints, w)

    def ant_run():
        state, js = aw.state, ant_js
        for u in commands:
            state, js = graphs.clone_tree(step(state, zero, js, u))
        return state, js

    steps = 2 * UNIFIED_ANT_CALLS
    state, js = counted(f"the Ant, {w} worlds", ant_run, steps)
    with recorded_inputs("unified") as rec:
        step(state, zero, js, torch.zeros(w, 8, device=dev))
    solves.append((f"the Ant, {w} worlds, step {steps}", rec["unified"][0]))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(len(solves) == 5, f"kernel #10: {len(solves)} solves recorded")
    for name, args in solves:
        n, c = args[8].shape
        joints = args[19]
        before = uk.KERNEL.launches
        got = uk.solve_unified(*args)
        launched = uk.KERNEL.launches - before
        want = uk.solve_unified_reference(*args)
        torch.cuda.synchronize()
        expect = DENSE_UNIFIED if joints is None else JOINTED_UNIFIED
        check(launched == expect, f"kernel #10, {name}: {launched} "
              f"launches, not {expect}")
        check(args[18] is not None and args[15] == 10,
              f"kernel #10, {name}: a cold start or {args[15]} iterations")
        leaves = []
        for out in (got, want):
            v, w_, lams, *rest = out
            leaves.append([v, w_, *lams] + (
                [rest[0].impulse, rest[0].limit_rows] if rest else []))
        check(len(leaves[0]) == len(leaves[1]) == (7 if joints else 5)
              and all(a.dtype == b.dtype and a.shape == b.shape
                      and torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                      for a, b in zip(*leaves)),
              f"kernel #10, {name}: differs from the plain version")
        layout = ("a thread a body" if -(-n // 32) >= 2 * sms
                  else "16 item lanes a body")
        what = "no joints" if joints is None else (
            f"J={joints.num_joints}, JB={joints.body_rows.shape[1]}, mass "
            f"splitting {'on' if joints.mass_splitting else 'off'}, "
            f"{int(want[3].limit_rows)} limit rows on")
        print(f"[unified] kernel #10 vs plain, {name} (N={n}, C={c}, "
              f"{what}; sweeps {layout}): {launched} launches, every "
              f"output bit-equal ({int(args[12].sum())} valid slots)")


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


def overlay_phase(dev) -> None:
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
    reset_launches()
    rec, syncs, img = _app_run(app, frames, fps, render=True, hud=True)
    counts = launch_counts()
    check(without_unified(replayed_counts()) == {"walk": frames,
                                                 "resolve": frames}
          and set(counts) == {"walk", "resolve", "unified"},
          f"overlay: {counts} launches ({launch_counts(warm=True)} in the "
          f"captures' warm-ups) in {frames} rendered frames")
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
    with plain_twins():
        plain_hud = app.render_current_frame(hud=True)
    check(np.array_equal(plain_hud, with_hud),
          "overlay: the HUD frame differs between the kernels and their "
          "plain versions")
    app.wireframe = True
    reset_launches()
    f1 = app.render_current_frame(hud=True)
    check(not launch_counts(), "overlay: the F1 frame launched a kernel")
    sky = (f1[..., :3] == SKY[:3]).all(-1)
    check(sky.mean() > 0.5 and ((f1 == 255).all(-1) & ~sky).any(),
          "overlay: the F1 frame is not white lines over the clear colour")
    app.wireframe = False
    print(f"[overlay] default path with F3 and the HUD "
          f"(render_current_frame(hud=True)), {width}x{height}: the first "
          f"{OVERLAY_SECONDS:g} s of play_demo's track, {frames} display "
          f"frames; bus events "
          f"{rec['events']}; max |char - JAX| {err:.3g}; walk and resolve "
          f"launched {counts['walk']} and {counts['resolve']} times; the "
          f"line pass on the card vs the CPU: {line_off} of {line_px} line "
          f"pixels differ (<= {LINE_OFF_SHARE:g}); the app's F3 frame is "
          f"the card's line pass, its HUD frame the HUD on it, bit-equal "
          f"with the plain kernels; F1 frame: no raster kernel; "
          f"{syncs / frames:.2f} blocking host syncs a display frame "
          f"({syncs} in all)")

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
    print(f"[runtime] build_scene(capacity={lg['capacity']}, "
          f"max_trigger_slots={lg['trigger_slots']}): a crate spawned at "
          f"{lg['crate_spawn']['pos']}, {lg['steps']} hot-reloadable steps "
          f"(no host sync): max |crate - JAX| "
          f"{crate_err:.3g} (< {lg['atol']:g}), at rest y = {rest:.6f}; "
          f"checkpoint at step {RESUME_AT} resumed {lg['steps'] - RESUME_AT} "
          f"steps: bit-equal; despawned, the trigger took id {zone} and "
          f"saw {enter} enter; the child reparented at {gw.tolist()}; no "
          f"static tensor moved; the checked step passed, then raised "
          f"{message!r} (no host sync in the step)")
    shutil.rmtree(tmp, ignore_errors=True)


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


def new_routes_phase(dev, state0, allpairs_state, static,
                     views: dict) -> None:
    """Phase 19: the grid route at full size against phase 4's all-pairs
    run, solid capsules on the flat many-world step, and the tiled shade
    over the tile raster."""
    from banggameengine_tpu_torch.engine import (
        make_multi_step_fn, make_step_fn)
    from banggameengine_tpu_torch.parallel import manyworld
    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.render import raster as rz
    from banggameengine_tpu_torch.render import shading
    from banggameengine_tpu_torch.render.pipeline import make_render_fn
    from banggameengine_tpu_torch.scene.synthetic import (
        build_falling_boxes, build_showcase_render)
    from banggameengine_tpu_torch.state import InputFrame

    inp = InputFrame.zero()

    # ---- the grid route at full size -------------------------------------
    over0 = grid_lists_check("step 0", state0, static)
    run = make_multi_step_fn(static, STEPS_PER_DISPATCH, **GRID_KW)
    reset_launches()
    state = state0
    with no_host_sync():
        for _ in range(DISPATCHES):
            state = run(state, inp)
    torch.cuda.synchronize()
    steps = DISPATCHES * STEPS_PER_DISPATCH
    dense_only("the grid route", steps)
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
          f"{DISPATCHES} dispatches (no host sync, kernel #10 alone): "
          f"finite, "
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
    reset_launches()
    with no_host_sync():
        for _ in range(g_steps):
            bs = one(bs, bi)
            track.append([getattr(bs, f)[0].clone() for f in fields])
        for _ in range(n_chunks):
            bs = chunk(bs, bi)
    torch.cuda.synchronize()
    check(replayed_counts() == {"solve": CAPSULE_STEPS},
          f"the capsule run launched {launch_counts()} hand kernels "
          f"({launch_counts(warm=True)} in the captures' warm-ups), "
          f"kernel #9 alone once a step expected")
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
    print(f"[capsules] {CAPSULE_WORLDS} worlds of the capsule scene on the "
          f"flat static route, {CAPSULE_STEPS} steps ({g_steps} one-step "
          f"dispatches, then {n_chunks} of {CAPSULE_CHUNK}; no host sync, no "
          f"hand kernel): world 0 within "
          f"{err_g:.3g} of JAX's flat step over its {g_steps} steps (< "
          f"{CAPSULE_ATOL:g}), every world within {err_w:.3g} of world 0 (< "
          f"{CAPSULE_WORLD_ATOL:g}), the upright capsule at rest at y = "
          f"{rest:.4f} (hh + r = {hh + r:.2f} +- 0.1), a live ground "
          f"manifold")

    # ---- the tiled shade over the tile raster ----------------------------
    def renderer(rs, **kw):
        return make_render_fn(rs, RENDER_W, RENDER_H, bin_capacity=2048,
                              return_depth=True, **kw)

    tile_r = {name: renderer(rs, raster_backend="tile")
              for name, (rs, _, _) in views.items()}
    walk_r = {name: renderer(rs) for name, (rs, _, _) in views.items()}
    reset_launches()
    with no_host_sync():
        frames = {name: tile_r[name](*args)
                  for name, (_, args, _) in views.items()}
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"resolve": 2, "tile": 4}
    check(replayed_counts() == want, f"tiled frames over the tile raster: "
          f"launches {launches} ({launch_counts(warm=True)} in the "
          f"captures' warm-ups), expected {want} in the replays")
    with plain_twins():
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
    reset_launches()
    with no_host_sync():
        narrow = shading.shade_visibility_tiled(tiled, *sargs, **NARROW_SLOTS)
    torch.cuda.synchronize()
    fb_launches = launch_counts()
    wide = shading.shade_visibility_tiled(
        tiled, *sargs, shade_slots=NARROW_SLOTS["shade_slots"],
        heavy_shade_slots=rz.K_GLOBAL + rz.HEAVY_CAPACITY)
    with plain_twins():
        narrow_p = shading.shade_visibility_tiled(tiled, *sargs,
                                                  **NARROW_SLOTS)
    check(n_fb > 0, f"{name}: no winner beyond slot {covered}")
    check(fb_launches == {"resolve": 1},
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


SHARDED_GOLDEN = os.path.join(DATA, "sharded_world_jax_golden.json")
SW_WORLDS = 1000
SW_STEPS = 50          # steps a vmapped dispatch
SW_RUN = 100           # steps of each vmapped run (zero, per-world input)
SW_CALL = 10           # steps a call of the route comparisons
SW_ATOL = 2e-4         # flat against vmapped (tests/test_flat_manyworld.py)
SW_DENSE_ATOL = dict(pos=2e-4, quat=2e-4, lin_vel=2e-3)  # test_sharded_world
SW_CPU_ATOL = 1e-5     # the entity-sharded phase, card against CPU
SW_SHARDED_STEPS = 10  # donated fully sharded steps on each route


def _sync_free(what: str, fn, *args):
    """``fn(*args)`` with host syncs and functorch's BatchedFallback
    warning raised as errors, and no hand kernel launched but kernel #10
    (the dense route's solve), ``DENSE_UNIFIED`` times a step."""
    import warnings

    reset_launches()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        with no_host_sync():
            out = fn(*args)
    torch.cuda.synchronize()
    dense_only(what)
    return out


def sharded_phase(dev, stress_state, stress_static) -> None:
    """Phase 20: the vmapped many-world step, the router and the flat
    step's world mesh, the fully sharded world, the entity-sharded
    contact phase, all on a one-rank NCCL group, each a CUDA graph held
    bit-equal to its eager route; the native OBJ loader and the windows;
    ``dryrun_multichip(1)`` (no hand kernel on these paths but kernels #8
    and #9 on the flat step's and #10 on the vmapped step's)."""
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

    res = {}
    store = tempfile.mkdtemp(prefix="bang_store_")
    ranks.init_rank(0, 1, os.path.join(store, "store"), "cuda")
    try:
        # ---- 20a. the vmapped many-world step ---------------------------
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
        # one step first: its capture, outside the checked runs
        v1 = mw.make_sharded_many_world_step(static1, mesh)
        v1(sharded["state"], sharded["zero"])
        torch.cuda.synchronize()

        def run(inp):
            s = sharded["state"]
            for _ in range(SW_RUN // SW_STEPS):
                s = vstep(s, inp)
            return graphs.owned(s)   # the program's buffers: the next run's

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
                  f"{SW_RUN // SW_STEPS} dispatches of {SW_STEPS} (one "
                  f"step's graph replayed), no host sync, no "
                  f"BatchedFallback warning, kernel #10 alone (the worlds' "
                  f"rows in one solve); finite, lowest "
                  f"box corner {lowest:.4f} > -0.08, characters on the "
                  f"ground {int(full.char_on_ground[:, MW_CHAR_ROW].sum())}")
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

        # the graph route against the eager one: the vmapped step with its
        # metrics (a second graph, the all-reduce inside it)
        vm = mw.make_sharded_many_world_step(
            static1, mesh, num_steps=SW_CALL, with_metrics=True)
        res["vmapped"] = _compare_routes(
            f"vmapped many-world step with_metrics on the one-rank world "
            f"mesh, {w} worlds, {SW_CALL} steps a call",
            _chain(vm, sharded["state"], sharded["drive"]), 2,
            _ops_of(vm, sharded["state"], sharded["drive"]), sync_free=True)
        mvals = {k: float(v)
                 for k, v in res["vmapped"]["outs"][-1][1].items()}
        check(all(np.isfinite(v) for v in mvals.values()),
              f"with_metrics: {mvals}")
        print(f"[sharded] with_metrics over the {w} worlds (a sum over the "
              f"ranks / W): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in mvals.items()))

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
        fmesh = mw.make_flat_many_world_step(
            static1, w, state1.comp_mask, num_steps=SW_CALL, mesh=mesh)
        res["flat"] = _compare_routes(
            f"flat many-world step on the one-rank world mesh, {w} worlds, "
            f"{SW_CALL} steps a call",
            _chain(fmesh, sharded["state"], sharded["drive"]), 2,
            _ops_of(fmesh, sharded["state"], sharded["drive"]),
            sync_free=True)

        # ---- 20c. the fully sharded world on one rank -------------------
        emesh = sw.make_entity_axis_mesh()
        inp = InputFrame.zero(dev)
        ss, sst = sw.shard_world(stress_state, stress_static, emesh)
        fstep = sw.make_fully_sharded_step(stress_static, emesh)
        res["fully"] = _compare_routes(
            f"fully sharded step, one rank, {N_STRESS} boxes from phase 4's "
            f"{DISPATCHES * STEPS_PER_DISPATCH}-step state, "
            f"{SW_SHARDED_STEPS} donated steps",
            _chain(fstep, ss, inp, sst), SW_SHARDED_STEPS,
            _ops_of(fstep, ss, inp, sst), sync_free=True)
        # a replay and the input frame's copies: the donated state and the
        # static captured by reference are not copied
        inp_leaves = len(graphs.flatten(inp)[0])
        check(fstep.program.captures == 1
              and res["fully"]["graph_host"] == 1 + inp_leaves,
              f"fully sharded step: {fstep.program.captures} captures, "
              f"{res['fully']['graph_host']} host launches a call")
        got = ranks.full(res["fully"]["outs"][0][0])
        dense = make_step_fn(stress_static, broadphase="dense",
                             max_neighbors=MAX_NEIGHBORS, warm_start=False)
        ref, _ = dense(stress_state, inp)
        errs = {}
        for f, tol in SW_DENSE_ATOL.items():
            errs[f] = float((getattr(got, f) - getattr(ref, f)).abs().max())
            check(errs[f] < tol, f"fully sharded vs dense at N={N_STRESS}: "
                  f"|{f}| = {errs[f]}")
        check(bool(torch.isfinite(got.pos).all()), "fully sharded: NaN")
        print(f"[sharded] fully sharded step, one rank, {N_STRESS} boxes: "
              f"no host sync, no hand kernel; its first step against the "
              f"dense route's (warm_start=False: the sharded solve starts "
              f"cold): max |sharded - dense| "
              + ", ".join(f"{k} {v:.3g} (< {SW_DENSE_ATOL[k]:g})"
                          for k, v in errs.items()))
        with open(SHARDED_GOLDEN) as f:
            golden = json.load(f)
        dstate, dstatic = build_demo_like(device=dev)
        ds, dst = sw.shard_world(dstate, dstatic, emesh)
        dstep = sw.make_fully_sharded_step(dstatic, emesh)
        # every step's events are the graph's outputs: the route runner
        # clones each call's results
        res["demo"] = _compare_routes(
            f"fully sharded demo topology, {golden['steps']} steps",
            _chain(dstep, ds, inp, dst), golden["steps"],
            _ops_of(dstep, ds, inp, dst), sync_free=True)
        douts = res["demo"]["outs"]
        enter = torch.stack([ranks.local(o[1].trigger_enter) for o in douts])
        exit_ = torch.stack([ranks.local(o[1].trigger_exit) for o in douts])
        check(_event_list(enter, 1) == golden["enter"],
              f"demo topology: Enter {_event_list(enter, 1)} vs JAX "
              f"{golden['enter']}")
        check(_event_list(exit_, 1) == golden["exit"],
              f"demo topology: Exit {_event_list(exit_, 1)} vs JAX "
              f"{golden['exit']}")
        dn = convert.world_state_to_numpy(ranks.full(douts[-1][0]))
        derr = {}
        for f in golden["float_fields"]:
            derr[f] = float(np.abs(dn[f] - np.asarray(
                golden["last"][f], np.float32)).max())
            check(derr[f] < golden["atol"],
                  f"demo topology: |{f} - JAX| = {derr[f]}")
        for f in golden["exact_fields"]:
            check(np.array_equal(dn[f], np.asarray(golden["last"][f])),
                  f"demo topology: {f} differs from JAX")
        print(f"[sharded] demo topology fully sharded on the graph route, "
              f"{golden['steps']} steps: events equal to the JAX golden "
              f"({len(golden['enter'])} Enter, {len(golden['exit'])} Exit), "
              f"{', '.join(golden['exact_fields'])} equal; max |port - JAX| "
              + ", ".join(f"{k} {v:.3g}" for k, v in derr.items())
              + f" (< {golden['atol']:g})")

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

        def phase_calls(n, call):
            for _ in range(n):
                call(lambda: phase(*args))

        res["phase"] = _compare_routes(
            f"entity-sharded contact phase, one rank, {N_STRESS} boxes",
            phase_calls, G_CALLS, _ops_of(phase, *args),
            sync_free=True)
        v_g, w_g = res["phase"]["outs"][0]
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
              f"(< {SW_CPU_ATOL:g})")

        # ---- 20e. the native OBJ loader and the windows ------------------
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
        print(f"[native] {os.path.relpath(LIB_PATH)} built with g++; "
              f"{len(objs)} meshes of "
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


G_CALLS = 3           # phase 21: calls of each factory on each route
G_APP_FRAMES = 8      # phase 21: display frames of each app on each route
G_MW_STEPS = 10       # phase 21: steps a many-world call
G_STRESS_HOST_MAX = 300   # host launches a 50-step stress dispatch may take


def _route_run(runner, n: int, eager: bool, sync_free: bool) -> dict:
    """``runner(n, call)`` on one route with the counts set to 0: each
    call's host launches (``graphs.stats``) counted; the hand kernels'
    launches less the captures' warm-ups.  ``sync_free``: a host sync in
    a call raises."""
    reset_launches()
    outs, host = [], []

    def call(fn):
        h0 = graphs.host_launches()
        out = fn()
        host.append(graphs.host_launches() - h0)
        outs.append(graphs.owned(out))
        return out

    with (graphs.eager() if eager else contextlib.nullcontext(),
          no_host_sync() if sync_free else contextlib.nullcontext()):
        runner(n, call)
    torch.cuda.synchronize()
    return dict(outs=outs, host=host, launches=replayed_counts(),
                warm=launch_counts(warm=True))


def _count_ops(fn) -> int:
    """The ATen ops one eager call of ``fn`` dispatches (views left out;
    each launches about one kernel), the hand kernels' launches added."""
    from banggameengine_tpu_torch.scripts import trace_summary as ts

    reset_launches()
    with graphs.eager():
        n = ts.count_ops(fn, ())
    torch.cuda.synchronize()
    return n + sum(launch_counts().values())


def _compare_routes(name: str, runner, n: int, ops_fn, kernels=(),
                    sync_free: bool = False) -> dict:
    """Phases 20's and 21's check of one factory: ``n`` calls through the
    graphs and ``n`` through ``graphs.eager()`` from the same start, every
    output bit-equal (a DTensor's local part), the hand kernels' replayed
    launches equal to the eager launches (each kernel of ``kernels``
    launched), then one more eager call's ATen ops and the printed line.
    ``sync_free``: a host sync in a call raises.  Returns the host
    launches, the launches and the graph route's outputs."""
    from banggameengine_tpu_torch.parallel import ranks

    g = _route_run(runner, n, eager=False, sync_free=sync_free)
    e = _route_run(runner, n, eager=True, sync_free=sync_free)
    for i, (a, b) in enumerate(zip(g["outs"], e["outs"])):
        la, sa = graphs.flatten(a)
        lb, sb = graphs.flatten(b)
        bad = [j for j, (x, y) in enumerate(zip(map(ranks.local, la),
                                                 map(ranks.local, lb)))
               if x.shape != y.shape or not torch.equal(x, y)]
        check(sa == sb and not bad, f"graphs: {name}: call {i + 1} differs "
              f"between the graph and eager routes (leaves {bad})")
    check(g["launches"] == e["launches"],
          f"graphs: {name}: hand-kernel launches through the replays "
          f"{g['launches']}, eager {e['launches']}")
    for k in kernels:
        check(g["launches"].get(k, 0) > 0, f"graphs: {name}: {k} not "
              f"launched")
    ops = ops_fn()
    g_host = statistics.median(g["host"][1:] or g["host"])
    print(f"[graphs] {name}: {n} calls bit-equal between the graph and "
          f"eager routes; hand-kernel launches through the replays "
          f"{g['launches']} = eager (captures' warm-ups "
          f"{g['warm'] or 'none'}); host launches a call: graph {g_host:g} "
          f"(replays, input copies, output clones; the first call "
          f"{g['host'][0]}, its capture included), eager {ops} (ATen ops "
          f"and hand kernels)")
    return dict(graph_host=g_host, eager_ops=ops, launches=g["launches"],
                outs=g["outs"])


def _chain(fn, start, *rest):
    """A runner of ``n`` chained calls ``state, ... = fn(state, *rest)``
    from ``start``; the state is the first output."""
    def runner(n, call):
        s = start
        for _ in range(n):
            out = call(lambda: fn(s, *rest))
            s = out[0] if isinstance(out, tuple) else out
    return runner


def _ops_of(fn, *args):
    return lambda: _count_ops(lambda: fn(*args))


def graphs_phase(dev, stress_run, stress_state, static,
                 views: dict) -> None:
    """Phase 21: every factory of the JAX package's one-dispatch programs,
    through its CUDA graphs and through ``graphs.eager()`` in the same
    run, from the same start: the stress multi-step (kernels #1, #8), the
    tick (#1, #8, #3, #2) and its merged form, the fused (#4) and flat (#5)
    frames, the flat (#8) and vmapped many-world steps at 1,000 worlds, the
    demo step,
    the app's fused and default display frames, a hot reload and a spawn
    that grows the level table."""
    from banggameengine_tpu_torch.app.application import Application
    from banggameengine_tpu_torch.app.events import TriggerPhase
    from banggameengine_tpu_torch.engine import (
        make_hot_reloadable_step_fn, make_step_fn)
    from banggameengine_tpu_torch.parallel import manyworld as mw
    from banggameengine_tpu_torch.physics.config import load_physics_config
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.pipeline import (
        make_frame_fn, make_render_fn)
    from banggameengine_tpu_torch.scene.build import BuiltScene, build_scene
    from banggameengine_tpu_torch.scene.resources import ResourceManager
    from banggameengine_tpu_torch.scene.schema import parse_scene_json
    from banggameengine_tpu_torch.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu_torch.scripts.play_demo import apply_track
    from banggameengine_tpu_torch.state import InputFrame

    inp = InputFrame.zero(dev)
    res = {}

    # the stress multi-step: phase 4's program, captured there
    res["stress"] = _compare_routes(
        f"stress multi-step, {N_STRESS} boxes, {STEPS_PER_DISPATCH} steps a "
        f"call (one step's graph replayed)",
        _chain(stress_run, stress_state, inp), 2,
        _ops_of(stress_run, stress_state, inp),
        kernels=("broadphase", "contacts", "solve"))
    check(res["stress"]["graph_host"] <= G_STRESS_HOST_MAX,
          f"graphs: a {STEPS_PER_DISPATCH}-step stress dispatch took "
          f"{res['stress']['graph_host']} host launches")

    # the tick and its merged form on the 10k-box world
    box_rs, box_args, _ = views["10k-box"]
    tick_args = box_args[1:]
    built = BuiltScene(static=static, initial_state=stress_state,
                       render=box_rs)
    for merged in (False, True):
        tick = make_frame_fn(built, RENDER_W, RENDER_H, merged=merged,
                             broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)
        key = "tick_merged" if merged else "tick"
        form = ("merged=True: one graph" if merged
                else "a step graph, then a frame graph")
        res[key] = _compare_routes(
            f"tick ({form}), {N_STRESS} boxes at {RENDER_W}x{RENDER_H}",
            _chain(tick, stress_state, inp, *tick_args), G_CALLS,
            _ops_of(tick, stress_state, inp, *tick_args),
            kernels=("broadphase", "contacts", "solve", "walk", "resolve"))

    # the fused and flat frames of the showcase
    show_rs, show_args, _ = views["showcase"]
    for mode, kw, k in (("fused", dict(shade_mode="fused"), "fused"),
                        ("flat", dict(shade_mode="flat",
                                      raster_backend="tile"), "tile")):
        r = make_render_fn(show_rs, RENDER_W, RENDER_H, bin_capacity=2048,
                           return_depth=True, **kw)

        def frames(n, call, r=r):
            for _ in range(n):
                call(lambda: r(*show_args))

        res[mode] = _compare_routes(
            f"{mode} frame, showcase {RENDER_W}x{RENDER_H}", frames,
            G_CALLS, _ops_of(r, *show_args), kernels=(k,))

    # the many-world steps at 1,000 worlds, per-world input
    state1, static1 = build_falling_boxes(**MW_SCENE, device=dev)
    w = MW_WORLDS
    bs0 = mw.replicate_state(state1, w)
    rng = np.random.default_rng(MW_SEED)
    drive = InputFrame(
        move_forward=torch.as_tensor(
            rng.uniform(0.5, 1.0, w).astype(np.float32), device=dev),
        move_right=torch.zeros(w, device=dev),
        jump=torch.as_tensor(rng.random(w) < 0.3, device=dev),
        sprint=torch.as_tensor(rng.random(w) < 0.3, device=dev),
        cam_yaw=torch.as_tensor(
            rng.uniform(-np.pi, np.pi, w).astype(np.float32), device=dev))
    flat = mw.make_flat_many_world_step(static1, w, state1.comp_mask,
                                        num_steps=G_MW_STEPS)
    vmapped = mw.make_sharded_many_world_step(static1, None,
                                              num_steps=G_MW_STEPS)
    for key, fn, used in (("flat", flat, ("contacts", "solve")),
                          ("vmapped", vmapped, ())):
        res[f"mw_{key}"] = _compare_routes(
            f"{key} many-world step, {w} worlds, {G_MW_STEPS} steps a call",
            _chain(fn, bs0, drive), 2, _ops_of(fn, bs0, drive),
            kernels=used)

    # a one-step flat call through its three graphs (flatten, the flat
    # step and unflatten): the trace holds the kernels they replay
    flat_one = mw.make_flat_many_world_step(static1, w, state1.comp_mask)
    tr = _traced(lambda: flat_one(bs0, drive).pos)
    check(tr["busy_ms"] > 0 and tr["launches"] > 0,
          f"graphs: the flat call's trace shows {tr['launches']} kernels")
    print(f"[graphs] flat many-world, {w} worlds: a one-step call's trace "
          f"holds {tr['launches']:g} kernels")

    # the demo step
    d0, dstatic = build_demo_like(device=dev)
    demo = make_step_fn(dstatic)
    res["demo"] = _compare_routes(
        "demo step (build_demo_like, the default route)",
        _chain(demo, d0, inp), 20, _ops_of(demo, d0, inp))

    # the app's display frames: the fused tick and the default path
    os.environ.pop("BANG_ASSETS_DIR", None)
    with open(APP_GOLDEN) as f:
        fps = json.load(f)["fps"]
    phases = list(TriggerPhase)

    def app_runner(fused: bool, last: dict):
        def runner(n, call):
            app = Application(assets_root=APP_ASSETS, width=1280,
                              height=720, fused_tick=fused, device=dev)
            cj = app.built.find_entity("cj")

            def frame():
                app.frame(real_dt=1.0 / fps)
                img = (torch.as_tensor(app.last_frame_image) if fused
                       else torch.as_tensor(app.render_current_frame()))
                log = torch.tensor([[phases.index(e.phase),
                                     e.trigger_entity, e.other_entity]
                                    for e in app._trigger_log] or
                                   [[-1, -1, -1]])
                return app.state, img, log

            for i in range(n):
                apply_track(app, i, fps, cj)
                call(frame)
            last.update(app=app, cj=cj, frame=frame, n=n)
        return runner

    def next_frame_ops(last: dict) -> int:
        """The ATen ops of the eager app's next display frame."""
        apply_track(last["app"], last["n"], fps, last["cj"])
        return _count_ops(last["frame"])

    for fused in (True, False):
        last = {}
        key = "app_fused" if fused else "app_default"
        res[key] = _compare_routes(
            f"app {'fused' if fused else 'default-path'} display frame, "
            f"1280x720 (play_demo's track)",
            app_runner(fused, last), G_APP_FRAMES,
            lambda last=last: next_frame_ops(last),
            kernels=("walk", "resolve"))

    # a hot reload: a rebuilt scene of the same shapes is copied in
    hot = make_hot_reloadable_step_fn()
    heavy = dataclasses.replace(dstatic, gravity=dstatic.gravity * 2.0)

    def reload_runner(n, call):
        s = d0
        for i in range(n):
            st = dstatic if i < n // 2 else heavy
            s, _ = call(lambda: hot(s, inp, st))

    res["hot"] = _compare_routes(
        "hot-reloadable step, the scene rebuilt (gravity x2) half-way",
        reload_runner, 6, _ops_of(hot, d0, inp, heavy))
    check(hot.program.captures == 1,
          f"graphs: the hot reload captured {hot.program.captures} times")

    # a spawn that grows the level table: the next step captures anew
    def scene():
        return build_scene(
            parse_scene_json(os.path.join(APP_ASSETS, "scenes",
                                          "demo.json")),
            ResourceManager(APP_ASSETS),
            load_physics_config(os.path.join(APP_ASSETS, "config",
                                             "physics.json")),
            capacity=16, max_trigger_slots=2, device=dev)

    rows = scene().static.level_nodes.shape[0]
    programs = []

    def spawn_runner(n, call):
        sb = scene()
        step = make_step_fn(sb.static)
        programs.append(step.program)
        s, parent = sb.initial_state, "cj_hat"
        for k in range(n):
            s, _ = sb.spawn(s, name=f"link{k}", parent=parent)
            parent = f"link{k}"
            s, _ = call(lambda: step(s, inp))

    def spawn_ops():
        sb = scene()
        return _count_ops(lambda: make_step_fn(sb.static)(sb.initial_state,
                                                          inp))

    res["spawn"] = _compare_routes(
        f"spawns in a chain until the level table grows ({rows} rows)",
        spawn_runner, rows - 1, spawn_ops)
    check(programs[0].captures == 2,
          f"graphs: the level table's growth made {programs[0].captures} "
          f"captures, not 2")
    print(f"[graphs] the hot reload copied the rebuilt scene into the "
          f"captured one (1 capture); the grown level table captured anew "
          f"(2 captures); graphs.stats "
          f"{ {k: v for k, v in graphs.stats.items() if k != 'capture_s'} }")


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

    # ---- 2. build: every kernel at once, one nvcc each -----------------
    kernels = hand_kernels()
    build_in_parallel([k.load for k in kernels.values()])
    print(f"[build] {len(kernels)} hand kernels built for sm_90a and "
          f"loaded, in parallel: "
          f"{', '.join(f'{key} ({k.name})' for key, k in kernels.items())}")

    # ---- 3. kernel vs plain ---------------------------------------------
    state0, static = build_falling_boxes(N_STRESS, seed=0)
    inp = InputFrame.zero()
    run = make_multi_step_fn(static, STEPS_PER_DISPATCH,
                             broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)

    # the 200-step run with the plain broadphase, box contacts and contact
    # solve, for case (b) and for the bit-equality check of phase 4
    with plain_twins("broadphase", "contacts", "solve"):
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
        check(torch.equal(nl_k.idx, nl_p.idx), f"{name}: idx differs")
        check(torch.equal(count_k, count_p), f"{name}: count differs")
        check(torch.equal(nl_k.nbr_overflow, nl_p.nbr_overflow),
              f"{name}: overflow differs")
        check(torch.equal(raw_k[0], raw_p[0])
              and torch.equal(raw_k[1], raw_p[1]),
              f"{name}: idx or count differs on the raw boxes")
        share = float(kept.float().mean())
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
    # the multi-step is one step's graph replayed 50 times a dispatch; the
    # first dispatch captures it (its eager warm-up launches the kernel
    # once more)
    reset_launches()
    state = state0
    with no_host_sync():
        for _ in range(DISPATCHES):
            state = run(state, inp)
        # run's buffers: phase 21 dispatches again
        state = graphs.owned(state)
    torch.cuda.synchronize()
    counts, warm_counts = launch_counts(), launch_counts(warm=True)
    launches, warm = counts["broadphase"], warm_counts.get("broadphase", 0)
    box_launches = counts["contacts"]
    box_warm = warm_counts.get("contacts", 0)
    solve_launches = counts["solve"]
    solve_warm = warm_counts.get("solve", 0)
    steps = DISPATCHES * STEPS_PER_DISPATCH
    check(launches - warm == steps,
          f"kernel launched {launches} times ({warm} in the capture's "
          f"warm-up) in {steps} steps")
    check(box_launches - box_warm == steps,
          f"kernel #8 launched {box_launches} times ({box_warm} in the "
          f"capture's warm-up) in {steps} steps")
    check(solve_launches - solve_warm == steps,
          f"kernel #9 launched {solve_launches} times ({solve_warm} in the "
          f"capture's warm-up) in {steps} steps")
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
          f"dispatches of {STEPS_PER_DISPATCH} (no host sync, one step's "
          f"graph replayed): "
          f"{launches} kernel launches ({warm} in the capture's warm-up), "
          f"kernel #8 {box_launches} ({box_warm}), kernel #9 "
          f"{solve_launches} ({solve_warm}), state finite, lowest "
          f"corner "
          f"{lowest:.4f} > -0.08, step_idx {int(state.step_idx)}, "
          f"contact_overflow of step {steps + 1}: "
          f"{int(events.contact_overflow)}")
    print(f"[slice] pos, quat, lin_vel, ang_vel, contact cache bit-equal to "
          f"the same {steps} steps with the plain broadphase, box contacts "
          f"and contact solve")

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

    contacts_phase(dev, static, state0, state, inp)

    views = render_phases(dev, state, static)
    route_phases(dev, views)
    profiling_phases(dev)
    manyworld_phase(dev)
    dense_phase(dev)
    app_phase(dev)
    overlay_phase(dev)
    new_routes_phase(dev, state0, state, static, views)
    sharded_phase(dev, state, static)
    graphs_phase(dev, run, state, static, views)
    unified_phase(dev)

    root = os.path.dirname(os.path.abspath(__file__))
    print(json.dumps({"kernels": [
        {"key": key, "library": k.name,
         "source": os.path.relpath(k.source, root), "replaces": k.replaces}
        for key, k in hand_kernels().items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
