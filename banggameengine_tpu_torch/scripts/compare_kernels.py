"""Time this tree's CUDA kernels against another tree's on the same card,
in one run: the way a kernel redesign is compared with its parent.

    git archive <parent> | tar -x -C _trees/parent    # a git-ignored dir
    python3 -m banggameengine_tpu_torch.scripts.compare_kernels _trees/parent

Each of the six kernels is called through its wrapper's launcher (the
``cuda_*`` function) in both trees.  The other tree's wrapper module is
loaded from its own file, so it marshals the arguments for its own
library, built from its own source (into this tree's build directory,
under another name); the helpers it imports come from this tree's package.  The inputs
are the main path's: the 10k-box stress scene at steps 0 and 200, the
showcase and the 10k-box view (at step 200) at 1920x1080 through the
tiled, fused and flat frames, and the shade-parts probe's gather.  On
each, the two trees' outputs must be equal; then each is timed by the
card's own time (``utils/profiling.measure_device_trials``, median of 5
windows of 10 calls) in the order other, this, this, other.  One line a
kernel and input, then a JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import types

import torch

from banggameengine_tpu_torch import cuda_build, kernel_cases
from banggameengine_tpu_torch.utils.profiling import measure_device_trials

# kernel: (wrapper module, launcher)
KERNELS = {
    "broadphase": ("banggameengine_tpu_torch.physics.broadphase_kernel",
                   "cuda_idx_count"),
    "walk": ("banggameengine_tpu_torch.render.raster_walk",
             "cuda_raster_walk"),
    "resolve": ("banggameengine_tpu_torch.render.resolve",
                "cuda_resolve_tiles_wide"),
    "fused": ("banggameengine_tpu_torch.render.raster_resolve",
              "cuda_raster_resolve_tiles"),
    "tile": ("banggameengine_tpu_torch.render.raster_tile",
             "cuda_raster_tiles"),
    "gather": ("banggameengine_tpu_torch.scripts.gather_rows",
               "cuda_gather_rows_u8"),
}
N_STRESS = 10_000
STEPS = (50, 4)            # 200 steps, in dispatches of 50
MAX_NEIGHBORS = 8
WIDTH, HEIGHT = 1920, 1080


def other_module(root: str, name: str) -> types.ModuleType:
    """The module ``name`` of the tree at ``root``, loaded from its file
    under a name of its own; its kernel library is built under a name of
    its own too, so it never stands in for this tree's."""
    path = os.path.join(root, *name.split(".")) + ".py"
    spec = importlib.util.spec_from_file_location(
        "other_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_build = types.SimpleNamespace(
        load_library=lambda lib, source, flags=(): cuda_build.load_library(
            "other_" + lib, source, flags))
    return mod


def main_path_inputs(dev) -> dict:
    """{kernel: [(input name, [launcher arguments, one tuple a call])]}."""
    from banggameengine_tpu_torch import convert
    from banggameengine_tpu_torch.engine import make_multi_step_fn
    from banggameengine_tpu_torch.physics.broadphase_kernel import (
        with_margin)
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.pipeline import make_render_fn
    from banggameengine_tpu_torch.scene.synthetic import (
        TICK_CAMERA_POS, TICK_CAMERA_YAW_PITCH, build_box_render,
        build_falling_boxes, build_showcase_render)
    from banggameengine_tpu_torch.scripts import profile_shade_parts
    from banggameengine_tpu_torch.state import InputFrame

    cases = {k: [] for k in KERNELS}
    state0, static = build_falling_boxes(N_STRESS, seed=0)
    run = make_multi_step_fn(static, STEPS[0], broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)
    state = state0
    for _ in range(STEPS[1]):
        state = run(state, InputFrame.zero())
    for step, s in ((0, state0), (STEPS[0] * STEPS[1], state)):
        mn, mx, *rest = kernel_cases.sorted_broadphase_inputs(s, static)
        cases["broadphase"].append(
            (f"stress {N_STRESS}, step {step}",
             [(*with_margin(mn, mx), *rest, MAX_NEIGHBORS)]))

    sc = build_showcase_render(0)
    tick_cam = Camera()
    tick_cam.position[:] = TICK_CAMERA_POS
    tick_cam.set_yaw_pitch(*TICK_CAMERA_YAW_PITCH)
    views = {
        "showcase": (convert.render_scene_from_numpy(sc.render),
                     (torch.as_tensor(sc.world, device=dev),
                      sc.camera.view_matrix(),
                      sc.camera.proj_matrix(WIDTH / HEIGHT),
                      torch.as_tensor(sc.camera.position, device=dev))),
        "10k-box view": (convert.render_scene_from_numpy(
            build_box_render(static)),
            (state.world, tick_cam.view_matrix(),
             tick_cam.proj_matrix(WIDTH / HEIGHT),
             torch.as_tensor(tick_cam.position, device=dev))),
    }
    routes = ({}, {"shade_mode": "fused"},
              {"shade_mode": "flat", "raster_backend": "tile"})
    for view, (rs, args) in views.items():
        for kw in routes:
            with kernel_cases.recorded_render_inputs() as rec:
                make_render_fn(rs, WIDTH, HEIGHT, bin_capacity=2048,
                               return_depth=True, **kw)(*args)
            for k, calls in rec.items():
                if calls:
                    cases[k].append((f"{view} {WIDTH}x{HEIGHT}", calls))
    table, idx = profile_shade_parts.probes(dev)["pl_gather"][1]
    cases["gather"].append(("shade-parts probe", [(table, idx)]))
    return cases


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (
            isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            and torch.equal(x, y)) for x, y in zip(la, lb))


def device_ms(fn) -> float:
    return statistics.median(measure_device_trials(fn, calls=10,
                                                   trials=5)) * 1e3


def compare(root: str, dev) -> list[dict]:
    """Check and time every kernel on every input: other, this, this,
    other.  A kernel whose outputs differ between the trees raises."""
    results = []
    inputs = main_path_inputs(dev)
    for k in KERNELS:
        module, launcher = KERNELS[k]
        this = getattr(importlib.import_module(module), launcher)
        other = getattr(other_module(root, module), launcher)
        for case, calls in inputs[k]:
            runs = [lambda f=f: [f(*a) for a in calls] for f in (other, this)]
            if not _equal(runs[0](), runs[1]()):
                raise AssertionError(f"{k} {case}: the two trees' outputs "
                                     f"differ")
            t = [device_ms(runs[i]) for i in (0, 1, 1, 0)]
            results.append({"kernel": k, "input": case,
                            "calls": len(calls), "other_ms": [t[0], t[3]],
                            "this_ms": [t[1], t[2]]})
            print(f"[compare] {k}, {case} ({len(calls)} call(s)): outputs "
                  f"equal; other, this, this, other "
                  f"{t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.4f} ms "
                  f"(device time)", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of another tree of this repository")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"[device] {smi}")
    results = compare(os.path.abspath(args.other), torch.device("cuda:0"))
    print(json.dumps({"device": smi, "other": args.other,
                      "compare": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
