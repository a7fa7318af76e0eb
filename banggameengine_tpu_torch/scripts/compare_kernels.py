"""Time this tree's hand kernels against another tree's on the same card,
in one run: the way a kernel redesign is compared with its parent.

    git archive <parent> | tar -x -C _trees/parent    # a git-ignored dir
    python3 -m banggameengine_tpu_torch.scripts.compare_kernels _trees/parent
    python3 -m banggameengine_tpu_torch.scripts.compare_kernels \\
        _trees/parent --kernels contacts,walk

The kernels are those of the registry (``cuda_build.KERNELS``), or the
keys ``--kernels`` names.  Each is called through its wrapper in both
trees; on CUDA tensors a wrapper always takes its kernel.  The other
tree's wrapper module is loaded from its own file, so its kernel builds
its own library from its own source (into this tree's build directory,
under the name ``other_<library>``) and stays out of this tree's
registry; the helpers it imports come from this tree's package.  The
other tree must have the registry too.  The inputs are the main path's,
recorded from its eager calls (``kernel_cases.recorded_inputs``): the
10k-box stress step at steps 0 and 200 and the flat many-world step at
4,096 worlds after 200 steps, the showcase and the 10k-box view (at step
200) at 1920x1080 through the tiled, fused and flat frames, and the
shade-parts probe's gather.  On each, the two trees' outputs must be
equal; then each is timed by the card's own time
(``utils/profiling.measure_device_trials``, median of 5 windows of 10
calls) in the order other, this, this, other.  One line a kernel and
input, then a JSON line.  Needs a CUDA device.
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

from banggameengine_tpu_torch import cuda_build, graphs, kernel_cases
from banggameengine_tpu_torch.utils.profiling import measure_device_trials

N_STRESS = 10_000
STEPS = (50, 4)            # 200 steps, in dispatches of 50
MAX_NEIGHBORS = 8
ROLLOUT_WORLDS = 4096      # the flat step of the rollout cell
ROLLOUT_SCENE = dict(num_bodies=8, with_character=True, with_trigger=True)
WIDTH, HEIGHT = 1920, 1080


def other_module(root: str, name: str) -> types.ModuleType:
    """The module ``name`` of the tree at ``root``, loaded from its file
    under a name of its own; its hand kernel builds its library under a
    name of its own too, so it never stands in for this tree's."""
    path = os.path.join(root, *name.split(".")) + ".py"
    spec = importlib.util.spec_from_file_location(
        "other_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not isinstance(getattr(mod, "KERNEL", None), cuda_build.HandKernel):
        raise RuntimeError(f"{path} makes no cuda_build.HandKernel: a tree "
                           f"older than the registry")
    return mod


def main_path_inputs(dev, keys) -> dict:
    """{kernel key: [(input name, [wrapper arguments, one tuple a call])]}
    for the kernels ``keys``."""
    from banggameengine_tpu_torch import convert
    from banggameengine_tpu_torch.engine import (
        make_multi_step_fn, make_step_fn)
    from banggameengine_tpu_torch.parallel.manyworld import (
        make_flat_many_world_step, replicate_input, replicate_state)
    from banggameengine_tpu_torch.render.camera import Camera
    from banggameengine_tpu_torch.render.pipeline import make_render_fn
    from banggameengine_tpu_torch.scene.synthetic import (
        TICK_CAMERA_POS, TICK_CAMERA_YAW_PITCH, build_box_render,
        build_falling_boxes, build_showcase_render)
    from banggameengine_tpu_torch.scripts import profile_shade_parts
    from banggameengine_tpu_torch.state import InputFrame

    cases = {k: [] for k in keys}

    def record(name, fn, *args):
        with kernel_cases.recorded_inputs(*keys) as rec:
            fn(*args)
        for k, calls in rec.items():
            if calls:
                cases[k].append((name, calls))

    inp = InputFrame.zero(dev)
    state0, static = build_falling_boxes(N_STRESS, seed=0)
    run = make_multi_step_fn(static, STEPS[0], broadphase="allpairs",
                             max_neighbors=MAX_NEIGHBORS)
    state = state0
    for _ in range(STEPS[1]):
        state = run(state, inp)
    steps = STEPS[0] * STEPS[1]
    step = make_step_fn(static, broadphase="allpairs",
                        max_neighbors=MAX_NEIGHBORS)
    for n, s in ((0, state0), (steps, state)):
        record(f"stress {N_STRESS}, step {n}", step, s, inp)

    w = ROLLOUT_WORLDS
    state1, static1 = build_falling_boxes(**ROLLOUT_SCENE, device=dev)
    zero = replicate_input(inp, w)
    flat = make_flat_many_world_step(static1, w, state1.comp_mask,
                                     num_steps=steps)(
        replicate_state(state1, w), zero)
    record(f"flat {w} worlds, step {steps}",
           make_flat_many_world_step(static1, w, state1.comp_mask), flat,
           zero)

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
            record(f"{view} {WIDTH}x{HEIGHT}",
                   make_render_fn(rs, WIDTH, HEIGHT, bin_capacity=2048,
                                  return_depth=True, **kw), *args)
    if "gather" in cases:
        table, idx = profile_shade_parts.probes(dev)["pl_gather"][1]
        cases["gather"].append(("shade-parts probe", [(table, idx)]))
    return cases


def _equal(a, b) -> bool:
    (la, sa), (lb, sb) = graphs.flatten(a), graphs.flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def device_ms(fn) -> float:
    return statistics.median(measure_device_trials(fn, calls=10,
                                                   trials=5)) * 1e3


def compare(root: str, dev, keys=None) -> list[dict]:
    """Check and time the kernels ``keys`` (every one of the registry by
    default) on every input: other, this, this, other.  A kernel whose
    outputs differ between the trees raises."""
    kernels = kernel_cases.hand_kernels()
    keys = list(keys or kernels)
    unknown = sorted(set(keys) - set(kernels))
    if unknown:
        raise ValueError(f"no hand kernel {unknown}; the registry holds "
                         f"{sorted(kernels)}")
    results = []
    inputs = main_path_inputs(dev, keys)
    for k in keys:
        wrapper = kernels[k].wrapper
        this = wrapper
        other = getattr(other_module(root, wrapper.__module__),
                        wrapper.__name__)
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
    ap.add_argument("--kernels", default="",
                    help="comma-separated keys of the registry (default: "
                         "every hand kernel)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"[device] {smi}")
    keys = [k for k in args.kernels.split(",") if k]
    results = compare(os.path.abspath(args.other), torch.device("cuda:0"),
                      keys)
    print(json.dumps({"device": smi, "other": args.other,
                      "compare": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
