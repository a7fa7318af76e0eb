"""Tiny cells for the CPU tests: the benchmark's own configurations,
traffic mixes and cells cut to a few bodies, worlds and pixels, written
as files into a temporary folder beside copies of the benchmark's
drivers and metric readers, so that a run finds them by name as it
finds the real ones."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each real cell's cuts: configuration scene keys, then traffic or
# measurement parameters
CUTS = {
    "boxes3k.settled": ({"size": 2, "layers": 3},
                        {"steps_per_call": 3, "settle_steps": 6,
                         "check_calls": 2}),
    "rollout4k.act60": ({"num_worlds": 4, "boxes": 2},
                        {"settle_steps": 4, "sample_worlds": 3,
                         "check_calls": 2, "trace_calls": 2}),
    "boxes3k.tick1080": ({"size": 2, "layers": 2},
                         {"width": 128, "height": 64, "settle_steps": 4,
                          "check_calls": 2, "trace_calls": 2}),
}


def load(path):
    with open(path) as f:
        return json.load(f)


def save(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def make_root(tmp: str) -> tuple[str, dict]:
    """A benchmark folder in ``tmp`` holding the tiny cells (named as the
    real ones) and copies of the traffic drivers and metric readers;
    returns it and its ``BENCHMARK.json`` object."""
    root = os.path.join(tmp, "bench")
    for sub in ("drivers", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(root, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = load(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"))
    for cell, (scene_cut, param_cut) in CUTS.items():
        w = load(os.path.join(HERE, "workloads", cell + ".json"))
        cfg = load(os.path.join(HERE, "configs", w["config"] + ".json"))
        cfg["scene"].update(scene_cut)
        mix = load(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        w["config"] = cfg["name"] = f"{w['config']}-{cell}"
        for k, v in param_cut.items():
            (mix if k in mix else w["measure"])[k] = v
        save(os.path.join(root, "configs", w["config"] + ".json"), cfg)
        save(os.path.join(root, "traffic", w["traffic"] + ".json"), mix)
        save(os.path.join(root, "workloads", cell + ".json"), w)
    return root, bench
