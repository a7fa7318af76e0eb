"""Cells, configurations, traffic mixes, drivers and metric readers,
found by the names ``BENCHMARK.json`` gives them.

Under the benchmark's folder: ``workloads/<cell>.json`` (its
configuration, its traffic mix, why it exists, the harness's
measurement parameters and the comparison's limits),
``configs/<config>.json`` (the deployment: the scene and the physics),
``traffic/<mix>.json`` (the mix's parameters and the ``driver`` that
generates it), ``drivers/<driver>.py`` (a module with a ``Driver``
class: one general generator a kind of traffic) and
``metrics/<metric>.py`` (a module with ``read(ctx)``).  Adding one of
them is adding a file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a fresh module."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell of a run: its file's contents, its configuration's, the
    run's seed and device, and where the run may write."""

    name: str
    config: dict
    traffic: str
    driver: str
    params: dict
    limits: dict
    seed: int
    device: object
    out_dir: str


def load_cell(root: str, name: str, seed: int, device) -> Cell:
    """The cell ``name``; its driver's parameters are the traffic mix's
    and the cell's ``measure``."""
    w = load_json(os.path.join(root, "workloads", name + ".json"))
    config = load_json(os.path.join(root, "configs", w["config"] + ".json"))
    mix = load_json(os.path.join(root, "traffic", w["traffic"] + ".json"))
    return Cell(name=name, config=config, traffic=w["traffic"],
                driver=mix["driver"], params={**mix, **w["measure"]},
                limits=w["limits"], seed=seed, device=device,
                out_dir=os.path.join(root, "_out"))


def driver_class(root: str, driver: str):
    """The ``Driver`` class of ``drivers/<driver>.py``."""
    path = os.path.join(root, "drivers", driver + ".py")
    return load_module(path, f"portbench_driver_{driver}").Driver


def metric_reader(root: str, metric: str):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, "metrics", metric + ".py")
    mod = load_module(path, "portbench_metric_" + metric.replace(".", "_"))
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries this cell reports: those
    that list it under ``workloads``, and those without the key (a
    per-layer one then where the end-to-end metric it moves is
    reported)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer
