"""CPU runs of tiny cells through every driver: the result line,
the faults the comparison must catch, the control, and a cell and a
metric found by their files alone.

Run: ``python -m pytest portbench/tests -q`` (from the repo root).  The
cells are the real ones cut to a few bodies, worlds and pixels
(:mod:`tiny`); the port runs its eager route and its kernels' plain
versions on the CPU.  ``test_card_run`` needs the card (marker
``cuda``) and skips without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import run
from portbench.tests import tiny

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
CELLS = tuple(tiny.CUTS)
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
REPO = os.path.dirname(tiny.HERE)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make_root(str(tmp_path_factory.mktemp("portbench")))


def one_run(root, cell, trace=False, **kw):
    path, bench = root
    return run.run_cell(path, bench, cell, SEED, 0.2, trace, "cpu",
                        time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_correct(root, cell):
    r = one_run(root, cell)
    assert list(r)[:5] == RESULT_KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    e2e, _ = run_metrics(root, cell)
    assert sorted(r["metrics"]) == sorted(m["name"] for m in e2e)
    for m in e2e:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
        assert r["metrics"][m["name"]]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


def run_metrics(root, cell):
    from portbench.harness import registry
    return registry.cell_metrics(root[1], cell)


@pytest.mark.parametrize("cell", ["rollout4k.act60", "boxes3k.tick1080"])
def test_traced_run_line(root, cell):
    r = one_run(root, cell, trace=True)
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    _, per_layer = run_metrics(root, cell)
    names = {m["name"] for m in per_layer}
    # on the CPU only what needs no device op is read
    assert set(r["metrics"]) <= names
    assert list(r)[-1] == "checks"


FAULTS = [(c, f) for c, fs in (
    ("boxes3k.settled", ("unchanged", "altered")),
    ("rollout4k.act60", ("unchanged", "half", "altered")),
    ("boxes3k.tick1080", ("unchanged", "altered"))) for f in fs]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(root, cell, fault):
    r = one_run(root, cell, fault=fault)
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The reference in bfloat16 put in the program's place fails."""
    r = one_run(root, cell, control=True)
    assert r["correct"] is False


def test_cell_and_metric_found_by_their_files(root, tmp_path):
    """A new cell and a new per-layer metric are new files and new
    entries in BENCHMARK.json: nothing else changes."""
    import shutil

    path, bench = root
    new = tmp_path / "bench"
    shutil.copytree(path, new)
    w = tiny.load(os.path.join(path, "workloads", "boxes3k.settled.json"))
    (new / "metrics" / "calls_traced.sim.py").write_text(
        "def read(ctx):\n    return float(ctx['calls'])\n")
    bench = json.loads(json.dumps(bench))
    mix = tiny.load(os.path.join(path, "traffic", w["traffic"] + ".json"))
    mix["steps_per_call"] = 2
    w["traffic"] = "twostep"
    tiny.save(str(new / "traffic" / "twostep.json"), mix)
    tiny.save(str(new / "workloads" / "boxes3k.twostep.json"), w)
    bench["workloads"].append({"name": "boxes3k.twostep",
                               "config": w["config"], "traffic": "twostep",
                               "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("boxes3k.twostep")
    bench["per_layer"].append({
        "name": "calls_traced.sim", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "test",
        "moves": "sim_steps_per_s", "workloads": ["boxes3k.twostep"]})
    r = run.run_cell(str(new), bench, "boxes3k.twostep", SEED, 0.2, True,
                     "cpu", time.perf_counter())
    assert r["metrics"]["calls_traced.sim"] == {"value": 1.0,
                                                "unit": "calls"}
    assert r["correct"] is True


def test_cell_metrics_follow_benchmark_json():
    from portbench.harness import registry

    bench = tiny.load(os.path.join(REPO, "BENCHMARK.json"))
    for w in bench["workloads"]:
        e2e, per_layer = registry.cell_metrics(bench, w["name"])
        names = [m["name"] for m in e2e]
        assert "setup_s" in names and len(names) >= 2
        assert per_layer, w["name"]
        assert {m["moves"] for m in per_layer} <= set(names)
        cell = tiny.load(os.path.join(tiny.HERE, "workloads",
                                      w["name"] + ".json"))
        assert (cell["config"], cell["traffic"], cell["why"]) == (
            w["config"], w["traffic"], w["why"])


def test_no_card_exits_without_result():
    """Without a card the benchmark prints no result and exits non-zero
    (on the CPU test machine, always)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(tiny.HERE, "run.py"),
                        "--workload", "boxes3k.settled", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_exits_without_result(tmp_path):
    """A folder holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_out",
                                                  "_cache"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "boxes3k.settled", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode == 5 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_card_run(card, root):
    """The smallest cell on the card: graphs captured, kernels built."""
    path, bench = root
    r = run.run_cell(path, bench, "boxes3k.settled", SEED, 0.5, True,
                     "cuda", time.perf_counter())
    assert r["correct"] is True and r["device"]["busy_s"] > 0
