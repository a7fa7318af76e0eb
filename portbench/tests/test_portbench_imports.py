"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port.  Names are compared whole, at
the top level: the port's name (``banggameengine_tpu_torch``) begins with
the JAX package's (``banggameengine_tpu``)."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench.tests import tiny

HERE = tiny.HERE
REPO = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "banggameengine_tpu"}
PORT = "banggameengine_tpu_torch"


def imported(path: str) -> set[str]:
    """Top-level names of every module that ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = "") -> list[str]:
    return sorted(p for p in glob.glob(os.path.join(HERE, sub, "**", "*.py"),
                                       recursive=True)
                  if os.sep + "tests" + os.sep not in p)


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_no_jax_and_no_port(path):
    bad = imported(path) & (JAX | {PORT})
    assert not bad, f"{path} imports {bad}"


def test_benchmark_sources_import_no_jax():
    for path in sources():
        bad = imported(path) & JAX
        assert not bad, f"{path} imports {bad}"


def test_whole_name_comparison():
    assert {"banggameengine_tpu_torch.state".split(".")[0]} & JAX == set()
    assert {"banggameengine_tpu.state".split(".")[0]} & JAX


def test_runs_load_no_jax(tmp_path):
    """A tiny run of each traffic driver, in a fresh interpreter, leaves
    no JAX module and no module of the JAX package loaded."""
    code = f"""
import json, sys, time
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
from portbench import run
from portbench.tests import tiny
root, bench = tiny.make_root({str(tmp_path)!r})
for cell in tiny.CUTS:
    run.run_cell(root, bench, cell, 7, 0.1, cell == "rollout4k.act60",
                 "cpu", time.perf_counter())
print(json.dumps(run.forbidden_modules()))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
