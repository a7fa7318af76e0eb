"""The port's spatial-hash grid broadphase (``broadphase.
build_neighbor_lists``) and the step's ``broadphase="grid"`` route against
the JAX package's, on the same numpy inputs.

The lists must be equal exactly (``idx``, ``valid``, ``cell_overflow``,
``nbr_overflow``): on the cases of ``tests/test_broadphase.py``, on 500
bodies hashed into 64 cells (hash collisions and full cells), and on
bodies at negative cell coordinates (the hash's floor modulo of negative
products).  The step: ``build_falling_boxes(200, seed=1)`` over 50 steps,
every step within 1e-4 of JAX (positions up to ~100; JAX's CPU compiler
fuses multiply-adds and PyTorch does not, and the solver carries the
difference), and the 32-box scene of the stress golden on the grid route
(the JAX test's grid settings, ``tests/test_contact_t.py:181``), whose
trajectory ``tests/data/grid32_jax_golden.json`` keeps for
``chip_smoke.py`` phase 19: contact features exact after one step,
positions within 1e-3 after 60 (a box's bounce near step 40 leaves
9.2e-5 on the CPU, which grows by 7e-6 a step); ``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_grid.py`` rewrites it.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu import math3d as jax_math3d
from banggameengine_tpu.engine import make_step_fn as jax_make_step_fn
from banggameengine_tpu.physics import broadphase as jax_broadphase
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.physics import broadphase
from banggameengine_tpu_torch.state import InputFrame

from test_torch_app_golden import one_torch_thread  # noqa: F401

STEP_ATOL = 1e-4
GOLDEN_ATOL = 1e-3   # step 60 of the 32-box scene (chip_smoke.py's bar too)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "grid32_jax_golden.json")
SCENE = dict(num_bodies=32, seed=11, spread=3.0)
GRID = dict(broadphase="grid", grid_cell_size=2.5, grid_table_size=1024,
            max_neighbors=8)
GOLDEN_STEPS = (1, 60)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _boxes(positions, half=0.5, quat=None) -> dict:
    n = len(positions)
    q = (np.asarray(jax_math3d.quat_identity((n,))) if quat is None
         else quat)
    return dict(pos=np.asarray(positions, np.float32), quat=q,
                shape_type=np.full(n, 1, np.int8),
                size=np.full((n, 3), half, np.float32),
                active=np.ones(n, bool))


def _cases():
    """(name, inputs, keyword arguments): ``tests/test_broadphase.py``'s
    cases, then the hash's hard ones."""
    rng = np.random.default_rng(0)
    inactive = _boxes([[0, 0, 0], [0.5, 0, 0]])
    inactive["active"] = np.array([True, False])
    pile = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    q = rng.standard_normal((500, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    crowd = _boxes(pile, 0.6, q)
    crowd["active"] = rng.random(500) < 0.9
    crowd["shape_type"][::7] = 2                     # some capsules
    crowd["size"][::7, 2] = 0.0
    negative = _boxes(rng.uniform(-40, -0.5, (120, 3)).astype(np.float32))
    straddle = _boxes(np.float32([[-0.05, -2.5, -5.0], [0.05, -2.5, -5.0],
                                  [-2.45, -2.55, -4.95], [-2.55, -2.45,
                                                          -5.05]]))
    return [
        ("adjacent", _boxes([[0, 0, 0], [0.9, 0, 0], [10, 0, 0]]),
         dict(cell_size=2.0)),
        ("cross_cell", _boxes([[1.95, 0, 0], [2.05, 0, 0]]),
         dict(cell_size=2.0)),
        ("inactive", inactive, dict(cell_size=2.0)),
        ("dense_cluster",
         _boxes(np.random.default_rng(0).uniform(0, 0.5, (40, 3))),
         dict(cell_size=4.0, cell_capacity=8)),
        ("hash_collisions",
         _boxes([[0, 0, 0], [50, 0, 0], [100, 0, 0], [150, 0, 0]]),
         dict(cell_size=2.0, table_size=2)),
        ("500_in_64_cells", crowd,
         dict(cell_size=2.5, table_size=64, cell_capacity=6,
              max_neighbors=6)),
        ("negative_cells", negative,
         dict(cell_size=1.5, table_size=97, max_neighbors=8)),
        ("straddle_negative_faces", straddle, dict(cell_size=2.5)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_build_neighbor_lists_equals_jax(case):
    name, inputs, kw = case
    args = ("pos", "quat", "shape_type", "size", "active")
    want = jax.jit(jax_broadphase.build_neighbor_lists,
                   static_argnames=tuple(kw))(
        *(jnp.asarray(inputs[k]) for k in args), **kw)
    got = broadphase.build_neighbor_lists(
        *(torch.from_numpy(np.array(inputs[k])) for k in args), **kw)
    for field in ("idx", "valid", "cell_overflow", "nbr_overflow"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, field
        np.testing.assert_array_equal(g, w, err_msg=f"{name}: {field}")
    if name == "500_in_64_cells":
        assert int(got.cell_overflow) > 0 and int(got.nbr_overflow) > 0
        assert int(got.valid.sum()) > 500
    if name == "negative_cells":
        assert int(got.valid.sum()) > 0
        assert bool((broadphase._cell_coords(
            torch.from_numpy(inputs["pos"]), 1.5) < 0).all())


def _pair(scene: dict, **kw):
    js, jst = jax_build_falling_boxes(**scene)
    ts = convert.world_state_from_numpy(_np(js), "cpu")
    tst = convert.static_scene_from_numpy(_np(jst), "cpu")
    return (js, jax_make_step_fn(jst, donate=False, **kw),
            ts, make_step_fn(tst, **kw))


def test_grid_step_tracks_jax(one_torch_thread):
    js, jf, ts, tf = _pair(dict(num_bodies=200, seed=1), broadphase="grid",
                           grid_cell_size=2.5, grid_table_size=8192)
    contacts = 0
    for i in range(50):
        js, je = jf(js, JaxInputFrame.zero())
        ts, te = tf(ts, InputFrame.zero("cpu"))
        np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos),
                                   atol=STEP_ATOL, rtol=0,
                                   err_msg=f"step {i + 1}")
        assert int(te.contact_overflow) == int(je.contact_overflow)
        contacts = int((ts.contact_feat >= 0).sum())
    assert contacts > 0


def _jax_golden() -> dict:
    js, jst = jax_build_falling_boxes(**SCENE)
    step = jax_make_step_fn(jst, donate=False, **GRID)
    at = {}
    for i in range(1, GOLDEN_STEPS[-1] + 1):
        js, _ = step(js, JaxInputFrame.zero())
        if i in GOLDEN_STEPS:
            rec = {"pos": np.asarray(js.pos).astype(float).tolist()}
            if i == GOLDEN_STEPS[0]:
                rec["contact_feat"] = np.asarray(js.contact_feat).tolist()
            at[str(i)] = rec
    return {"scene": SCENE, "grid": GRID, "steps": list(GOLDEN_STEPS),
            "at": at, "source": "banggameengine_tpu make_step_fn(static, "
                                "**grid) on the CPU"}


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_grid32_tracks_the_golden(golden, one_torch_thread):
    _, _, ts, tf = _pair(golden["scene"], **golden["grid"])
    for i in range(1, golden["steps"][-1] + 1):
        ts, _ = tf(ts, InputFrame.zero("cpu"))
        rec = golden["at"].get(str(i))
        if rec is None:
            continue
        if "contact_feat" in rec:
            assert ts.contact_feat.tolist() == rec["contact_feat"], i
        np.testing.assert_allclose(ts.pos.numpy(), np.float32(rec["pos"]),
                                   atol=GOLDEN_ATOL, rtol=0, err_msg=str(i))


def test_chip_smoke_golden_is_current(golden):
    assert golden == json.loads(json.dumps(_jax_golden())), (
        "tests/data/grid32_jax_golden.json is stale: run PYTHONPATH=. "
        "JAX_PLATFORMS=cpu python tests/test_torch_grid.py")


if __name__ == "__main__":
    with open(GOLDEN, "w") as f:
        json.dump(_jax_golden(), f)
        f.write("\n")
    print(f"wrote {GOLDEN}")
