"""The step's solver options (``warm_start``, ``solver_sor``,
``solver_momentum``) against the JAX package's, on the dense route and
on the static route of the flat many-world step, 30 steps from the same
numpy state.

The scenes: boxes resting on the ground and on each other, two falling
onto them and a capsule dropping, so contacts live from the first step
(the dense route: one world; the static route: the capsule scene of
``tests/test_torch_capsule_slots.py`` in 2 worlds).  Each option runs
alone with the others at their defaults on the dense route, and all
three at once on the static route.  Bar: every step within 1e-4 of
JAX, positions, rotations and velocities (JAX's CPU compiler fuses
multiply-adds and PyTorch does not, and 10 Jacobi iterations carry the
difference).  The defaults are the port's own behaviour, so every other
test of the step holds them.  Without warm start the step keeps the
previous contact cache, as JAX's ``_finish_step`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import make_step_fn as jax_make_step_fn
from banggameengine_tpu.parallel import manyworld as jax_mw
from banggameengine_tpu.state import InputFrame as JaxInputFrame
from banggameengine_tpu_torch import convert
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.parallel import manyworld
from banggameengine_tpu_torch.state import InputFrame

from test_physics import build_world
from test_torch_app_golden import one_torch_thread  # noqa: F401
from test_torch_capsule_slots import CAPSULE_BODIES

ATOL = 1e-4
STEPS = 30
FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
OPTIONS = {"cold": dict(warm_start=False), "sor_1.3": dict(solver_sor=1.3),
           "no_momentum": dict(solver_momentum=0.0)}
DENSE_BODIES = [
    {"pos": (0.0, 0.5, 0.0)},
    {"pos": (0.1, 1.49, 0.05), "euler": (0.0, 0.3, 0.0)},
    {"pos": (1.2, 0.5, 0.0), "friction": 0.8},
    {"pos": (1.1, 2.3, 0.1), "euler": (0.4, 0.0, 0.2)},
    {"pos": (-1.5, 0.6, 0.4), "shape": "capsule", "size": (0.3, 0.4, 0.0)},
    {"pos": (-1.4, 3.0, 0.0), "euler": (0.0, 0.0, 0.7), "restitution": 0.3},
]


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _port(state, static):
    return (convert.world_state_from_numpy(_np(state), "cpu"),
            convert.static_scene_from_numpy(_np(static), "cpu"))


def _compare(port, jax_state, step):
    for k in FIELDS:
        np.testing.assert_allclose(
            getattr(port, k).numpy(), np.asarray(getattr(jax_state, k)),
            atol=ATOL, rtol=0, err_msg=f"{k} at step {step}")


@pytest.mark.parametrize("name", list(OPTIONS))
def test_dense_route_options_match_jax(name, one_torch_thread):
    kw = OPTIONS[name]
    js, jst = build_world(DENSE_BODIES, capacity=8)
    ts, tst = _port(js, jst)
    jf = jax_make_step_fn(jst, donate=False, **kw)
    tf = make_step_fn(tst, **kw)
    feat0 = ts.contact_feat.clone()
    for i in range(STEPS):
        js, _ = jf(js, JaxInputFrame.zero())
        ts, _ = tf(ts, InputFrame.zero("cpu"))
        _compare(ts, js, i + 1)
        np.testing.assert_array_equal(ts.contact_feat.numpy(),
                                      np.asarray(js.contact_feat))
    if name == "cold":
        assert torch.equal(ts.contact_feat, feat0)     # the cache is kept
    else:
        assert bool((ts.contact_feat >= 0).any())


def test_static_route_options_match_jax(one_torch_thread):
    """The three options at once (one JAX compilation of the flat step):
    a cold start and no momentum in the transposed solver, and the
    over-relaxation, which that solver does not take (in JAX neither)."""
    kw = {k: v for o in OPTIONS.values() for k, v in o.items()}
    js, jst = build_world(CAPSULE_BODIES, capacity=8)
    ts, tst = _port(js, jst)
    jf = jax_mw.make_flat_many_world_step(jst, 2, js.comp_mask, **kw)
    tf = manyworld.make_flat_many_world_step(tst, 2, ts.comp_mask, **kw)
    jb = jax.tree.map(jnp.array, jax_mw.replicate_state(js, 2))
    tb = manyworld.replicate_state(ts, 2)
    ji = jax_mw.replicate_input(JaxInputFrame.zero(), 2)
    ti = manyworld.replicate_input(InputFrame.zero("cpu"), 2)
    for i in range(STEPS):
        jb, tb = jf(jb, ji), tf(tb, ti)
        _compare(tb, jb, i + 1)
    np.testing.assert_array_equal(tb.contact_feat.numpy(),
                                  np.asarray(jb.contact_feat))
    assert not bool((tb.contact_feat >= 0).any())     # the cache is kept


def test_options_change_the_result(one_torch_thread):
    """Each option really reaches the solver: 10 steps of each differ from
    the default's."""
    js, jst = build_world(DENSE_BODIES, capacity=8)
    ts0, tst = _port(js, jst)
    runs = {}
    for name, kw in [("default", {})] + list(OPTIONS.items()):
        tf = make_step_fn(tst, **kw)
        ts = ts0
        for _ in range(10):
            ts, _ = tf(ts, InputFrame.zero("cpu"))
        runs[name] = ts.lin_vel
    for name in OPTIONS:
        assert not torch.equal(runs[name], runs["default"]), name
    # the flat step's transposed solver takes no over-relaxation
    js, jst = build_world(CAPSULE_BODIES, capacity=8)
    ts, tst = _port(js, jst)
    tb = manyworld.replicate_state(ts, 2)
    ti = manyworld.replicate_input(InputFrame.zero("cpu"), 2)
    outs = [manyworld.make_flat_many_world_step(
        tst, 2, ts.comp_mask, num_steps=10, **kw)(tb, ti).lin_vel
        for kw in ({}, dict(solver_sor=1.3), dict(solver_momentum=0.0))]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
