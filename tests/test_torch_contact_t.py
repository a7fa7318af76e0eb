"""The PyTorch port's transposed box contact pipeline and Jacobi solver
against the JAX package's ``contact_t``, given the same neighbor lists.

Tolerances: integer and bool outputs (partners, validity, feature ids,
overflow) exact; contact floats atol=1e-5; solver velocities and lambdas
atol=1e-5, rtol=1e-5 (JAX's CPU compiler fuses multiply-adds, PyTorch does
not, and 10 Jacobi iterations carry the last-bit differences along).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.engine import make_step_fn as jax_make_step_fn
from banggameengine_tpu.physics import contact_t as jax_contact_t
from banggameengine_tpu.physics import shapes as jax_shapes
from banggameengine_tpu.physics.broadphase_pallas import (
    morton_key_xz,
    neighbor_lists_pallas_aabb,
)
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu.state import InputFrame
from banggameengine_tpu_torch.physics import contact_t

NAMES = ("c_prt", "c_ptx", "c_pty", "c_ptz", "c_nx", "c_ny", "c_nz", "c_dep",
         "c_valid", "overflow", "c_feat")


@pytest.fixture(scope="module")
def sorted_scene():
    """24 boxes after 120 steps (the scene of tests/test_contact_t.py; some
    touch, some still fall), in Morton order with their Pallas neighbor
    lists, as the stress step sees them."""
    state, static = jax_build_falling_boxes(24, seed=7, spread=2.5)
    step = jax_make_step_fn(static, donate=False)
    for _ in range(120):
        state, _ = step(state, InputFrame.zero())
    order = jnp.argsort(morton_key_xz(state.pos))
    mn, mx = jax_shapes.shape_aabb(state.pos, state.quat, static.shape_type,
                                   static.shape_size)
    alive = np.asarray(state.alive)
    dyn = jnp.asarray(np.where(alive, 1, -1).astype(np.int32))
    layer = jnp.asarray(np.asarray(static.layer).view(np.int32))
    mask = jnp.asarray(np.asarray(static.mask).view(np.int32))
    nl = neighbor_lists_pallas_aabb(mn[order], mx[order], dyn[order],
                                    layer[order], mask[order],
                                    max_neighbors=8, interpret=True)
    g = np.float32(-9.81) * np.float32(1.0 / 120.0)
    vel = np.asarray(state.lin_vel)[np.asarray(order)].copy()
    vel[alive[np.asarray(order)], 1] += g
    s = {
        "pos": state.pos[order], "quat": state.quat[order],
        "half": static.shape_size[order], "nb_idx": nl.idx,
        "nb_valid": nl.valid, "ground_valid": jnp.asarray(alive)[order],
        "order": order.astype(jnp.int32), "vel": jnp.asarray(vel),
        "ang": state.ang_vel[order], "inv_m": static.inv_mass[order],
        "inertia": static.inv_inertia_body[order],
        "friction": static.friction[order],
        "restitution": static.restitution[order],
        "dt": static.fixed_dt,
    }
    return {k: np.array(v) for k, v in s.items()}


def _t(a):
    return torch.as_tensor(np.array(a))


def _contacts(s, lib, conv, with_feat):
    args = [conv(s[k]) for k in ("pos", "quat", "half", "nb_idx", "nb_valid",
                                 "ground_valid")]
    return lib.box_contacts_t(*args, budget=12,
                              orig_id=conv(s["order"]) if with_feat else None)


@pytest.mark.parametrize("with_feat", [True, False])
def test_box_contacts_match_jax(sorted_scene, with_feat):
    want = _contacts(sorted_scene, jax_contact_t, jnp.asarray, with_feat)
    got = _contacts(sorted_scene, contact_t, _t, with_feat)
    assert len(want) == len(got) == (11 if with_feat else 10)
    valid, partner = np.asarray(want[8]), np.asarray(want[0])
    assert (valid & (partner >= 0)).any()       # box-box contacts
    assert (valid & (partner < 0)).any()        # ground contacts
    for name, w, g in zip(NAMES, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _solve(s, lib, conv, contacts, warm):
    body = [conv(s[k]) for k in ("vel", "ang", "pos", "quat", "inv_m",
                                 "inertia")]
    mats = [conv(s["friction"]), conv(s["restitution"]), conv(s["dt"])]
    return lib.solve_contacts_t(
        *body, *map(conv, contacts[:9]), *mats, iterations=10,
        ground_friction=0.5, momentum=0.5, return_lambdas=True,
        warm=None if warm is None else tuple(map(conv, warm)))


@pytest.mark.parametrize("warm_start", [False, True])
def test_solve_matches_jax(sorted_scene, warm_start):
    contacts = [np.asarray(c) for c in _contacts(
        sorted_scene, jax_contact_t, jnp.asarray, with_feat=False)]
    warm = None
    if warm_start:
        # last step's impulses, as the feature match would hand them over
        _, _, lams = _solve(sorted_scene, jax_contact_t, jnp.asarray,
                            contacts, None)
        warm = tuple(np.asarray(x) * np.float32(0.9) for x in lams)
    v_j, w_j, lam_j = _solve(sorted_scene, jax_contact_t, jnp.asarray,
                             contacts, warm)
    v_t, w_t, lam_t = _solve(sorted_scene, contact_t, _t, contacts, warm)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **tol)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **tol)
    for name, a, b in zip(("ln", "lt1", "lt2"), lam_j, lam_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **tol)
    assert np.abs(np.asarray(lam_j[0])).max() > 0.0


def test_unported_options_raise(sorted_scene):
    s = sorted_scene
    with pytest.raises(NotImplementedError, match="capsule"):
        contact_t.box_contacts_t(
            *(_t(s[k]) for k in ("pos", "quat", "half", "nb_idx", "nb_valid",
                                 "ground_valid")),
            shape_type=torch.ones(len(s["pos"]), dtype=torch.int8))
    contacts = _contacts(s, contact_t, _t, with_feat=False)
    with pytest.raises(NotImplementedError, match="lane-roll"):
        contact_t.solve_contacts_t(
            *(_t(s[k]) for k in ("vel", "ang", "pos", "quat", "inv_m",
                                 "inertia")),
            *contacts[:9], _t(s["friction"]), _t(s["restitution"]),
            _t(s["dt"]), block_size=8)
