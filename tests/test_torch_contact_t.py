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
from banggameengine_tpu_torch import kernel_cases
from banggameengine_tpu_torch.physics import contact_t, contacts_kernel
from banggameengine_tpu_torch.state import FEAT_STRIDE as FEAT
from banggameengine_tpu_torch.state import SHAPE_BOX

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
    # the capsule slots are ported (tests/test_torch_capsule_slots.py holds
    # them against JAX): a scene of boxes alone gives the box-only contacts
    # bit for bit, since every capsule slot is gated off
    box_args = [_t(s[k]) for k in ("pos", "quat", "half", "nb_idx",
                                   "nb_valid", "ground_valid")]
    mixed = contact_t.box_contacts_t(
        *box_args, budget=12, orig_id=_t(s["order"]),
        shape_type=torch.ones(len(s["pos"]), dtype=torch.int8))
    boxes = contact_t.box_contacts_t(*box_args, budget=12,
                                     orig_id=_t(s["order"]))
    assert all(torch.equal(a, b) for a, b in zip(mixed, boxes))
    # the block-diagonal partner read is the gather on every route
    # (tests/test_torch_manyworld.py holds it against the JAX block route)
    contacts = _contacts(s, contact_t, _t, with_feat=False)
    args = [*(_t(s[k]) for k in ("vel", "ang", "pos", "quat", "inv_m",
                                 "inertia")),
            *contacts[:9], _t(s["friction"]), _t(s["restitution"]),
            _t(s["dt"])]
    with pytest.raises(TypeError):
        contact_t.solve_contacts_t(*args, block_size=8)


# ---- the contract the CUDA kernel copies (physics/csrc/box_contacts.cu) ----

def _boxes(centres, halves, pairs, k, orig):
    """Axis-aligned boxes with each listed pair in both rows' lists, in the
    order given, -1 padded to K (``kernel_cases.listed_pairs``)."""
    n = len(centres)
    idx, valid = map(torch.as_tensor, kernel_cases.listed_pairs(pairs, n, k))
    quat = torch.tensor([[0.0, 0.0, 0.0, 1.0]] * n)
    return (torch.tensor(centres), quat, torch.tensor(halves), idx, valid,
            torch.ones(n, dtype=torch.bool),
            torch.tensor(orig, dtype=torch.int64))


def _corner(centre, half, c):
    """Corner c of an axis-aligned box (sign bits x, y, z = bits 2, 1, 0)."""
    return [centre[a] + (half[a] if (c >> (2 - a)) & 1 else -half[a])
            for a in range(3)]


def _expect_rows(out, body, rows):
    """Row ``body`` of the compacted contacts holds ``rows`` = [(partner,
    feature id, point, normal, depth)] in order, then nothing valid."""
    prt, pts, nrm, dep, valid, feat = (out[0], out[1:4], out[4:7], out[7],
                                       out[8], out[10])
    assert int(valid[:, body].sum()) == len(rows)
    for s, (p, f, pt, n, d) in enumerate(rows):
        assert bool(valid[s, body])
        assert (int(prt[s, body]), int(feat[s, body])) == (p, f)
        got = [float(c[s, body]) for c in pts]
        np.testing.assert_allclose(got, pt, atol=1e-6)
        assert [float(c[s, body]) for c in nrm] == n
        assert abs(float(dep[s, body]) - d) < 1e-6
    assert (prt[len(rows):, body] == -1).all()
    assert (feat[len(rows):, body] == -1).all()


def _box_on_box(monkeypatch):
    """A unit box 0.02 m into a wide slab: its 4 lower corners (slots 0, 1,
    4, 5) against the slab; the slab's row holds the same points as slots
    8, 9, 12, 13 (the partner's corners), the normal turned; no ground
    contact (the slab's underside is on y = 0, not below)."""
    a, ha, b, hb = (0.0, 1.98, 0.0), (1.0, 1.0, 1.0), (0.0, 0.5, 0.0), (
        3.0, 0.5, 3.0)
    case = _boxes([a, b], [ha, hb], [(0, 1)], 1, [7, 3])
    out = contact_t.box_contacts_t(*case[:6], budget=12, orig_id=case[6])
    _expect_rows(out, 0, [(1, 4 * FEAT + s, _corner(a, ha, s), [0, 1, 0],
                           0.02) for s in (0, 1, 4, 5)])
    _expect_rows(out, 1, [(0, 8 * FEAT + 8 + s, _corner(a, ha, s),
                           [0, -1, 0], 0.02) for s in (0, 1, 4, 5)])
    assert int(out[9]) == 0


def _pairs_then_ground(monkeypatch):
    """A grounded unit box between two others, 0.02 m into each: its
    pair contacts in the order c * K + k (partner 1's corners 4..7 and
    partner 2's 0..3, alternating), then its 4 ground corners with their
    bare corner ids, which fill the budget of 12."""
    mid, h = (0.0, 0.95, 0.0), (1.0, 1.0, 1.0)
    case = _boxes([mid, (1.98, 0.95, 0.0), (-1.98, 0.95, 0.0)], [h] * 3,
                  [(0, 1), (0, 2)], 2, [0, 1, 2])
    out = contact_t.box_contacts_t(*case[:6], budget=12, orig_id=case[6])
    pair = {1: ([4, 5, 6, 7], [-1, 0, 0]), 2: ([0, 1, 2, 3], [1, 0, 0])}
    rows = [(p, (p + 1) * FEAT + pair[p][0][c], _corner(mid, h, pair[p][0][c]),
             pair[p][1], 0.02) for c in range(4) for p in (1, 2)]
    rows += [(-1, g, _corner(mid, h, g), [0, 1, 0], 0.05)
             for g in (0, 1, 4, 5)]
    _expect_rows(out, 0, rows)
    # each pair has 8 candidates a side (4 over the cap), no budget over
    assert int(out[9]) == 4 * 4


def _overflows(monkeypatch):
    """The overflow count adds the pairs' candidates over the 4-point cap
    (two boxes half into each other: 8 candidates a side), the ground's
    over its cap (a box under the ground: 8 corners) and the budget's."""
    case = _boxes([(-20.0, -2.0, 0.0), (10.0, 5.0, 0.0), (10.0, 6.5, 0.0)],
                  [(1.0, 1.0, 1.0)] * 3, [(1, 2)], 1, [0, 1, 2])
    pair_over, ground_over = 4 + 4, 8 - 4
    for budget, budget_over in ((12, 0), (4, 0), (3, 3), (1, 9)):
        out = contact_t.box_contacts_t(*case[:6], budget=budget)
        assert int(out[9]) == pair_over + ground_over + budget_over, budget
        assert out[8].sum(dim=0).tolist() == [min(budget, 4)] * 3


def _plain_route(monkeypatch):
    """CPU tensors, box-only or mixed, never reach the kernel's wrapper and
    give the plain version's outputs."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(contacts_kernel, "box_contacts", no_kernel)
    case = _boxes([(0.0, 0.95, 0.0), (1.98, 0.95, 0.0)],
                  [(1.0, 1.0, 1.0)] * 2, [(0, 1)], 1, [0, 1])
    for shape_type in (None, torch.tensor([SHAPE_BOX] * 2, dtype=torch.int8)):
        got = contact_t.box_contacts_t(*case[:6], orig_id=case[6],
                                       shape_type=shape_type)
        want = contact_t.box_contacts_t_reference(*case[:6], orig_id=case[6],
                                                  shape_type=shape_type)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("scene", [_box_on_box, _pairs_then_ground,
                                   _overflows, _plain_route],
                         ids=lambda f: f.__name__.strip("_"))
def test_box_contacts_contract(scene, monkeypatch):
    """The order, feature ids and overflow count of ``box_contacts_t`` on
    hand-built scenes, which the CUDA kernel copies bit for bit."""
    scene(monkeypatch)
