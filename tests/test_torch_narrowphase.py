"""The port's narrowphase, dense broadphase, compaction and unified solver
against the JAX package's, on the same seeded numpy inputs.

Random pairs at random rotations: box-box, capsule-box, box-capsule,
capsule-capsule, and the edge-on-edge pair of
``tests/test_physics.py::test_edge_edge_cross_contact``; cross axes win
the SAT on some of them.  The JAX functions run jitted on the CPU.

Tolerances: floats atol=1e-5 (values up to ~3; JAX's CPU compiler fuses
multiply-adds and PyTorch does not, so the two differ in the last bits:
measured up to ~1e-6 here); integer and boolean outputs exact.  The SAT's
winning axis is ``argmin`` over 15 overlaps: it is held exact on the
pairs where the best axis wins by more than 1e-6 (a float64 recount of
the overlaps gives the margin), and the near ties are counted, not
compared.  The solver: one call of 10 iterations on both sides of the
JAX solver's one-hot partner read (n <= 128), a 12-box and a 200-box
packed pile: velocities and impulses within 1e-5 plus 1e-6 of their size
(the 200-box pile's impulses reach ~90, where one f32 ulp is 7.6e-6;
measured: velocities 4.8e-6, impulses 1.5e-5 at most).
"""
SOLVE_RTOL = 1e-6

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu import math3d as jax_math3d
from banggameengine_tpu.physics import broadphase as jax_broadphase
from banggameengine_tpu.physics import narrowphase as jax_nf
from banggameengine_tpu.physics import shapes as jax_shapes
from banggameengine_tpu.physics import solver as jax_solver
from banggameengine_tpu_torch import math3d
from banggameengine_tpu_torch.physics import broadphase, shapes, solver
from banggameengine_tpu_torch.physics import narrowphase as nf
from banggameengine_tpu_torch.physics.step import SOLVER_MOMENTUM as MOMENTUM

ATOL = 1e-5
SAT_MARGIN = 1e-6
BOX, CAP = 1, 2
KINDS = {"box-box": (BOX, BOX), "capsule-box": (CAP, BOX),
         "box-capsule": (BOX, CAP), "capsule-capsule": (CAP, CAP)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file (small ops beside other test
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _sizes(rng, types):
    box = rng.uniform(0.2, 0.8, (len(types), 3))
    cap = np.stack([rng.uniform(0.2, 0.5, len(types)),
                    rng.uniform(0.2, 0.8, len(types)),
                    np.zeros(len(types))], axis=1)
    return np.where((types == BOX)[:, None], box, cap).astype(np.float32)


def _pairs(kind: str, seed: int, n: int = 96) -> dict:
    """n random pairs of ``kind`` close enough that most touch; for
    box-box, the edge-on-edge pair of test_physics.py last."""
    rng = np.random.default_rng(seed)
    ta, tb = KINDS[kind]
    p = dict(type_a=np.full(n, ta, np.int8), type_b=np.full(n, tb, np.int8),
             pos_a=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
             quat_a=_quats(rng, n), quat_b=_quats(rng, n))
    p["pos_b"] = (p["pos_a"] + rng.uniform(-1.3, 1.3, (n, 3))).astype(
        np.float32)
    p["size_a"] = _sizes(rng, p["type_a"])
    p["size_b"] = _sizes(rng, p["type_b"])
    if kind == "box-box":
        e = jax_math3d.quat_from_euler_xyz(
            jnp.asarray([[0, 0, 0], [0.0, 0.785398, 0.785398]], jnp.float32))
        p["pos_a"][-1], p["pos_b"][-1] = (0, 1.75, 0), (0, 0.5, 0)
        p["quat_a"][-1], p["quat_b"][-1] = np.asarray(e)[1], np.asarray(e)[0]
        p["size_a"][-1] = p["size_b"][-1] = 0.5
    return p


ARGS = ("pos_a", "quat_a", "type_a", "size_a",
        "pos_b", "quat_b", "type_b", "size_b")


def _sat_margin(p) -> np.ndarray:
    """How far each box pair's best SAT axis wins (float64 recount of the
    15 overlaps; cross axes shorter than 1e-4 left out, as the SAT does)."""
    ra = np.asarray(jax_math3d.quat_to_mat3(jnp.asarray(p["quat_a"])),
                    np.float64)
    rb = np.asarray(jax_math3d.quat_to_mat3(jnp.asarray(p["quat_b"])),
                    np.float64)
    ha, hb = p["size_a"].astype(np.float64), p["size_b"].astype(np.float64)
    t = (p["pos_b"] - p["pos_a"]).astype(np.float64)
    axes = [ra[:, :, i] for i in range(3)] + [rb[:, :, j] for j in range(3)]
    axes += [np.cross(ra[:, :, i], rb[:, :, j]) for i in range(3)
             for j in range(3)]
    ovs = []
    for ax in axes:
        ln = np.linalg.norm(ax, axis=1)
        u = ax / np.maximum(ln, 1e-300)[:, None]
        ov = (np.abs(np.einsum("nki,nk->ni", ra, u)) * ha).sum(1) + (
            np.abs(np.einsum("nki,nk->ni", rb, u)) * hb).sum(1) - np.abs(
            (t * u).sum(1))
        ovs.append(np.where(ln > 1e-4, ov, np.inf))
    ovs = np.sort(np.stack(ovs, 1), axis=1)
    return ovs[:, 1] - ovs[:, 0]


_jax_pair = jax.jit(jax_nf.pair_contacts, static_argnames="enable_capsule")


def _jax_sat(p):
    rot_a = jax_math3d.quat_to_mat3(jnp.asarray(p["quat_a"]))
    rot_b = jax_math3d.quat_to_mat3(jnp.asarray(p["quat_b"]))
    return [np.asarray(x) for x in jax.jit(jax_nf.box_box_sat_mtv)(
        jnp.asarray(p["pos_a"]), rot_a, jnp.asarray(p["size_a"]),
        jnp.asarray(p["pos_b"]), rot_b, jnp.asarray(p["size_b"]))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_box_sat_mtv(seed):
    p = _pairs("box-box", seed)
    jn, jd, jov, jbest = _jax_sat(p)
    tn, td, tov, tbest = nf.box_box_sat_mtv(
        _t(p["pos_a"]), math3d.quat_to_mat3(_t(p["quat_a"])),
        _t(p["size_a"]), _t(p["pos_b"]),
        math3d.quat_to_mat3(_t(p["quat_b"])), _t(p["size_b"]))
    clear = _sat_margin(p) > SAT_MARGIN
    assert clear.sum() >= len(clear) - 2, f"{(~clear).sum()} near ties"
    assert clear[-1] and (jbest[clear] >= 6).sum() > 5   # cross axes win
    np.testing.assert_array_equal(tov.numpy(), jov)
    np.testing.assert_array_equal(tbest.numpy()[clear], jbest[clear])
    np.testing.assert_allclose(tn.numpy()[clear], jn[clear], atol=ATOL)
    np.testing.assert_allclose(td.numpy(), jd, atol=ATOL)


@pytest.mark.parametrize("kind,enable_capsule",
                         [(k, True) for k in KINDS] + [("box-box", False)])
def test_pair_contacts(kind, enable_capsule):
    p = _pairs(kind, seed=len(kind))
    out_j = [np.asarray(x) for x in _jax_pair(
        *[jnp.asarray(p[k]) for k in ARGS], enable_capsule=enable_capsule)]
    out_t = [x.numpy() for x in nf.pair_contacts(
        *[_t(p[k]) for k in ARGS], enable_capsule=enable_capsule)]
    keep = (_sat_margin(p) > SAT_MARGIN if kind == "box-box"
            else np.ones(len(p["pos_a"]), bool))
    assert keep.sum() >= len(keep) - 2
    (jp, jn, jd, jg), (tp, tn, td, tg) = out_j, out_t
    assert tg.shape == jg.shape == (len(keep), nf.K_PAIR if enable_capsule
                                    else nf.K_BB)
    np.testing.assert_array_equal(tg[keep], jg[keep])
    assert jg[keep].any(axis=1).mean() > 0.3       # most pairs touch
    # the slots whose shape case applies (the others hold the arithmetic
    # of a case that does not, e.g. a capsule read as a flat box)
    live = jg & keep[:, None]
    for t, j, name in ((tp, jp, "point"), (tn, jn, "normal"),
                       (td, jd, "depth")):
        np.testing.assert_allclose(t[live], j[live], atol=ATOL, rtol=0,
                                   err_msg=name)


def _entities(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    st = np.where(rng.random(n) < 0.6, BOX, CAP).astype(np.int8)
    st[:2] = (0, BOX)                     # a shapeless entity, a box
    return dict(pos=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
                quat=_quats(rng, n), shape_type=st, size=_sizes(rng, st))


@pytest.mark.parametrize("seed", [0, 1])
def test_ground_contacts(seed):
    e = _entities(seed)
    keys = ("pos", "quat", "shape_type", "size")
    out_j = jax.jit(jax_nf.ground_contacts)(*[jnp.asarray(e[k]) for k in keys])
    out_t = nf.ground_contacts(*[_t(e[k]) for k in keys])
    for t, j in zip(out_t, out_j):
        if t.dtype == torch.bool:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_boolean_overlap_pairs(kind):
    p = _pairs(kind, seed=7 + len(kind))
    j = np.asarray(jax.jit(jax_nf.boolean_overlap_pairs)(
        *[jnp.asarray(p[k]) for k in ARGS]))
    t = nf.boolean_overlap_pairs(*[_t(p[k]) for k in ARGS]).numpy()
    assert 0.2 < j.mean() < 0.95
    np.testing.assert_array_equal(t, j)


def test_boolean_overlap_matrix():
    e = _entities(3)
    keys = ("pos", "quat", "shape_type", "size")
    j = np.asarray(jax.jit(jax_nf.boolean_overlap_matrix)(
        *[jnp.asarray(e[k]) for k in keys]))
    t = nf.boolean_overlap_matrix(*[_t(e[k]) for k in keys]).numpy()
    assert j.any() and not j.all()
    np.testing.assert_array_equal(t, j)


# ---- shapes --------------------------------------------------------------

def test_shape_helpers():
    rng = np.random.default_rng(5)
    q = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    half = rng.uniform(0.2, 1.0, (200, 3)).astype(np.float32)
    q[0] = (0.0, 0.1, 0.1)                  # inside, on no axis's sign
    q[1] = (0.3, 0.3, 0.0)                  # equal clearances: x wins
    half[1] = (0.5, 0.5, 0.9)
    for t, j in zip(shapes.closest_point_on_box(_t(q), _t(half)),
                    jax_shapes.closest_point_on_box(jnp.asarray(q),
                                                    jnp.asarray(half))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    segs = rng.uniform(-2, 2, (4, 200, 3)).astype(np.float32)
    segs[2:, 0] = segs[:2, 0]               # the same segment twice
    segs[1, 1] = segs[0, 1]                 # a point, not a segment
    for t, j in zip(shapes.closest_segment_segment(*map(_t, segs)),
                    jax_shapes.closest_segment_segment(
                        *map(jnp.asarray, segs))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    mn = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    mx = mn + rng.uniform(0, 1, (50, 3)).astype(np.float32)
    j = jax_shapes.aabb_overlap(mn[:, None], mx[:, None], mn[None], mx[None],
                                margin=0.04)
    t = shapes.aabb_overlap(_t(mn)[:, None], _t(mx)[:, None], _t(mn)[None],
                            _t(mx)[None], margin=0.04)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    qs = _quats(rng, 5)
    np.testing.assert_array_equal(math3d.quat_conj(_t(qs)).numpy(),
                                  np.asarray(jax_math3d.quat_conj(qs)))


# ---- the dense broadphase and the compaction -------------------------------

def _pile(n: int, seed: int) -> dict:
    """n unit boxes on a jittered grid at 0.99 spacing (neighbors touch),
    a few capsules, random velocities: a dense contact set."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n]
    pos = (grid * 0.99 + rng.uniform(-0.01, 0.01, (n, 3))
           + (0, 0.48, 0)).astype(np.float32)
    q = rng.standard_normal((n, 4)) * (0.03, 0.03, 0.03, 1.0)
    st = np.where(rng.random(n) < 0.85, BOX, CAP).astype(np.int8)
    size = np.where((st == BOX)[:, None], 0.5, (0.4, 0.3, 0.0)).astype(
        np.float32)
    return dict(pos=pos, quat=(q / np.linalg.norm(q, axis=1,
                                                  keepdims=True)).astype(
        np.float32), shape_type=st, size=size,
        pair_mask=rng.random((n, n)) < 0.9,
        vel=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        ang=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        inv_mass=rng.uniform(0.5, 2, n).astype(np.float32),
        inv_inertia=rng.uniform(1, 8, (n, 3)).astype(np.float32))


@jax.jit
def _jax_pile(pos, quat, st, size, pair_mask):
    """The dense route's contact set of a pile as JAX builds it: the
    neighbor lists, the candidate slots (partner, point, normal, depth,
    valid, feature) and their compaction to 12 per body."""
    nl = jax_broadphase.build_neighbor_lists_dense(
        pos, quat, st, size, pair_mask, max_neighbors=8)
    j = jnp.maximum(nl.idx, 0)
    pp, pn, pd, pg = jax_nf.pair_contacts(
        pos[:, None], quat[:, None], st[:, None], size[:, None],
        pos[j], quat[j], st[j], size[j])
    gp, gn, gd, gg = jax_nf.ground_contacts(pos, quat, st, size)
    n, k = pd.shape[0], pd.shape[1] * pd.shape[2]
    partner = jnp.broadcast_to(nl.idx[:, :, None], pd.shape)
    cand = (
        jnp.concatenate([partner.reshape(n, k),
                         jnp.full((n, 8), -1, jnp.int32)], 1),
        jnp.concatenate([pp.reshape(n, k, 3), gp], 1),
        jnp.concatenate([pn.reshape(n, k, 3), gn], 1),
        jnp.concatenate([pd.reshape(n, k), gd], 1),
        jnp.concatenate([(pg & (pd > 0) & nl.valid[..., None]).reshape(n, k),
                         gg & (gd > 0)], 1),
        jnp.concatenate([((partner + 1) * 64 + jnp.arange(pd.shape[2])
                          ).reshape(n, k),
                         jnp.broadcast_to(jnp.arange(8), (n, 8))], 1))
    return nl, cand, jax_solver.compact_contacts(*cand[:5], 12, feat=cand[5])


@pytest.fixture(scope="module", params=[12, 200])
def pile(request):
    """A pile of n bodies (both sides of the JAX solver's n <= 128 one-hot
    partner read) and JAX's contact set of it, as numpy."""
    n = request.param
    p = _pile(n, seed=n)
    nl, cand, comp = _jax_pile(*[jnp.asarray(p[k]) for k in (
        "pos", "quat", "shape_type", "size", "pair_mask")])
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return n, p, to_np(nl), to_np(cand), to_np(comp)


def test_build_neighbor_lists_dense(pile):
    n, p, jl, _, _ = pile
    keys = ("pos", "quat", "shape_type", "size", "pair_mask")
    tl = broadphase.build_neighbor_lists_dense(*[_t(p[k]) for k in keys],
                                               max_neighbors=8)
    for name, t, j in zip(("idx", "valid", "cell_overflow", "nbr_overflow"),
                          tl, jl):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert int(jl[3]) > 0 and jl[1].any()


def test_compact_contacts_exact(pile):
    n, _, _, cand, jout = pile
    b, pt, nrm, d, v, f = cand
    tout = solver.compact_contacts(*map(_t, (b, pt, nrm, d, v)), 12,
                                   feat=_t(f))
    names = ("c_b", "point", "normal", "depth", "valid", "overflow", "feat")
    for name, t, j in zip(names, tout, jout):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert jout[4].sum() > n
    assert int(jout[5]) > 0 or n < 100      # the 200-box pile overflows


def test_one_hot_compaction_spreads_an_unselected_inf():
    """A fault of the reference (ROADMAP §3): the JAX compaction moves
    payloads by a one-hot contraction, so an inf in a slot that is not
    selected becomes 0 * inf = NaN in the selected one.  The port's
    gather returns only the selected entries."""
    valid = np.array([[True, False, True, False]])
    depth = np.array([[0.5, np.inf, 0.25, 1.0]], np.float32)
    b = np.array([[3, 1, 2, 0]], np.int32)
    pt = np.zeros((1, 4, 3), np.float32)
    jout = jax_solver.compact_contacts(
        jnp.asarray(b), jnp.asarray(pt), jnp.asarray(pt), jnp.asarray(depth),
        jnp.asarray(valid), 2)
    tout = solver.compact_contacts(_t(b), _t(pt), _t(pt), _t(depth),
                                   _t(valid), 2)
    assert np.isnan(np.asarray(jout[3])).all()
    np.testing.assert_array_equal(tout[3].numpy(), [[0.5, 0.25]])
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))


# ---- the unified solver ----------------------------------------------------

def test_solve_contacts_unified(pile):
    """One solve on both sides of the JAX solver's one-hot partner read
    (n <= 128), warm-started from random impulses, with momentum."""
    n, p, _, _, comp = pile
    c_b, c_pt, c_n, c_d, c_v = comp[:5]
    rng = np.random.default_rng(n + 1)
    assert c_v.sum() > n and (c_b[c_v] >= 0).any() and (c_b[c_v] < 0).any()
    mu = rng.uniform(0, 0.6, c_d.shape).astype(np.float32)
    e = rng.uniform(0, 0.5, c_d.shape).astype(np.float32)
    warm = rng.uniform(-0.02, 0.05, (3,) + c_d.shape).astype(np.float32)
    iw = np.asarray(jax_solver.inv_inertia_world(
        jnp.asarray(p["quat"]), jnp.asarray(p["inv_inertia"])))
    np.testing.assert_allclose(
        solver.inv_inertia_world(_t(p["quat"]), _t(p["inv_inertia"])).numpy(),
        iw, atol=ATOL, rtol=1e-6)
    dt = np.float32(1 / 120)
    args = (p["vel"], p["ang"], p["pos"], p["inv_mass"], iw, c_b, c_pt, c_n,
            c_d, c_v, mu, e, dt)
    jv, jw, jl = jax_solver.solve_contacts_unified(
        *map(jnp.asarray, args), warm=tuple(map(jnp.asarray, warm)),
        iterations=10, return_lambdas=True, momentum=MOMENTUM)
    tv, tw, tl = solver.solve_contacts_unified(
        *map(_t, args[:-1]), torch.tensor(dt), tuple(map(_t, warm)),
        MOMENTUM, iterations=10)
    for t, j in zip((tv, tw) + tuple(tl), (jv, jw) + tuple(jl)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=SOLVE_RTOL)
    assert np.abs(np.asarray(jv) - p["vel"]).max() > 0.01   # it did work


def test_solve_contacts_unified_from_an_empty_cache(pile):
    """The solve of a scene's first step: the contact cache is empty, so
    every warm impulse is 0; one friction and no restitution."""
    n, p, _, _, comp = pile
    c_b, c_pt, c_n, c_d, c_v = comp[:5]
    mu = np.full(c_d.shape, 0.5, np.float32)
    e = np.zeros(c_d.shape, np.float32)
    warm = np.zeros((3,) + c_d.shape, np.float32)
    iw = np.asarray(jax_solver.inv_inertia_world(
        jnp.asarray(p["quat"]), jnp.asarray(p["inv_inertia"])))
    dt = np.float32(1 / 120)
    args = (p["vel"], p["ang"], p["pos"], p["inv_mass"], iw, c_b, c_pt, c_n,
            c_d, c_v, mu, e, dt)
    jv, jw, jl = jax_solver.solve_contacts_unified(
        *map(jnp.asarray, args), warm=tuple(map(jnp.asarray, warm)),
        iterations=10, return_lambdas=True, momentum=MOMENTUM)
    tv, tw, tl = solver.solve_contacts_unified(
        *map(_t, args[:-1]), torch.tensor(dt), tuple(map(_t, warm)),
        MOMENTUM, iterations=10)
    for t, j in zip((tv, tw) + tuple(tl), (jv, jw) + tuple(jl)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=SOLVE_RTOL)
