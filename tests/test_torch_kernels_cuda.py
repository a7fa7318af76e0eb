"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (sm_90a) and ``nvcc``; without a card every test skips.
Imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import inspect
import os

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import convert, graphs, kernel_cases
from banggameengine_tpu_torch.engine import make_multi_step_fn
from banggameengine_tpu_torch.engine import make_step_fn
from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.physics import contact_t
from banggameengine_tpu_torch.physics import contacts_kernel as ck
from banggameengine_tpu_torch.physics import shapes
from banggameengine_tpu_torch.physics import joints as jt
from banggameengine_tpu_torch.physics import solve_kernel as sk
from banggameengine_tpu_torch.physics import unified_kernel as uk
from banggameengine_tpu_torch.render import raster_resolve as rr
from banggameengine_tpu_torch.render import raster_tile as rt
from banggameengine_tpu_torch.render import raster_walk as rwk
from banggameengine_tpu_torch.render import resolve as rsv
from banggameengine_tpu_torch.render.pipeline import make_render_fn
from banggameengine_tpu_torch.scene.synthetic import (
    build_falling_boxes,
    build_showcase_render,
)
from banggameengine_tpu_torch.scripts import gather_rows as gr
from banggameengine_tpu_torch.state import FEAT_STRIDE, InputFrame

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _random_case(n, seed, device):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    half = rng.uniform(0.1, 0.8, (n, 3)).astype(np.float32)
    dyn = rng.choice(np.array([-1, 0, 1], np.int32), n, p=[0.1, 0.3, 0.6])
    layer = rng.integers(0, 4, n).astype(np.int32)
    mask = np.where(rng.random(n) < 0.5, -1,
                    rng.integers(0, 4, n)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(center - half), t(center + half), t(dyn), t(layer), t(mask)


def _packed_case(side, layers, device):
    """side x side x layers randomly rotated unit boxes at 0.98 spacing,
    in Morton order: every interior box overlaps more than 8 others."""
    n = side * side * layers
    state, static = build_falling_boxes(n, seed=0)
    g = torch.arange(n, device=device)
    pos = torch.stack([g % side, g // (side * side), (g // side) % side],
                      dim=1).to(torch.float32) * 0.98
    pos[:, 1] += 0.49
    order = torch.argsort(bk.morton_key_xz(pos), stable=True)
    mn, mx = shapes.shape_aabb(pos, state.quat, static.shape_type,
                               static.shape_size)
    dyn = torch.where(state.alive, 1, -1).to(torch.int32)
    return (mn[order], mx[order], dyn[order], static.layer[order],
            static.mask[order])


def _assert_kernel_equals_plain(case, k):
    nl_k = bk.neighbor_lists_aabb(*case, max_neighbors=k)
    nl_p = bk.neighbor_lists_aabb_reference(*case, max_neighbors=k)
    lo, hi = bk.with_margin(case[0], case[1])
    _, count_k = bk.cuda_idx_count(lo, hi, *case[2:], k)
    _, count_p = bk.plain_idx_count(lo, hi, *case[2:], k)
    torch.cuda.synchronize()
    assert torch.equal(nl_k.idx, nl_p.idx)
    assert torch.equal(nl_k.valid, nl_p.valid)
    assert torch.equal(count_k, count_p)
    assert torch.equal(nl_k.nbr_overflow, nl_p.nbr_overflow)
    return nl_k


@pytest.mark.parametrize("n", [1, 2, 31, 33, 1025, 3000])
@pytest.mark.parametrize("k", [1, 8, 40])
def test_random_cases_exact(device, n, k):
    _assert_kernel_equals_plain(_random_case(n, seed=n + k, device=device), k)


@pytest.mark.parametrize("side,layers", [(16, 8), (4, 6)])
def test_packed_pile_overflows_exactly(device, side, layers):
    case = _packed_case(side, layers, device)
    nl = _assert_kernel_equals_plain(case, 8)
    assert int(nl.nbr_overflow) > 0
    kept = bk.band_group_kept(*bk.with_margin(case[0], case[1]))
    if side == 4:        # 96 boxes: every band meets every group
        assert bool(kept.all())


@pytest.mark.parametrize("name", sorted(kernel_cases.broadphase_edge_cases()))
def test_broadphase_edge_cases_exact(device, name):
    """Touching boxes, NaN and infinite bounds, groups of non-solid or
    static rows, far clusters, n below a group or just above a band: idx,
    count and overflow equal, through the wrapper (margins applied) and on
    the raw boxes (touching exactly)."""
    case = [torch.as_tensor(a, device=device)
            for a in kernel_cases.broadphase_edge_cases()[name]]
    _assert_kernel_equals_plain(case, 8)
    idx_k, count_k = bk.cuda_idx_count(*case, 8)
    idx_p, count_p = bk.plain_idx_count(*case, 8)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(count_k, count_p)
    if name == "far_clusters":
        kept = bk.band_group_kept(*bk.with_margin(case[0], case[1]))
        assert float(kept.float().mean()) < 0.1


def test_kernel_counts_launches_and_rejects_bad_input(device):
    case = _random_case(64, seed=1, device=device)
    before = bk.KERNEL.launches
    bk.neighbor_lists_aabb(*case, max_neighbors=8)
    assert bk.KERNEL.launches == before + 1
    with pytest.raises(ValueError):
        bk.neighbor_lists_aabb(case[0], case[1], case[2].float(), *case[3:])


# ---- the box contact kernel -------------------------------------------------

CONTACT_NAMES = ("c_prt", "c_ptx", "c_pty", "c_ptz", "c_nx", "c_ny", "c_nz",
                 "c_dep", "c_valid", "overflow", "c_feat")


def _assert_contacts_equal_plain(case, budget=12):
    """The kernel's outputs (through ``box_contacts_t``, one launch a
    call) equal the plain version's bit for bit, with ``orig_id`` and
    without; returns the plain outputs with feature ids."""
    for with_feat in (False, True):
        args = list(case[:6])
        orig = case[6] if with_feat else None
        before = ck.KERNEL.launches
        got = contact_t.box_contacts_t(*args, budget=budget, orig_id=orig)
        assert ck.KERNEL.launches == before + 1
        want = contact_t.box_contacts_t_reference(*args, budget=budget,
                                                  orig_id=orig)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (11 if with_feat else 10)
        for name, w, g in zip(CONTACT_NAMES, want, got):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), name
    return want


@pytest.mark.parametrize("name", sorted(kernel_cases.box_contact_cases()))
def test_box_contact_cases_exact(device, name):
    """Random poses at K = 1, 7, 8, 16, 256, 257 and 299 (the last two on
    the wide kernel, one with its contacts in the second chunk) with
    -1-padded and invalid partners, a box resting flat on another (the SAT
    tie), parallel and crossing edges, pairs over the 4-point cap, a body
    over the budget and one under the ground: every output bit-equal to
    the plain version's."""
    case = [torch.as_tensor(a, device=device)
            for a in kernel_cases.box_contact_cases()[name]]
    out = _assert_contacts_equal_plain(case)
    valid, prt, feat = out[8], out[0], out[10]
    assert bool((valid & (prt >= 0)).any())
    if name == "overflow":
        assert int(out[9]) > 0
        for budget in (3, 40):
            _assert_contacts_equal_plain(case, budget)
    k = case[3].shape[1]
    if k > 256:                       # the wide kernel: every level, then
        for budget in (3, 4 * k + 100):   # the ground and unused rows
            _assert_contacts_equal_plain(case, budget)
    if name == "edges":               # slot 16 holds the edges' points
        assert bool((valid & (feat % 64 == 16)).any())


def test_box_contacts_sorted_scene_exact(device):
    """The falling boxes of tests/test_torch_contact_t.py (24, seed 7)
    stepped 120 times on the card, in Morton order with the broadphase
    kernel's lists, as the all-pairs route hands them over: once from
    contiguous rows, once from the rows of a packed [N, 16] tensor."""
    state, static = build_falling_boxes(24, seed=7, spread=2.5,
                                        device=device)
    step = make_step_fn(static)
    for _ in range(120):
        state, _ = step(state, InputFrame.zero(device))
    case = list(kernel_cases.sorted_contact_inputs(state, static))
    out = _assert_contacts_equal_plain(case)
    valid, prt = out[8], out[0]
    assert bool((valid & (prt >= 0)).any())
    assert bool((valid & (prt < 0)).any())
    n = case[0].shape[0]
    packed = torch.cat([torch.zeros(n, 2, device=device), *case[:3],
                        torch.zeros(n, 3, device=device)], dim=1)
    _assert_contacts_equal_plain(
        [packed[:, 2:5], packed[:, 5:9], packed[:, 9:12], *case[3:]])


def test_box_contacts_route_and_bad_input(device):
    """A mixed scene (``shape_type`` given) runs the plain version on the
    card; inputs the kernel does not take raise ValueError, an empty list
    (K = 0, which the plain version does not take either) among them."""
    case = [torch.as_tensor(a, device=device)
            for a in kernel_cases.box_contact_cases()["random_k8"]]
    before = ck.KERNEL.launches
    shape_type = torch.ones(case[0].shape[0], dtype=torch.int8,
                            device=device)
    mixed = contact_t.box_contacts_t(*case[:6], orig_id=case[6],
                                     shape_type=shape_type)
    plain = contact_t.box_contacts_t_reference(*case[:6], orig_id=case[6],
                                               shape_type=shape_type)
    assert ck.KERNEL.launches == before
    assert all(torch.equal(a, b) for a, b in zip(mixed, plain))
    bad = {0: case[0].double(), 1: case[1][:, :3], 3: case[3].long(),
           4: case[4].to(torch.uint8), 5: case[5][:-1]}
    for i, t in bad.items():
        args = list(case[:6])
        args[i] = t
        with pytest.raises(ValueError):
            contact_t.box_contacts_t(*args)
    with pytest.raises(ValueError):
        contact_t.box_contacts_t(*case[:6], orig_id=case[6].float())
    n = case[0].shape[0]
    empty = torch.zeros((n, 0), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="K=0"):
        contact_t.box_contacts_t(*case[:3], empty, empty >= 0, case[5])
    assert ck.KERNEL.launches == before


def test_flat_step_lists_longer_than_a_block(device):
    """The flat many-world step over worlds of 300 boxes lists 299
    partners a body, past a block of the kernel (its wide form): after 240
    steps (the boxes rain in a column 12 m wide) one more step equals the
    same step with the plain contacts bit for bit, pair contacts in its
    cache."""
    from banggameengine_tpu_torch.parallel import manyworld as mw

    state1, static1 = build_falling_boxes(300, seed=5, spread=6.0,
                                          device=device)
    run = mw.make_flat_many_world_step(static1, 2, state1.comp_mask,
                                       num_steps=240)
    one = mw.make_flat_many_world_step(static1, 2, state1.comp_mask)
    inp = mw.replicate_input(InputFrame.zero(device), 2)
    state = graphs.clone_tree(run(mw.replicate_state(state1, 2), inp))
    before = ck.KERNEL.launches
    with graphs.eager():
        got = one(state, inp)
    assert ck.KERNEL.launches == before + 1
    with kernel_cases.plain_twins("contacts"):
        want = one(state, inp)
    torch.cuda.synchronize()
    assert ck.KERNEL.launches == before + 1
    assert bool((got.contact_feat >= FEAT_STRIDE).any())
    for a, b in zip(graphs.flatten(got)[0], graphs.flatten(want)[0]):
        assert torch.equal(a, b)


# ---- the contact solve kernel -----------------------------------------------



def _solve_case(n, c, seed, device, ground_only=False):
    """(the 18 positional arguments of ``solve_contacts_t``, the warm
    planes) of ``kernel_cases.solve_contact_case`` on ``device``."""
    case = [torch.as_tensor(a, device=device) for a in
            kernel_cases.solve_contact_case(n, c, seed, ground_only)]
    return case[:18], tuple(case[18:])


def _solve_leaves(out):
    return list(out[:2]) + (list(out[2]) if len(out) == 3 else [])


def _assert_solve_equals_plain(args, want=None, **kw):
    """``solve_contacts_t`` on CUDA tensors (with the contact cache, as
    ``step._solve`` calls it, or without) launches kernel #9 once, and
    every output equals the plain version's (or ``want``) bit for bit (the
    sign of a zero included)."""
    cached = kw.get("cache") is not None
    before = sk.KERNEL.launches
    got = contact_t.solve_contacts_t(*args, **kw)
    assert sk.KERNEL.launches == before + 1
    if want is None:
        want = sk.solve_contacts_reference(*args, **kw)
    torch.cuda.synchronize()
    got, want = _solve_leaves(got), _solve_leaves(want)
    assert len(got) == len(want) == (
        4 if cached else 5 if kw.get("return_lambdas") else 2)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), i
    return want


@pytest.mark.parametrize("c,n", [(1, 5), (1, 3000), (12, 37), (12, 3000),
                                 (12, 9000)])
def test_solve_random_cases_exact(device, c, n):
    """Random bodies and slots (ground slots, invalid slots filled as the
    contact kernels fill them and left random, body 0's column all
    invalid, body 1's all valid): bit-equal to the plain version for 0, 1
    and 10 iterations, momentum 0 and 0.5, with and without warm
    impulses, with and without the impulses returned; on a slot a lane
    (up to 3,000 bodies) and two (9,000)."""
    args, warm = _solve_case(n, c, c + n, device)
    for iterations in (0, 1, 10):
        for momentum in (0.0, 0.5):
            for w in (None, warm):
                for lambdas in (False, True):
                    _assert_solve_equals_plain(
                        args, iterations=iterations, momentum=momentum,
                        warm=w, return_lambdas=lambdas)


@pytest.mark.parametrize("n", [37, 3000, 9000])
def test_solve_cache_exact(device, n):
    """With the contact cache (feature ids matched or not, strided views
    of the state's [N, CB] and [N, CB, 3] fields, as the routes hand them
    over): velocities and the refreshed cache bit-equal to the plain
    version's warm start, solve and refresh, for 0, 1 and 10 iterations,
    momentum 0 and 0.5."""
    args, _ = _solve_case(n, 12, n, device)
    c_feat, feat, imp = (torch.as_tensor(a, device=device) for a in
                         kernel_cases.solve_cache_case(n, 12, 12, n))
    cache = (c_feat, feat.T, imp.permute(1, 2, 0))
    for iterations in (0, 1, 10):
        for momentum in (0.0, 0.5):
            _assert_solve_equals_plain(args, iterations=iterations,
                                       momentum=momentum, cache=cache)


def test_solve_ground_only_and_budgets_exact(device):
    """Ground-only rows (every partner -1), and budgets past one chunk of
    the kernel (16 slots) and past its four accumulators' groups (C = 5,
    17, 40): bit-equal to the plain version."""
    args, warm = _solve_case(200, 12, 11, device, ground_only=True)
    for w in (None, warm):
        out = _assert_solve_equals_plain(args, iterations=10, momentum=0.5,
                                         warm=w, return_lambdas=True)
    assert float(out[2][0].abs().max()) > 0.0
    for c in (5, 17, 40):
        args, warm = _solve_case(300, c, c, device)
        _assert_solve_equals_plain(args, iterations=10, momentum=0.5,
                                   warm=warm, return_lambdas=True)


def test_solve_recorded_steps_exact(device):
    """The solve's inputs as the main path hands them over
    (``kernel_cases.recorded_inputs``): a step of 300 boxes settling on
    the all-pairs route after 240 steps (the contact cache in Morton
    order, the packed rows), and the flat many-world step at 4,096 worlds
    after 200 steps (the static route, 65,536 rows): bit-equal to the
    plain version, the refreshed cache included."""
    from banggameengine_tpu_torch.parallel import manyworld as mw

    state, static = build_falling_boxes(300, seed=5, spread=6.0,
                                        device=device)
    state = make_multi_step_fn(static, 240, broadphase="allpairs")(
        state, InputFrame.zero(device))
    step = make_step_fn(static, broadphase="allpairs")
    with kernel_cases.recorded_inputs("solve") as rec:
        step(state, InputFrame.zero(device))
    state1, static1 = build_falling_boxes(
        num_bodies=8, with_character=True, with_trigger=True, device=device)
    w = 4096
    zero = mw.replicate_input(InputFrame.zero(device), w)
    flat = mw.make_flat_many_world_step(static1, w, state1.comp_mask,
                                        num_steps=200)(
        mw.replicate_state(state1, w), zero)
    with kernel_cases.recorded_inputs("solve") as rec_flat:
        mw.make_flat_many_world_step(static1, w, state1.comp_mask)(flat,
                                                                   zero)
    calls = rec["solve"] + rec_flat["solve"]
    assert len(calls) == 2
    for i, args in enumerate(calls):
        args, kw = args[:18], dict(zip(
            ("iterations", "ground_friction", "warm", "return_lambdas",
             "momentum", "cache"), args[18:]))
        prt, valid = args[6], args[14]
        if i == 0:       # the pile: boxes on boxes (the flat worlds' 8
            assert bool((valid & (prt >= 0)).any())   # lie apart)
        assert bool((valid & (prt < 0)).any())
        assert kw["cache"] is not None and kw["momentum"] == 0.5
        feat, imp = _assert_solve_equals_plain(args, **kw)[2:]
        assert bool((feat >= 0).any()) and bool((imp[..., 0] > 0).any())


def test_solve_cache_repeated_ids_within_rounding(device):
    """Cached feature ids repeated within a body (the step keeps them
    unique, and only there is the kernel not bit-equal): a slot whose id
    matches m cached slots starts from the sum of their m impulses, which
    the kernel takes in slot order (four accumulators over the cached slot
    mod 4, then ((a0 + a1) + a2) + a3) and the plain version in its
    ``[C, CB, 3, N]`` product's order.  The kernel equals the plain solve
    started from the slot-order sum bit for bit, and that sum lies within
    the rounding of a sum of m terms of the plain one: two orders differ
    by at most 2 gamma(m - 1) sum |imp|, gamma(k) = k u / (1 - k u),
    u = 2^-24."""
    n = 3000
    args, _ = _solve_case(n, 12, 7, device)
    c_feat, feat, imp = (torch.as_tensor(a, device=device) for a in
                         kernel_cases.solve_cache_case(n, 12, 12, 7,
                                                       unique=False))
    cache = (c_feat, feat.T, imp.permute(1, 2, 0))
    eq = ((c_feat[:, None, :] == cache[1][None])
          & (c_feat >= 0)[:, None, :]).to(torch.float32)    # [C, CB, N]
    acc = [torch.zeros(12, 3, n, device=device) for _ in range(4)]
    for b in range(12):
        acc[b % 4] = acc[b % 4] + eq[:, b, None, :] * cache[2][b]
    in_order = ((acc[0] + acc[1]) + acc[2]) + acc[3]          # [C, 3, N]
    m = eq.sum(dim=1, dtype=torch.float64)[:, None, :]
    assert int(m.max()) >= 3
    u = 2.0 ** -24
    gamma = (m - 1).clamp_min(0) * u / (1 - (m - 1).clamp_min(0) * u)
    bound = 2 * gamma * (eq.double()[:, :, None, :]
                         * cache[2].double().abs()[None]).sum(dim=1)
    plain = sk.cached_warm_start(*cache)
    assert bool(((in_order.double() - plain.double()).abs()
                 <= bound).all())
    kw = dict(iterations=10, momentum=0.5)
    vel, ang, lams = contact_t.solve_contacts_t_reference(
        *args, warm=in_order.unbind(1), return_lambdas=True, **kw)
    _assert_solve_equals_plain(
        args, want=(vel, ang, sk.refreshed_cache(args[14], c_feat, lams)),
        cache=cache, **kw)


def test_solve_route_and_bad_input(device):
    """Inputs the kernel does not take raise ValueError before any launch:
    functorch-batched CUDA tensors (the kernel reads a tensor by pointer;
    the many-world steps hand it one plain world-major row set), a budget
    past ``MAX_C``, a wrong dtype, shape or device."""
    args, warm = _solve_case(40, 12, 3, device)
    kw = dict(iterations=3, momentum=0.5, return_lambdas=True)
    before = sk.KERNEL.launches
    batched = [torch.stack([a, a]) for a in (*args, *warm)]
    with pytest.raises(ValueError, match="functorch-batched"):
        torch.func.vmap(lambda *a: contact_t.solve_contacts_t(
            *a[:18], warm=a[18:], **kw))(*batched)
    with pytest.raises(ValueError, match="past MAX_C"):
        contact_t.solve_contacts_t(*_solve_case(40, sk.MAX_C + 1, 3,
                                                device)[0])
    bad = {0: args[0].double(), 3: args[3][:, :3], 6: args[6].long(),
           10: args[10][:-1], 14: args[14].to(torch.uint8),
           15: args[15].cpu(), 17: args[17][None]}
    for i, t in bad.items():
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            contact_t.solve_contacts_t(*a)
    with pytest.raises(ValueError):
        contact_t.solve_contacts_t(*args, warm=warm[:2])
    assert sk.KERNEL.launches == before


# ---- the unified solve kernel (the dense and jointed routes) ---------------


def _unified_case(n, c, seed, device, joints=0, mass_splitting=False):
    """``kernel_cases.unified_solve_case`` on ``device``, its joint set's
    effective masses split or not."""
    return kernel_cases.unified_solve_tensors(
        kernel_cases.unified_solve_case(n, c, seed, joints=joints), device,
        mass_splitting)


def _unified_leaves(out):
    v, w, lams, *rest = out
    leaves = [v, w, *lams]
    if rest:
        leaves += [rest[0].impulse, rest[0].limit_rows]
    return leaves


def _assert_unified_equals_plain(args, **kw):
    """``solve_unified`` on CUDA tensors launches kernel #10 (the set-ups
    and two launches a sweep with joints, the contacts' set-up and one a
    sweep without), and every output equals the plain twin's bit for bit
    (the sign of a zero included): the velocities, the contacts'
    impulses, the joints' impulses and the count of limit rows on, so the
    angles and the rows they switch on are the plain version's."""
    joints = kw.get("joints") is not None
    sweeps = max(int(kw.get("iterations", 10)), 0)
    before = uk.KERNEL.launches
    got = uk.solve_unified(*args, **kw)
    assert uk.KERNEL.launches == before + (
        2 + 2 * sweeps if joints else 1 + sweeps)
    want = uk.solve_unified_reference(*args, **kw)
    torch.cuda.synchronize()
    got, want = _unified_leaves(got), _unified_leaves(want)
    assert len(got) == len(want) == (7 if joints else 5)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), i
    return want


@pytest.mark.parametrize("n,joints", [(9, 0), (37, 0), (3000, 0), (9, 12),
                                      (300, 280), (3000, 2800),
                                      (12000, 11000)])
def test_unified_random_cases_exact(device, n, joints):
    """Random bodies and slots (ground slots, invalid slots filled as the
    compaction fills them and left random, body 0's row all invalid and
    body 1's all valid), a tenth of the bodies dead, and random hinges and
    cone-twists at random poses whose limit, swing and twist rows come out
    both on and off, bodies in up to ~9 joints: bit-equal to the plain twin
    for 0, 1 and 10 iterations, momentum 0.5 or 0 with over-relaxation 1
    or 1.3, warm-started from the contact cache or cold, the joints'
    effective masses split (mass splitting) or not; J = 0 takes the same
    kernels without the rows; a slot a lane (up to 3,000 bodies) and a
    thread a body (12,000)."""
    for mass_splitting in (False, True) if joints else (False,):
        case = _unified_case(n, 12, n + joints, device, joints,
                             mass_splitting)
        jkw = {} if not joints else dict(
            joints=case["joints"], joint_state=case["joint_state"],
            alive=case["alive"])
        assert not bool(case["alive"].all())
        for iterations in (0, 1, 10):
            for momentum, sor in ((0.5, 1.0), (0.0, 1.3)):
                for warm in ({}, {"cache": case["cache"]}):
                    want = _assert_unified_equals_plain(
                        case["args"], momentum=momentum,
                        iterations=iterations, sor=sor, **warm, **jkw)
        if joints:
            assert case["joints"].body_rows.shape[1] >= 4
            assert 0 < int(want[-1]) < 2 * joints


def test_unified_budgets_exact(device):
    """Budgets of 1, 5, 17 and 40 slots (one and three chunks of the
    kernels' 16 items, and past the four accumulators' groups), with
    joints: bit-equal to the plain twin."""
    for c in (1, 5, 17, uk.MAX_C):
        case = _unified_case(300, c, c, device, 250, mass_splitting=c > 9)
        _assert_unified_equals_plain(
            case["args"], momentum=0.5, iterations=10, cache=case["cache"],
            joints=case["joints"], joint_state=case["joint_state"],
            alive=case["alive"])


def test_unified_recorded_steps_exact(device):
    """The solves the main path hands the registry's kernel #10
    (``kernel_cases.recorded_inputs``): the ragdoll pile of the benchmark
    (136 ragdolls, the dense route, each side's split) at its start and
    after 60 steps, the benchmark's 4,096 Ant worlds on the flat step (the
    static route with joints, mass splitting, ground contacts only; 36,864
    bodies, so the sweeps take a thread a body) after 12 calls of random
    commands, and 300 boxes on the dense route (no joints): every output
    bit-equal to the plain twin's."""
    import json

    from banggameengine_tpu_torch.parallel.manyworld import (
        make_many_world_step)
    from banggameengine_tpu_torch.scene.ant import build_ant_worlds
    from banggameengine_tpu_torch.scene.ragdolls import build_ragdoll_pyramid

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kernel = kernel_cases.hand_kernels()["unified"]
    inp = InputFrame.zero(device)
    calls = []
    with open(os.path.join(root, "portbench", "configs",
                           "bullet-ragdolls136.json")) as f:
        sc = build_ragdoll_pyramid(json.load(f)["scene"], device=device)
    with graphs.eager():
        state, js = make_multi_step_fn(
            sc.static, 60, joints=sc.joints, broadphase="dense",
            max_neighbors=8)(sc.state, inp, jt.make_joint_state(sc.joints))
    one = make_multi_step_fn(sc.static, 1, joints=sc.joints,
                             broadphase="dense", max_neighbors=8)
    with kernel_cases.recorded_inputs("unified") as rec:
        one(sc.state, inp, jt.make_joint_state(sc.joints))
        one(state, inp, js)
    calls += rec["unified"]
    with open(os.path.join(root, "portbench", "configs",
                           "isaacgym-ant4k.json")) as f:
        cfg = json.load(f)
    w = cfg["scene"]["num_worlds"]
    aw = build_ant_worlds(cfg["scene"], cfg["physics"], num_worlds=w, seed=7,
                          device=device)
    gen = torch.Generator(device="cpu").manual_seed(3)
    with graphs.eager():
        step, _ = make_many_world_step(aw.static, None,
                                       aw.state.comp_mask[0], w, num_steps=2,
                                       joints=aw.joints, verbose=False)
        state, js = aw.state, jt.make_joint_state(aw.joints, w)
        for _ in range(12):
            u = torch.randn(w, 8, generator=gen).clamp(-1, 1).to(device)
            state, js = graphs.clone_tree(step(state, inp, js, u))
    with kernel_cases.recorded_inputs("unified") as rec:
        step(state, inp, js, torch.zeros(w, 8, device=device))
    calls += rec["unified"][:1]
    boxes, static = build_falling_boxes(300, seed=5, spread=6.0,
                                        device=device)
    with graphs.eager():
        boxes = make_multi_step_fn(static, 120, broadphase="dense")(boxes,
                                                                    inp)
    with kernel_cases.recorded_inputs("unified") as rec:
        make_multi_step_fn(static, 1, broadphase="dense")(boxes, inp)
    calls += rec["unified"]
    assert len(calls) == 4
    # the Ant's blocks of 32 bodies give every SM two or more: the narrow
    # set-up and the serial sweeps, the layout the benchmark runs
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert -(-calls[2][0].shape[0] // 32) >= 2 * sms
    names = list(inspect.signature(kernel.wrapper).parameters)[14:]
    for i, args in enumerate(calls):
        kw = dict(zip(names, args[14:]))
        assert kw["cache"] is not None and kw["momentum"] == 0.5
        assert (kw["joints"] is None) == (i == 3)
        if kw["joints"] is not None:
            assert kw["joints"].mass_splitting == (i == 2)
        want = _assert_unified_equals_plain(args[:14], **kw)
        if i < 3:
            assert 0 < int(want[-1]) < 2 * kw["joints"].num_joints


def test_unified_vmapped_over_worlds_exact(device):
    """A solve vmapped over worlds (the many-world steps' vmapped layout:
    the state's planes batched, the scene's not) takes the kernels once over
    every world's rows: bit-equal to the plain twin vmapped; a dt a world
    or joints under vmap raise ValueError before any launch."""
    cases = [_unified_case(700, 12, s, device) for s in range(3)]
    bodies = [torch.stack([c["args"][i] for c in cases]) for i in range(13)]
    bodies[4], bodies[6] = cases[0]["args"][4], cases[0]["args"][6]
    cache = [torch.stack([c["cache"][k] for c in cases]) for k in range(3)]
    dt = cases[0]["args"][13]
    in_dims = tuple(None if i in (4, 6) else 0 for i in range(13)) + (0,) * 3

    def call(solve):
        return lambda *a: solve(*a[:13], dt, 0.5, cache=a[13:])

    before = uk.KERNEL.launches
    got = torch.func.vmap(call(uk.solve_unified), in_dims=in_dims)(
        *bodies, *cache)
    assert uk.KERNEL.launches == before + 11
    want = torch.func.vmap(call(uk.solve_unified_reference),
                           in_dims=in_dims)(*bodies, *cache)
    torch.cuda.synchronize()
    for g, w in zip(_unified_leaves(got), _unified_leaves(want)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    with pytest.raises(ValueError, match="one step dt"):
        torch.func.vmap(lambda *a: uk.solve_unified(*a, 0.5)[0])(
            *bodies[:4], *[torch.stack([b, b, b]) for b in bodies[4:7]],
            *bodies[7:], dt.expand(3))
    case = _unified_case(40, 12, 3, device, 30)
    with pytest.raises(ValueError, match="no joints"):
        torch.func.vmap(lambda *a: uk.solve_unified(
            *a, case["args"][13], 0.5, joints=case["joints"],
            joint_state=case["joint_state"], alive=case["alive"])[0])(
            *[torch.stack([a, a]) for a in case["args"][:13]])
    assert uk.KERNEL.launches == before + 11


def test_unified_route_and_bad_input(device):
    """Inputs the kernels do not take raise ValueError before any launch:
    a budget past ``MAX_C``, a wrong dtype, shape or device, a joint table
    that does not match its bodies."""
    case = _unified_case(40, 12, 3, device, 30)
    args = case["args"]
    jkw = dict(joints=case["joints"], joint_state=case["joint_state"],
               alive=case["alive"])
    before = uk.KERNEL.launches
    with pytest.raises(ValueError, match="past MAX_C"):
        uk.solve_unified(*_unified_case(40, uk.MAX_C + 1, 3,
                                        device)["args"], 0.5)
    bad = {0: args[0].double(), 3: args[3][:, :3], 8: args[8].long(),
           10: args[10][:-1], 12: args[12].to(torch.uint8),
           6: args[6].cpu(), 13: args[13][None]}
    for i, t in bad.items():
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            uk.solve_unified(*a, 0.5, **jkw)
    with pytest.raises(ValueError, match="alive must be"):
        uk.solve_unified(*args, 0.5, **dict(jkw, alive=case["alive"][1:]))
    assert uk.KERNEL.launches == before


def test_graph_replays_count_unified_launches(device):
    """Kernel #10's launches counted through the graphs: a jointed step
    holds 22 (the rows' and the contacts' set-ups, two a sweep), on the
    dense route (3 ragdolls, 3 steps a call) and the flat step's static
    route with joints (8 Ant worlds, 2 steps a call): the capture's eager
    warm-up counts one step apart, each replay its steps; the box routes
    (all pairs, and the flat step without joints) launch it never."""
    import json

    from banggameengine_tpu_torch.parallel import manyworld as mw
    from banggameengine_tpu_torch.scene.ant import build_ant_worlds
    from banggameengine_tpu_torch.scene.ragdolls import build_ragdoll_pyramid

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kernel = kernel_cases.hand_kernels()["unified"]
    inp = InputFrame.zero(device)
    with open(os.path.join(root, "portbench", "configs",
                           "bullet-ragdolls136.json")) as f:
        sc = build_ragdoll_pyramid(dict(json.load(f)["scene"], size=2),
                                   device=device)
    with open(os.path.join(root, "portbench", "configs",
                           "isaacgym-ant4k.json")) as f:
        cfg = json.load(f)
    aw = build_ant_worlds(cfg["scene"], cfg["physics"], num_worlds=8,
                          seed=7, device=device)
    ragdolls = make_multi_step_fn(sc.static, 3, joints=sc.joints,
                                  broadphase="dense", max_neighbors=8)
    ants, layout = mw.make_many_world_step(
        aw.static, None, aw.state.comp_mask[0], 8, num_steps=2,
        joints=aw.joints, verbose=False)
    assert layout == "flat"
    boxes, static = build_falling_boxes(64, seed=0, device=device)
    box_run = make_multi_step_fn(static, 3, broadphase="allpairs")
    state1, static1 = build_falling_boxes(
        num_bodies=8, with_character=True, with_trigger=True, device=device)
    rollout = mw.make_flat_many_world_step(static1, 4, state1.comp_mask,
                                           num_steps=2)
    graphs.warmup_launches.clear()
    kernel.launches = 0
    box_run(boxes, inp)
    rollout(mw.replicate_state(state1, 4), mw.replicate_input(inp, 4))
    torch.cuda.synchronize()
    assert kernel.launches == 0 and graphs.warmup_launches["unified"] == 0
    js = jt.make_joint_state(sc.joints)
    for call in range(2):
        graphs.clone_tree(ragdolls(sc.state, inp, js))
        torch.cuda.synchronize()
        assert graphs.warmup_launches["unified"] == 22
        assert kernel.launches == 22 + 3 * 22 * (call + 1)
    assert ragdolls.program.captures == 1
    kernel.launches = 0
    graphs.warmup_launches.clear()
    u = torch.zeros(8, 8, device=device)
    for call in range(2):
        ants(aw.state, inp, jt.make_joint_state(aw.joints, 8), u)
        torch.cuda.synchronize()
        assert graphs.warmup_launches["unified"] == 22
        assert kernel.launches == 22 + 2 * 22 * (call + 1)
    kernel.launches = 0
    with graphs.eager():
        ragdolls(sc.state, inp, js)
    assert kernel.launches == 3 * 22


# ---- the render kernels: the visibility walk and the attribute resolve ----


def _walk_case(n_tiles, k_pad, seed, tiles_x, device):
    """Random triangles over each tile, counts from -1 to k_pad + 3 (the
    kernel clamps them), rows past the count marked unused."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(-1, k_pad + 4, n_tiles).astype(np.int32)
    shape = (n_tiles, k_pad)
    ox = (np.arange(n_tiles) % tiles_x)[:, None] * 128.0
    oy = (np.arange(n_tiles) // tiles_x)[:, None] * 32.0
    pack = np.zeros(shape + (rwk.PACK_CH,), np.float32)
    pack[..., 0:3] = (ox + rng.uniform(-10, 138, shape))[..., None] + \
        rng.uniform(-60, 60, shape + (3,))
    pack[..., 3:6] = (oy + rng.uniform(-10, 42, shape))[..., None] + \
        rng.uniform(-30, 30, shape + (3,))
    pack[..., 6:9] = rng.uniform(-0.2, 1.2, shape + (3,))
    pack[..., 9] = np.arange(k_pad)[None, :] < counts[:, None]
    pack[:, ::7, 9] = 0.0                       # some unused rows inside
    return (torch.as_tensor(counts, device=device),
            torch.as_tensor(pack, device=device))


@pytest.mark.parametrize("n_tiles,k_pad,tiles_x",
                         [(1, 8, 1), (11, 272, 4), (37, 13, 15),
                          (510, 272, 15)])
def test_walk_equals_plain(device, n_tiles, k_pad, tiles_x):
    counts, pack = _walk_case(n_tiles, k_pad, n_tiles + k_pad, tiles_x,
                              device)
    before = rwk.KERNEL.launches
    dep_k, slot_k = rwk.raster_walk(counts, pack, tiles_x)
    assert rwk.KERNEL.launches == before + 1
    dep_p, slot_p = rwk.raster_walk_reference(counts, pack, tiles_x)
    torch.cuda.synchronize()
    assert torch.equal(slot_k, slot_p)
    assert torch.equal(dep_k, dep_p)
    assert bool((slot_k >= 0).any())


def test_compare_kernels_builds_the_other_trees_library(device):
    """compare_kernels on this tree as the other: the other walk wrapper
    builds and loads a library of its own and gives the same output."""
    from banggameengine_tpu_torch.scripts import compare_kernels as ck

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = ck.other_module(root, rwk.__name__)
    counts, pack = _walk_case(37, 272, 5, 15, device)
    dep_o, slot_o = other.cuda_raster_walk(counts, pack, 15)
    dep_t, slot_t = rwk.cuda_raster_walk(counts, pack, 15)
    torch.cuda.synchronize()
    assert torch.equal(slot_o, slot_t) and torch.equal(dep_o, dep_t)
    assert other.load_kernel_library()._name != rwk.load_kernel_library()._name
    assert other.KERNEL.launches == 1


def test_walk_edge_case_equals_plain(device):
    """Zero-area rows, corners on pixel centres, slivers, huge triangles,
    ties, counts 0, 1 and 272 over 13 tiles."""
    counts, pack = (torch.as_tensor(a, device=device)
                    for a in kernel_cases.walk_edge_case())
    dep_k, slot_k = rwk.raster_walk(counts, pack, 5)
    dep_p, slot_p = rwk.raster_walk_reference(counts, pack, 5)
    torch.cuda.synchronize()
    assert torch.equal(slot_k, slot_p)
    assert torch.equal(dep_k, dep_p)
    r, c = kernel_cases.WALK_LINE_PIXEL
    assert int(slot_k[kernel_cases.WALK_LINE_TILE, r * 128 + c]) == 0


@pytest.mark.parametrize("n_tiles,c,kl", [(1, 1, 1), (10, 40, 272),
                                          (510, 40, 272), (3, 7, 130)])
def test_resolve_equals_plain(device, n_tiles, c, kl):
    rng = np.random.default_rng(n_tiles + c)
    slot = rng.integers(-1, kl + 40, (n_tiles, 4096)).astype(np.int32)
    slot[0] = -1                                   # an all-sky tile
    table = rng.standard_normal((n_tiles, c, kl)).astype(np.float32)
    slot_t = torch.as_tensor(slot, device=device)
    table_t = torch.as_tensor(table, device=device)
    before = rsv.KERNEL.launches
    out_k = rsv.resolve_tiles_wide(slot_t, table_t)
    assert rsv.KERNEL.launches == before + 1
    out_p = rsv.resolve_tiles_wide_reference(slot_t, table_t)
    torch.cuda.synchronize()
    assert out_k.shape == (c, n_tiles, 4096)
    assert torch.equal(out_k, out_p)


def test_render_kernels_reject_bad_input(device):
    counts, pack = _walk_case(2, 8, 0, 2, device)
    with pytest.raises(ValueError):
        rwk.raster_walk(counts.long(), pack, 2)
    with pytest.raises(ValueError):
        rsv.resolve_tiles_wide(torch.zeros((2, 4096), dtype=torch.int32,
                                           device=device),
                               torch.zeros((3, 4, 5), device=device))


@pytest.mark.parametrize("shade_mode,raster_backend",
                         [("tiled", "walk"), ("fused", "walk"),
                          ("flat", "tile")])
def test_showcase_frame_kernels_equal_plain(device, shade_mode,
                                            raster_backend):
    sc = build_showcase_render(0)
    rs = convert.render_scene_from_numpy(sc.render)
    w, h = 640, 360
    args = (torch.as_tensor(sc.world, device=device),
            sc.camera.view_matrix(), sc.camera.proj_matrix(w / h),
            torch.as_tensor(sc.camera.position, device=device))
    render = make_render_fn(rs, w, h, return_depth=True,
                            shade_mode=shade_mode,
                            raster_backend=raster_backend)
    frame_k, depth_k = render(*args)
    with kernel_cases.plain_twins():   # eager: the graph holds the kernels
        frame_p, depth_p = render(*args)
    torch.cuda.synchronize()
    assert frame_k.shape == (h, w, 4) and frame_k.dtype == torch.uint8
    assert torch.equal(frame_k, frame_p)
    assert torch.equal(depth_k, depth_p)


# ---- the route kernels: the fused walk + resolve, the full-carry raster ----


@pytest.mark.parametrize("n_tiles,k_pad,kl,c",
                         [(1, 8, 8, 1), (11, 272, 260, 40),
                          (510, 272, 272, 40), (37, 13, 13, 7)])
@pytest.mark.parametrize("with_tables", [True, False])
def test_raster_resolve_equals_plain(device, n_tiles, k_pad, kl, c,
                                     with_tables):
    counts, pack = _walk_case(n_tiles, k_pad, n_tiles + kl, 15, device)
    rng = np.random.default_rng(c)
    table = (torch.as_tensor(rng.standard_normal(
        (n_tiles, c, kl)).astype(np.float32), device=device)
        if with_tables else None)
    before = rr.KERNEL.launches
    dep_k, slot_k, res_k = rr.raster_resolve_tiles(counts, pack, table, 15)
    assert rr.KERNEL.launches == before + 1
    dep_p, slot_p, res_p = rr.raster_resolve_tiles_reference(counts, pack,
                                                             table, 15)
    dep_w, slot_w = rwk.raster_walk(counts, pack, 15)
    torch.cuda.synchronize()
    assert torch.equal(slot_k, slot_p) and torch.equal(dep_k, dep_p)
    assert torch.equal(slot_k, slot_w) and torch.equal(dep_k, dep_w)
    if with_tables:
        assert torch.equal(res_k, res_p)
        assert torch.equal(res_k, rsv.resolve_tiles_wide(slot_w, table))
    else:
        assert res_k is None


@pytest.mark.parametrize("with_tables", [True, False])
def test_raster_resolve_edge_case_equals_plain(device, with_tables):
    """The walk's edge rows through the fused kernel, which skips slots
    by the same cover boxes: depth and slot equal to the plain version and
    to the walk kernel, the zero-area line keeps its pixel outside its
    box; the planes equal to the plain version and the resolve kernel."""
    counts, pack = (torch.as_tensor(a, device=device)
                    for a in kernel_cases.walk_edge_case())
    rng = np.random.default_rng(3)
    table = (torch.as_tensor(rng.standard_normal(
        (pack.shape[0], 40, pack.shape[1])).astype(np.float32),
        device=device) if with_tables else None)
    dep_k, slot_k, res_k = rr.raster_resolve_tiles(counts, pack, table, 5)
    dep_p, slot_p, res_p = rr.raster_resolve_tiles_reference(counts, pack,
                                                             table, 5)
    dep_w, slot_w = rwk.raster_walk(counts, pack, 5)
    torch.cuda.synchronize()
    assert torch.equal(slot_k, slot_p) and torch.equal(dep_k, dep_p)
    assert torch.equal(slot_k, slot_w) and torch.equal(dep_k, dep_w)
    r, c = kernel_cases.WALK_LINE_PIXEL
    assert int(slot_k[kernel_cases.WALK_LINE_TILE, r * 128 + c]) == 0
    if with_tables:
        assert torch.equal(res_k, res_p)
        assert torch.equal(res_k, rsv.resolve_tiles_wide(slot_w, table))
    else:
        assert res_k is None


def test_raster_resolve_wide_table_equals_plain(device):
    """A table of 8,000 channels (more than a block's shared memory could
    stage) resolves equal to the plain version: the kernel reads the
    winners' entries from the table itself."""
    counts, pack = _walk_case(2, 8, 0, 2, device)
    counts = counts.clamp(0, 8)
    pack[..., 9] = 1.0
    table = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 8000, 8)).astype(np.float32), device=device)
    dep_k, slot_k, res_k = rr.raster_resolve_tiles(counts, pack, table, 2)
    dep_p, slot_p, res_p = rr.raster_resolve_tiles_reference(counts, pack,
                                                             table, 2)
    torch.cuda.synchronize()
    assert torch.equal(slot_k, slot_p) and torch.equal(dep_k, dep_p)
    assert res_k.shape == (8000, 2, 4096) and torch.equal(res_k, res_p)
    assert bool((slot_k >= 0).any())


def _tile_kernel_case(n, k, tiles_x, seed, device):
    """Random triangles over n listed tiles (a random subset of a
    tiles_x-wide grid), ok = 0 on some rows, random ids and corners."""
    rng = np.random.default_rng(seed)
    _, pack = _walk_case(n, k, seed, tiles_x, torch.device("cpu"))
    tile_idx = rng.permutation(max(n, 2 * tiles_x))[:n].astype(np.int32)
    shift_x = (tile_idx % tiles_x - np.arange(n) % tiles_x) * 128.0
    shift_y = (tile_idx // tiles_x - np.arange(n) // tiles_x) * 32.0
    pack = pack.numpy()
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    f32 = np.float32
    return (t(tile_idx),
            t((pack[..., 0:3] + shift_x[:, None, None]).astype(f32)),
            t((pack[..., 3:6] + shift_y[:, None, None]).astype(f32)),
            t(pack[..., 6:9]),
            t(rng.integers(0, 10**6, (n, k)).astype(np.int32)),
            t(rng.uniform(0, 1, (n, k, 3)).astype(np.float32)),
            t(rng.uniform(0, 1, (n, k, 3)).astype(np.float32)),
            t(pack[..., 9].astype(np.int32)), tiles_x)


@pytest.mark.parametrize("n,k,tiles_x", [(1, 8, 1), (64, 272, 15),
                                         (510, 64, 15), (9, 13, 5)])
def test_raster_tiles_equals_plain(device, n, k, tiles_x):
    *args, tx = _tile_kernel_case(n, k, tiles_x, n + k, device)
    before = rt.KERNEL.launches
    out_k = rt.raster_tiles(*args, tx)
    assert rt.KERNEL.launches == before + 1
    out_p = rt.raster_tiles_reference(*args, tx)
    torch.cuda.synchronize()
    for name, a, b in zip(("depth", "tri", "b1", "b2", "slot"), out_k,
                          out_p):
        assert torch.equal(a, b), name
    assert bool((out_k[4] >= 0).any())


def test_raster_tiles_edge_case_equals_plain(device):
    """The walk's edge rows as full-carry arguments over 13 tiles listed in
    a shuffled order: all five planes equal to the plain version, depth
    and slot to the walk kernel's on the same rows, and the zero-area
    line keeps its pixel outside its box."""
    *args, tiles_x = (torch.as_tensor(a, device=device) if i < 8 else a
                      for i, a in enumerate(kernel_cases.tile_edge_case()))
    out_k = rt.raster_tiles(*args, tiles_x)
    out_p = rt.raster_tiles_reference(*args, tiles_x)
    counts, pack = (torch.as_tensor(a, device=device)
                    for a in kernel_cases.walk_edge_case())
    dep_w, slot_w = rwk.raster_walk(counts, pack, tiles_x)
    torch.cuda.synchronize()
    for name, a, b in zip(("depth", "tri", "b1", "b2", "slot"), out_k,
                          out_p):
        assert torch.equal(a, b), name
    order = args[0].long()
    assert torch.equal(out_k[4].flatten(1), slot_w[order])
    assert torch.equal(out_k[0].flatten(1), dep_w[order])
    item = int((args[0] == kernel_cases.WALK_LINE_TILE).nonzero()[0, 0])
    r, c = kernel_cases.WALK_LINE_PIXEL
    assert int(out_k[4][item, r, c]) == 0


def test_route_kernels_reject_bad_input(device):
    counts, pack = _walk_case(2, 8, 0, 2, device)
    with pytest.raises(ValueError):
        rr.raster_resolve_tiles(counts, pack,
                                torch.zeros((3, 4, 5), device=device), 2)
    *args, tx = _tile_kernel_case(3, 8, 2, 0, device)
    with pytest.raises(ValueError):
        rt.raster_tiles(args[0].long(), *args[1:], tx)
    with pytest.raises(ValueError):
        rt.raster_tiles(*args[:7], args[7].float(), tx)


# ---- the u8 row gather of the shade-parts probe ---------------------------


@pytest.mark.parametrize("r,w,p,offset", [(1, 16, 1, 0), (300, 16, 1024, 0),
                                          (12345, 16, 100_003, 0),
                                          (999, 16, 4097, 1),
                                          (1001, 7, 4099, 0),
                                          (257, 33, 513, 3)])
def test_gather_rows_equals_plain(device, r, w, p, offset):
    """Indices below -R, at the ends and beyond R; 16-byte rows on an
    aligned and an unaligned table, and other widths (the byte loop)."""
    rng = np.random.default_rng(r + p)
    base = torch.as_tensor(rng.integers(0, 256, r * w + offset).astype(
        np.uint8), device=device)
    table = base[offset:].view(r, w)
    idx = rng.integers(-r - 7, r + 4, p).astype(np.int32)
    idx[:min(p, 8)] = (-r - 7, -r - 1, -r, -1, 0, r - 1, r, r + 3)[:p]
    idx = torch.as_tensor(idx, device=device)
    before = gr.KERNEL.launches
    out_k = gr.gather_rows_u8(table, idx)
    out_p = gr.gather_rows_u8_reference(table, idx)
    torch.cuda.synchronize()
    assert gr.KERNEL.launches == before + 1
    assert torch.equal(out_k, out_p)
    in_range = idx[(idx >= 0) & (idx < r)]
    if in_range.numel():
        assert torch.equal(gr.gather_rows_u8(table, in_range),
                           torch.index_select(table, 0, in_range))


def test_gather_rows_rejects_bad_input(device):
    table = torch.zeros((4, 16), dtype=torch.uint8, device=device)
    idx = torch.zeros(8, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        gr.gather_rows_u8(table.float(), idx)
    with pytest.raises(ValueError):
        gr.gather_rows_u8(table, idx.long())
    with pytest.raises(ValueError):
        gr.gather_rows_u8(table, idx.cpu())


# ---- the captured programs (graphs.py) ------------------------------------


def test_graph_replays_count_kernel_launches(device):
    """A frame's graph and a stress multi-step's graph (the broadphase,
    the box contact and the contact solve kernels once a step): after the
    capture (whose eager warm-up launches each kernel once, counted apart
    in ``graphs.warmup_launches``) every replay adds the launches its
    graph holds to the kernels' counts, as many as the eager route
    launches; the outputs bit-equal to the eager route's.  The static
    route (the flat many-world step) launches the box contact and solve
    kernels once a step too; the dense route neither, but kernel #10's
    set-up and 10 sweeps (11 launches a step, no joints)."""
    sc = build_showcase_render(0)
    rs = convert.render_scene_from_numpy(sc.render)
    w, h = 640, 360
    args = (torch.as_tensor(sc.world, device=device),
            sc.camera.view_matrix(), sc.camera.proj_matrix(w / h),
            torch.as_tensor(sc.camera.position, device=device))
    render = make_render_fn(rs, w, h, return_depth=True)
    state, static = build_falling_boxes(64, seed=0, device=device)
    run = make_multi_step_fn(static, 5, broadphase="allpairs")
    inp = InputFrame.zero(device)
    kernels = kernel_cases.hand_kernels()

    def launches():
        return {k: v.launches for k, v in kernels.items() if v.launches}

    graphs.warmup_launches.clear()
    for kernel in kernels.values():
        kernel.launches = 0
    frame_g = render(*args)
    state_g = graphs.clone_tree(run(state, inp))
    torch.cuda.synchronize()
    assert {k: n for k, n in graphs.warmup_launches.items() if n} == {
        "broadphase": 1, "contacts": 1, "solve": 1, "walk": 1, "resolve": 1}
    assert launches() == {"walk": 2, "resolve": 2, "broadphase": 6,
                          "contacts": 6, "solve": 6}
    for _ in range(3):
        render(*args)
        run(state, inp)
    torch.cuda.synchronize()
    assert launches() == {"walk": 5, "resolve": 5, "broadphase": 21,
                          "contacts": 21, "solve": 21}
    assert render.program.captures == run.program.captures == 1
    for kernel in kernels.values():
        kernel.launches = 0
    with graphs.eager():
        frame_e = render(*args)
        state_e = run(state, inp)
    torch.cuda.synchronize()
    assert launches() == {"walk": 1, "resolve": 1, "broadphase": 5,
                          "contacts": 5, "solve": 5}
    for a, b in zip(graphs.flatten((frame_g, state_g))[0],
                    graphs.flatten((frame_e, state_e))[0]):
        assert torch.equal(a, b)

    from banggameengine_tpu_torch.parallel import manyworld as mw

    state1, static1 = build_falling_boxes(
        num_bodies=8, with_character=True, with_trigger=True, device=device)
    flat = mw.make_flat_many_world_step(static1, 4, state1.comp_mask,
                                        num_steps=3)
    dense = make_multi_step_fn(static, 3, broadphase="dense")
    graphs.warmup_launches.clear()
    for kernel in kernels.values():
        kernel.launches = 0
    flat(mw.replicate_state(state1, 4), mw.replicate_input(inp, 4))
    dense(state, inp)
    torch.cuda.synchronize()
    assert {k: n for k, n in graphs.warmup_launches.items() if n} == {
        "contacts": 1, "solve": 1, "unified": 11}
    assert launches() == {"contacts": 4, "solve": 4, "unified": 44}


def test_failed_capture_raises(device):
    """A host read inside a program breaks its capture: the call raises,
    nothing runs eagerly in its place, nothing is cached, and the card
    takes work again."""
    program = graphs.Program(lambda x: x * float(x.sum()), name="host_read")
    x = torch.ones(8, device=device)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            program(x)
    assert program.captures == 0
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 16.0


def test_span_markers_replayed_in_order(device):
    """The stage markers (``utils/csrc/spans.cu``) are nodes of the
    captured graphs: a trace of replays shows each stage's entry marker
    and ``bge_span_end`` in order, step by step and frame by frame."""
    from banggameengine_tpu_torch.utils import profiling

    state, static = build_falling_boxes(64, seed=0, device=device)
    run = make_multi_step_fn(static, 2, broadphase="allpairs")
    inp = InputFrame.zero(device)
    sc = build_showcase_render(0)
    rs = convert.render_scene_from_numpy(sc.render, device)
    w, h = 320, 180
    render = make_render_fn(rs, w, h)
    args = (torch.as_tensor(sc.world, device=device),
            sc.camera.view_matrix(device),
            sc.camera.proj_matrix(w / h, device),
            torch.as_tensor(sc.camera.position, device=device))
    state = run(state, inp)
    render(*args)
    torch.cuda.synchronize()
    replays = graphs.stats["replays"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(state, inp)
        render(*args)
        torch.cuda.synchronize()
    assert graphs.stats["replays"] == replays + 3       # 2 steps, 1 frame
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("bge_span_")
             and e.device_type == torch.autograd.DeviceType.CUDA]
    # the masks and gravity, then the sort, gather and kernel #1
    step = ["physics.broadphase", "physics.broadphase",
            "physics.narrowphase", "physics.solver", "physics.integrate",
            "ecs.transforms"]
    want = [n for s in step * 2 + ["render.raster", "render.shade"]
            for n in (profiling.marker_kernel(s), "bge_span_end")]
    assert names == want
