"""The PyTorch port's all-pairs broadphase against the JAX package's Pallas
kernel (interpret mode on the CPU).  Everything here is integer or a pure
selection, so every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu.physics import shapes as jax_shapes
from banggameengine_tpu.physics.broadphase_pallas import (
    morton_key_xz as jax_morton_key_xz,
    neighbor_lists_pallas_aabb,
)
from banggameengine_tpu.scene.synthetic import (
    build_falling_boxes as jax_build_falling_boxes,
)
from banggameengine_tpu_torch import kernel_cases
from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.physics import shapes
from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes


def _stress_positions(n=10_000):
    state, _ = jax_build_falling_boxes(n, seed=0)
    return np.array(state.pos)


@pytest.mark.parametrize("case", ["stress10k", "wide", "tiny"])
def test_morton_key_exact(case):
    rng = np.random.default_rng(1)
    pos = {
        "stress10k": lambda: _stress_positions(),
        # beyond the 15-bit clamp on x, negative coordinates on z
        "wide": lambda: (rng.standard_normal((500, 3)) * [9000.0, 1.0, 50.0]
                         ).astype(np.float32),
        "tiny": lambda: rng.uniform(-1, 1, (3, 3)).astype(np.float32),
    }[case]()
    want = np.asarray(jax_morton_key_xz(jnp.asarray(pos)))
    got = bk.morton_key_xz(torch.as_tensor(pos)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_stable_argsort_matches_jax_on_tied_keys():
    keys = np.array(jax_morton_key_xz(jnp.asarray(_stress_positions())))
    assert np.unique(keys).size < keys.size      # the stress scene has ties
    want = np.asarray(jnp.argsort(jnp.asarray(keys)))
    got = torch.argsort(torch.as_tensor(keys), stable=True).numpy()
    np.testing.assert_array_equal(got, want)


def _random_case(n, seed):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    half = rng.uniform(0.1, 0.8, (n, 3)).astype(np.float32)
    dyn = rng.choice(np.array([-1, 0, 1], np.int32), n, p=[0.1, 0.3, 0.6])
    layer = rng.integers(0, 4, n).astype(np.int32)
    mask = np.where(rng.random(n) < 0.5, -1,
                    rng.integers(0, 4, n)).astype(np.int32)
    return center - half, center + half, dyn, layer, mask


def _pile_case():
    """The saturated 96-box pile of tests/test_stress_edge.py, in Morton
    order as the stress step feeds it."""
    state, static = jax_build_falling_boxes(96, seed=4, spread=1.5)
    pos = np.array([(x * 0.98, 0.49 + y * 0.98, z * 0.98)
                    for y in range(6) for x in range(4) for z in range(4)],
                   np.float32)
    quat = np.tile(np.float32([0, 0, 0, 1]), (96, 1))
    state = dataclasses.replace(state, pos=jnp.asarray(pos),
                                quat=jnp.asarray(quat))
    order = np.asarray(jnp.argsort(jax_morton_key_xz(state.pos)))
    mn, mx = jax_shapes.shape_aabb(state.pos, state.quat, static.shape_type,
                                   static.shape_size)
    dyn = np.ones(96, np.int32)
    layer = np.asarray(static.layer).view(np.int32)
    mask = np.asarray(static.mask).view(np.int32)
    return (np.asarray(mn)[order], np.asarray(mx)[order], dyn[order],
            layer[order], mask[order])


@pytest.mark.parametrize("case", ["n37", "n300", "n1100", "pile96"])
def test_neighbor_lists_match_pallas_exactly(case):
    if case == "pile96":
        args = _pile_case()
    else:
        n = int(case[1:])
        args = _random_case(n, seed=n)
    want = neighbor_lists_pallas_aabb(*map(jnp.asarray, args),
                                      max_neighbors=8, interpret=True)
    got = bk.neighbor_lists_aabb(*map(torch.as_tensor, args),
                                 max_neighbors=8)
    for name in ("idx", "valid", "nbr_overflow", "cell_overflow"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if case in ("n1100", "pile96"):
        assert int(want.nbr_overflow) > 0        # K = 8 saturated


def test_reference_equals_wrapper_on_cpu():
    args = [torch.as_tensor(a) for a in _random_case(200, seed=9)]
    a = bk.neighbor_lists_aabb(*args, max_neighbors=3)
    b = bk.neighbor_lists_aabb_reference(*args, max_neighbors=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_more_slots_than_bodies_pads_with_minus_one():
    args = [torch.as_tensor(a) for a in _random_case(5, seed=2)]
    nl = bk.neighbor_lists_aabb(*args, max_neighbors=8)
    assert nl.idx.shape == (5, 8)
    assert (nl.idx[:, 4:] == -1).all()
    assert int(nl.nbr_overflow) == 0


def test_other_devices_raise():
    args = [torch.as_tensor(a).to("meta") for a in _random_case(4, seed=3)]
    with pytest.raises(NotImplementedError, match="no kernel"):
        bk.neighbor_lists_aabb(*args)


# ---- block-AABB pruning: the kernel skips (band, group) pairs whose union
# boxes do not meet; these hold its plain helpers to that argument ----


def _passing_pairs(lo, hi, dyn, layer, mask):
    """bool[N, N]: the plain all-pairs filter, margins already applied."""
    n = lo.shape[0]
    ov = ~torch.eye(n, dtype=torch.bool)
    for ax in range(3):
        ov &= (lo[:, None, ax] <= hi[None, :, ax]) & (lo[None, :, ax]
                                                     <= hi[:, None, ax])
    rd, cd = dyn[:, None], dyn[None, :]
    ov &= (rd >= 0) & (cd >= 0) & ((rd > 0) | (cd > 0))
    return ov & ((layer[:, None] & mask[None, :]) != 0) & (
        (layer[None, :] & mask[:, None]) != 0)


def _assert_pruning_keeps_every_pair(lo, hi, dyn, layer, mask):
    """Every passing pair lies in a (band, group) pair the band test keeps
    and in a (row, group) pair the row test keeps; returns the kept
    share of (band, group) pairs."""
    ov = _passing_pairs(lo, hi, dyn, layer, mask)
    i, j = torch.nonzero(ov, as_tuple=True)
    kept = bk.band_group_kept(lo, hi)
    assert bool(kept[i // bk.BAND_ROWS, j // bk.GROUP_COLS].all())
    glo, ghi = bk.block_bounds(lo, hi, bk.GROUP_COLS)
    g = j // bk.GROUP_COLS
    assert bool(((lo[i] <= ghi[g]) & (glo[g] <= hi[i])).all())
    # the plain filter agrees with the plain neighbor lists' counts
    _, count = bk.plain_idx_count(lo, hi, dyn, layer, mask, 8)
    assert torch.equal(count, ov.sum(1, dtype=torch.int32))
    return float(kept.float().mean())


def _stress_inputs(n):
    """The stress scene's broadphase inputs at N bodies, Morton-sorted and
    margins applied, as the physics step feeds the kernel."""
    state, static = build_falling_boxes(n, seed=0, device="cpu")
    order = torch.argsort(bk.morton_key_xz(state.pos), stable=True)
    mn, mx = shapes.shape_aabb(state.pos, state.quat, static.shape_type,
                               static.shape_size)
    lo, hi = bk.with_margin(mn[order], mx[order])
    dyn = torch.ones(n, dtype=torch.int32)
    return lo, hi, dyn, static.layer[order], static.mask[order]


def test_block_union_pruning_keeps_every_pair():
    lo, hi, dyn, layer, mask = _stress_inputs(2000)
    share = _assert_pruning_keeps_every_pair(lo, hi, dyn, layer, mask)
    assert share < 0.5, share            # Morton order lets most go
    # NaN rows change nothing: they leave the unions, pass with no one,
    # and every other list is what it is with those rows not solid
    nan_rows = torch.tensor([5, 40, 41, 700, 1999])
    lo_n, hi_n = lo.clone(), hi.clone()
    lo_n[5, 0] = hi_n[40, 1] = float("nan")
    lo_n[41:42] = hi_n[700:701] = hi_n[1999:] = float("nan")
    _assert_pruning_keeps_every_pair(lo_n, hi_n, dyn, layer, mask)
    for group in (bk.GROUP_COLS, bk.BAND_ROWS):
        blo, bhi = bk.block_bounds(lo_n, hi_n, group)
        for b in range(blo.shape[0]):
            rows = slice(b * group, (b + 1) * group)
            np.testing.assert_array_equal(blo[b].numpy(), np.fmin.reduce(
                lo_n[rows].numpy(), axis=0, initial=np.inf))
            np.testing.assert_array_equal(bhi[b].numpy(), np.fmax.reduce(
                hi_n[rows].numpy(), axis=0, initial=-np.inf))
    idx_n, count_n = bk.plain_idx_count(lo_n, hi_n, dyn, layer, mask, 8)
    off = dyn.clone()
    off[nan_rows] = -1
    idx_o, count_o = bk.plain_idx_count(lo, hi, off, layer, mask, 8)
    assert torch.equal(idx_n, idx_o) and torch.equal(count_n, count_o)
    assert int(count_n[nan_rows].sum()) == 0


@pytest.mark.parametrize("case", sorted(kernel_cases.broadphase_edge_cases()))
def test_union_pruning_edge_cases(case):
    """The edge cases of the card tests and chip_smoke.py: the pruning
    keeps every pair, and the port agrees with the Pallas kernel except
    where the Pallas kernel's unions take a NaN (see the next test)."""
    args = kernel_cases.broadphase_edge_cases()[case]
    t = [torch.as_tensor(a) for a in args]
    share = _assert_pruning_keeps_every_pair(*bk.with_margin(t[0], t[1]),
                                             *t[2:])
    _assert_pruning_keeps_every_pair(*t)     # touching exactly, no margin
    if case == "far_clusters":
        assert share < 0.1, share
    if case != "nan_inf":
        want = neighbor_lists_pallas_aabb(*map(jnp.asarray, args),
                                          max_neighbors=8, interpret=True)
        got = bk.neighbor_lists_aabb(*t, max_neighbors=8)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        assert int(got.nbr_overflow) == int(want.nbr_overflow)


def test_nan_bound_drops_its_block_in_the_pallas_kernel():
    """The Pallas kernel's 128-body block unions take a NaN bound as it is
    (``jnp.min``), and a NaN union fails every test: one NaN body drops
    every pair of its block.  The port leaves NaN bounds out of its
    unions, so it gives what the Pallas kernel gives when the NaN bodies
    are moved far away and made not solid."""
    args = kernel_cases.broadphase_edge_cases()["nan_inf"]
    got = bk.neighbor_lists_aabb(*map(torch.as_tensor, args),
                                 max_neighbors=8)
    want = neighbor_lists_pallas_aabb(*map(jnp.asarray, args),
                                      max_neighbors=8, interpret=True)
    assert int(got.nbr_overflow) > int(want.nbr_overflow)
    mn, mx, dyn, layer, mask = (a.copy() for a in args)
    bad = np.isnan(mn).any(1) | np.isnan(mx).any(1)
    mn[bad], mx[bad], dyn[bad] = 1e6, 1e6 + 1, -1
    fixed = neighbor_lists_pallas_aabb(
        *map(jnp.asarray, (mn, mx, dyn, layer, mask)), max_neighbors=8,
        interpret=True)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(fixed.idx))
    assert int(got.nbr_overflow) == int(fixed.nbr_overflow)
