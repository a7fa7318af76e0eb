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
from banggameengine_tpu_torch.physics import broadphase_kernel as bk


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
