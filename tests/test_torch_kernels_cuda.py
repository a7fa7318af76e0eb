"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (sm_90a) and ``nvcc``; without a card every test skips.
Imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.physics import shapes
from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes

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
    state, static = build_falling_boxes(n, seed=0, device=device)
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


def test_packed_pile_overflows_exactly(device):
    nl = _assert_kernel_equals_plain(_packed_case(16, 8, device), 8)
    assert int(nl.nbr_overflow) > 0


def test_kernel_counts_launches_and_rejects_bad_input(device):
    case = _random_case(64, seed=1, device=device)
    before = bk.neighbor_lists_aabb.launches
    bk.neighbor_lists_aabb(*case, max_neighbors=8)
    assert bk.neighbor_lists_aabb.launches == before + 1
    with pytest.raises(ValueError):
        bk.neighbor_lists_aabb(case[0], case[1], case[2].float(), *case[3:])
