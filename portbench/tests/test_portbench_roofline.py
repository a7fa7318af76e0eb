"""The rooflines' work counts: the frozen copies in
``portbench/harness/roofline.py`` give the numbers of the functions they
were copied from (``chip_smoke.py``'s ``broadphase_bound``,
``walk_bound`` and ``resolve_bound``) on the kernels' edge cases, and a
case small enough to count by hand."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from portbench.harness import roofline
from portbench.tests import tiny

REPO = os.path.dirname(tiny.HERE)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_broadphase_bound_matches_chip_smoke(smoke):
    from banggameengine_tpu_torch.kernel_cases import broadphase_edge_cases

    for name, (mn, mx, *_) in broadphase_edge_cases().items():
        mn, mx = torch.as_tensor(mn), torch.as_tensor(mx)
        ours = roofline.broadphase_bound(mn, mx, 8)
        theirs, _ = smoke.broadphase_bound(mn, mx)
        assert ours == pytest.approx(theirs, rel=1e-12), name


def test_broadphase_bound_by_hand():
    """64 boxes at one point: one band, two groups, both kept; every
    count by hand."""
    mn = torch.zeros((64, 3))
    mx = torch.ones((64, 3))
    ops = 30 * 64 + 11 * 2 + 25 * 2 * 64 * 32
    n_bytes = 36 * 64 + 4 * 9 * 64
    want = max(ops / 67e12, n_bytes / 3.35e12) * 1e3
    assert roofline.broadphase_bound(mn, mx, 8) == pytest.approx(want)
    # the recorded stress count (PERF.md's kernel table), by its own
    # arithmetic: 2,662 of 49,141 pairs kept at N = 10,000 is 137.13 M
    # operations, 0.0020 ms
    ops = 30 * 10_000 + 11 * 49_141 + 25 * 2_662 * 64 * 32
    assert roofline.bound_ms(0, ops) == pytest.approx(0.0020468, rel=1e-4)


def test_walk_bound_matches_chip_smoke(smoke):
    from banggameengine_tpu_torch.kernel_cases import walk_edge_case

    for seed in (0, 1):
        counts, pack = walk_edge_case(seed=seed)
        counts, pack = torch.as_tensor(counts), torch.as_tensor(pack)
        ours = roofline.walk_bound(counts, pack, 5)
        theirs, _ = smoke.walk_bound(counts, pack, 5)
        assert ours == pytest.approx(theirs, rel=1e-12)
    counts, pack, tiles_x = smoke.random_walk_case(7, 40, 3, 3, "cpu")
    assert roofline.walk_bound(counts, pack, tiles_x) == pytest.approx(
        smoke.walk_bound(counts, pack, tiles_x)[0], rel=1e-12)


def test_resolve_bound_matches_chip_smoke(smoke):
    slot, table = smoke.random_resolve_case(6, 40, 272, 5, "cpu")
    ours = roofline.resolve_bound(slot, table)
    n = 6 * 4096
    want = (4 * n + 4 * 6 * 40 * 272 + 4 * 40 * n) / 3.35e12 * 1e3
    assert ours == pytest.approx(want)
    assert ours == pytest.approx(smoke.resolve_bound(slot, table)[0])


def test_walk_skip_share_all_kept_where_one_triangle_covers_all():
    """One triangle far larger than the tile: no warp skips it."""
    pack = torch.zeros((1, 1, 16))
    pack[0, 0, 0:3] = torch.tensor([-1e4, 1e4, -1e4])
    pack[0, 0, 3:6] = torch.tensor([-1e4, -1e4, 1e4])
    pack[0, 0, 9] = 1.0
    counts = torch.ones(1, dtype=torch.int32)
    assert roofline.walk_skip_share(counts, pack, 1) == 0.0
    assert np.isfinite(roofline.walk_bound(counts, pack, 1))


def test_broadphase_work_counts_each_step(tmp_path):
    """Kernel #1's work in a traced call is counted from each of its
    steps' own AABBs: one count a step, the first from the state the call
    started from."""
    from portbench.harness import readers, registry
    from portbench.reference.physics import broadphase_kernel as bk
    from portbench.reference.physics import shapes

    torch.set_num_threads(1)
    root, _ = tiny.make_root(str(tmp_path))
    cell = registry.load_cell(root, "boxes3k.settled", 5, "cpu")
    drv = registry.driver_class(root, cell.driver)(cell)
    drv.setup()
    drv.tracing = True
    for i in range(2):
        drv.call(i)
    bounds = readers.broadphase_work({"driver": drv})
    assert len(bounds) == 2 * drv.steps_per_call
    s, st = drv.traced_pre[0], drv.ref_static
    order = bk.morton_key_xz(s.pos).argsort(stable=True)
    mn, mx = shapes.shape_aabb(s.pos, s.quat, st.shape_type, st.shape_size)
    assert bounds[0] == roofline.broadphase_bound(mn[order], mx[order], 8)
    assert bk.neighbor_lists_aabb.__name__ == "neighbor_lists_aabb"
