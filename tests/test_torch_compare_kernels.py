"""The kernel comparison script's loading of another tree's wrappers, on the
CPU: each wrapper module comes from the other tree's file, and its library
would be built under a name of its own, never this tree's."""

import os
import shutil

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import cuda_build
from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.scripts import compare_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _copy_module(name, root):
    rel = os.path.join(*name.split(".")) + ".py"
    dst = os.path.join(root, rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(os.path.join(ROOT, rel), dst)


@pytest.mark.parametrize("kernel", sorted(ck.KERNELS))
def test_other_module_comes_from_the_other_tree(kernel, tmp_path,
                                                monkeypatch):
    name, launcher = ck.KERNELS[kernel]
    _copy_module(name, str(tmp_path))
    mod = ck.other_module(str(tmp_path), name)
    assert os.path.dirname(mod.__file__).startswith(str(tmp_path))
    assert mod._SOURCE.startswith(str(tmp_path))
    assert callable(getattr(mod, launcher))
    this = __import__(name, fromlist=[launcher])
    assert getattr(mod, launcher) is not getattr(this, launcher)
    built = []
    monkeypatch.setattr(cuda_build, "load_library",
                        lambda lib, source, flags=(): built.append(
                            (lib, source, tuple(flags))))
    mod.cuda_build.load_library("bge_x", mod._SOURCE, ("--fmad=false",))
    assert built == [("other_bge_x", mod._SOURCE, ("--fmad=false",))]


def test_other_module_runs_with_this_trees_helpers(tmp_path):
    """The other tree's broadphase wrapper on CPU tensors (its plain
    version) gives this tree's lists."""
    name = ck.KERNELS["broadphase"][0]
    _copy_module(name, str(tmp_path))
    other = ck.other_module(str(tmp_path), name)
    rng = np.random.default_rng(0)
    c = rng.uniform(-3, 3, (70, 3)).astype(np.float32)
    h = rng.uniform(0.1, 0.8, (70, 3)).astype(np.float32)
    args = [torch.as_tensor(a) for a in (
        c - h, c + h, rng.integers(-1, 2, 70).astype(np.int32),
        np.ones(70, np.int32), np.full(70, -1, np.int32))]
    a = other.neighbor_lists_aabb(*args, max_neighbors=8)
    b = bk.neighbor_lists_aabb(*args, max_neighbors=8)
    assert torch.equal(a.idx, b.idx)
    assert torch.equal(a.nbr_overflow, b.nbr_overflow)
    assert other.neighbor_lists_aabb.launches == 0


def test_outputs_are_compared_leaf_by_leaf():
    x, y = torch.arange(4), torch.zeros(2)
    assert ck._equal([(x, None)], [(x.clone(), None)])
    assert not ck._equal([(x, None)], [(x, y)])
    assert not ck._equal([(x, y)], [(x, y + 1)])
    assert not ck._equal([x], [x, x])
