"""The kernel comparison script's loading of another tree's wrappers, on the
CPU: each wrapper module comes from the other tree's file, its kernel
would build its library under a name of its own, never this tree's, and
stays out of the registry that ``graphs.py`` counts."""

import os
import shutil

import numpy as np
import pytest
import torch

from banggameengine_tpu_torch import cuda_build, kernel_cases
from banggameengine_tpu_torch.physics import broadphase_kernel as bk
from banggameengine_tpu_torch.scripts import compare_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = kernel_cases.hand_kernels()


def _copy_module(name, root):
    rel = os.path.join(*name.split(".")) + ".py"
    dst = os.path.join(root, rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(os.path.join(ROOT, rel), dst)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_other_module_comes_from_the_other_tree(kernel, tmp_path,
                                                monkeypatch):
    """The other tree's wrapper module builds its own library, under an
    ``other_`` name, from its own source, and leaves the registry as it
    was."""
    this = KERNELS[kernel]
    name = this.wrapper.__module__
    _copy_module(name, str(tmp_path))
    registry = dict(cuda_build.KERNELS)
    mod = ck.other_module(str(tmp_path), name)
    assert cuda_build.KERNELS == registry
    assert all(cuda_build.KERNELS[k] is v for k, v in registry.items())
    assert os.path.dirname(mod.__file__).startswith(str(tmp_path))
    other = mod.KERNEL
    assert other is not this and other.key == this.key
    assert other.source.startswith(str(tmp_path))
    assert other.name == "other_" + this.name
    assert other.symbols == this.symbols and other.flags == this.flags
    wrapper = getattr(mod, this.wrapper.__name__)
    assert callable(wrapper) and wrapper is not this.wrapper
    assert other.wrapper is wrapper
    built = []
    monkeypatch.setattr(cuda_build, "load_library",
                        lambda lib, source, flags=(): built.append(
                            (lib, source, tuple(flags))))
    with pytest.raises(AttributeError):   # the stand-in loads no library
        other.load()
    assert built == [(other.name, other.source, this.flags)]


def test_other_module_runs_with_this_trees_helpers(tmp_path):
    """The other tree's broadphase wrapper on CPU tensors (its plain
    version) gives this tree's lists."""
    name = KERNELS["broadphase"].wrapper.__module__
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
    assert other.KERNEL.launches == 0


def test_other_module_needs_the_registry(tmp_path):
    """A wrapper module that makes no hand kernel (a tree older than the
    registry) is refused: its library would build under this tree's
    name."""
    path = tmp_path / "banggameengine_tpu_torch" / "render" / "resolve.py"
    path.parent.mkdir(parents=True)
    path.write_text("def resolve_tiles_wide(slot, table):\n    pass\n")
    with pytest.raises(RuntimeError, match="older than the registry"):
        ck.other_module(str(tmp_path),
                        "banggameengine_tpu_torch.render.resolve")


def test_outputs_are_compared_leaf_by_leaf():
    x, y = torch.arange(4), torch.zeros(2)
    assert ck._equal([(x, None)], [(x.clone(), None)])
    assert not ck._equal([(x, None)], [(x, y)])
    assert not ck._equal([(x, y)], [(x, y + 1)])
    assert not ck._equal([x], [x, x])
