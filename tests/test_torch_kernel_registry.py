"""The registry of the hand kernels (``cuda_build.KERNELS``) on the CPU:
what the wrapper modules enter into it, the launch counts that
``graphs.py`` keeps through it, and the tools' routes over it
(``kernel_cases.recorded_inputs`` and ``kernel_cases.plain_twins``).
The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import collections
import importlib
import os
import sys

import torch

from banggameengine_tpu_torch import cuda_build, graphs, kernel_cases
from banggameengine_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the wrapper module of each hand kernel, by the registry's key
WRAPPER_MODULES = {
    "broadphase": "banggameengine_tpu_torch.physics.broadphase_kernel",
    "contacts": "banggameengine_tpu_torch.physics.contacts_kernel",
    "solve": "banggameengine_tpu_torch.physics.solve_kernel",
    "unified": "banggameengine_tpu_torch.physics.unified_kernel",
    "walk": "banggameengine_tpu_torch.render.raster_walk",
    "resolve": "banggameengine_tpu_torch.render.resolve",
    "fused": "banggameengine_tpu_torch.render.raster_resolve",
    "tile": "banggameengine_tpu_torch.render.raster_tile",
    "gather": "banggameengine_tpu_torch.scripts.gather_rows",
}


def test_wrapper_modules_register_the_seven_kernels():
    """Importing the wrapper modules enters exactly the nine hand kernels,
    each with its wrapper, a plain twin, its source and the TPU kernel it
    stands for (a ``def`` of the JAX repository; none for the box contacts,
    the contact solve and the unified solve, which XLA fuses or the JAX
    package does not have); the span markers stay out."""
    for name in WRAPPER_MODULES.values():
        importlib.import_module(name)
    kernels = cuda_build.KERNELS
    assert sorted(kernels) == sorted(WRAPPER_MODULES)
    assert kernel_cases.hand_kernels() is kernels
    for key, k in kernels.items():
        mod = sys.modules[WRAPPER_MODULES[key]]
        assert k.key == key and mod.KERNEL is k
        assert mod.load_kernel_library == k.load
        assert k.wrapper.__module__ == mod.__name__
        assert getattr(mod, k.wrapper.__name__) is k.wrapper
        assert callable(k.plain) and k.plain is not k.wrapper
        assert k.name.startswith("bge_") and os.path.isfile(k.source)
        if key in ("contacts", "solve", "unified"):
            assert k.replaces is None
            continue
        path, line = k.replaces.rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            text = f.read().splitlines()[int(line) - 1].strip()
        assert text.startswith("def ") and "kernel" in text, k.replaces
    assert not isinstance(profiling.SPAN_LIBRARY, cuda_build.HandKernel)
    assert profiling.SPAN_LIBRARY.name not in {k.name
                                               for k in kernels.values()}


class _CardLikeGraph:
    """A stand-in for the CUDA graph class: a capture runs the body once,
    a replay runs no Python, so only the launches a graph holds reach the
    counts, as on the card."""

    def capture(self, body, stream, inputs):
        return body()

    def replay(self):
        pass


def test_replays_add_held_launches(monkeypatch):
    """A program whose body launches a registered kernel once: its
    capture's eager warm-up counts in ``warmup_launches``, the capture
    itself adds nothing, and each replay adds the launch its graph holds;
    a kernel defined outside the package is not entered by itself."""
    def body(x):
        kernel.launches += 1            # what a launch does to the count
        return (x + 1,)

    kernel = cuda_build.HandKernel("test", "bge_test", "test.cu", [],
                                   wrapper=body, plain=body, replaces=None)
    assert "test" not in cuda_build.KERNELS
    assert kernel.name == "other_bge_test"
    monkeypatch.setitem(cuda_build.KERNELS, "test", kernel)
    monkeypatch.setattr(graphs, "cpu_graph_class", _CardLikeGraph)
    monkeypatch.setattr(graphs, "warmup_launches", collections.Counter())
    others = {k: v.launches for k, v in cuda_build.KERNELS.items()
              if k != "test"}
    once = graphs.Program(lambda x: body(x)[0], name="once")
    x = torch.zeros(3)
    for _ in range(3):
        once(x)
    assert kernel.launches == 1 + 3
    assert graphs.warmup_launches == {"test": 1}
    steps = graphs.Program(body, donate=True, name="steps")
    steps(x, times=5)
    steps(x, times=5)
    assert kernel.launches == 4 + 1 + 10
    assert graphs.warmup_launches == {"test": 2}
    assert once.captures == steps.captures == 1
    with graphs.eager():
        steps(x, times=2)
    assert kernel.launches == 15 + 2
    assert {k: v.launches for k, v in cuda_build.KERNELS.items()
            if k != "test"} == others


def test_recorded_inputs_and_plain_twins_swap_the_wrappers():
    """A step's broadphase call is recorded with its positional
    arguments, defaults filled in, and the same call routes to the plain
    twin; both run eagerly and put the wrappers back."""
    from banggameengine_tpu_torch.engine import make_step_fn
    from banggameengine_tpu_torch.physics import broadphase_kernel as bk
    from banggameengine_tpu_torch.scene.synthetic import build_falling_boxes
    from banggameengine_tpu_torch.state import InputFrame

    state, static = build_falling_boxes(6, seed=1, device="cpu")
    step = make_step_fn(static, broadphase="allpairs", max_neighbors=4)
    inp = InputFrame.zero("cpu")
    wrapper = bk.neighbor_lists_aabb
    with kernel_cases.recorded_inputs("broadphase") as rec:
        assert graphs.is_eager()
        want, _ = step(state, inp)
    assert bk.neighbor_lists_aabb is wrapper
    (args,) = rec["broadphase"]
    assert len(args) == 6 and args[5] == 4
    assert torch.equal(wrapper(*args).idx,
                       bk.neighbor_lists_aabb_reference(*args).idx)
    called = []

    def plain(*a, **kw):
        called.append(a)
        return bk.neighbor_lists_aabb_reference(*a, **kw)

    kernel = cuda_build.KERNELS["broadphase"]
    saved, kernel.plain = kernel.plain, plain
    try:
        with kernel_cases.plain_twins("broadphase"):
            assert bk.neighbor_lists_aabb is plain
            got, _ = step(state, inp)
    finally:
        kernel.plain = saved
    assert bk.neighbor_lists_aabb is wrapper and len(called) == 1
    for a, b in zip(graphs.flatten(got)[0], graphs.flatten(want)[0]):
        assert torch.equal(a, b)
