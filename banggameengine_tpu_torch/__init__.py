"""banggameengine_tpu_torch — the engine's physics tick in PyTorch and CUDA.

A port of the JAX package ``banggameengine_tpu`` to PyTorch on NVIDIA
Hopper.  It imports ``torch`` and never ``jax`` or ``banggameengine_tpu``:
the host-side modules it needs (physics config, hierarchy levels, the
procedural scene builder) are copied, because the JAX package imports
``jax`` on any import of any of its modules.

The slice ported so far is the single-world stress tick
(``engine.make_multi_step_fn(static, n, broadphase="allpairs")``): the
Morton-sorted all-pairs AABB broadphase (a CUDA kernel,
``physics/csrc/neighbor_lists.cu``), the transposed box contact pipeline,
the warm-started Jacobi solver, integration, trigger diffing and the world
matrices.  Module paths mirror the JAX package's.

Float32 matrix products must stay in full f32 (the warm-start match and
one-hot moves carry payload rows): the port never enables TF32.
"""

__version__ = "0.1.0"

from banggameengine_tpu_torch.state import (  # noqa: F401
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
)
