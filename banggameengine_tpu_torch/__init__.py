"""banggameengine_tpu_torch — the engine's physics tick in PyTorch and CUDA.

A port of the JAX package ``banggameengine_tpu`` to PyTorch on NVIDIA
Hopper.  It imports ``torch`` and never ``jax`` or ``banggameengine_tpu``:
the host-side modules it needs (physics config, hierarchy levels, the
procedural scene builder) are copied, because the JAX package imports
``jax`` on any import of any of its modules.

The physics slices ported so far are the default single-world route
(``engine.make_step_fn(static)``, ``broadphase="dense"``, as in the JAX
package: all-pairs AABB neighbor lists, the narrowphase manifolds of
boxes and capsules, the unified solver, the character step against
every entity, shape or AABB triggers, kinematic bodies; the demo world
``scene.synthetic.build_demo_like``), the single-world stress tick
(``engine.make_multi_step_fn(static, n, broadphase="allpairs")``: the
Morton-sorted all-pairs AABB broadphase as a CUDA kernel,
``physics/csrc/neighbor_lists.cu``) and the flat many-world step
(``parallel.make_flat_many_world_step``: neighbor lists fixed at build
time, the planar character step), the last two on the transposed box
contact pipeline; all with the warm-started Jacobi solver, integration,
trigger diffing and the world matrices.  The render slices live in
``render/``.  The application shell (``app.Application``: scene files
through ``scene.build_scene``, the fixed-step loop on the default path
and the fused tick, input, the orbit camera, trigger events, raycasts,
the interpolated frame; ``scripts.play_demo`` drives it headless) runs
them together, with its debug views (the line pass of the F1 wireframe
and the F3 physics overlay, the HUD), run-time scene editing
(``ecs.lifecycle``), checkpoints and the checked step (``utils``).
``parallel`` adds the vmapped many-world step, its router and the
sharded modes over ``torch.distributed``; ``native`` the C++ OBJ loader
and window presenter; ``app.window`` the windowed backends.  Module
paths mirror the JAX package's.

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
