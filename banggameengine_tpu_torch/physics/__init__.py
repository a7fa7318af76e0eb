"""Physics: the dense route (the default: all-pairs AABB neighbor lists,
narrowphase manifolds, the unified solver), the stress route (the
all-pairs broadphase kernel) and the static route (build-time neighbor
lists) of the tick, the transposed box contacts and Jacobi solver, the
planar character step, triggers, kinematic bodies, raycasts and the
global facade (``raycast``, ``api``), and the broadphase's CUDA kernel
under ``csrc/``."""
