"""Physics: the stress route (all-pairs broadphase) and the static route
(build-time neighbor lists) of the tick, box contacts, the Jacobi solver,
the planar character step, triggers, and the broadphase's CUDA kernel
under ``csrc/``."""
