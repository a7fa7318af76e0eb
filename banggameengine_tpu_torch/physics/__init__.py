"""Physics: the stress route of the tick (all-pairs broadphase, box contacts,
Jacobi solver, triggers) and its CUDA kernel under ``csrc/``."""
