"""Tools of the port, counterparts of the JAX repository's ``scripts/``
and ``examples/``: the shade-parts probe (:mod:`.profile_shade_parts`,
with its u8 row gather :mod:`.gather_rows` as a CUDA kernel), the frame
stage timer (:mod:`.profile_render`), the op-level trace summary
(:mod:`.trace_summary`), the kernel comparison with another tree
(:mod:`.compare_kernels`) and the headless demo (:mod:`.play_demo`).
Each runs as ``python3 -m banggameengine_tpu_torch.scripts.<name>``, on
the card by default and on the CPU with ``--device cpu`` (the measurement
tools with ``--small``)."""
