"""The benchmark's plain reference.

A frozen copy of the port's plain PyTorch code, taken from
``banggameengine_tpu_torch`` at commit ``ee4b4ae`` (the port's last
``bring_up`` change): the state types, ``math3d``, the transform
hierarchy, the engine step and every physics module it runs, and the
frame pipeline's tiled route.  The copy keeps no kernel and no captured
program: every hand kernel's call runs its plain version, on any device,
and every call runs eagerly.  A later change to the port is held to this
copy, so the copy is not edited with the port.

Nothing here imports ``jax``, the JAX package or the port
(``portbench/tests`` scans the imports).  :mod:`.scene` packs the box
world's render arrays from the scene's own sizes, as the port's
``build_box_render`` and ``pack_render_scene`` do, without the edges that
only the wireframe reads.
"""
