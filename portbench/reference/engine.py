"""Engine step: physics, then the world-matrix refresh.

Frozen copy of the port's ``engine.py`` :func:`engine_step` and
:func:`visual_positions`, run eagerly: the benchmark's plain reference
steps with it, and no captured program or kernel is involved.
"""

from __future__ import annotations

import torch

from portbench.reference.ecs.transform import (
    scatter_rows,
    update_world_matrices,
)
from portbench.reference.physics.step import physics_step
from portbench.reference.state import (
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
    tree_replace,
)


def visual_positions(state: WorldState, static: StaticScene) -> torch.Tensor:
    """Transform positions as the reference scene sees them: a character's
    capsule center sits ``half_height + radius`` above its Transform (the
    reference's visual offset), every other entity is unchanged."""
    offset = static.char_half_height + static.char_radius  # [C]
    ce = static.char_entity
    shifted = state.pos[ce.clamp_min(0).to(torch.int64)].clone()
    shifted[:, 1] = shifted[:, 1] - offset
    return scatter_rows(state.pos, ce, shifted)


def engine_step(
    state: WorldState,
    inp: InputFrame,
    static: StaticScene,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> tuple[WorldState, StepEvents]:
    """One fixed simulation step: physics then world-matrix refresh.
    ``physics_kwargs`` go to :func:`physics_step`."""
    state, events = physics_step(state, inp, static, solver_iterations,
                                 **physics_kwargs)
    world = update_world_matrices(
        visual_positions(state, static), state.quat, state.scale,
        static.parent, static.level_nodes, state.alive,
    )
    return tree_replace(state, world=world), events
