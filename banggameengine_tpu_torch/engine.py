"""Engine step: physics, then the world-matrix refresh.

Counterpart of ``banggameengine_tpu/engine.py``: :func:`engine_step`,
:func:`visual_positions` and the step factories :func:`make_step_fn` and
:func:`make_multi_step_fn`.  The JAX package jits its steps and scans the
multi-step; here the steps run eagerly, and :func:`make_multi_step_fn` is a
Python loop of ``num_steps`` steps inside one call.  Nothing in a step
synchronises with the host, so the card runs ahead of the Python loop.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from banggameengine_tpu_torch.ecs.transform import (
    scatter_rows,
    update_world_matrices,
)
from banggameengine_tpu_torch.physics.step import physics_step, scene_census
from banggameengine_tpu_torch.state import (
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


def make_step_fn(
    static: StaticScene,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], tuple[WorldState, StepEvents]]:
    """A single-world step bound to the static scene.  The host-side scene
    census (dead-stage skipping) runs here, once."""
    return functools.partial(
        engine_step, static=static, solver_iterations=solver_iterations,
        **{**scene_census(static), **physics_kwargs})


def make_multi_step_fn(
    static: StaticScene,
    num_steps: int,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], WorldState]:
    """``num_steps`` fixed steps with constant input in one call; returns
    the final state only (per-step events are dropped)."""
    step = make_step_fn(static, solver_iterations, **physics_kwargs)

    def run(state: WorldState, inp: InputFrame) -> WorldState:
        for _ in range(num_steps):
            state, _events = step(state, inp)
        return state

    return run
