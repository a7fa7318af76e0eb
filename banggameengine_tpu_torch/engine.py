"""Engine step: physics, then the world-matrix refresh.

Counterpart of ``banggameengine_tpu/engine.py``: :func:`engine_step`,
:func:`visual_positions`, :func:`interpolated_world` and the step
factories :func:`make_step_fn`,
:func:`make_hot_reloadable_step_fn`, :func:`make_multi_step_fn` and
:func:`make_step_fn_with_events`.  The JAX package jits its steps and scans
the multi-steps; here the steps run eagerly, and a multi-step is a Python
loop of ``num_steps`` steps inside one call.  Nothing in a step
synchronises with the host, so the card runs ahead of the Python loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from banggameengine_tpu_torch import math3d
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


def interpolated_world(prev_state: WorldState, state: WorldState, alpha,
                       static: StaticScene) -> torch.Tensor:
    """World matrices f32[N, 4, 4] at a fraction ``alpha`` in [0, 1] of the
    way from ``prev_state`` to ``state``, two consecutive fixed steps: the
    reference renders Bullet's motion states interpolated by the
    accumulator's remainder.  Positions lerp, rotations nlerp, and the
    matrices are rebuilt with the characters' visual offsets.  ``alpha``
    is a float or an f32 0-d tensor (one staged on the device keeps the
    host out of the frame)."""
    pos = prev_state.pos + (state.pos - prev_state.pos) * alpha
    quat = math3d.quat_nlerp(prev_state.quat, state.quat, alpha)
    interp = tree_replace(state, pos=pos, quat=quat)
    return update_world_matrices(
        visual_positions(interp, static), quat, state.scale,
        static.parent, static.level_nodes, state.alive,
    )


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


def make_hot_reloadable_step_fn(
    solver_iterations: int = 10,
) -> Callable[[WorldState, InputFrame, StaticScene],
              tuple[WorldState, StepEvents]]:
    """A step that takes the static scene as an argument of each call, so
    a config hot reload (the reference's mtime-polled ``physics.json``
    reload, ``PhysicsSystem.cpp:216-324``) passes a rebuilt scene.  No
    census is read from a scene that may change, so every stage runs, as
    in the JAX package's traced-scene step: the character sweep, the
    capsule slots and the trigger sweep (on the default route, the same
    result as a step that skips them where they are dead)."""
    return functools.partial(
        engine_step, solver_iterations=solver_iterations,
        any_char=True, enable_capsule=True, any_trig=True)


def stack_events(events: list[StepEvents]) -> StepEvents:
    """Per-step events stacked on a new leading [num_steps] axis."""
    return StepEvents(**{
        f.name: torch.stack([getattr(e, f.name) for e in events])
        for f in dataclasses.fields(StepEvents)})


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


def make_step_fn_with_events(
    static: StaticScene,
    num_steps: int,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], tuple[WorldState, StepEvents]]:
    """Like :func:`make_multi_step_fn`, but returns the per-step events
    too, each field with a leading [num_steps] axis."""
    step = make_step_fn(static, solver_iterations, **physics_kwargs)

    def run(state: WorldState, inp: InputFrame):
        events = []
        for _ in range(num_steps):
            state, ev = step(state, inp)
            events.append(ev)
        return state, stack_events(events)

    return run
