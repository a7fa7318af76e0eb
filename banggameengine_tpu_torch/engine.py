"""Engine step: physics, then the world-matrix refresh.

Counterpart of ``banggameengine_tpu/engine.py``: :func:`engine_step`,
:func:`visual_positions`, :func:`interpolated_world` and the step
factories :func:`make_step_fn`,
:func:`make_hot_reloadable_step_fn`, :func:`make_multi_step_fn` and
:func:`make_step_fn_with_events`.  The JAX package jits its steps and scans
the multi-steps; here each factory returns a captured program
(:mod:`graphs`): on the card a call replays a CUDA graph of one step, and
a multi-step replays it ``num_steps`` times, each replay writing the state
back into the graph's own input buffers.  On the CPU, or inside
:func:`graphs.eager`, the same factories run the step eagerly and a
multi-step is a Python loop.  Nothing in a step synchronises with the
host, so the card runs ahead of the caller.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from banggameengine_tpu_torch import graphs, math3d
from banggameengine_tpu_torch.ecs.transform import (
    scatter_rows,
    update_world_matrices,
)
from banggameengine_tpu_torch.physics.joints import JointSet, JointState
from banggameengine_tpu_torch.physics.step import physics_step, scene_census
from banggameengine_tpu_torch.state import (
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
    tree_replace,
)
from banggameengine_tpu_torch.utils.profiling import span


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
    ``physics_kwargs`` go to :func:`physics_step`; with ``joints`` there
    the step returns the joints' new state last, as it does."""
    state, events, *joint_state = physics_step(
        state, inp, static, solver_iterations, **physics_kwargs)
    with span("ecs.transforms", state.pos.device):
        world = update_world_matrices(
            visual_positions(state, static), state.quat, state.scale,
            static.parent, static.level_nodes, state.alive,
        )
    return (tree_replace(state, world=world), events, *joint_state)


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


def _bound_step(static: StaticScene, solver_iterations: int,
                physics_kwargs: dict):
    """``fn(state, inp, static) -> (state, events)`` with the host-side
    scene census (dead-stage skipping) taken here, once."""
    return functools.partial(
        engine_step, solver_iterations=solver_iterations,
        **{**scene_census(static), **physics_kwargs})


def make_step_fn(
    static: StaticScene,
    solver_iterations: int = 10,
    donate: bool = True,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], tuple[WorldState, StepEvents]]:
    """A single-world step bound to the static scene.  The host-side scene
    census (dead-stage skipping) runs here, once.

    On the card a call replays the step's graph.  ``donate=True`` (as in
    JAX) consumes the state passed in: the step is written in place into
    the graph's buffers, and the returned state and events are those
    buffers, valid until the next call (pass the state back to step on
    with no copy).  ``donate=False`` returns clones.  The static scene is
    captured by reference: in-place writes to it (``ecs.lifecycle``)
    reach the graph."""
    program = graphs.Program(
        _bound_step(static, solver_iterations, physics_kwargs),
        donate=donate, by_ref=(2,), name="step")

    def step(state: WorldState, inp: InputFrame):
        return program(state, inp, static)

    step.program = program
    return step


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
    result as a step that skips them where they are dead).

    On the card the scene is an input of the graph like the state: each
    call copies it into the graph's buffers (a rebuilt scene of equal
    shapes needs nothing more; new shapes capture anew).  Nothing is
    donated, as in JAX: the call returns clones, and the state passed in
    stays valid (the app interpolates from it)."""
    program = graphs.Program(functools.partial(
        engine_step, solver_iterations=solver_iterations,
        any_char=True, enable_capsule=True, any_trig=True),
        name="hot_step")

    def step(state: WorldState, inp: InputFrame, static: StaticScene):
        return program(state, inp, static)

    step.program = program
    return step


def stack_events(events: list[StepEvents]) -> StepEvents:
    """Per-step events stacked on a new leading [num_steps] axis."""
    return StepEvents(**{
        f.name: torch.stack([getattr(e, f.name) for e in events])
        for f in dataclasses.fields(StepEvents)})


def make_multi_step_fn(
    static: StaticScene,
    num_steps: int,
    solver_iterations: int = 10,
    joints: JointSet | None = None,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], WorldState]:
    """``num_steps`` fixed steps with constant input in one call; returns
    the final state only (per-step events are dropped).

    On the card: one step's graph that writes the state back into its own
    input buffers, replayed ``num_steps`` times (the JAX package's
    ``lax.scan`` in one dispatch).  The state is donated, as in JAX: the
    returned state is the graph's buffers, valid until the next call.

    With ``joints`` (:class:`physics.joints.JointSet`, bound like the
    scene; the dense route) a call is ``run(state, inp, joint_state,
    command=None) -> (state, joint_state)``: the joints' impulses are
    carried and donated with the state, and ``joint_state.limit_rows``
    counts the limit rows at their bound in the last step.  ``command``
    f32[J] drives the hinges' motors, held for the call's steps: a set
    with motors (``joints.motored``) needs it, a set without takes none."""
    if joints is not None:
        return _multi_step_joints(static, num_steps, solver_iterations,
                                  joints, physics_kwargs)
    program = graphs.Program(
        _bound_step(static, solver_iterations, physics_kwargs),
        donate=True, by_ref=(2,), name="multi_step")

    def run(state: WorldState, inp: InputFrame) -> WorldState:
        if num_steps < 1:
            return state
        return program(state, inp, static, times=num_steps)[0]

    run.program = program
    return run


def _multi_step_joints(static, num_steps, solver_iterations, joints,
                       physics_kwargs):
    """:func:`make_multi_step_fn` with joints: the carried state is the
    pair (state, joint state), the joint set an argument by reference."""
    fn = _bound_step(static, solver_iterations, physics_kwargs)

    def body(carry, inp, st, js, command):
        state, joint_state = carry
        state, _, joint_state = fn(state, inp, st, joints=js,
                                   joint_state=joint_state,
                                   motor_command=command)
        return ((state, joint_state),)

    program = graphs.Program(body, donate=True, by_ref=(2, 3),
                             name="multi_step")

    def run(state: WorldState, inp: InputFrame, joint_state: JointState,
            command: torch.Tensor | None = None):
        if num_steps < 1:
            return state, joint_state
        return program((state, joint_state), inp, static, joints, command,
                       times=num_steps)[0]

    run.program = program
    return run


def _event_stack(num_steps: int, state: WorldState) -> StepEvents:
    """Zeroed [num_steps, ...] buffers of every event field, sized from
    the state: the trigger planes are its overlap planes' shape."""
    planes = state.trigger_overlap

    def stack(shape, dtype):
        return torch.zeros((num_steps,) + tuple(shape), dtype=dtype,
                           device=planes.device)

    return StepEvents(
        trigger_enter=stack(planes.shape, torch.bool),
        trigger_stay=stack(planes.shape, torch.bool),
        trigger_exit=stack(planes.shape, torch.bool),
        contact_overflow=stack((), torch.int32))


def make_step_fn_with_events(
    static: StaticScene,
    num_steps: int,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], tuple[WorldState, StepEvents]]:
    """Like :func:`make_multi_step_fn`, but returns the per-step events
    too, each field with a leading [num_steps] axis.

    Each step writes its events into stacked [num_steps, ...] buffers (by
    reference) at a step index kept on the device, donated with the state
    (so a capture's warm-up leaves it as it found it): on the card
    ``num_steps`` replays stack the events with no host read.  The
    returned events are clones."""
    fn = _bound_step(static, solver_iterations, physics_kwargs)

    def body(carry, inp, st, stack):
        state, at = carry
        state, events = fn(state, inp, st)
        for f in dataclasses.fields(StepEvents):
            getattr(stack, f.name).index_copy_(
                0, at, getattr(events, f.name)[None])
        return ((state, at + 1),)

    program = graphs.Program(body, donate=True, by_ref=(2, 3),
                             name="steps_with_events")
    stacks: dict = {}

    def run(state: WorldState, inp: InputFrame):
        key = graphs.signature(state)
        if key not in stacks:
            stacks[key] = (_event_stack(num_steps, state),
                           torch.zeros(1, dtype=torch.int64,
                                       device=state.pos.device))
        stack, zero = stacks[key]
        ((state, _at),) = program((state, zero), inp, static, stack,
                                  times=num_steps)
        return state, graphs.clone_tree(stack)

    run.program = program
    return run
