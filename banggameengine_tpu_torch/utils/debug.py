"""Checked stepping: NaN and runaway guards for the step.

Counterpart of ``banggameengine_tpu/utils/debug.py`` (numeric safety in
place of the reference's HUD invariant checks): a step that also returns
an error value flagging non-finite positions or quaternions and runaway
or non-finite velocities with the failing step's index, and a host-side
spot check.  PyTorch has no ``checkify``: the step computes the three
flags and keeps the step index on the device, with no host
synchronisation, and :meth:`StepError.throw` reads them once and raises
with the JAX package's message.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from banggameengine_tpu_torch.engine import engine_step
from banggameengine_tpu_torch.physics.step import scene_census

VELOCITY_LIMIT = 1e4  # anything faster is runaway integration

# the checks in the JAX package's order; the first that failed is reported
_MESSAGES = (
    "non-finite position at step {i}",
    "non-finite quaternion at step {i}",
    "runaway/non-finite velocity at step {i}",
)


class CheckError(ValueError):
    """A failed check of the checked step (``checkify``'s error is a
    ValueError too)."""


@dataclasses.dataclass
class StepError:
    """The checks of one checked step, on the device: ``failed`` bool[3]
    in the order of the messages, ``step`` the new state's int32 index."""

    failed: torch.Tensor
    step: torch.Tensor

    def get(self) -> str | None:
        """The first failed check's message (as ``checkify`` words it), or
        None; one read of the flags and the index."""
        values = torch.cat([self.failed.to(torch.int64),
                            self.step.reshape(1).to(torch.int64)]).tolist()
        for failed, message in zip(values[:3], _MESSAGES):
            if failed:
                return f"{message.format(i=values[3])} (`check` failed)"
        return None

    def throw(self) -> None:
        """Raise :class:`CheckError` if a check failed."""
        message = self.get()
        if message is not None:
            raise CheckError(message)


def make_checked_step_fn(static, solver_iterations: int = 10,
                         **physics_kwargs):
    """A step that also returns a :class:`StepError`::

        step = make_checked_step_fn(static)
        err, (state, events) = step(state, inp)
        err.throw()   # raises with a message when the state went bad
    """
    physics_kwargs = {**scene_census(static), **physics_kwargs}

    def checked(state, inp):
        new_state, events = engine_step(state, inp, static, solver_iterations,
                                        **physics_kwargs)
        vel = new_state.lin_vel
        failed = torch.stack([
            ~torch.isfinite(new_state.pos).all(),
            ~torch.isfinite(new_state.quat).all(),
            ~(torch.isfinite(vel).all() & (vel.abs() < VELOCITY_LIMIT).all()),
        ])
        return StepError(failed, new_state.step_idx), (new_state, events)

    return checked


def assert_state_healthy(state) -> None:
    """Host-side spot check: one read of two flags (and of the positions,
    to name the bad entities)."""
    pos_ok, vel_ok = torch.stack([torch.isfinite(state.pos).all(),
                                  torch.isfinite(state.lin_vel).all()]).tolist()
    if not pos_ok:
        bad = np.argwhere(~np.isfinite(state.pos.cpu().numpy()))
        raise FloatingPointError(f"non-finite positions at entities {bad[:5]}")
    if not vel_ok:
        raise FloatingPointError("non-finite velocities")
