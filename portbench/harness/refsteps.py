"""The reference's side of a comparison: stepping, the control, the gaps.

The program's states are handed over field by field into the reference's
frozen state types; the reference steps them eagerly with its own
``engine_step`` (:mod:`portbench.reference`).  The control is the same
reference with every float of the state and of the scene stored in
bfloat16 (rounded on the way in and after every step), the nearest
precision below the configuration's float32 that the physics step can
take: it has no matrix product, so TF32 does not touch it.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.engine import engine_step
from portbench.reference.physics.step import scene_census


def to_ref(obj, cls):
    """A dataclass of tensors (either side's) as the reference's ``cls``,
    every tensor cloned."""
    return cls(**{f.name: getattr(obj, f.name).clone()
                  for f in dataclasses.fields(cls)})


def bf16(obj):
    """``obj`` with every float tensor rounded to bfloat16 and back."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(torch.bfloat16).to(torch.float32)
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).dtype == torch.float32})


MODES = ("program", "control", "rounding")


def nudged(state):
    """``state`` with every other entity's position one float32 step up:
    a state that differs from it by rounding alone."""
    pos = state.pos.clone()
    pos[..., ::2, :] = torch.nextafter(pos[..., ::2, :],
                                       torch.full_like(pos[..., ::2, :],
                                                       float("inf")))
    return dataclasses.replace(state, pos=pos)


def step(state, inp, static, steps: int, solver_iterations: int,
         mode: str = "program", **physics_kwargs):
    """``steps`` reference steps of ``state`` (reference types) under
    ``inp``.  ``mode="control"``: in bfloat16 storage; ``"rounding"``:
    from :func:`nudged` ``state``, what a program that rounds once
    differently would read."""
    kw = {**scene_census(static), **physics_kwargs}
    control = mode == "control"
    if mode == "rounding":
        state = nudged(state)
    if control:
        state, static = bf16(state), bf16(static)
    for _ in range(steps):
        state, _ = engine_step(state, inp, static, solver_iterations, **kw)
        if control:
            state = bf16(state)
    return state


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def state_gaps(got, want, alive, detail: bool = False) -> dict:
    """The numbers compared of one state (either side's types) against the
    reference's: the largest position gap (m) and quaternion gap (the
    sign of q taken where it is nearer) over the live entities, and the
    step counter's gap.  ``detail`` adds the spread of the entities'
    position gaps (quantiles, the share off by more than 1 cm)."""
    a = alive.bool()
    gap = (got.pos - want.pos).abs().amax(-1)[a]
    dq = torch.minimum((got.quat - want.quat).abs().amax(-1),
                       (got.quat + want.quat).abs().amax(-1))
    out = {
        "pos_gap_m": _max(gap),
        "quat_gap": _max(dq[a]),
        "step_gap": _max((got.step_idx.to(torch.int64)
                          - want.step_idx.to(torch.int64)).abs()
                         .reshape(-1)),
    }
    if detail and gap.numel():
        q = torch.quantile(gap.double(), torch.tensor(
            [0.5, 0.9, 0.99], dtype=torch.float64, device=gap.device))
        out.update(pos_gap_p50=float(q[0]), pos_gap_p90=float(q[1]),
                   pos_gap_p99=float(q[2]),
                   off_1cm_share=float((gap > 0.01).double().mean()))
    return out


def median_pos_gap(got, want, alive) -> float:
    """The median live entity's position gap (m): steady where a chaotic
    few carry the largest gap."""
    gap = (got.pos - want.pos).abs().amax(-1)[alive.bool()]
    return float(gap.median()) if gap.numel() else 0.0


def merge_max(readings: list[dict]) -> dict:
    """The largest of each number over several compared calls."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            old = out.get(k, v)
            # NaN wins: a number that is not a number fails its limit
            out[k] = v if v != v else old if old != old else max(old, v)
    return out
