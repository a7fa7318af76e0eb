"""What every driver shares: the cell, the device, the compared
calls, the faults a test plants.

A driver's ``setup()`` builds the program through the entry its cell
names and runs what the traffic needs before the window (settling,
capture); ``call(i)`` is the window's i-th call; ``end_to_end(calls,
seconds)`` gives the window's end-to-end metrics; ``judge(mode)``
compares the compared calls with the reference once the window has
closed and returns, for each compared call, each number compared:
``mode="program"`` judges the program's outputs, ``"control"`` puts the
reference in bfloat16 in their place and ``"rounding"`` the reference
from a state one rounding away (:mod:`refsteps`).
"""

from __future__ import annotations

import torch

from portbench.harness import refsteps, scenes

# the faults a test plants under the timed path (see portbench/tests)
FAULTS = ("unchanged", "half", "altered")


def build_scene(cfg: dict, seed: int, device):
    """The configuration's scene: ``(static, state)`` raw fields."""
    make = getattr(scenes, cfg["scene"]["kind"])
    return make(cfg["scene"], cfg["physics"], seed, device)


def owned(tree, cls=None):
    """A copy of a program's state or input (its buffers are reused), as
    ``cls`` (default: its own class)."""
    return refsteps.to_ref(tree, cls or type(tree))


def fault_after(fault, pre, out) -> None:
    """Plant ``fault`` in a program's output state ``out`` (in place):
    ``unchanged`` puts back the state it started from, ``half`` does so
    for the second half of the worlds, ``altered`` moves body 0 (of
    every world) by 5 cm."""
    if fault == "unchanged":
        for k, v in scenes.fields(out).items():
            v.copy_(getattr(pre, k))
    elif fault == "half":
        half = out.pos.shape[0] // 2
        for k, v in scenes.fields(out).items():
            v[half:] = getattr(pre, k)[half:]
    elif fault == "altered":
        out.pos.view(-1, out.pos.shape[-2], 3)[:, 0, 0] += 0.05


class Pair:
    """One compared call: the program's state before it, its input and
    its outputs, copied when they were produced."""

    def __init__(self, label: str, pre, inp, steps: int):
        self.label, self.pre, self.inp, self.steps = label, pre, inp, steps
        self.post = None
        self.image = None
        self.camera = None


def labelled(pair: Pair, numbers: dict, start_skips=()) -> dict:
    """A compared call's numbers under their names: the start's (the first
    settling call, from the scene as built) with ``start_`` before each,
    less those in ``start_skips``."""
    if pair.label != "start":
        return numbers
    return {"start_" + k: v for k, v in numbers.items()
            if k not in start_skips}


class Base:
    steps_per_call = 1     # physics steps a call
    detail = False         # add the spread of the gaps (control.py)

    def __init__(self, cell, fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        self.cell = cell
        self.dev = torch.device(cell.device)
        self.p = cell.params
        self.cfg = cell.config
        self.fault = fault
        self.pairs: list[Pair] = []
        g = scenes.generator(cell.seed, "cpu", stream=5)
        self.check_at = int(torch.randint(0, int(self.p["check_calls"]),
                                          (1,), generator=g))
        self.trace_calls = int(self.p["trace_calls"])
        self.traced_pre: list = []     # states before the traced calls
        self.tracing = False

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def notes(self) -> list[str]:
        """Lines for standard error before the comparison's."""
        return []

    def free(self) -> None:
        """Drop the program and its state (the compared copies stay)."""
        for name in ("program", "state", "static"):
            if hasattr(self, name):
                setattr(self, name, None)
