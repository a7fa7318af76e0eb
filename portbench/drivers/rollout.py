"""Driver ``rollout``: W worlds in lockstep, each call ``steps_per_call``
steps under one fresh action a world (an RL policy's move axes, jump,
sprint and camera yaw, drawn on the device from the seed as the mix
says), held for the call's steps.

Entry: the port's ``parallel.manyworld.make_many_world_step(static,
None, comp_mask, num_worlds, num_steps)``, whose router picks the layout
(recorded on an earlier line).  Set-up builds one world of the
configuration, gives every world its own box poses from the seed,
captures the program and settles ``settle_steps`` under zero input.
End to end: ``world_steps_per_s``.  Compared: the first settling call and
one window call drawn from the seed, on ``sample_worlds`` worlds drawn
from the seed, each stepped by the reference on its own, not flattened.
"""

from __future__ import annotations

import math

import torch

from portbench.harness import refsteps, scenes
from portbench.harness.driver import (
    Base,
    Pair,
    fault_after,
    labelled,
    owned,
)
from portbench.reference import manyworld as ref_mw
from portbench.reference import state as rs


def world_of(tree, w: int, cls):
    """World ``w`` of a [W, ...] batch as the reference's ``cls``."""
    return refsteps.to_ref(cls(**{
        k: v[w] for k, v in scenes.fields(tree).items()}), cls)


class Driver(Base):
    def setup(self) -> None:
        from banggameengine_tpu_torch import state as ps
        from banggameengine_tpu_torch.parallel.manyworld import (
            make_many_world_step)

        p, sc = self.p, self.cfg["scene"]
        self.steps_per_call = int(p["steps_per_call"])
        self.worlds = w = int(sc["num_worlds"])
        static_raw, state_raw = scenes.rollout_world(
            sc, self.cfg["physics"], self.dev)
        self.ref_static = refsteps.to_ref(rs.StaticScene(**static_raw),
                                          rs.StaticScene)
        batched = {k: v.expand((w,) + v.shape).clone()
                   for k, v in state_raw.items()}
        nb = int(sc["boxes"])
        batched["pos"][:, :nb], batched["quat"][:, :nb] = (
            scenes.rollout_poses(sc, w, self.cell.seed, self.dev))
        self.static = ps.StaticScene(**static_raw)
        state = ps.WorldState(**batched)
        self.iters = int(self.cfg["physics"]["solver_iterations"])
        self.program, self.layout = make_many_world_step(
            self.static, None, state.comp_mask[0], num_worlds=w,
            num_steps=self.steps_per_call, verbose=False,
            solver_iterations=self.iters)
        self.input_cls = ps.InputFrame
        self.actions = scenes.generator(self.cell.seed, self.dev, stream=3)
        zero = ps.InputFrame(
            move_forward=torch.zeros(w, device=self.dev),
            move_right=torch.zeros(w, device=self.dev),
            jump=torch.zeros(w, dtype=torch.bool, device=self.dev),
            sprint=torch.zeros(w, dtype=torch.bool, device=self.dev),
            cam_yaw=torch.zeros(w, device=self.dev))
        calls = int(p["settle_steps"]) // self.steps_per_call
        for i in range(calls):
            state = self._call(state, zero, "start" if i == 0 else None)
        self.state = state
        g = scenes.generator(self.cell.seed, "cpu", stream=4)
        self.sample = torch.randperm(w, generator=g)[
            :int(p["sample_worlds"])].tolist()
        self.sync()

    def _actions(self):
        """One action a world: 5 components from N(0, ``std``) clipped to
        [-``clip``, ``clip``], read as move forward and right, camera yaw
        (x pi / clip), and jump and sprint pressed above ``press_above``."""
        w, g, dev, a = self.worlds, self.actions, self.dev, self.p["actions"]
        clip = float(a["clip"])
        r = (float(a["std"]) * torch.randn((5, w), generator=g, device=dev)
             ).clamp(-clip, clip)
        press = float(a["press_above"])
        return self.input_cls(
            move_forward=r[0], move_right=r[1],
            cam_yaw=r[2] * (math.pi / clip), jump=r[3] > press,
            sprint=r[4] > press)

    def _call(self, state, inp, label=None):
        pair = None
        if label is not None or self.fault:
            pair = Pair(label, owned(state), owned(inp), self.steps_per_call)
        out = self.program(state, inp)
        if self.fault:
            fault_after(self.fault, pair.pre, out)
        if label is not None:
            pair.post = owned(out)
            self.pairs.append(pair)
        return out

    def call(self, i: int) -> None:
        self.state = self._call(self.state, self._actions(),
                                "window" if i == self.check_at else None)

    def end_to_end(self, calls: int, seconds: float) -> dict:
        return {"world_steps_per_s":
                calls * self.steps_per_call * self.worlds / seconds}

    def judge(self, mode: str = "program") -> list:
        route = ref_mw.static_route(self.ref_static,
                                    self.pairs[0].pre.comp_mask[0])
        readings = []
        for pair in self.pairs:
            worlds = []
            for w in self.sample:
                pre = world_of(pair.pre, w, rs.WorldState)
                inp = world_of(pair.inp, slice(w, w + 1), rs.InputFrame)
                want = refsteps.step(pre, inp, self.ref_static, pair.steps,
                                     self.iters, **route)
                got = (world_of(pair.post, w, rs.WorldState) if mode == "program"
                       else refsteps.step(pre, inp, self.ref_static,
                                          pair.steps, self.iters,
                                          mode=mode, **route))
                r = refsteps.state_gaps(got, want, want.alive, self.detail)
                r["ground_flips"] = float(
                    (got.char_on_ground != want.char_on_ground).sum())
                r["trigger_flips"] = float(
                    (got.trigger_overlap != want.trigger_overlap).sum())
                worlds.append(r)
            readings.append(labelled(pair, refsteps.merge_max(worlds)))
        return readings

    def notes(self) -> list[str]:
        return [f"layout {self.layout}: {self.worlds} worlds of "
                f"{self.static.capacity} entities, {self.steps_per_call} "
                f"steps a call; compared worlds {self.sample}"]
