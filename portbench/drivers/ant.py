"""Driver ``ant``: W worlds of IsaacGymEnvs' Ant in lockstep, each call
``steps_per_call`` steps under one fresh torque action a world, held for
the call's steps.

Entry: the port's ``parallel.manyworld.make_many_world_step(static,
None, comp_mask, num_worlds, num_steps, joints=...)``, whose router picks
the layout (recorded on an earlier line), with the scene, joint table and
starts of the port's Ant builder; the reference's scene, joint table and
motors are built from the configuration alone (:mod:`harness.ant`).
Set-up builds the worlds from the seed, captures the program and settles
``settle_steps`` under zero command.  A call's action: one component a hinge, drawn on the
device from the seed from N(0, ``std``), clipped to the configuration's
``clip_actions`` and times its ``power_scale``: the motors' command
(torque = gear x command).  End to end: ``world_steps_per_s``.
Compared: the first settling call and one window call drawn from the
seed, on ``sample_worlds`` worlds drawn from the seed, each stepped alone
by the reference's articulated step from the program's state, joint
impulses and command before the call.
"""

from __future__ import annotations

import types

import torch

from portbench.harness import ant, refsteps, scenes
from portbench.harness.driver import Base, Pair, fault_after, labelled, owned
from portbench.reference import state as rs


def world_of(tree, w: int):
    """World ``w`` of a [W, ...] batched state as the reference's."""
    return refsteps.to_ref(rs.WorldState(**{
        k: v[w] for k, v in scenes.fields(tree).items()}), rs.WorldState)


class Driver(Base):
    def setup(self) -> None:
        from banggameengine_tpu_torch import state as ps
        from banggameengine_tpu_torch.parallel.manyworld import (
            make_many_world_step)
        from banggameengine_tpu_torch.physics import joints as pj

        p, control = self.p, self.cfg["control"]
        self.steps_per_call = int(p["steps_per_call"])
        worlds = ant.ant_worlds(self.cfg, self.cell.seed, self.dev)
        self.worlds = w = worlds.state.pos.shape[0]
        self.ref = ant.reference_scene(self.cfg, self.dev)
        self.static, self.joints = worlds.static, worlds.joints
        self.iters = int(self.cfg["physics"]["solver_iterations"])
        self.program, self.layout = make_many_world_step(
            self.static, None, worlds.state.comp_mask[0], num_worlds=w,
            num_steps=self.steps_per_call, verbose=False,
            solver_iterations=self.iters, joints=self.joints)
        self.clip = float(control["clip_actions"])
        self.power = float(control["power_scale"])
        self.std = float(p["actions"]["std"])
        self.actions = scenes.generator(self.cell.seed, self.dev, stream=3)
        self.inp = ps.InputFrame.zero(self.dev)
        state = worlds.state
        joint_state = pj.make_joint_state(self.joints, w)
        zero = torch.zeros((w, self.joints.num_joints), device=self.dev)
        calls = int(p["settle_steps"]) // self.steps_per_call
        for i in range(calls):
            state, joint_state = self._call(state, joint_state, zero,
                                            "start" if i == 0 else None)
        self.state, self.joint_state = state, joint_state
        g = scenes.generator(self.cell.seed, "cpu", stream=4)
        self.sample = torch.randperm(w, generator=g)[
            :int(p["sample_worlds"])].tolist()
        self.sync()

    def _command(self):
        """One action a world, a component a hinge: N(0, ``std``) clipped
        to [-clip, clip], times the power scale."""
        a = self.std * torch.randn((self.worlds, self.joints.num_joints),
                                   generator=self.actions, device=self.dev)
        return a.clamp(-self.clip, self.clip) * self.power

    def _call(self, state, joint_state, command, label=None):
        pair = None
        if label is not None or self.fault:
            pair = Pair(label, owned(state), None, self.steps_per_call)
            pair.impulse = joint_state.impulse.clone()
            pair.command = command.clone()
        state, joint_state = self.program(state, self.inp, joint_state,
                                          command)
        if self.fault:
            fault_after(self.fault, pair.pre, state)
        if label is not None:
            pair.post = owned(state)
            pair.limit_rows = int(joint_state.limit_rows)
            self.pairs.append(pair)
        return state, joint_state

    def call(self, i: int) -> None:
        self.state, self.joint_state = self._call(
            self.state, self.joint_state, self._command(),
            "window" if i == self.check_at else None)

    def end_to_end(self, calls: int, seconds: float) -> dict:
        return {"world_steps_per_s":
                calls * self.steps_per_call * self.worlds / seconds}

    def judge(self, mode: str = "program") -> list:
        readings = []
        for pair in self.pairs:
            worlds, got_pos, want_pos, alive = [], [], [], []
            for w in self.sample:
                pre = world_of(pair.pre, w)
                args = (*self.ref, pair.impulse[w], pair.command[w],
                        pair.steps, self.iters)
                want = ant.step(pre, *args)[0]
                got = (world_of(pair.post, w) if mode == "program"
                       else ant.step(pre, *args, mode=mode)[0])
                worlds.append(refsteps.state_gaps(got, want, want.alive,
                                                  self.detail))
                got_pos.append(got.pos)
                want_pos.append(want.pos)
                alive.append(want.alive)
            r = refsteps.merge_max(worlds)
            # the median body of every compared world together
            r["pos_gap_p50_m"] = refsteps.median_pos_gap(
                types.SimpleNamespace(pos=torch.cat(got_pos)),
                types.SimpleNamespace(pos=torch.cat(want_pos)),
                torch.cat(alive))
            readings.append(labelled(pair, r))
        return readings

    def notes(self) -> list[str]:
        return [f"layout {self.layout}: {self.worlds} worlds of "
                f"{self.static.capacity} bodies and "
                f"{self.joints.num_joints} motor hinges, "
                f"{self.steps_per_call} steps a call; compared worlds "
                f"{self.sample}"] + [
            f"joint limit rows at their bound in the last step of the "
            f"{pair.label} call (step {int(pair.post.step_idx[0])}): "
            f"{pair.limit_rows} of {self.worlds * self.joints.num_joints}"
            for pair in self.pairs]

    def free(self) -> None:
        super().free()
        self.joints = self.joint_state = None
