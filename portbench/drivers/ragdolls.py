"""Driver ``ragdolls``: one world of jointed ragdolls stepped headless, a
fixed count of 120 Hz steps a call, zero input, the state and the joints'
impulses donated from call to call.

Entry: the port's ``engine.make_multi_step_fn(static, steps_per_call,
joints=..., broadphase="dense", max_neighbors=...)``, with the joint table
built by ``physics.joints.make_joint_set``.  Set-up builds the
configuration's pyramid from the seed (:mod:`harness.ragdolls`), captures
the program and settles the pile for ``settle_steps``; the window calls
it back to back and ends on a device synchronise.  End to end:
``sim_steps_per_s``.  Compared: the first settling call (the start) and
one window call drawn from the seed, against the reference's jointed
step (:mod:`reference.physics.jointed`) from the program's own state and
joint impulses before each.
"""

from __future__ import annotations

from portbench.harness import ragdolls, refsteps
from portbench.harness.driver import Base, Pair, fault_after, labelled, owned
from portbench.reference import state as rs


class Driver(Base):
    def setup(self) -> None:
        from banggameengine_tpu_torch import engine
        from banggameengine_tpu_torch import state as ps
        from banggameengine_tpu_torch.physics import joints as pj

        p = self.p
        self.steps_per_call = int(p["steps_per_call"])
        static_raw, state_raw, joints_raw = ragdolls.ragdoll_pyramid(
            self.cfg["scene"], self.cfg["physics"], self.cell.seed, self.dev)
        self.ref_static = refsteps.to_ref(rs.StaticScene(**static_raw),
                                          rs.StaticScene)
        self.ref_joints = ragdolls.joints_of(joints_raw)
        self.static = ps.StaticScene(**static_raw)
        self.joints = pj.make_joint_set(self.static.capacity, **joints_raw,
                                        device=self.dev)
        # a hinge has one limit row, a cone-twist two (swing and twist)
        self.limit_slots = int((self.joints.kind == pj.CONE_TWIST).sum()
                               + self.joints.num_joints)
        state = ps.WorldState(**state_raw)
        joint_state = pj.make_joint_state(self.joints)
        self.kwargs = dict(max_neighbors=int(p["max_neighbors"]))
        self.iters = int(self.cfg["physics"]["solver_iterations"])
        self.program = engine.make_multi_step_fn(
            self.static, self.steps_per_call, solver_iterations=self.iters,
            joints=self.joints, broadphase=p["broadphase"], **self.kwargs)
        self.inp = ps.InputFrame.zero(self.dev)
        calls = int(p["settle_steps"]) // self.steps_per_call
        for i in range(calls):
            state, joint_state = self._call(state, joint_state,
                                            "start" if i == 0 else None)
        self.state, self.joint_state = state, joint_state
        self.sync()

    def _call(self, state, joint_state, label=None):
        pair = None
        if label is not None or self.fault:
            pair = Pair(label, owned(state, rs.WorldState), None,
                        self.steps_per_call)
            pair.impulse = joint_state.impulse.clone()
        state, joint_state = self.program(state, self.inp, joint_state)
        if self.fault:
            fault_after(self.fault, pair.pre, state)
        if label is not None:
            pair.post = owned(state, rs.WorldState)
            pair.limit_rows = int(joint_state.limit_rows)
            self.pairs.append(pair)
        return state, joint_state

    def call(self, i: int) -> None:
        self.state, self.joint_state = self._call(
            self.state, self.joint_state,
            "window" if i == self.check_at else None)

    def end_to_end(self, calls: int, seconds: float) -> dict:
        return {"sim_steps_per_s": calls * self.steps_per_call / seconds}

    def ref_steps(self, pair: Pair, mode: str = "program"):
        """The reference through one call from the pair's state and
        impulses: (state, impulses, limit rows)."""
        return ragdolls.step(pair.pre, self.ref_static, self.ref_joints,
                             pair.impulse, self.steps_per_call, self.iters,
                             self.kwargs["max_neighbors"], mode=mode)

    def judge(self, mode: str = "program") -> list:
        readings = []
        for pair in self.pairs:
            want = self.ref_steps(pair)[0]
            got = (pair.post if mode == "program"
                   else self.ref_steps(pair, mode)[0])
            r = refsteps.state_gaps(got, want, want.alive, self.detail)
            r["pos_gap_p50_m"] = refsteps.median_pos_gap(got, want,
                                                         want.alive)
            readings.append(labelled(pair, r))
        return readings

    def notes(self) -> list[str]:
        """The joints' limit rows at their bound in the compared calls'
        last steps (hinge limits, swings and twists)."""
        return [f"joint limit rows at their bound in the last step of the "
                f"{pair.label} call (step {int(pair.post.step_idx)}): "
                f"{pair.limit_rows} of the {self.limit_slots} hinge limit, "
                f"swing and twist rows" for pair in self.pairs]

    def free(self) -> None:
        super().free()
        self.joints = self.joint_state = None
