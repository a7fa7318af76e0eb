"""Driver ``steps``: one big world stepped headless, a fixed count of
120 Hz steps a call, zero input, the state donated from call to call.

Entry: the port's ``engine.make_multi_step_fn(static, steps_per_call,
broadphase=..., max_neighbors=...)``.  Set-up builds the configuration's
scene from the seed, captures the program and settles the world for
``settle_steps``; the window calls it back to back and ends on a device
synchronise.  End to end: ``sim_steps_per_s``.  Compared: the first
settling call (the start) and one window call drawn from the seed,
against the reference stepping the same states.
"""

from __future__ import annotations

import torch

from portbench.harness import refsteps
from portbench.harness.driver import (
    Base,
    Pair,
    build_scene,
    fault_after,
    labelled,
    owned,
)
from portbench.reference import state as rs
from portbench.reference.physics import broadphase_kernel as bk
from portbench.reference.physics import shapes

# the start's boxes fall freely and do not turn: its quaternion gap reads
# 0 to rounding and 1.5e-5 under the control, and is not compared; its
# largest position gap is already held tight, so its median is not either.
START_SKIPS = ("quat_gap", "pos_gap_p50_m")


class Driver(Base):
    def setup(self) -> None:
        from banggameengine_tpu_torch import engine
        from banggameengine_tpu_torch import state as ps

        p = self.p
        self.steps_per_call = int(p["steps_per_call"])
        static_raw, state_raw = build_scene(self.cfg, self.cell.seed,
                                            self.dev)
        self.ref_static = refsteps.to_ref(rs.StaticScene(**static_raw),
                                          rs.StaticScene)
        self.static = ps.StaticScene(**static_raw)
        state = ps.WorldState(**state_raw)
        self.kwargs = dict(broadphase=p["broadphase"],
                           max_neighbors=int(p["max_neighbors"]))
        self.iters = int(self.cfg["physics"]["solver_iterations"])
        self.program = engine.make_multi_step_fn(
            self.static, self.steps_per_call, solver_iterations=self.iters,
            **self.kwargs)
        self.inp = ps.InputFrame.zero(self.dev)
        calls = int(p["settle_steps"]) // self.steps_per_call
        for i in range(calls):
            state = self._call(state, "start" if i == 0 else None)
        self.state = state
        self.sync()

    def _call(self, state, label=None):
        pair = None
        if label is not None or self.fault:
            pair = Pair(label, owned(state, rs.WorldState), None,
                        self.steps_per_call)
        out = self.program(state, self.inp)
        if self.fault:
            fault_after(self.fault, pair.pre, out)
        if label is not None:
            pair.post = owned(out, rs.WorldState)
            self.pairs.append(pair)
        return out

    def call(self, i: int) -> None:
        if self.tracing:
            self.traced_pre.append(owned(self.state, rs.WorldState))
        self.state = self._call(self.state,
                                "window" if i == self.check_at else None)

    def end_to_end(self, calls: int, seconds: float) -> dict:
        return {"sim_steps_per_s": calls * self.steps_per_call / seconds}

    def ref_steps(self, pre, mode: str = "program"):
        """The reference through one call from the state ``pre``."""
        return refsteps.step(pre, refsteps.to_ref(self.inp, rs.InputFrame),
                             self.ref_static, self.steps_per_call,
                             self.iters, mode=mode, **self.kwargs)

    def judge(self, mode: str = "program") -> list:
        readings = []
        for pair in self.pairs:
            want = self.ref_steps(pair.pre)
            got = (pair.post if mode == "program"
                   else self.ref_steps(pair.pre, mode))
            r = refsteps.state_gaps(got, want, want.alive, self.detail)
            r["pos_gap_p50_m"] = refsteps.median_pos_gap(got, want,
                                                         want.alive)
            readings.append(labelled(pair, r, START_SKIPS))
        return readings

    def notes(self) -> list[str]:
        """The neighbor lists' overflow at the compared window call: the
        bodies whose AABB partners outnumber ``max_neighbors``."""
        pair = self.pairs[-1]
        s = pair.post
        st = self.ref_static
        mn, mx = shapes.shape_aabb(s.pos, s.quat, st.shape_type,
                                   st.shape_size)
        dyn = torch.where(s.alive, 1, -1).to(torch.int32)
        lo, hi = bk.with_margin(mn, mx)
        _, count = bk.plain_idx_count(lo, hi, dyn, st.layer, st.mask, 1)
        k = self.kwargs["max_neighbors"]
        over = int((count > k).sum())
        return [f"neighbor lists at the compared call (step "
                f"{int(s.step_idx)}): {over} of {count.numel()} bodies "
                f"have more than {k} AABB partners (their extra partners "
                f"are dropped); most partners {int(count.max())}"]
