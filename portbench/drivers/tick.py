"""Driver ``tick``: one world stepped and drawn each display frame, a
closed loop: each frame is called, its image waited for on the device,
then the next is called, as a presenting game loop does.

Entry: the port's ``render.pipeline.make_frame_fn(built, width, height,
substeps=..., broadphase=..., max_neighbors=...)``: the substeps' graph
then the frame's graph, the state donated.  The camera orbits the scene's
``orbit`` centre at a fixed rate per display frame from an angle drawn
from the seed.  Set-up builds the scene and its render arrays, captures
both graphs and settles the world through the tick's own step graph.  End
to end: ``frame_ms_p95`` over every frame of the window, each from its
call to its image's event on the device.  Compared: the first settling
call's state, and one window frame drawn from the seed: its state and its
image against the reference's steps and frame.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
import types

import numpy as np
import torch

from portbench.harness import refsteps, scenes
from portbench.harness.driver import (
    Base,
    Pair,
    build_scene,
    fault_after,
    labelled,
    owned,
)
from portbench.reference import scene as ref_scene
from portbench.reference import state as rs
from portbench.reference.render.camera import Camera
from portbench.reference.render.pipeline import render_frame

# as the steps driver's start: free fall, no turning
START_SKIPS = ("quat_gap",)


class Driver(Base):
    def setup(self) -> None:
        from banggameengine_tpu_torch import convert
        from banggameengine_tpu_torch import state as ps
        from banggameengine_tpu_torch.render.pipeline import make_frame_fn
        from banggameengine_tpu_torch.scene.build import BuiltScene
        from banggameengine_tpu_torch.scene.synthetic import build_box_render

        p = self.p
        self.width, self.height = int(p["width"]), int(p["height"])
        self.substeps = self.steps_per_call = int(p["substeps"])
        static_raw, state_raw = build_scene(self.cfg, self.cell.seed,
                                               self.dev)
        self.ref_static = refsteps.to_ref(rs.StaticScene(**static_raw),
                                          rs.StaticScene)
        self.static = ps.StaticScene(**static_raw)
        state = ps.WorldState(**state_raw)
        self.kwargs = dict(broadphase=p["broadphase"],
                           max_neighbors=int(p["max_neighbors"]))
        self.iters = int(self.cfg["physics"]["solver_iterations"])
        self.bin_capacity = int(p["bin_capacity"])
        render = convert.render_scene_from_numpy(
            build_box_render(self.static), self.dev)
        built = BuiltScene(static=self.static, initial_state=state,
                           render=render)
        self.program = make_frame_fn(
            built, self.width, self.height, solver_iterations=self.iters,
            bin_capacity=self.bin_capacity, substeps=self.substeps,
            **self.kwargs)
        self.inp = ps.InputFrame.zero(self.dev)
        self._cameras()
        # settle through the tick's own step graph (no frame drawn)
        step_program = self.program.programs[0]
        calls = int(p["settle_steps"]) // self.substeps
        for i in range(calls):
            pair = (Pair("start", owned(state, rs.WorldState), None,
                         self.substeps) if i == 0 else None)
            state, _ = step_program(state, self.inp, self.static)
            if pair is not None:
                pair.post = owned(state, rs.WorldState)
                self.pairs.append(pair)
        self.state = state
        # the first frames capture the frame graph: set-up, not window
        for i in range(int(p["warmup_frames"])):
            self._frame(-1 - i)
        self.frame_ms: list[float] = []
        self.traced_frames: list = []

    def _cameras(self) -> None:
        """The orbit's view matrices, one a display frame over a whole
        turn, and the projection: made once, on the device."""
        o = self.p["orbit"]
        g = scenes.generator(self.cell.seed, "cpu", stream=6)
        a0 = float(torch.rand((), generator=g)) * 2.0 * math.pi
        per_turn = int(round(2.0 * math.pi / float(o["rad_per_frame"])))
        centre = np.asarray(o["centre"], np.float64)
        cam = Camera()
        views, eyes = [], []
        for i in range(per_turn):
            a = a0 + i * float(o["rad_per_frame"])
            eye = centre + np.array([o["radius"] * math.cos(a), o["height"],
                                     o["radius"] * math.sin(a)])
            d = centre - eye
            cam.position = eye.astype(np.float32)
            cam.set_yaw_pitch(math.atan2(d[2], d[0]),
                              math.atan2(d[1], math.hypot(d[0], d[2])))
            views.append(cam.view_matrix("cpu"))
            eyes.append(torch.as_tensor(cam.position))
        self.views = torch.stack(views).to(self.dev)
        self.eyes = torch.stack(eyes).to(self.dev)
        self.proj = cam.proj_matrix(self.width / self.height, self.dev)

    def camera(self, i: int):
        k = i % self.views.shape[0]
        return self.views[k], self.proj, self.eyes[k]

    def _frame(self, i: int, label=None):
        view, proj, eye = self.camera(i)
        pair = None
        if label is not None or self.fault:
            pair = Pair(label, owned(self.state, rs.WorldState), None,
                        self.substeps)
        state, image, _ = self.program(self.state, self.inp, view, proj, eye)
        if self.fault:
            fault_after(self.fault, pair.pre, state)
            if self.fault == "altered":
                image[:8, :8] = 255 - image[:8, :8]
        self.state = state
        if label is not None:
            pair.post = owned(state, rs.WorldState)
            pair.image = image.clone()
            pair.camera = (view.clone(), proj.clone(), eye.clone())
            self.pairs.append(pair)
        if self.tracing:
            self.traced_frames.append(
                (state.world.clone(), view.clone(), proj, eye.clone()))
        return image

    def call(self, i: int) -> None:
        t0 = time.perf_counter()
        self._frame(i, "window" if i == self.check_at else None)
        done = torch.cuda.Event() if self.dev.type == "cuda" else None
        if done is not None:
            done.record()
            done.synchronize()
        self.frame_ms.append((time.perf_counter() - t0) * 1e3)

    def end_to_end(self, calls: int, seconds: float) -> dict:
        ms = sorted(self.frame_ms)
        p95 = ms[min(len(ms) - 1, math.ceil(0.95 * len(ms)) - 1)]
        print(f"frames {len(ms)} in {seconds:.3f} s: median "
              f"{statistics.median(ms):.4f} ms, p95 {p95:.4f} ms, slowest "
              f"{ms[-1]:.4f} ms", file=sys.stderr)
        return {"frame_ms_p95": p95}

    def ref_frame(self, world, view, proj, eye):
        if not hasattr(self, "ref_render"):
            self.ref_render = ref_scene.box_render(
                self.ref_static.shape_type.cpu().numpy(),
                self.ref_static.shape_size.cpu().numpy(), self.dev)
        return render_frame(types.SimpleNamespace(**self.ref_render), world, view, proj, eye, width=self.width,
                            height=self.height,
                            bin_capacity=self.bin_capacity)

    def judge(self, mode: str = "program") -> list:
        readings = []
        for pair in self.pairs:
            want = refsteps.step(pair.pre, refsteps.to_ref(self.inp, rs.InputFrame),
                                 self.ref_static, pair.steps, self.iters,
                                 **self.kwargs)
            got = pair.post
            if mode != "program":
                got = refsteps.step(pair.pre, refsteps.to_ref(self.inp, rs.InputFrame),
                                    self.ref_static, pair.steps, self.iters,
                                    mode=mode, **self.kwargs)
            r = refsteps.state_gaps(got, want, want.alive, self.detail)
            if pair.camera is not None:
                image = (pair.image if mode == "program"
                         else self.ref_frame(got.world, *pair.camera))
                ref = self.ref_frame(want.world, *pair.camera)
                off = ((image.to(torch.int16) - ref.to(torch.int16)).abs()
                       .amax(-1) > 1)
                r["pixels_off_share"] = float(off.float().mean())
            readings.append(labelled(pair, r, START_SKIPS))
        return readings
