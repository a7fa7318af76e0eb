"""Application shell: the host game loop around the engine.

Counterpart of ``banggameengine_tpu/app/application.py`` (the reference's
``Application``): owns one of every subsystem, runs the fixed-timestep
accumulator loop, services hotkeys, hot-reloads the three JSON configs,
dispatches trigger events from the device step to the EventBus, and keeps
the half-second status line.  ``device`` (default ``"cuda"``) is the
port's one new argument: the scene, the state and every step and frame
live there.

Headless-first: ``frame(real_dt)`` advances one display frame (the
default path: one device step per fixed step, each followed by the
events and the downward raycast; ``fused_tick=True``: up to 4 fixed steps
and the shaded frame in one :func:`make_frame_fn` call);
``render_current_frame()`` renders the current state, interpolated
between the last two fixed steps on the default path, with the physics
overlay (F3) and, on request, the debug-text HUD.  Hotkeys arrive
through the InputSystem so a scripted source can drive them (F1
wireframe, F3 physics overlay, F5 scene reload, F9 stats, V vsync).

The host talks to the card as the reference's design does, with one
transfer each way where it can: the host values of a step or a frame
(input, camera matrices, light, interpolation weight) go down in one
non-blocking copy from a pinned staging row; what the host must read (the
orbit target's world matrix and the trigger event planes each fixed
step; the image of each fused frame) comes back in one blocking copy
each.

On the card every step and frame is a captured program
(:mod:`graphs`): the fused tick's step and frame graphs, the
hot-reloadable step's graph (not donated: the state it is given stays
valid, since the interpolated frame reads it), and the frame graphs of
``render_current_frame``.  The host reads stay between replays.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os

import numpy as np
import torch

from banggameengine_tpu_torch import graphs
from banggameengine_tpu_torch.app.events import (
    EventBus,
    TriggerEvent,
    TriggerPhase,
    dispatch_event_planes,
    event_planes,
)
from banggameengine_tpu_torch.app.hud import compose_hud, standard_hud_lines
from banggameengine_tpu_torch.app.input import (
    ActionState,
    AxisBinding,
    InputSystem,
    ScriptedInputSource,
)
from banggameengine_tpu_torch.app.orbit import CameraOrbitController
from banggameengine_tpu_torch.app.timing import Time
from banggameengine_tpu_torch.engine import make_hot_reloadable_step_fn
from banggameengine_tpu_torch.physics import raycast as rc
from banggameengine_tpu_torch.physics.config import load_physics_config
from banggameengine_tpu_torch.physics.debugdraw import collision_shape_lines
from banggameengine_tpu_torch.render.camera import Camera
from banggameengine_tpu_torch.render.lines import draw_lines
from banggameengine_tpu_torch.render.pipeline import (
    make_frame_fn,
    make_interp_render_fn,
    make_render_fn,
)
from banggameengine_tpu_torch.render.shading import LightParams
from banggameengine_tpu_torch.scene.build import build_scene
from banggameengine_tpu_torch.scene.resources import ResourceManager
from banggameengine_tpu_torch.scene.schema import parse_scene_json
from banggameengine_tpu_torch.state import (
    COMP_CHARACTER,
    COMP_COLLIDER,
    InputFrame,
)

log = logging.getLogger("App")

MAX_SUBSTEPS = 4     # the reference's stepSimulation(dt, 4, fixedStep)
_LIGHT_FIELDS = ("yaw", "pitch", "color", "ambient", "shininess",
                 "spec_intensity")


class _Staging:
    """Host floats to the device in one copy: a ring of pinned staging
    rows, each written again only after the copy that last read it has
    finished, so a non-blocking copy never reads a row being rewritten.
    On the CPU a call returns a copy of the values."""

    def __init__(self, device: torch.device, width: int = 64,
                 depth: int = 8):
        self._device = device
        self._cuda = device.type == "cuda"
        self._rows = [torch.zeros(width, dtype=torch.float32,
                                  pin_memory=self._cuda)
                      for _ in range(depth)]
        self._done: list = [None] * depth
        self._next = 0

    def __call__(self, values) -> torch.Tensor:
        values = np.asarray(values, np.float32)
        i = self._next
        self._next = (i + 1) % len(self._rows)
        if self._done[i] is not None:
            self._done[i].synchronize()
        row = self._rows[i][:values.size]
        row.numpy()[:] = values
        if not self._cuda:
            return row.clone()
        out = row.to(self._device, non_blocking=True)
        self._done[i] = torch.cuda.Event()
        self._done[i].record()
        return out


def _light_values(light: LightParams) -> list[float]:
    """The light's 8 floats (yaw, pitch, colour rgb, ambient, shininess,
    spec intensity) from its host tensors."""
    return torch.cat([getattr(light, f).reshape(-1)
                      for f in _LIGHT_FIELDS]).tolist()


def _light_from(row: torch.Tensor) -> LightParams:
    """A device LightParams of views into a staged row of 8 floats."""
    return LightParams(yaw=row[0], pitch=row[1], color=row[2:5],
                       ambient=row[5], shininess=row[6],
                       spec_intensity=row[7])


class Application:
    def __init__(
        self,
        assets_root: str | None = None,
        scene_path: str = "scenes/demo.json",
        width: int = 1280,
        height: int = 720,
        input_source=None,
        fused_tick: bool = False,
        device: torch.device | str = "cuda",
    ):
        self.width = width
        self.height = height
        self.device = torch.device(device)
        # fused_tick=True drains the accumulator through make_frame_fn
        # (substeps + shaded frame, trigger events carried back), the
        # interactive production path; the default keeps separate step
        # and render calls (per-substep orbit updates, the interpolated
        # frame)
        self.fused_tick = fused_tick
        self._frame_fns: dict = {}
        self.last_frame_image: np.ndarray | None = None
        self.resources = ResourceManager(assets_root)
        root = self.resources.get_assets_root()
        self.scene_path = os.path.join(root, scene_path)
        self.physics_config_path = os.path.join(root, "config/physics.json")
        self.camera_config_path = os.path.join(root, "config/camera.json")
        self.bindings_path = os.path.join(root, "input/bindings.json")

        self.time = Time()
        self.bus = EventBus()
        self.input = InputSystem(input_source or ScriptedInputSource())
        self.input.load_bindings(self.bindings_path)

        self.camera = Camera()
        self.orbit = CameraOrbitController(self.camera, self.input)
        self.orbit.load_config(self.camera_config_path)

        self.config = load_physics_config(self.physics_config_path)
        self.built = None
        self.state = None
        self._trig_entity = None
        self._step = make_hot_reloadable_step_fn()
        self._render = None
        # the light's values live on the host (the light keys change them
        # between frames); each frame stages them to the device
        self.light = LightParams.default("cpu")
        self._stage = _Staging(self.device)
        self._down = torch.tensor([0.0, -1.0, 0.0], device=self.device)

        # toggles (the reference's hotkeys)
        self.wireframe = False
        self.physics_overlay = False
        self.vsync = True

        self._accumulator = 0.0
        self._status_timer = 0.0
        self.frame_count = 0
        self.last_status = ""
        self.last_ray_hit = None
        self._trigger_log: list[TriggerEvent] = []

        self.bus.subscribe(TriggerEvent, self._on_trigger_event)
        self.reload_scene("initial")

        # publish the global facade (the reference's SetActiveSystem)
        from banggameengine_tpu_torch.physics import api as physics_api

        physics_api.set_active_system(self)

    # ------------------------------------------------------------------
    # scene / config management
    # ------------------------------------------------------------------
    def reload_scene(self, tag: str) -> bool:
        """Parse + build the scene; on failure keep the current one (the
        reference's atomic swap)."""
        try:
            desc = parse_scene_json(self.scene_path)
            built = build_scene(desc, self.resources, self.config,
                                device=self.device)
        except Exception as e:
            log.warning("[App] scene reload failed (%s); keeping current", e)
            return False
        self.built = built
        self.state = built.initial_state
        self._trig_entity = built.static.trig_entity.cpu().numpy()
        self._render = None  # rebuilt lazily (the render scene changed)
        self._frame_fns = {}  # fused ticks hold the old scene's tensors
        self.orbit.on_scene_reloaded()
        log.info(
            "[App] scene %s: %d entities, %d renderers, %d colliders",
            tag, built.counts["entities"], built.counts["mesh_renderers"],
            built.counts["colliders"],
        )
        self.resources.print_stats()
        return True

    def reload_physics_config_if_needed(self) -> bool:
        try:
            m = os.path.getmtime(self.physics_config_path)
        except OSError:
            return False
        if m <= self.config.mtime:
            return False
        self.config = load_physics_config(self.physics_config_path, self.config)
        # rebuild the static scene with the same shapes
        try:
            desc = parse_scene_json(self.scene_path)
            rebuilt = build_scene(desc, self.resources, self.config,
                                  capacity=self.built.static.capacity,
                                  device=self.device)
            # one scene object for the app: a rebuilt scene of the same
            # shapes is copied into it, so the fused ticks (which capture
            # it by reference) and later run-time edits see one scene
            if not graphs.copy_into(self.built.static, rebuilt.static):
                self.built.static = rebuilt.static
                for fn in self._frame_fns.values():
                    fn.update_static(rebuilt.static)
            log.info("[Physics] config hot-reloaded")
            return True
        except Exception as e:
            log.warning("[Physics] config reload failed: %s", e)
            return False

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def run(self, max_frames: int | None = None) -> None:
        """The fixed-timestep accumulator loop."""
        while max_frames is None or self.frame_count < max_frames:
            self.frame()

    def frame(self, real_dt: float | None = None) -> None:
        dt = self.time.tick() if real_dt is None else real_dt
        dt = min(dt, 0.25)  # avoid a spiral of death after pauses

        self.input.reload_if_changed()
        self.input.update()
        self.orbit.reload_config_if_needed()
        self.reload_physics_config_if_needed()
        self._handle_hotkeys()
        self._handle_light_keys(dt)

        fixed = self.config.fixed_step
        self._accumulator += dt
        if self.fused_tick:
            # drain up to 4 substeps through the fused interactive tick
            n = min(int(self._accumulator / fixed), MAX_SUBSTEPS)
            if n > 0:
                self._fused_frame(n, fixed)
                self._accumulator -= n * fixed
        else:
            while self._accumulator >= fixed:
                self.update(fixed)
                self._accumulator -= fixed

        self._status_timer += dt
        if self._status_timer >= 0.5:
            self._status_timer = 0.0
            self.last_status = self.status_line()
            log.info(self.last_status)
        self.frame_count += 1

    def _input_values(self) -> list[float]:
        return [
            self.input.get_axis("MoveForward"),
            self.input.get_axis("MoveRight"),
            # pressed-edge, not held: the reference jumps on the action's
            # edge and Bullet's canJump latch
            float(self.input.action_pressed("Jump")),
            float(self.input.action_held("Sprint")),
            self.camera.yaw,
        ]

    @staticmethod
    def _input_from(row: torch.Tensor) -> InputFrame:
        return InputFrame(move_forward=row[0], move_right=row[1],
                          jump=row[2] != 0, sprint=row[3] != 0,
                          cam_yaw=row[4])

    def _camera_values(self) -> list[float]:
        """view (16), proj (16), camera position (3), light (8)."""
        view = self.camera.view_matrix("cpu")
        proj = self.camera.proj_matrix(self.width / self.height, "cpu")
        return (view.reshape(-1).tolist() + proj.reshape(-1).tolist()
                + self.camera.position.tolist() + _light_values(self.light))

    @staticmethod
    def _camera_from(row: torch.Tensor):
        return (row[:16].reshape(4, 4), row[16:32].reshape(4, 4),
                row[32:35], _light_from(row[35:43]))

    def _fused_frame(self, substeps: int, fixed_dt: float) -> None:
        """Drain ``substeps`` fixed steps and render one shaded frame in
        one fused tick, then dispatch the per-substep trigger events."""
        target = self.built.find_entity(self.orbit.target_id)
        self.orbit.update(substeps * fixed_dt, self.state.world, target)

        if substeps not in self._frame_fns:
            self._frame_fns[substeps] = make_frame_fn(
                self.built, self.width, self.height, substeps=substeps)
        row = self._stage(self._input_values() + self._camera_values())
        view, proj, cam_pos, light = self._camera_from(row[5:])
        self.state, img, events = self._frame_fns[substeps](
            self.state, self._input_from(row), view, proj, cam_pos, light)
        self.last_frame_image = img.cpu().numpy()
        planes = event_planes(events)
        if substeps == 1:
            dispatch_event_planes(self.bus, planes, self._trig_entity)
        else:
            for i in range(substeps):
                dispatch_event_planes(self.bus, planes[:, i],
                                      self._trig_entity)

    def update(self, fixed_dt: float) -> None:
        """One fixed step: orbit -> device step -> events -> raycast."""
        target = self.built.find_entity(self.orbit.target_id)
        self.orbit.update(fixed_dt, self.state.world, target)

        row = self._stage(self._input_values()
                          + self.camera.position.tolist())
        self._prev_state = self.state  # the interpolation's source
        self.state, events = self._step(self.state, self._input_from(row),
                                        self.built.static)
        self._last_events = events  # F9 reads contact_overflow lazily
        dispatch_event_planes(self.bus, event_planes(events),
                              self._trig_entity)

        # the downward raycast of the status line (read only there)
        s = self.built.static
        self.last_ray_hit = rc.raycast_closest(
            row[5:8], self._down, 200.0, 1,
            self.state.pos, self.state.quat, s.shape_type, s.shape_size,
            s.layer, self.state.alive,
            (self.state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0,
        )

    def _handle_light_keys(self, dt: float) -> None:
        """Continuous light controls: arrows rotate the light, Z/X
        ambient, C/V spec intensity, B/N shininess, R resets to
        defaults (f32 on the host, as the JAX package's scalars)."""
        keys = {k.upper() for k in self.input.source.keys_down()}
        rot = math.radians(90.0) * dt
        lp = self.light
        upd = {}
        if "LEFT" in keys:
            upd["yaw"] = lp.yaw - rot
        if "RIGHT" in keys:
            upd["yaw"] = lp.yaw + rot
        if "UP" in keys:
            upd["pitch"] = lp.pitch - rot * 0.5
        if "DOWN" in keys:
            upd["pitch"] = lp.pitch + rot * 0.5
        if "Z" in keys:
            upd["ambient"] = torch.clamp(lp.ambient - 0.8 * dt, 0.0, 1.0)
        if "X" in keys:
            upd["ambient"] = torch.clamp(lp.ambient + 0.8 * dt, 0.0, 1.0)
        if "C" in keys:
            upd["spec_intensity"] = torch.clamp(lp.spec_intensity - 1.2 * dt, 0.0, 4.0)
        if "V" in keys:
            upd["spec_intensity"] = torch.clamp(lp.spec_intensity + 1.2 * dt, 0.0, 4.0)
        if "B" in keys:
            upd["shininess"] = torch.clamp(lp.shininess - 128.0 * dt, 1.0, 1024.0)
        if "N" in keys:
            upd["shininess"] = torch.clamp(lp.shininess + 128.0 * dt, 1.0, 1024.0)
        if "R" in keys and not getattr(self, "_light_r_latch", False):
            self.light = LightParams.default("cpu")
            self._light_r_latch = True
            return
        self._light_r_latch = "R" in keys
        if upd:
            self.light = dataclasses.replace(lp, **upd)

    def _handle_hotkeys(self) -> None:
        src_keys = {k.upper() for k in self.input.source.keys_down()}
        # edge-latched F-keys through pseudo-actions the bindings lack
        for key in ("F1", "F3", "V"):
            action = f"__{key}"
            if action not in self.input._actions:
                self.input._actions[action] = [AxisBinding("key", key)]
                self.input._action_states[action] = ActionState()
        if self.input.action_pressed("__F1"):
            self.wireframe = not self.wireframe
        if self.input.action_pressed("__F3"):
            self.physics_overlay = not self.physics_overlay
        if self.input.action_pressed("__V"):
            self.vsync = not self.vsync
        if "F5" in src_keys and not getattr(self, "_f5_latch", False):
            self.reload_scene("reloaded")
        self._f5_latch = "F5" in src_keys
        if "F9" in src_keys and not getattr(self, "_f9_latch", False):
            log.info(self.physics_stats())
            log.info(self.resources.print_stats())
        self._f9_latch = "F9" in src_keys

    # ------------------------------------------------------------------
    # events / reporting
    # ------------------------------------------------------------------
    def _on_trigger_event(self, ev: TriggerEvent) -> None:
        """Console messages for trigger events.  The bus carries
        Enter/Stay/Exit; the app, as the reference's, reacts to Enter and
        Exit only (Stay fires every step while overlapping)."""
        if ev.phase is TriggerPhase.STAY:
            return
        self._trigger_log.append(ev)
        name = self.entity_label(ev.trigger_entity)
        other = self.entity_label(ev.other_entity)
        log.info("[Trigger] %s: %s <- %s", ev.phase.value, name, other)

    def entity_label(self, entity: int) -> str:
        """The reference's GetEntityLabel."""
        if self.built and 0 <= entity < len(self.built.entity_names):
            return f"{self.built.entity_names[entity]}#{entity}"
        return f"entity#{entity}"

    def status_line(self) -> str:
        c = self.built.counts
        hit = self.last_ray_hit
        parts = [self.state.time.reshape(1)]
        if hit is not None:
            parts += [hit.entity.to(torch.float32).reshape(1),
                      hit.distance.reshape(1)]
        values = torch.cat(parts).tolist()        # one read
        ray = ""
        if hit is not None and int(values[1]) != rc.NO_HIT:
            ray = (f" ray={self.entity_label(int(values[1]))}"
                   f"@{values[2]:.2f}")
        return (
            f"[App] fps={self.time.fps:.1f} frame={self.frame_count} "
            f"t={values[0]:.2f}s entities={c['entities']} "
            f"renderers={c['mesh_renderers']}{ray} {self.orbit.hud_line()}"
        )

    def physics_stats(self) -> str:
        """The F9 stats line."""
        c = self.built.counts
        ovf = ""
        ev = getattr(self, "_last_events", None)
        if ev is not None:
            ovf = f" contactOverflow={int(ev.contact_overflow.sum())}"
        return (
            f"[Physics] bodies={c['rigid_bodies']} colliders={c['colliders']} "
            f"characters={c['characters']} triggers={c['triggers']} "
            f"fixedStep={self.config.fixed_step:.6f} "
            f"steps={int(self.state.step_idx)}{ovf}"
        )

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def render_current_frame(self, hud: bool = False) -> np.ndarray:
        """uint8[H, W, 4] frame of the current state.  On the default
        path it renders the interpolated motion states: the accumulator's
        remainder blends the last two fixed steps, in the frame's own
        call.  With ``physics_overlay`` on (F3) the collision shapes of
        the current state are drawn over it as lines, depth-tested
        against the frame's own depth (the reference's debug-line pass,
        ``Application.cpp:359-360``), before the one read of the image;
        ``hud=True`` then draws the debug-text HUD on the host copy."""
        if self._render is None:
            self._render = {}
        prev = getattr(self, "_prev_state", None)
        interp = prev is not None and self.config.fixed_step > 0
        key = (bool(self.wireframe), interp)
        if key not in self._render:
            factory = make_interp_render_fn if interp else make_render_fn
            self._render[key] = factory(
                self.built.render, self.width, self.height,
                bin_capacity=2048, return_depth=True, wireframe=key[0],
            )
        values = self._camera_values()
        if interp:
            values.append(min(max(self._accumulator / self.config.fixed_step,
                                  0.0), 1.0))
        row = self._stage(values)
        view, proj, cam_pos, light = self._camera_from(row)
        if interp:
            frame, depth = self._render[key](
                prev, self.state, row[43], self.built.static, view, proj,
                cam_pos, light)
        else:
            frame, depth = self._render[key](
                self.state.world, view, proj, cam_pos, light)
        if self.physics_overlay:
            pts, cols, valid = collision_shape_lines(self.state,
                                                     self.built.static)
            frame = draw_lines(frame, depth, pts, cols, valid, view, proj)
        out = frame.cpu().numpy()
        if hud:
            out = compose_hud(out, standard_hud_lines(self))
        return out
