"""Third-person orbit camera controller.

A copy of ``banggameengine_tpu/app/orbit.py`` (the JAX package cannot be
imported without JAX), its logic unchanged; the target's world matrix may
be a tensor on the card, read in one device-to-host copy.

Re-design of ``src/camera/CameraOrbitController.{h,cpp}`` with the same
observable behavior and the same ``assets/config/camera.json`` schema:

- orbits the entity with logical id ``targetId`` (default "cj"); target
  position read from world matrix column 3
  (``CameraOrbitController.cpp:310-342``); last position remembered if the
  entity disappears;
- look only while the OrbitLook action (RMB) is held
  (``:237-256``); LookX/LookY axes scaled by ``sensLook``; optional invertY;
- pitch clamped to [-85 deg, -5 deg] (``:37-38``), distance clamped to
  [1.5, 12] by the Zoom axis * sensZoom (``:275-283``);
- exponential smoothing ``1 - exp(-smoothFactor * dt)`` with the yaw lerped
  through sin/cos so crossing +/-pi never takes the long way (``:285-308``);
- OrbitReset (R) restores config yaw/pitch/distance; OrbitCancel (Esc)
  releases the look; mtime-based config hot reload (``:66-170``).
"""

from __future__ import annotations

import json
import logging
import math
import os

import numpy as np
import torch

log = logging.getLogger("CameraOrbit")

_PITCH_MIN = math.radians(-85.0)
_PITCH_MAX = math.radians(-5.0)
_DIST_MIN = 1.5
_DIST_MAX = 12.0


class CameraOrbitController:
    def __init__(self, camera, input_system, target_id: str = "cj"):
        self.camera = camera
        self.input = input_system
        self.target_id = target_id

        # config defaults (camera.json schema)
        self.cfg_yaw = math.radians(90.0)
        self.cfg_pitch = math.radians(-20.0)
        self.cfg_distance = 6.0
        self.sens_look = 1.0
        self.sens_zoom = 1.0
        self.invert_y = False
        self.smoothing = True
        self.smooth_factor = 8.0

        self._config_path: str | None = None
        self._config_mtime = 0.0

        # live state
        self.target_yaw = self.cfg_yaw
        self.target_pitch = self.cfg_pitch
        self.target_distance = self.cfg_distance
        self.yaw = self.cfg_yaw
        self.pitch = self.cfg_pitch
        self.distance = self.cfg_distance
        self.looking = False
        self._last_target_pos = np.zeros(3, np.float32)

    # -- config ---------------------------------------------------------------
    def load_config(self, path: str) -> bool:
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            log.warning("[CameraOrbit] config load failed: %s", e)
            return False
        self.target_id = str(data.get("targetId", self.target_id))
        self.cfg_yaw = math.radians(float(data.get("yawDeg", 90.0)))
        self.cfg_pitch = math.radians(float(data.get("pitchDeg", -20.0)))
        self.cfg_distance = float(data.get("distance", 6.0))
        self.sens_look = float(data.get("sensLook", 1.0))
        self.sens_zoom = float(data.get("sensZoom", 1.0))
        self.invert_y = bool(data.get("invertY", False))
        self.smoothing = bool(data.get("smoothing", True))
        self.smooth_factor = float(data.get("smoothFactor", 8.0))
        self._config_path = path
        try:
            self._config_mtime = os.path.getmtime(path)
        except OSError:
            self._config_mtime = 0.0
        self.reset()
        return True

    def reload_config_if_needed(self) -> bool:
        if not self._config_path:
            return False
        try:
            m = os.path.getmtime(self._config_path)
        except OSError:
            return False
        if m > self._config_mtime:
            return self.load_config(self._config_path)
        return False

    def reset(self) -> None:
        self.target_yaw = self.cfg_yaw
        self.target_pitch = self.cfg_pitch
        self.target_distance = self.cfg_distance

    def on_scene_reloaded(self) -> None:
        """CameraOrbitController.cpp:184-187: forget stale target pos."""
        self._last_target_pos = np.zeros(3, np.float32)

    # -- per-frame ------------------------------------------------------------
    def update(self, dt: float, scene_worlds, target_entity: int) -> None:
        """scene_worlds: f32[N,4,4] world matrices (a host array or a
        tensor); target_entity: index of the orbit target, -1 if
        missing."""
        inp = self.input

        # look gating by OrbitLook (RMB held); Esc cancels
        if inp.action_held("OrbitLook"):
            self.looking = True
        if inp.action_pressed("OrbitCancel") or not inp.action_held("OrbitLook"):
            self.looking = False
        if inp.action_pressed("OrbitReset"):
            self.reset()

        if self.looking:
            dyaw = inp.get_axis("LookX") * self.sens_look
            dpitch = inp.get_axis("LookY") * self.sens_look
            if self.invert_y:
                dpitch = -dpitch
            self.target_yaw += dyaw
            self.target_pitch = float(
                np.clip(self.target_pitch - dpitch, _PITCH_MIN, _PITCH_MAX)
            )

        zoom = inp.get_axis("Zoom") * self.sens_zoom
        if zoom:
            self.target_distance = float(
                np.clip(self.target_distance + zoom * 4.0 * dt * 60.0 / 60.0,
                        _DIST_MIN, _DIST_MAX)
            )

        # smoothing: alpha = 1 - exp(-k dt); yaw via sin/cos blend (crossing
        # +/-pi takes the short way, CameraOrbitController.cpp:285-308)
        if self.smoothing:
            a = 1.0 - math.exp(-self.smooth_factor * max(dt, 0.0))
        else:
            a = 1.0
        sy = math.sin(self.yaw) + (math.sin(self.target_yaw) - math.sin(self.yaw)) * a
        cy = math.cos(self.yaw) + (math.cos(self.target_yaw) - math.cos(self.yaw)) * a
        self.yaw = math.atan2(sy, cy)
        self.pitch += (self.target_pitch - self.pitch) * a
        self.distance += (self.target_distance - self.distance) * a

        # target position from world matrix column 3
        if target_entity >= 0:
            w = scene_worlds[target_entity]
            if isinstance(w, torch.Tensor):
                w = w.cpu().numpy()     # a blocking read: one copy
            self._last_target_pos = np.asarray(w)[:3, 3].astype(np.float32)
        tpos = self._last_target_pos

        cp = math.cos(self.pitch)
        forward = np.array(
            [math.cos(self.yaw) * cp, math.sin(self.pitch), math.sin(self.yaw) * cp],
            np.float32,
        )
        self.camera.position = (tpos - forward * self.distance).astype(np.float32)
        self.camera.set_yaw_pitch(self.yaw, self.pitch)

    def hud_line(self) -> str:
        return (
            f"Orbit[{self.target_id}] yaw={math.degrees(self.yaw):.1f} "
            f"pitch={math.degrees(self.pitch):.1f} dist={self.distance:.2f} "
            f"look={'ON' if self.looking else 'off'}"
        )
