"""Free camera: position + yaw/pitch, view/projection matrices.

Counterpart of ``banggameengine_tpu/render/camera.py``: pitch clamped to
+-89 degrees, view by look-at along the yaw/pitch forward vector,
camera-local moves, defaults pos (0, 2, -7), yaw = pi/2 (facing +Z),
fovY 60 degrees, near 0.1, far 1000.  A host object; its matrices come
back as f32 tensors on the device the caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import math3d

_PITCH_LIMIT = np.deg2rad(89.0)


class Camera:
    def __init__(self):
        self.position = np.array([0.0, 2.0, -7.0], np.float32)
        self.yaw = float(np.pi / 2)   # facing +Z
        self.pitch = 0.0
        self.fov_y_deg = 60.0
        self.near = 0.1
        self.far = 1000.0

    def set_yaw_pitch(self, yaw: float, pitch: float) -> None:
        self.yaw = float(yaw)
        self.pitch = float(np.clip(pitch, -_PITCH_LIMIT, _PITCH_LIMIT))

    def add_yaw_pitch(self, dyaw: float, dpitch: float) -> None:
        self.set_yaw_pitch(self.yaw + dyaw, self.pitch + dpitch)

    def forward(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        return np.array(
            [np.cos(self.yaw) * cp, np.sin(self.pitch), np.sin(self.yaw) * cp],
            np.float32,
        )

    def right(self) -> np.ndarray:
        f = self.forward()
        r = np.cross(np.array([0.0, 1.0, 0.0], np.float32), f)
        n = np.linalg.norm(r)
        return (r / n if n > 1e-9
                else np.array([1, 0, 0], np.float32)).astype(np.float32)

    def move(self, local: np.ndarray) -> None:
        """Move in camera-local space (x = right, y = up, z = forward)."""
        up = np.array([0.0, 1.0, 0.0], np.float32)
        self.position = (self.position + self.right() * local[0]
                         + up * local[1]
                         + self.forward() * local[2]).astype(np.float32)

    def view_matrix(self, device: torch.device | str = "cuda") -> torch.Tensor:
        eye = torch.as_tensor(self.position, device=device)
        at = eye + torch.as_tensor(self.forward(), device=device)
        return math3d.mtx_look_at(eye, at)

    def proj_matrix(self, aspect: float,
                    device: torch.device | str = "cuda") -> torch.Tensor:
        return math3d.mtx_proj(self.fov_y_deg, aspect, self.near, self.far,
                               device=device)
