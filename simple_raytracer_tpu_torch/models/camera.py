"""Host camera: position + yaw/pitch + fov.

Mirrors Camera (include/helper.hpp:16-31) and the fov handling in
main.cpp:111-112 (fov_scale = tan(fov/2), default 90 degrees).  Also
implements the fly-camera motion used by the interactive loop
(main.cpp:221-240) so a viewer can drive it identically.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..ops.trace import CameraState


@dataclasses.dataclass
class Camera:
    position: tuple = (0.0, 0.0, 5.0)   # default scene camera (main.cpp:109)
    yaw: float = 0.0
    pitch: float = 0.0
    fov: float = math.pi / 2.0          # 90 degrees (main.cpp:111)

    @property
    def fov_scale(self) -> float:
        return math.tan(self.fov / 2.0)

    def rotation_matrix(self) -> np.ndarray:
        """3x3 RotY(yaw) @ RotX(pitch) — glm::eulerAngleYXZ(yaw, pitch, 0)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        return np.array([
            [cy, sy * sp, sy * cp],
            [0.0, cp, -sp],
            [-sy, cy * sp, cy * cp],
        ], np.float32)

    def move(self, horizontal: float, transversal: float, vertical: float,
             delta_time: float, speed: float = 15.0) -> None:
        """WASD/Space/C fly movement (main.cpp:221-235): horizontal and
        transversal are rotated into camera space, vertical is world-up."""
        r = self.rotation_matrix()
        v = r @ np.array([horizontal, 0.0, transversal], np.float32)
        v = v + np.array([0.0, vertical, 0.0], np.float32)
        n = np.linalg.norm(v)
        if n > 1e-12 and np.isfinite(n):
            v = v / n
            self.position = tuple(np.asarray(self.position, np.float32)
                                  + v * delta_time * speed)

    def look(self, xrel: float, yrel: float, delta_time: float,
             look_speed: float = 25.0) -> None:
        """Mouse-look (main.cpp:195-214)."""
        k = -math.pi * delta_time * look_speed * self.fov_scale / 1000.0
        self.yaw += k * xrel
        self.pitch += k * yrel

    def zoom(self, wheel: float) -> None:
        """Mouse-wheel fov change, 1 degree PER WHEEL NOTCH
        (main.cpp:186-193 applies 1 degree per SDL event; the HTTP
        client batches notches per input tick, so the magnitude here is
        the batched notch count, not just a direction)."""
        self.fov += (math.pi / 180.0) * wheel

    def state(self, aspect_ratio: float) -> CameraState:
        """The render pass's camera parameters, float32-rounded host
        scalars (the kernel takes them by value)."""
        f32 = lambda v: float(np.float32(v))
        return CameraState(
            position=tuple(f32(c) for c in self.position),
            yaw=f32(self.yaw), pitch=f32(self.pitch),
            aspect_ratio=f32(aspect_ratio), fov_scale=f32(self.fov_scale))
