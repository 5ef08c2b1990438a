"""Perspective camera (port of `tinypathtracer_tpu/models/camera.py`).

Reference: camera.h:9-66 (vertical field of view in radians from glTF,
aspect, near plane, TRS transform). Host-side numpy, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tinypathtracer_tpu_torch.utils.math3d import trs_to_mat4


@dataclasses.dataclass
class Camera:
    yfov: float = np.deg2rad(60.0)     # vertical FOV, radians
    aspect: float = 16.0 / 9.0
    znear: float = 0.1
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0, 0.0)   # quaternion (x, y, z, w)
    scale: tuple = (1.0, 1.0, 1.0)

    def camera_to_world(self) -> np.ndarray:
        """4x4 camera->world (the reference's Transform::localToWorld)."""
        return trs_to_mat4(self.translation, self.rotation,
                           self.scale).astype(np.float32)
