"""Primary (camera) ray generation (port of
`tinypathtracer_tpu/render/raygen.py`).

Jittered pixel position on a pinhole sensor of height 2 tan(yfov / 2)
at unit focal distance, rotated to world space. Pixel row 0 maps to the
sensor bottom; the film flips the image.
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.ops.sampling import uniform
from tinypathtracer_tpu_torch.ops.shading_c import normalize_c


def camera_rays_u(u, cam_to_world, yfov, aspect, px, py, width, height):
    """Primary rays for pixel coordinates px, py [N] (ints) from raw
    per-lane uniforms u [N, 2]. Returns (origins [N, 3], dirs [N, 3]).
    The camera rotation is applied in component form (no matmul)."""
    tan_half = torch.tan(0.5 * yfov)
    sensor_h = 2.0 * tan_half
    sensor_w = aspect * sensor_h
    sx = (px.float() + u[:, 0]) / width * sensor_w
    sy = (py.float() + u[:, 1]) / height * sensor_h
    cx = sx - 0.5 * sensor_w
    cy = sy - 0.5 * sensor_h
    cz = -torch.ones_like(sx)
    rot = cam_to_world[:3, :3]
    d = [(cx * rot[i, 0] + cy * rot[i, 1]) + cz * rot[i, 2] for i in range(3)]
    d = torch.stack(normalize_c(*d), dim=1)
    return cam_to_world[:3, 3].expand_as(d), d


def camera_rays(key, cam_to_world, yfov, aspect, px, py, width, height):
    """Key-based wrapper over camera_rays_u: one [2] key, draws
    `uniform(key, px.shape + (2,))`."""
    u = uniform(key, tuple(px.shape) + (2,))
    return camera_rays_u(u, cam_to_world, yfov, aspect, px, py, width, height)
