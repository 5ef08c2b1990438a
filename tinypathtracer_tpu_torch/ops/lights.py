"""Delta-light (point / directional / spot) evaluation (port of
`tinypathtracer_tpu/ops/lights.py`), in component form.

A light is one row of the [L, 16] lights table (`lights_block`; the JAX
package builds it as ops/mega.py `_lights_block`): kind, color rgb,
intensity, position xyz, direction xyz, cos_outer, inv_cone. The
kernels read the same rows and the same expressions (`csrc/shade.cuh`,
shared by kernel B and the modular bounce's kernels), at most
`MAX_LIGHTS` of them.
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.ops.shading_c import dot_c
from tinypathtracer_tpu_torch.utils.math3d import sqrt

POINT, DIRECTIONAL, SPOT = 0, 1, 2
MAX_LIGHTS = 6   # csrc/shade.cuh kMaxLights


def lights_block(data):
    """[max(L, 1), 16] lights table of a TraceData, one row per light:
    kind, color rgb, intensity, position xyz, direction xyz, cos_outer,
    inv_cone, 0 x3."""
    n = data.light_kind.shape[0]
    if n == 0:
        return data.light_color.new_zeros((1, 16))
    return torch.cat([
        data.light_kind.float()[:, None], data.light_color,
        data.light_intensity[:, None], data.light_pos, data.light_dir,
        data.light_cos_outer[:, None], data.light_inv_cone[:, None],
        data.light_color.new_zeros((n, 3))], dim=1).contiguous()


def sample_delta_light(px, py, pz, row):
    """Evaluate one light (row [16]) for shading points [N].

    Returns (wix, wiy, wiz, lr, lg, lb): the unit direction toward the
    light and the radiance with distance/cone attenuation (delta_light.h
    sample() + CalcDistAttenuation :25-33, radius-10 window baked in as
    0.01; directional lights have distance 0).
    """
    tlx, tly, tlz = row[5] - px, row[6] - py, row[7] - pz
    dist_ps = sqrt(torch.clamp_min(dot_c(tlx, tly, tlz, tlx, tly, tlz),
                                   1e-20))
    is_dir = row[0] == DIRECTIONAL
    wix = torch.where(is_dir, -row[8], tlx / dist_ps)
    wiy = torch.where(is_dir, -row[9], tly / dist_ps)
    wiz = torch.where(is_dir, -row[10], tlz / dist_ps)
    dist = torch.where(is_dir, 0.0, dist_ps)
    # spot cone falloff (delta_light.h:80-84)
    cos_theta = dot_c(-wix, -wiy, -wiz, row[8], row[9], row[10])
    cone = torch.clamp((cos_theta - row[11]) * row[12], 0.0, 1.0)
    falloff = torch.where(row[0] == SPOT, cone * cone, 1.0)
    d2 = dist * dist
    window = torch.clamp(1.0 - (d2 * 0.01) * (d2 * 0.01), 0.0, 1.0)
    fa = falloff * ((1.0 / (d2 + 1.0)) * (window * window))
    return (wix, wiy, wiz, row[1] * row[4] * fa, row[2] * row[4] * fa,
            row[3] * row[4] * fa)
