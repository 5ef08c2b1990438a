"""BSDF sampling: lambertian / mirror / dielectric lobes (port of
`tinypathtracer_tpu/ops/bsdf.py`), on (..., 3) tensors.

The reference's shading model (path_tracer.cu:137-225): every lane
evaluates the three lobes and selects, in priority order, the
dielectric (eta > 0: a Fresnel coin between mirror reflection and
refraction, weight 1), the mirror (metallic > 0, weight 1), else the
cosine-hemisphere diffuse lobe around the side-corrected normal (weight
cos / pi over pdf cos / pi). The throughput gains a base-color factor.
These share the bounce loop's component-form arithmetic
(ops/shading_c.py).
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.ops import shading_c
from tinypathtracer_tpu_torch.ops.sampling import split, uniform, uniform2

schlick_fresnel = shading_c.schlick_fresnel


def refract_reference(d, n, ior):
    """The reference's `refract` (path_tracer.cu:143-163). d: incoming
    directions [N, 3]; n: geometric-side normals [N, 3]; ior [N].
    Returns (refracted [N, 3], cos_theta_i [N], eta [N], tir [N])."""
    rx, ry, rz, cos_i, eta, tir = shading_c.refract_reference_c(
        *d.unbind(dim=-1), *n.unbind(dim=-1), ior)
    return torch.stack([rx, ry, rz], dim=-1), cos_i, eta, tir


def sample_bsdf_u(u_hemi1, u_hemi2, u_coin, d, n, eta, metallic, base_color):
    """Next directions of surface interactions from raw uniforms [N]
    (diffuse hemisphere, Fresnel coin). d, n: unit [N, 3]; eta,
    metallic [N]; base_color [N, 3]. Returns (next_dir [N, 3], weight
    [N, 3] = base_color * atten / pdf, is_specular [N])."""
    ndx, ndy, ndz, ratio, is_spec = shading_c.sample_bsdf_c(
        u_hemi1, u_hemi2, u_coin, *d.unbind(dim=-1), *n.unbind(dim=-1),
        eta, metallic)
    return (torch.stack([ndx, ndy, ndz], dim=-1),
            base_color * ratio[..., None], is_spec)


def sample_bsdf(key, d, n, eta, metallic, base_color):
    """Key-based wrapper over sample_bsdf_u."""
    k_diff, k_flip = split(key)
    u1, u2 = uniform2(k_diff, d.shape[:-1])
    u_coin = uniform(k_flip, tuple(d.shape[:-1]))
    return sample_bsdf_u(u1, u2, u_coin, d, n, eta, metallic, base_color)
