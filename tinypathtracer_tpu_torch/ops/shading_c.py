"""Component-form shading math of the bounce loop (port of
`tinypathtracer_tpu/ops/shading_c.py`).

Every per-lane quantity is a plain [N] tensor (vectors as three
components), each function an order-preserving transcription of the JAX
one: same operations, same association, no fused multiply-adds. The
kernels' shading (`csrc/shade.cuh`: kernel B's and the modular
bounce's) transcribes the same expressions, so their plain twins
(ops/mega.py, ops/shade.py) share these functions. Two operations that
torch rounds differently on the CPU and on CUDA are pinned down: square
roots are correctly rounded (`math3d.sqrt`, as CUDA's `sqrtf`), and a
division by a constant is the product with its float32 reciprocal, as
XLA compiles the JAX package's (`INV_PI`, `INV_2PI`). sin, cos, atan2
and acos are still the device library's.
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.utils.math3d import f32_reciprocal, rsqrt, sqrt

PI = 3.141592653589793
# the JAX package's `/ pi` and `/ (2 pi)`, as XLA computes them
INV_PI = f32_reciprocal(PI)
INV_2PI = f32_reciprocal(2.0 * PI)


def dot_c(ax, ay, az, bx, by, bz):
    """(a.x*b.x + a.y*b.y) + a.z*b.z."""
    return (ax * bx + ay * by) + az * bz


def normalize_c(ax, ay, az, eps=0.0):
    inv = rsqrt(torch.clamp_min((ax * ax + ay * ay) + az * az, eps))
    return ax * inv, ay * inv, az * inv


def reflect_c(dx, dy, dz, nx, ny, nz):
    """d - 2 (d.n) n."""
    k = 2.0 * dot_c(dx, dy, dz, nx, ny, nz)
    return dx - k * nx, dy - k * ny, dz - k * nz


def build_onb_c(nx, ny, nz):
    """Tangent frame of the reference (sampler.h:75-79): returns
    (tx, ty, tz, bx, by, bz); ty == 0 by construction."""
    z_zero = nz == 0.0
    safe_nz = torch.where(z_zero, 1.0, nz)
    rx = torch.where(z_zero, 0.0, 1.0)
    rz = torch.where(z_zero, 1.0, -nx / safe_nz)
    inv = rsqrt(torch.clamp_min(rx * rx + rz * rz, 0.0))
    tx, tz = rx * inv, rz * inv
    ty = torch.zeros_like(tx)
    # b = cross(t, n) with t.y == 0
    bx = ty * nz - tz * ny
    by = tz * nx - tx * nz
    bz = tx * ny - ty * nx
    return tx, ty, tz, bx, by, bz


def hemisphere_cosine_c(u1, u2, nx, ny, nz):
    """Cosine-weighted hemisphere sample (sampler.h:75-89). Returns
    (dx, dy, dz, pdf)."""
    phi = 2.0 * PI * u1
    cos_t = sqrt(u2)
    sin_t = sqrt(torch.clamp_min(1.0 - u2, 0.0))
    tx, ty, tz, bx, by, bz = build_onb_c(nx, ny, nz)
    a = torch.cos(phi) * sin_t
    c = torch.sin(phi) * sin_t
    dx = (a * tx + cos_t * nx) + c * bx
    dy = (a * ty + cos_t * ny) + c * by
    dz = (a * tz + cos_t * nz) + c * bz
    return dx, dy, dz, cos_t * INV_PI


def refract_reference_c(dx, dy, dz, nx, ny, nz, ior):
    """The reference's refraction. Returns (rx, ry, rz, cos_i_abs, eta, tir)."""
    cos_i = dot_c(dx, dy, dz, nx, ny, nz)
    exiting = cos_i > 0.0
    ior_safe = torch.where(ior > 0.0, ior, 1.0)
    eta = torch.where(exiting, ior_safe, 1.0 / ior_safe)
    sx = torch.where(exiting, -nx, nx)
    sy = torch.where(exiting, -ny, ny)
    sz = torch.where(exiting, -nz, nz)
    cos_i_abs = torch.abs(cos_i)
    sin2_t = eta * eta * (1.0 - cos_i_abs * cos_i_abs)
    tir = sin2_t >= 1.0
    cos_t = sqrt(torch.clamp_min(1.0 - torch.where(tir, 0.0, sin2_t), 0.0))
    k = cos_i_abs * eta - cos_t
    rx = torch.where(tir, 0.0, eta * dx + k * sx)
    ry = torch.where(tir, 0.0, eta * dy + k * sy)
    rz = torch.where(tir, 0.0, eta * dz + k * sz)
    return rx, ry, rz, cos_i_abs, eta, tir


def schlick_fresnel(cos_i, eta):
    f0 = (1.0 - eta) / (1.0 + eta)
    f0 = f0 * f0
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * m2 * m2 * m


def sample_bsdf_c(u1, u2, u3, dx, dy, dz, nx, ny, nz, eta, metallic):
    """BSDF sample without the base-color factor: Fresnel-coin
    dielectric, mirror, or cosine diffuse. Returns (ndx, ndy, ndz,
    ratio, is_specular); the throughput weight is base_color * ratio."""
    rfx, rfy, rfz, cos_i, eta_r, tir = refract_reference_c(
        dx, dy, dz, nx, ny, nz, eta)
    rlx, rly, rlz = reflect_c(dx, dy, dz, nx, ny, nz)
    fr = torch.where(tir, 1.0, schlick_fresnel(cos_i, eta_r))
    take_refl = u3 < fr
    ddx = torch.where(take_refl, rlx, rfx)
    ddy = torch.where(take_refl, rly, rfy)
    ddz = torch.where(take_refl, rlz, rfz)

    sign = torch.where(dot_c(dx, dy, dz, nx, ny, nz) > 0.0, -1.0, 1.0)
    nsx, nsy, nsz = nx * sign, ny * sign, nz * sign
    hx, hy, hz, pdf = hemisphere_cosine_c(u1, u2, nsx, nsy, nsz)
    cos_o = dot_c(hx, hy, hz, nsx, nsy, nsz)
    atten = torch.abs(cos_o) * INV_PI
    diff_ratio = atten / torch.clamp_min(pdf, 1e-12)

    is_dielec = eta > 0.0
    is_mirror = ~is_dielec & (metallic > 0.0)
    is_specular = is_dielec | is_mirror

    ndx = torch.where(is_dielec, ddx, torch.where(is_mirror, rlx, hx))
    ndy = torch.where(is_dielec, ddy, torch.where(is_mirror, rly, hy))
    ndz = torch.where(is_dielec, ddz, torch.where(is_mirror, rlz, hz))
    ratio = torch.where(is_specular, 1.0, diff_ratio)
    return ndx, ndy, ndz, ratio, is_specular


def env_texel_c(h: int, w: int, dx, dy, dz):
    """Equirect texel of a direction (env_light.cuh:72-78): +Y up,
    u = atan2(z, x) / 2pi wrapped to [0, 1), v = 1 - acos(y) / pi.
    Returns the flat texel index [N] i64 (row * w + col)."""
    u = torch.atan2(dz, dx) * INV_2PI
    u = torch.where(u < 0.0, u + 1.0, u)
    v = 1.0 - torch.acos(torch.clamp(dy, -1.0, 1.0)) * INV_PI
    col = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    row = torch.clamp(((1.0 - v) * h).to(torch.int32), 0, h - 1)
    return (row * w + col).long()
