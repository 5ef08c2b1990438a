"""Small 3D vector helpers on torch tensors.

Port of the device half of `tinypathtracer_tpu/utils/math3d.py`, for
the scene tables (world geometry, Woop planes). The helpers work on
(..., 3) tensors and round exactly as XLA:CPU rounds the JAX package's
versions (measured): XLA fuses each product sum into fused multiply-adds
(a dot product is fma(x2, y2, fma(x1, y1, x0 y0)), a cross component
fma(a1, b2, -(a2 b1))). The geometry the hit test reads is then
bit-equal to the JAX package's, so hits compare bit for bit.

`fma` computes a float32 fused multiply-add on any device; the CUDA
kernels use the hardware's (`fmaf`) for the same roundings. The per-ray
shading math (ops/shading_c.py) is unfused.
"""

from __future__ import annotations

import numpy as np
import torch

DELTA = float(np.float32(2e-4))  # self-intersection epsilon (reference vec.h)
REAL_MAX = float(np.finfo(np.float32).max)


def vdot(a, b):
    """Dot product over the trailing axis: fma(x2, y2, fma(x1, y1, x0 y0))."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def vcross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
                        fma(ax, by, -(ay * bx))], dim=-1)


def sqrt(x):
    """float32 square root, correctly rounded on every device (CUDA
    `sqrtf`). torch's vectorised CPU kernel is not: it is 1 ulp low on
    0.6 % of inputs (measured, AVX-512). The float64 root rounded to
    float32 is correctly rounded (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def rsqrt(x):
    """1 / sqrt(x), both correctly rounded. Not torch.rsqrt: that is the
    hardware's approximation on CUDA, which the kernels would then have
    to match instruction for instruction. (XLA:CPU's rsqrt is an
    approximation too; it differs from this by up to 1 ulp, measured.)"""
    return 1.0 / sqrt(x)


def f32_reciprocal(c: float) -> float:
    """1 / c rounded to float32, as a Python float (exact in float32).

    Inside jit, XLA rewrites a division by a constant, `x / c`, into
    `x * (1 / c)` with the reciprocal rounded to float32 (measured for
    `x / pi`: 15 % of quotients differ from the IEEE ones). The port
    multiplies by this constant where the JAX package divides by one,
    so its quotients are XLA's on every device; torch on CUDA makes the
    same rewrite for a tensor / Python-scalar division, torch on the CPU
    does not, so a plain `x / c` would differ between the two."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a, b, c):
    """float32 a * b + c with ONE rounding, as a fused multiply-add unit
    computes it (CUDA `fmaf`).

    The product of two float32 values is exact in float64; the sum is
    made exact with TwoSum and rounded to odd in float64, after which the
    final rounding to float32 is correctly rounded (round-to-odd needs
    53 >= 24 + 2 bits).
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # p + c == s + err exactly
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(fix, (bits + step).view(torch.float64), s)
    return s.float()
