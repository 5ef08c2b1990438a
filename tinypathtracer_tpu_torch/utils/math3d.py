"""Small 3D math helpers (port of `tinypathtracer_tpu/utils/math3d.py`).

Host half: numpy transform composition (TRS matrices, quaternions, the
normal matrix), float64 inside as in the JAX package, used while
flattening a glTF scene.

Device half: helpers on (..., 3) tensors, for the scene tables (world
geometry, Woop planes) and the physical estimator. `vdot` and `vcross`
round exactly as XLA:CPU rounds the JAX package's versions (measured):
XLA fuses each product sum into fused multiply-adds (a dot product is
fma(x2, y2, fma(x1, y1, x0 y0)), a cross component fma(a1, b2,
-(a2 b1))). The geometry the hit test reads is then bit-equal to the
JAX package's, so hits compare bit for bit.

`fma` computes a float32 fused multiply-add on any device; the CUDA
kernels use the hardware's (`fmaf`) for the same roundings. The per-ray
shading math (ops/shading_c.py) is unfused.
"""

from __future__ import annotations

import numpy as np
import torch

DELTA = float(np.float32(2e-4))  # self-intersection epsilon (reference vec.h)
REAL_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Host side (numpy, float64 inside): scene flattening.
# ---------------------------------------------------------------------------

def quat_to_mat3(q) -> np.ndarray:
    """Rotation matrix of a quaternion (x, y, z, w) (glTF order), as the
    reference builds it (quat.h:52-69): not normalised, so the zero
    quaternion of a node without rotation gives the identity."""
    x, y, z, w = [float(v) for v in q]
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array(
        [[1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy)],
         [2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx)],
         [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2)]],
        dtype=np.float64)


def trs_to_mat4(translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0, 0.0),
                scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """local->world = Translate @ Rotate @ Scale (transform.h:28-33)."""
    m = np.eye(4, dtype=np.float64)
    r = quat_to_mat3(np.asarray(rotation, dtype=np.float64))
    m[:3, :3] = r @ np.diag(np.asarray(scale, dtype=np.float64))
    m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def normal_matrix(l2w: np.ndarray) -> np.ndarray:
    """Inverse transpose of the linear part (mesh.cu:371-378)."""
    return np.linalg.inv(np.array(l2w[:3, :3], dtype=np.float64).T)


def euler_zxy_to_quat(angles_deg) -> np.ndarray:
    """Euler degrees (ZXY application order) -> quaternion (x, y, z, w)
    (quat.h:13-27)."""
    ax, ay, az = [np.deg2rad(float(a)) * 0.5 for a in angles_deg]
    cx, cy, cz = np.cos([ax, ay, az])
    sx, sy, sz = np.sin([ax, ay, az])
    return np.array([sx * cy * cz - cx * sy * sz,
                     cx * sy * cz + sx * cy * sz,
                     sx * sy * cz + cx * cy * sz,
                     cx * cy * cz - sx * sy * sz], dtype=np.float64)


# ---------------------------------------------------------------------------
# Device side: (..., 3) tensors.
# ---------------------------------------------------------------------------


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


def vnorm2(a):
    """Squared norm over the trailing axis (a fused dot product)."""
    return vdot(a, a)


def vnormalize(a, eps: float = 0.0):
    """a / |a| over the trailing axis, |a|^2 clamped below by eps."""
    return a * rsqrt(torch.clamp_min(vdot(a, a), eps))[..., None]


def transform_points(m4, pts):
    """A 4x4 (or [..., 4, 4]) applied to (..., 3) points (w = 1), each
    row a fused dot product."""
    return vdot(m4[..., :3, :3], pts[..., None, :]) + m4[..., :3, 3]


def transform_dirs(m4, dirs):
    """A 4x4 (or [..., 4, 4]) applied to (..., 3) directions (w = 0)."""
    return vdot(m4[..., :3, :3], dirs[..., None, :])


def reflect(d, n):
    """d mirrored about n (path_tracer.cu:137-141)."""
    return d - 2.0 * vdot(d, n)[..., None] * n


def build_onb(n):
    """Tangent frame (t, b) of unit normals n (..., 3), the reference's
    (sampler.h:75-79): t = normalize((1, 0, -n.x / n.z)), or (0, 0, 1)
    where n.z == 0, and b = cross(t, n)."""
    nx, nz = n[..., 0], n[..., 2]
    z_zero = nz == 0.0
    safe_nz = torch.where(z_zero, 1.0, nz)
    x_raw = torch.stack([torch.where(z_zero, 0.0, 1.0), torch.zeros_like(nx),
                         torch.where(z_zero, 1.0, -nx / safe_nz)], dim=-1)
    t = vnormalize(x_raw)
    return t, vcross(t, n)


class _FusedMulAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def fma_diff(a, b, c):
    """`fma` with the gradient of a * b + c (a, b, c of one shape);
    `fma` itself has none where its rounding fix applies."""
    return _FusedMulAdd.apply(a, b, c)


def _sum_seq(x):
    """Sum over the trailing axis, left to right in float32."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _pad_blocks(x, block: int):
    n = x.shape[-1]
    nb = -(-n // block)
    pad = x.new_zeros(x.shape[:-1] + (nb * block - n,))
    return torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (nb, block))


def xla_sum(x):
    """Sum over the trailing axis in the order XLA:CPU gives the JAX
    package's env-table row sums (measured on [H, W] float32 tables,
    W a power of two): XLA's tree-reduction rewriter cuts a reduction
    longer than 32 into windows of 32 consecutive elements, each summed
    left to right, and reduces the window sums the same way; a fused row
    of exactly 32 is summed in 8 lanes (element j into lane j % 8, left
    to right) whose totals are added as a tree; a shorter one left to
    right."""
    if x.shape[-1] == 32:
        lanes = ((x[..., 0:8] + x[..., 8:16]) + x[..., 16:24]) + x[..., 24:32]
        while lanes.shape[-1] > 1:
            half = lanes.shape[-1] // 2
            lanes = lanes[..., :half] + lanes[..., half:]
        return lanes[..., 0]
    while x.shape[-1] > 32:
        x = _sum_seq(_pad_blocks(x, 32))
    return _sum_seq(x)


def xla_cumsum(x):
    """Inclusive prefix sum over the trailing axis in XLA:CPU's order
    (`jnp.cumsum` is a reduce-window there, measured equal on every
    length tried, 16 to 61,452): XLA's reduce-window rewriter cuts the
    axis into blocks of 16, scans each left to right, scans the block
    totals the same way, and adds each block's preceding total."""
    n = x.shape[-1]
    if n <= 16:
        outs = [x[..., 0]]
        for j in range(1, n):
            outs.append(outs[-1] + x[..., j])
        return torch.stack(outs, dim=-1)
    local = xla_cumsum(_pad_blocks(x, 16))           # [..., nb, 16]
    totals = xla_cumsum(local[..., -1])               # [..., nb]
    before = torch.cat([totals.new_zeros(totals.shape[:-1] + (1,)),
                        totals[..., :-1]], dim=-1)
    return (local + before[..., None]).flatten(-2)[..., :n]
