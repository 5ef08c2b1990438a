"""Dense ray x triangle closest hit (port of `tinypathtracer_tpu/ops/dense.py`).

Every ray is tested against every triangle, each triangle stored as
Woop's unit-triangle transform (12 plane floats): o' = W o + c,
d' = W d, t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y; hit iff
u, v >= 0, u + v <= 1 and t > DELTA. Triangles sit in morton order of
their centroids ("slots"), padding slots hold all-zero planes (t = NaN,
rejected), and among equal t the lowest slot wins.

The CUDA kernel (`csrc/dense.cu`, kernel A) replaces the TPU kernel
`_make_dense_kernel`. `_dense_torch` is its plain PyTorch twin: same
inputs, same outputs, same arithmetic. `dense_hit` dispatches on the
tensors' device: CPU tensors take the twin, CUDA tensors launch the
kernel, anything else raises.

Hit arithmetic: each three-term product sum is computed as
fma(z, c, fma(x, a, y * b)) and u, v as fma(t, d'x, o'x) -- the single
roundings XLA:CPU produces for the JAX reference's hit test (measured),
so (slot, t, u, v) are bit-equal to the JAX package on the CPU. The
CUDA kernel writes these FMAs explicitly and is compiled with
--fmad=false; the twin emulates them exactly (utils/math3d.fma).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tinypathtracer_tpu_torch.ops.lbvh import morton30
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import (DELTA, REAL_MAX, fma,
                                                   vcross, vdot)

# Faces pad to a CLUSTER multiple up to _BIG_SCENE faces and to a
# TILE_TRIS multiple above (the JAX package's rule, so both packages
# route the same scenes to the megakernel).
CLUSTER = 128
TILE_TRIS = 4096
_BIG_SCENE = 4096
_I32_MAX = 2**31 - 1
# (ray, triangle) pairs per tile of the plain scan: bounds its memory
_TILE_PAIRS = 1 << 21


@dataclasses.dataclass
class WoopTris:
    """Triangles as unit-triangle transforms, in morton slot order.

    planes: [Fp, 12] f32, face-major: (W[0, 0:3], c0, W[1, 0:3], c1,
    W[2, 0:3], c2) per slot; padding slots are all-zero. perm: [Fp] i64,
    slot -> original face id (padding slots map to 0).
    """

    planes: torch.Tensor
    perm: torch.Tensor
    n_faces: int

    @property
    def n_padded(self) -> int:
        return self.planes.shape[0]


def precompute_woop(tri_verts) -> WoopTris:
    """[F, 3, 3] world-space triangles -> WoopTris (stable morton order)."""
    f = tri_verts.shape[0]
    fb_min = tri_verts.amin(dim=1)
    fb_max = tri_verts.amax(dim=1)
    cent = 0.5 * (fb_min + fb_max)
    codes = morton30(cent, fb_min.amin(dim=0), fb_max.amax(dim=0))
    order = torch.argsort(codes, stable=True)      # ties keep file order
    tv = tri_verts[order]

    v0 = tv[:, 0]
    e1 = tv[:, 1] - v0
    e2 = tv[:, 2] - v0
    n = vcross(e1, e2)
    det = vdot(n, n)[:, None]                      # det([e1 e2 n]) = |n|^2
    ok = det > 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    # rows of M^-1 for M = [e1 e2 n] (columns): cross-product adjugate
    w = torch.stack([vcross(e2, n) * inv, vcross(n, e1) * inv, n * inv],
                    dim=1)                         # [F, 3(row), 3(col)]
    c = -vdot(w, v0[:, None, :])                   # [F, 3]
    planes = torch.cat([w, c[:, :, None]], dim=2).reshape(f, 12)
    quantum = CLUSTER if f <= _BIG_SCENE else TILE_TRIS
    pad = (-f) % quantum
    planes = torch.nn.functional.pad(planes, (0, 0, 0, pad))
    perm = torch.nn.functional.pad(order, (0, pad))
    return WoopTris(planes=planes.contiguous(), perm=perm, n_faces=f)


def _affine(x, y, z, a, b, c):
    """x a + y b + z c with XLA:CPU's rounding: fma(z, c, fma(x, a, y b))."""
    return fma(z, c, fma(x, a, y * b))


def hit_terms(op, dx, dy, dz, w):
    """(t, u, v) of a direction against plane columns w[0..11], given the
    origin's transformed point op = (o'x, o'y, o'z)."""
    opx, opy, opz = op
    dpx = _affine(dx, dy, dz, w[0], w[1], w[2])
    dpy = _affine(dx, dy, dz, w[4], w[5], w[6])
    dpz = _affine(dx, dy, dz, w[8], w[9], w[10])
    t = -opz / dpz               # inf/NaN on parallel/degenerate: rejected
    return t, fma(t, dpx, opx), fma(t, dpy, opy)


def origin_terms(ox, oy, oz, w):
    """o' = W o + c against plane columns w[0..11]."""
    return (_affine(ox, oy, oz, w[0], w[1], w[2]) + w[3],
            _affine(ox, oy, oz, w[4], w[5], w[6]) + w[7],
            _affine(ox, oy, oz, w[8], w[9], w[10]) + w[11])


def scan_queries(planes, origin, dirs, n_closest: int):
    """Plain scan of several directions from one origin per ray over
    all triangles, in tiles of rays x triangles.

    origin: (ox, oy, oz) [N]; dirs: list of (dx, dy, dz) [N]. The first
    n_closest directions are closest-hit queries -> (t [N], slot [N] i32,
    -1 = miss); the rest are any-hit queries -> occluded [N] bool.
    """
    ox, oy, oz = origin
    n, fp = ox.shape[0], planes.shape[0]
    dev = ox.device
    tf = min(TILE_TRIS, fp)
    tn = max(1, _TILE_PAIRS // tf)
    best_t = [torch.full((n,), REAL_MAX, device=dev) for _ in range(n_closest)]
    best_i = [torch.zeros((n,), dtype=torch.int32, device=dev)
              for _ in range(n_closest)]
    occ = [torch.zeros((n,), dtype=torch.bool, device=dev)
           for _ in range(len(dirs) - n_closest)]
    for r0 in range(0, n, tn):
        rs = slice(r0, r0 + tn)
        col = lambda x: x[rs, None]                  # noqa: E731
        for f0 in range(0, fp, tf):
            w = list(planes[f0:f0 + tf].T[:, None, :])   # 12 x [1, tf]
            op = origin_terms(col(ox), col(oy), col(oz), w)
            for q, (dx, dy, dz) in enumerate(dirs):
                t, u, v = hit_terms(op, col(dx), col(dy), col(dz), w)
                ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
                if q < n_closest:
                    tc = torch.where(ok, t, REAL_MAX)
                    cmin = tc.amin(dim=1)
                    iota = torch.arange(f0, f0 + tc.shape[1], device=dev,
                                        dtype=torch.int32)
                    cid = torch.where(tc == cmin[:, None], iota,
                                      _I32_MAX).amin(dim=1)
                    better = cmin < best_t[q][rs]
                    best_i[q][rs] = torch.where(better, cid, best_i[q][rs])
                    best_t[q][rs] = torch.where(better, cmin, best_t[q][rs])
                else:
                    occ[q - n_closest][rs] |= ok.any(dim=1)
    closest = [(bt, torch.where(bt >= REAL_MAX, -1, bi))
               for bt, bi in zip(best_t, best_i)]
    return closest, occ


def _dense_torch(rays, planes):
    """Plain twin of kernel A. rays [N, 8] (origin xyz, 0, dir xyz, 0 --
    only columns 0-5 are read); planes [Fp, 12]. Returns (t [N] f32,
    REAL_MAX on miss; slot [N] i32, -1 on miss; uv [N, 2] f32, 0 on
    miss) -- `_dense_xla`'s outputs."""
    o = (rays[:, 0], rays[:, 1], rays[:, 2])
    d = (rays[:, 3], rays[:, 4], rays[:, 5])
    ((t, slot),), _ = scan_queries(planes, o, [d], 1)
    # the winner's (u, v): recomputed with the scan's arithmetic, so
    # bit-equal to the values the scan compared
    w = list(planes[torch.clamp_min(slot, 0).long()].T)
    _, u, v = hit_terms(origin_terms(*o, w), *d, w)
    hit = (slot >= 0)[:, None]
    return t, slot, torch.where(hit, torch.stack([u, v], dim=1), 0.0)


@functools.cache
def _lib():
    lib = cuda_build.load_library("dense")
    lib.tpt_dense_hit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.tpt_dense_hit.restype = ctypes.c_int
    return lib


def _dense_cuda(rays, planes):
    cuda_build.check_operands(rays, planes)
    n, fp = rays.shape[0], planes.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    slot = torch.empty((n,), dtype=torch.int32, device=rays.device)
    uv = torch.empty((n, 2), dtype=torch.float32, device=rays.device)
    if n == 0:
        return t, slot, uv
    status = _lib().tpt_dense_hit(
        rays.data_ptr(), planes.data_ptr(), n, fp, t.data_ptr(),
        slot.data_ptr(), uv.data_ptr(), cuda_build.stream_ptr(rays.device))
    cuda_build.check_launch(status, "dense_hit")
    dense_hit.launches += 1
    return t, slot, uv


def dense_hit(rays, planes):
    """Closest hit of rays [N, 8] against planes [Fp, 12]: kernel A on
    CUDA tensors, its plain twin on CPU tensors. See `_dense_torch`."""
    if rays.shape[-1] != 8 or planes.shape[-1] != 12:
        raise ValueError(f"bad shapes rays {tuple(rays.shape)}, "
                         f"planes {tuple(planes.shape)}")
    if rays.device.type == "cuda":
        return _dense_cuda(rays, planes)
    if rays.device.type == "cpu":
        return _dense_torch(rays, planes)
    raise ValueError(f"dense_hit has no kernel for device {rays.device}")


dense_hit.launches = 0


def face_hits(t, slot, uv, woop: WoopTris, mask=None):
    """A closest-hit kernel's (t, slot, uv) as the intersectors report
    them: (fid [N] i64, original face id, -1 = miss; t [N] f32, REAL_MAX
    on miss; uv [N, 2] f32, 0 on miss). Slots at or above n_faces and
    lanes with mask=False become misses."""
    fid = torch.where(slot >= woop.n_faces, -1, slot.long())
    if mask is not None:
        fid = torch.where(mask, fid, -1)
    t = torch.where(fid < 0, REAL_MAX, t)
    uv = torch.where((fid >= 0)[:, None], uv, 0.0)
    return torch.where(fid >= 0, woop.perm[torch.clamp_min(fid, 0)], -1), t, uv


def closest_hit_dense(origins, dirs, woop: WoopTris, mask=None):
    """Closest hit against all triangles. origins/dirs: [N, 3].

    Returns `face_hits`' (fid, t, uv). mask ([N] bool, optional) is
    semantics only: lanes with mask=False report miss.
    """
    n = origins.shape[0]
    rays = torch.cat([origins, dirs, origins.new_zeros((n, 2))], dim=1)
    return face_hits(*dense_hit(rays.contiguous(), woop.planes), woop, mask)
