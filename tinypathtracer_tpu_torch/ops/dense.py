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

The SUPER gate (the JAX package's, on scenes of _GATE_MIN_FACES padded
faces or more): the slots are cut into runs of SUPER, each with a box
(`WoopTris.sp_boxes`), and the runs are taken in ascending order; a warp
of the kernel tests a run only when one of its rays enters the run's box
no later than its best t so far, and a block stages it only when one of
its warps does. `_dense_schedule` is the plain model of that gate, run by
the tests and by chip_smoke.py (which holds the kernel's counts of runs
tested and staged to it); the twin visits only the runs it lets through.
The gate only skips work: the boxes are widened by a margin on the host,
so that the slab test's rounding cannot cull a hit the Woop test accepts
(the JAX package slab-tests unwidened boxes), and the outputs are the
ungated sweep's.
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

# Faces pad to a CLUSTER multiple up to _GATE_MIN_FACES faces and to a
# TILE_TRIS multiple above (the JAX package's rule, so both packages
# route the same scenes to the megakernel); from _GATE_MIN_FACES padded
# faces on, the sweep is gated per run of SUPER slots.
CLUSTER = 128
TILE_TRIS = 4096
SUPER = 1024
_GATE_MIN_FACES = 4096
# Box margin, relative to max(1, |bmin| + |bmax|) over the axes
BOX_MARGIN = 1e-5
_I32_MAX = 2**31 - 1
# (ray, triangle) pairs per tile of the plain scan: bounds its memory.
# On the card a larger tile (~1 GB of temporaries): there the twins run
# at the main path's shapes, and small tiles leave them bound by the
# host's launches. Each ray's result does not depend on the tiling.
_TILE_PAIRS = 1 << 21
_TILE_PAIRS_CUDA = 1 << 24
# kernel A's block: threads, and rays per thread (csrc/dense.cu kThreads,
# kRays); a warp holds LANES * DENSE_RAYS consecutive rays
DENSE_THREADS = 256
DENSE_RAYS = 4
LANES = 32


@dataclasses.dataclass
class WoopTris:
    """Triangles as unit-triangle transforms, in morton slot order.

    planes: [Fp, 12] f32, face-major: (W[0, 0:3], c0, W[1, 0:3], c1,
    W[2, 0:3], c2) per slot; padding slots are all-zero. perm: [Fp] i64,
    slot -> original face id (padding slots map to 0). sp_boxes: [8,
    Fp / sp] f32 per run of sp = SUPER slots (CLUSTER where SUPER does
    not divide Fp), the JAX package's layout: rows 0-2 bmin xyz, 3-5
    bmax xyz over the run's real faces (widened by the margin; an
    inverted box for an all-padding run), row 6 validity (0 for an
    all-padding run), row 7 zeros. The gate reads them.
    """

    planes: torch.Tensor
    perm: torch.Tensor
    sp_boxes: torch.Tensor
    n_faces: int

    @property
    def n_padded(self) -> int:
        return self.planes.shape[0]


def precompute_woop(tri_verts, margin: float = BOX_MARGIN) -> WoopTris:
    """[F, 3, 3] world-space triangles -> WoopTris (stable morton order),
    each valid run box widened by `margin` times max(1, |bmin| + |bmax|)
    (0: the JAX package's boxes, bit for bit)."""
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
    quantum = CLUSTER if f <= _GATE_MIN_FACES else TILE_TRIS
    pad = (-f) % quantum
    planes = torch.nn.functional.pad(planes, (0, 0, 0, pad))
    perm = torch.nn.functional.pad(order, (0, pad))
    fp = f + pad
    sp = SUPER if fp % SUPER == 0 else CLUSTER
    runs = fp // sp
    bmin = torch.nn.functional.pad(fb_min[order], (0, 0, 0, pad),
                                   value=REAL_MAX).reshape(runs, sp, 3)
    bmax = torch.nn.functional.pad(fb_max[order], (0, 0, 0, pad),
                                   value=-REAL_MAX).reshape(runs, sp, 3)
    sp_min, sp_max = bmin.amin(dim=1), bmax.amax(dim=1)
    valid = torch.arange(runs, device=tri_verts.device) * sp < f
    extent = (sp_min.abs() + sp_max.abs()).amax(dim=1).clamp_min(1.0)
    widen = torch.where(valid, margin * extent, 0.0)[:, None]
    sp_boxes = torch.cat([(sp_min - widen).T, (sp_max + widen).T,
                          valid[None].to(sp_min.dtype),
                          torch.zeros_like(sp_min[None, :, 0])])
    return WoopTris(planes=planes.contiguous(), perm=perm,
                    sp_boxes=sp_boxes.contiguous(), n_faces=f)


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
    tn = max(1, (_TILE_PAIRS_CUDA if dev.type == "cuda" else _TILE_PAIRS)
             // tf)
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


def reciprocals(d):
    """1 / d per component, correctly rounded (the float64 quotient
    rounded to float32), REAL_MAX where the component is zero: a ray
    parallel to a slab never culls a box it lies in."""
    zero = d == 0.0
    inv = (1.0 / torch.where(zero, 1.0, d).double()).float()
    return torch.where(zero, REAL_MAX, inv)


def slab(o, iv, boxes):
    """(near, far) [N, B] of rays (origins o [N, 3], reciprocals iv
    [N, 3]) against boxes [B, >= 6] (bmin xyz, bmax xyz). NaN-ignoring
    min and max, as CUDA's fminf / fmaxf."""
    t0 = (boxes[None, :, 0:3] - o[:, None]) * iv[:, None]     # [N, B, 3]
    t1 = (boxes[None, :, 3:6] - o[:, None]) * iv[:, None]
    lo, hi = torch.fmin(t0, t1), torch.fmax(t0, t1)
    near = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    far = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    return near, far


def run_need(o, iv, box, best_t, live):
    """[N] bool: the live rays (origins o [N, 3], reciprocals iv [N, 3])
    that need the run whose box [8] (WoopTris.sp_boxes' column) this is:
    they enter it at or beyond DELTA no later than their best t so far,
    and the box is valid."""
    near, far = slab(o, iv, box[None])
    near, far = near[:, 0], far[:, 0]
    entry = torch.fmax(near, torch.full_like(near, DELTA))
    return live & (far >= entry) & (near <= best_t) & (box[6] != 0.0)


def _run_scan(rays, planes, boxes, live, gated: bool):
    """The kernel's sweep over runs of SUPER slots, in ascending order,
    rays cut into the kernel's warps of LANES * DENSE_RAYS. Before each
    run a live ray needs it when gated is false, or when it enters the
    run's box (boxes [runs, 8]) at or beyond DELTA no later than its best
    t so far and the box is valid; a warp tests the run when one of its
    rays needs it, and then every live ray of the warp is tested against
    the run's slots and keeps a strictly smaller t. Returns (t [N],
    REAL_MAX on a miss; slot [N] i64, -1 on a miss; tested [warps, runs]
    bool)."""
    n, fp = rays.shape[0], planes.shape[0]
    dev, group = rays.device, LANES * DENSE_RAYS
    groups, runs = -(-n // group), -(-fp // SUPER)
    o, iv = rays[:, 0:3], reciprocals(rays[:, 3:6])
    col = [rays[:, k] for k in range(6)]
    best_t = torch.full((n,), REAL_MAX, device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tested = torch.zeros((groups, runs), dtype=torch.bool, device=dev)
    spare = groups * group - n
    for s in range(runs):
        need = run_need(o, iv, boxes[s], best_t, live) if gated else live
        grp = torch.nn.functional.pad(need, (0, spare)).view(groups, group)
        tested[:, s] = grp.any(dim=1)
        r = (tested[:, s].repeat_interleave(group)[:n] & live).nonzero()[:, 0]
        if r.numel() == 0:
            continue
        lo = s * SUPER
        ((t, slot),), _ = scan_queries(
            planes[lo:lo + SUPER], [c[r] for c in col[:3]],
            [[c[r] for c in col[3:]]], 1)
        take = t < best_t[r]
        best_t[r] = torch.where(take, t, best_t[r])
        best_s[r] = torch.where(take, lo + slot.long(), best_s[r])
    return best_t, best_s, tested


def winner_uv(rays, planes, slot):
    """[N, 2] (u, v) of each ray's winning slot, recomputed with the
    sweep's arithmetic (so bit-equal to the values it compared); 0 where
    slot is -1."""
    w = list(planes[torch.clamp_min(slot, 0).long()].T)
    o, d = rays[:, 0:3].T, rays[:, 3:6].T
    _, u, v = hit_terms(origin_terms(*o, w), *d, w)
    return torch.where((slot >= 0)[:, None], torch.stack([u, v], dim=1), 0.0)


def _dense_torch(rays, planes, sp_boxes=None, live=None):
    """Plain twin of kernel A. rays [N, 8] (origin xyz, direction xyz;
    columns 6-7 are not read); planes [Fp, 12]; sp_boxes: None (the
    ungated sweep) or WoopTris.sp_boxes with Fp / SUPER runs (the gated
    sweep, `_run_scan` in the kernel's warps); live: None or [N] bool,
    False = masked. Returns (t [N] f32, REAL_MAX on miss; slot [N] i32,
    -1 on miss; uv [N, 2] f32, 0 on miss) -- `_dense_xla`'s outputs on
    the live rays, a miss on masked ones."""
    if sp_boxes is None:
        o = (rays[:, 0], rays[:, 1], rays[:, 2])
        d = (rays[:, 3], rays[:, 4], rays[:, 5])
        ((t, slot),), _ = scan_queries(planes, o, [d], 1)
        if live is not None:
            t = torch.where(live, t, REAL_MAX)
            slot = torch.where(live, slot, -1)
    else:
        ones = torch.ones((rays.shape[0],), dtype=torch.bool,
                          device=rays.device)
        t, slot, _ = _run_scan(rays, planes, sp_boxes.T,
                               ones if live is None else live, True)
    return t, slot.int(), winner_uv(rays, planes, slot)


def gated(woop: WoopTris) -> bool:
    """Whether kernel A and its twin gate their sweep on this scene."""
    return woop.n_padded >= _GATE_MIN_FACES


def _dense_schedule(rays, woop: WoopTris, mask=None):
    """Plain model of kernel A's gate, for the tests and chip_smoke.py
    only: no route calls it. Rays are cut into blocks of DENSE_THREADS *
    DENSE_RAYS and warps of LANES * DENSE_RAYS consecutive rays, and the
    sweep runs as `_run_scan` does (gated when `gated(woop)`; masked
    rays never need a run). Returns ((t, slot, uv) as `_dense_torch`
    does; tested [blocks * warps a block] i32, the runs each warp
    tested (0 for a warp past the last ray); staged [blocks] i32, the
    runs each block staged: those one of its warps tested)."""
    n = rays.shape[0]
    live = (torch.ones((n,), dtype=torch.bool, device=rays.device)
            if mask is None else mask)
    t, slot, tested = _run_scan(rays, woop.planes, woop.sp_boxes.T, live,
                                gated(woop))
    warps = DENSE_THREADS // LANES
    blocks = -(-tested.shape[0] // warps)
    rows = torch.nn.functional.pad(tested, (0, 0, 0, blocks * warps
                                            - tested.shape[0]))
    staged = rows.view(blocks, warps, -1).any(dim=1).sum(dim=1)
    return ((t, slot.int(), winner_uv(rays, woop.planes, slot)),
            rows.sum(dim=1, dtype=torch.int32), staged.int())


@functools.cache
def _lib():
    lib = _bind(cuda_build.load_library("dense"))
    if geometry(lib) != (DENSE_THREADS, DENSE_RAYS):
        raise RuntimeError(f"csrc/dense.cu runs blocks of {geometry(lib)} "
                           f"(threads, rays a thread), ops/dense expects "
                           f"{(DENSE_THREADS, DENSE_RAYS)}")
    return lib


def _bind(lib):
    """Declare kernel A's C entry points on a loaded build (the kernel's
    or a lab variant's)."""
    lib.tpt_dense_hit.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
        + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
    lib.tpt_dense_hit.restype = ctypes.c_int
    lib.tpt_dense_resources.argtypes = [ctypes.c_void_p] * 3
    lib.tpt_dense_resources.restype = ctypes.c_int
    lib.tpt_dense_geometry.argtypes = [ctypes.c_void_p] * 2
    lib.tpt_dense_geometry.restype = ctypes.c_int
    return lib


def geometry(lib=None):
    """(threads per block, rays per thread) of a build of kernel A."""
    threads, per_thread = ctypes.c_int(), ctypes.c_int()
    (lib or _lib()).tpt_dense_geometry(ctypes.byref(threads),
                                       ctypes.byref(per_thread))
    return threads.value, per_thread.value


@functools.cache
def kernel_resources():
    """(registers per thread, local memory bytes per thread, blocks an
    SM) of kernel A, from cudaFuncGetAttributes and the occupancy
    query."""
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    status = _lib().tpt_dense_resources(ctypes.byref(regs),
                                        ctypes.byref(local),
                                        ctypes.byref(per_sm))
    cuda_build.check_launch(status, "dense_resources")
    return regs.value, local.value, per_sm.value


def _counts_ok(x, size, dev):
    return (x is None or (x.dtype == torch.int32 and x.device == dev
                          and x.is_contiguous() and x.shape == (size,)))


def _dense_cuda(rays, woop: WoopTris, live=None, tested=None, staged=None,
                lib=None):
    """Kernel A (or another build of it, `lib`). With `tested` and
    `staged` (int32, [warps] and [blocks] on the rays' device) it also
    writes the runs each warp tested and each block staged; the route
    passes none."""
    boxes = woop.sp_boxes if gated(woop) else None
    cuda_build.check_operands(rays, woop.planes,
                              *(() if boxes is None else (boxes,)))
    n, dev = rays.shape[0], rays.device
    if live is not None and not (live.dtype == torch.bool
                                 and live.device == dev
                                 and live.is_contiguous()
                                 and live.shape == (n,)):
        raise ValueError(f"mask must be a contiguous bool tensor of {n} on "
                         f"{dev}")
    lib = lib or _lib()
    threads, per_thread = geometry(lib)
    blocks = -(-n // (threads * per_thread))
    if not (_counts_ok(tested, blocks * threads // LANES, dev)
            and _counts_ok(staged, blocks, dev)):
        raise ValueError(f"tested and staged must be contiguous int32 "
                         f"tensors of {blocks * threads // LANES} and "
                         f"{blocks} on {dev}")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return t, slot, uv
    ptr = lambda x: None if x is None else x.data_ptr()    # noqa: E731
    status = lib.tpt_dense_hit(
        rays.data_ptr(), woop.planes.data_ptr(), ptr(boxes),
        0 if boxes is None else boxes.shape[1], ptr(live), n,
        woop.n_padded, t.data_ptr(), slot.data_ptr(), uv.data_ptr(),
        ptr(tested), ptr(staged), cuda_build.stream_ptr(dev))
    cuda_build.check_launch(status, "dense_hit")
    if lib is _lib():
        dense_hit.launches += 1
    return t, slot, uv


def dense_hit(rays, woop: WoopTris, mask=None):
    """Closest hit of rays [N, 8] against the scene's planes: kernel A
    on CUDA tensors, its plain twin on CPU tensors, gated exactly when
    `gated(woop)`. mask: None or [N] bool; masked rays report a miss.
    See `_dense_torch`."""
    if rays.shape[-1] != 8 or woop.planes.shape[-1] != 12:
        raise ValueError(f"bad shapes rays {tuple(rays.shape)}, "
                         f"planes {tuple(woop.planes.shape)}")
    if rays.device.type == "cuda":
        return _dense_cuda(rays, woop, mask)
    if rays.device.type == "cpu":
        return _dense_torch(rays, woop.planes,
                            woop.sp_boxes if gated(woop) else None, mask)
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

    Returns `face_hits`' (fid, t, uv). mask ([N] bool, optional): lanes
    with mask=False report a miss; they take no part in the gate.
    """
    n = origins.shape[0]
    rays = torch.cat([origins, dirs, origins.new_zeros((n, 2))], dim=1)
    if mask is not None:
        mask = mask.contiguous()
    return face_hits(*dense_hit(rays.contiguous(), woop, mask), woop, mask)
