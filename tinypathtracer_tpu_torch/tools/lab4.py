"""Kernel lab 4: the closest hit with the Woop transform on the tensor
cores (kernel D) and on the CUDA cores from staged triangles (kernel E),
beside the production dense kernel (kernel A). Port of
`tinypathtracer_tpu/tools/lab4.py`.

The TPU question was whether moving the transform's multiply-adds to the
matrix unit frees the vector unit for the epilogue. Here kernel D runs
them as mma.sync TF32 products (csrc/lab4.cu) and kernel E as plain
fp32 from a shared-memory tile that every thread of a block reads
(a broadcast). `tc` is the lab's sweep parameter: triangles per staged
tile.

Precision of kernel D, per instance (not the TPU's: its DEFAULT is one
bf16 pass): "highest" splits each operand into two TF32 parts, the
products small·big + big·small + big·big (3xTF32, the card's nearest to
fp32); "default" is one TF32 pass. Operands are rounded to TF32 as
`cvt.rna.tf32.f32` rounds (to nearest, ties away from zero). The twin
`_mxu_torch` emulates each instance with those roundings, exact
products and fp32 sums in the order k = 0..3 per product, then the
accumulator; the tensor cores' own order of accumulation is not fixed,
so kernel D is held to its twin and to kernel A by tolerance and by the
share of agreeing face ids. Kernel E's arithmetic is kernel A's (the
fused multiply-adds where XLA:CPU fuses the JAX kernel, measured): E
equals its twin `_vpu_rol_torch` and kernel A exactly.

Usage: python -m tinypathtracer_tpu_torch.tools.lab4 [--device cuda|cpu]
       [--n 1048576] [--f 1948]
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from tinypathtracer_tpu_torch.ops import dense
from tinypathtracer_tpu_torch.ops.dense import precompute_woop, scan_queries
from tinypathtracer_tpu_torch.tools import common
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX, fma

PRECISIONS = {"highest": 1, "default": 0}
_I32_MAX = 2**31 - 1
# (ray, triangle) pairs per tile of the plain twins: bounds their memory
_TILE_PAIRS = 1 << 21


def make_planes4(woop) -> torch.Tensor:
    """WoopTris -> [3 * Fp, 4] component-major plane rows [w0 w1 w2 c]:
    the x rows of every slot, then the y rows, then the z rows."""
    return torch.cat([woop.planes[:, 0:4], woop.planes[:, 4:8],
                      woop.planes[:, 8:12]], dim=0).contiguous()


def make_planesT(woop) -> torch.Tensor:
    """WoopTris -> [Fp, 12] triangle-major rows [wx0..3 | wy0..3 |
    wz0..3]: kernel A's plane table."""
    return woop.planes.contiguous()


def _check(rays8, planes, rows: int, tc: int, what: str):
    fp = planes.shape[0] // rows
    if (rays8.dim() != 2 or rays8.shape[0] != 8
            or planes.shape[-1] != 12 // rows or planes.shape[0] != rows * fp
            or tc % 16 or not 16 <= tc <= 1024 or fp % tc):
        raise ValueError(f"{what}: bad shapes rays8 {tuple(rays8.shape)}, "
                         f"planes {tuple(planes.shape)}, tc {tc} (a multiple "
                         "of 16 up to 1024 that divides the slots)")
    return fp


def _closest(tcand, best_t, best_i, base):
    """Fold the [R, T] candidates of slots base.. into the running best:
    the lowest slot among a tile's minima, taken on a strictly smaller t."""
    cmin = tcand.amin(dim=1)
    iota = torch.arange(base, base + tcand.shape[1], device=tcand.device,
                        dtype=torch.int32)
    cid = torch.where(tcand == cmin[:, None], iota, _I32_MAX).amin(dim=1)
    better = cmin < best_t
    return torch.where(better, cmin, best_t), torch.where(better, cid, best_i)


def _scan(rays8, fp, tile_fn):
    """Closest hit of every ray over fp slots, tile by tile, with kernel
    D's arithmetic: tile_fn(rs, f0, f1) -> (t, u, v) [R, f1 - f0] of the
    rays rs."""
    n = rays8.shape[1]
    tf = min(fp, 2048)
    tn = max(1, _TILE_PAIRS // tf)
    best_t = torch.full((n,), REAL_MAX, device=rays8.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=rays8.device)
    for r0 in range(0, n, tn):
        rs = slice(r0, r0 + tn)
        for f0 in range(0, fp, tf):
            t, u, v = tile_fn(rs, f0, min(fp, f0 + tf))
            ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
            best_t[rs], best_i[rs] = _closest(torch.where(ok, t, REAL_MAX),
                                              best_t[rs], best_i[rs], f0)
    return best_t, torch.where(best_t >= REAL_MAX, -1, best_i)


def _vpu_rol_torch(rays8, planesT, tc: int = 512):
    """Plain twin of kernel E: (t [N], fid [N] i32), kernel A's scan.
    `tc` only tiles the kernel's work; the result does not depend on it."""
    _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    ((t, fid),), _ = scan_queries(planesT, tuple(rays8[0:3]),
                                  [tuple(rays8[4:7])], 1)
    return t, fid


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away
    from zero), as cvt.rna.tf32.f32 computes it."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | (bits & -0x80000000)).view(torch.float32)


def _split(x, highest: bool):
    big = tf32_round(x)
    return big, (tf32_round(x - big) if highest else torch.zeros_like(x))


def _mma(acc, a, b):
    """acc + sum_k a[k] b[k] in fp32, k = 0..3 first, then the
    accumulator; TF32 products are exact in fp32."""
    s = a[0] * b[0]
    for k in range(1, 4):
        s = s + a[k] * b[k]
    return s + acc


def _mxu_torch(rays8, planes4, tc: int = 512, precision: str = "highest"):
    """Plain twin of kernel D: (t [N], fid [N] i32) with the kernel's
    TF32 roundings (module docstring)."""
    fp = _check(rays8, planes4, 3, tc, "mxu_closest_hit")
    highest = precision == "highest"
    o = [_split(rays8[k][:, None], highest) for k in range(4)]
    d = [_split(rays8[4 + k][:, None], highest) for k in range(4)]
    p = [[_split(planes4[c * fp:(c + 1) * fp, k][None], highest)
          for k in range(4)] for c in range(3)]

    def product(rs, cols, ray):
        """One component of o' or d' [R, T]: the kernel's mma sequence."""
        a_big, a_small = [c[0] for c in cols], [c[1] for c in cols]
        r_big, r_small = [r[0][rs] for r in ray], [r[1][rs] for r in ray]
        acc = 0.0
        if highest:
            acc = _mma(acc, a_small, r_big)
            acc = _mma(acc, a_big, r_small)
        return _mma(acc, a_big, r_big)

    def tile(rs, f0, f1):
        pc = [[(pk[0][:, f0:f1], pk[1][:, f0:f1]) for pk in comp]
              for comp in p]
        op = [product(rs, pc[c], o) for c in range(3)]
        dp = [product(rs, pc[c], d) for c in range(3)]
        t = -op[2] / dp[2]
        return t, fma(t, dp[0], op[0]), fma(t, dp[1], op[1])

    return _scan(rays8, fp, tile)


@functools.cache
def _lib():
    lib = cuda_build.load_library("lab4")
    lib.tpt_mxu_hit.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    lib.tpt_mxu_hit.restype = ctypes.c_int
    lib.tpt_vpu_rol_hit.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.tpt_vpu_rol_hit.restype = ctypes.c_int
    return lib


def _outputs(rays8):
    n = rays8.shape[1]
    return (torch.empty((n,), dtype=torch.float32, device=rays8.device),
            torch.empty((n,), dtype=torch.int32, device=rays8.device))


def mxu_closest_hit(rays8, planes4, tc: int = 512,
                    precision: str = "highest"):
    """Closest hit with the transform on the tensor cores: kernel D on
    CUDA tensors, its plain twin on CPU tensors. rays8 [8, N] (rows ox oy
    oz 1 dx dy dz 0), planes4 [3 * Fp, 4] (`make_planes4`); tc divides
    Fp. Returns (t [N], REAL_MAX on a miss; fid [N] i32, the slot, -1 on
    a miss)."""
    fp = _check(rays8, planes4, 3, tc, "mxu_closest_hit")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {list(PRECISIONS)}")
    if rays8.device.type == "cpu":
        return _mxu_torch(rays8, planes4, tc, precision)
    if rays8.device.type != "cuda":
        raise ValueError(f"mxu_closest_hit has no kernel for {rays8.device}")
    cuda_build.check_operands(rays8, planes4)
    t, fid = _outputs(rays8)
    if rays8.shape[1]:
        status = _lib().tpt_mxu_hit(
            rays8.data_ptr(), planes4.data_ptr(), rays8.shape[1], fp, tc,
            PRECISIONS[precision], t.data_ptr(), fid.data_ptr(),
            cuda_build.stream_ptr(rays8.device))
        cuda_build.check_launch(status, "mxu_closest_hit")
        mxu_closest_hit.launches += 1
    return t, fid


mxu_closest_hit.launches = 0


def vpu_rol_closest_hit(rays8, planesT, tc: int = 512):
    """The same closest hit on the CUDA cores, triangles staged tc at a
    time in shared memory: kernel E on CUDA tensors, its plain twin on
    CPU tensors. planesT [Fp, 12] (`make_planesT`). Returns (t, fid) as
    `mxu_closest_hit`."""
    fp = _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    if rays8.device.type == "cpu":
        return _vpu_rol_torch(rays8, planesT, tc)
    if rays8.device.type != "cuda":
        raise ValueError(f"vpu_rol_closest_hit has no kernel for "
                         f"{rays8.device}")
    cuda_build.check_operands(rays8, planesT)
    t, fid = _outputs(rays8)
    if rays8.shape[1]:
        status = _lib().tpt_vpu_rol_hit(
            rays8.data_ptr(), planesT.data_ptr(), rays8.shape[1], fp, tc,
            t.data_ptr(), fid.data_ptr(), cuda_build.stream_ptr(rays8.device))
        cuda_build.check_launch(status, "vpu_rol_closest_hit")
        vpu_rol_closest_hit.launches += 1
    return t, fid


vpu_rol_closest_hit.launches = 0


def test_data(n, f, dev, seed=0):
    """(woop, rays [N, 8] for kernel A, rays8 [8, N]): f random triangles
    in [0, 100]^3, n rays from random origins there in random directions,
    made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    tv = torch.from_numpy((rng.random((f, 3, 3)) * 100.0).astype(np.float32))
    o = (rng.random((n, 3)) * 100.0).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    woop = precompute_woop(tv.to(dev))
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ones = torch.ones((n, 1), device=dev)
    zeros = torch.zeros((n, 1), device=dev)
    rays = torch.cat([o, d, zeros, zeros], dim=1).contiguous()
    rays8 = torch.cat([o, ones, d, zeros], dim=1).T.contiguous()
    return woop, rays, rays8


def agreement(t, fid, t_ref, slot_ref):
    """(share of lanes with the reference's slot, max |dt| on the lanes
    where the reference hits)."""
    match = float((fid == slot_ref).float().mean())
    hit = slot_ref >= 0
    dt = float((t - t_ref)[hit].abs().max()) if bool(hit.any()) else 0.0
    return match, dt


def check_correctness(n=4096, f=1948, dev=torch.device("cuda")):
    """Kernels D (both instances) and E against kernel A's hits on the
    same rays: the share of equal slots and the max |dt| on hits.
    Returns {label: (share, max |dt|)}."""
    woop, rays, rays8 = test_data(n, f, dev)
    t_ref, slot_ref, _ = dense.dense_hit(rays, woop)
    planes4 = make_planes4(woop)
    res = {}
    for label, (t, fid) in (
            ("mxu highest", mxu_closest_hit(rays8, planes4,
                                            precision="highest")),
            ("mxu default", mxu_closest_hit(rays8, planes4,
                                            precision="default")),
            ("vpu_rol", vpu_rol_closest_hit(rays8, make_planesT(woop)))):
        res[label] = agreement(t, fid, t_ref, slot_ref)
        print(f"  {label}: fid match {res[label][0]:.6f}, max |dt| on hits "
              f"{res[label][1]:.3e}", flush=True)
    return res


def _rate(fn, n, fp, dev, reps):
    ms = common.timed_ms(fn, dev, reps)
    return ms, n * fp / (ms * 1e-3)


def mxu_rate(n=1 << 20, f=1948, tc=512, precision="highest",
             dev=torch.device("cuda"), reps=10):
    """(ms per call, pairs/s) of kernel D on n rays x f triangles."""
    woop, _, rays8 = test_data(n, f, dev)
    planes4 = make_planes4(woop)
    return _rate(lambda: mxu_closest_hit(rays8, planes4, tc, precision), n,
                 woop.n_padded, dev, reps)


def vpu_rol_rate(n=1 << 20, f=1948, tc=512, dev=torch.device("cuda"),
                 reps=10):
    """(ms per call, pairs/s) of kernel E."""
    woop, _, rays8 = test_data(n, f, dev)
    planesT = make_planesT(woop)
    return _rate(lambda: vpu_rol_closest_hit(rays8, planesT, tc), n,
                 woop.n_padded, dev, reps)


def baseline_rate(n=1 << 20, f=1948, dev=torch.device("cuda"), reps=10):
    """(ms per call, pairs/s) of kernel A, the production dense kernel."""
    woop, rays, _ = test_data(n, f, dev)
    return _rate(lambda: dense.dense_hit(rays, woop), n,
                 woop.n_padded, dev, reps)


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--f", type=int, default=1948)
    ap.add_argument("--reps", type=int, default=10)
    args, dev = common.parse(ap, argv, "lab4")
    kw = dict(n=args.n, f=args.f, dev=dev, reps=args.reps)
    print("correctness (vs production dense kernel):", flush=True)
    check_correctness(min(args.n, 4096), args.f, dev)
    res = {"device": common.device_name(dev), "n_rays": args.n}
    t, rate = baseline_rate(**kw)
    res["baseline_1Mx2048_ms"] = t
    res["baseline_gpairs_per_s"] = rate / 1e9
    for tc in (256, 512, 1024):
        t, rate = mxu_rate(tc=tc, **kw)
        res[f"mxu_tc{tc}_highest_ms"] = t
        res[f"mxu_tc{tc}_highest_gpairs_per_s"] = rate / 1e9
    t, rate = mxu_rate(tc=512, precision="default", **kw)
    res["mxu_tc512_default_ms"] = t
    res["mxu_tc512_default_gpairs_per_s"] = rate / 1e9
    for tc in (256, 512):
        t, rate = vpu_rol_rate(tc=tc, **kw)
        res[f"vpu_rol_tc{tc}_ms"] = t
        res[f"vpu_rol_tc{tc}_gpairs_per_s"] = rate / 1e9
    print(json.dumps(res, indent=2), flush=True)
    return res


if __name__ == "__main__":
    main()
