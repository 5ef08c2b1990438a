"""Kernel lab 5 diagnosis: stripped variants of the v1 packet kernel,
to attribute its fixed cost per packet (kernel F). Port of
`tinypathtracer_tpu/tools/lab5_diag.py`.

A packet is 8 consecutive rays; a 256-ray block holds 32. Each variant
computes, per ray, the output the JAX tool defines for it:

  empty      ox + dx
  epilogue   the cross-lane argmin epilogue alone, over a [8, 128]
             scratch of REAL_MAX: REAL_MAX + 0 (the JAX kernel reads
             scratch nothing wrote, undefined there; the port fills it)
  boxtest    the slab test of the C chunk boxes and the packed keys: the
             ray's smallest key, as a float
  boxvec     the slab test alone, no validity check: the ray's smallest
             entry over the boxes it hits, or REAL_MAX
  select1    one packet-wide select: the packet's smallest live key
  walkfix    the hit tests of 8 fixed chunks (p + i) % 16, p the packet's
             index in its block, no select: the ray's best t there
  walksel    the select chain alone, each select dropping the chunk it
             picked: 2**31 - 1 for every ray (timed only)
  walk       the real walk: the ray's closest t

Keys are the JAX kernel's int32 keys: the bits of max(entry, DELTA),
low 10 bits replaced by the chunk id (so at most 1024 chunks), or
2**31 - 1 where the box is missed or invalid. A key is live while it is
<= the bits of its ray's best t with the low 10 bits set. A packet
visits the chunk of its smallest live key for all 8 rays and drops that
chunk for all 8.

The tables are the JAX layout from the port's own
`precompute_packet(tv, tc=128, margin=0.0)` (the JAX package's boxes):
planes [16 * C, 128] (rows 0-11 of chunk c are the 12 plane
coefficients of its 128 slots), boxes [8, Cp] (bmin xyz, bmax xyz,
validity, 0; Cp = C padded to a multiple of 128 with zero boxes).
DELTA = 1e-4 and REAL_MAX = 3.4e38 are the tool's own constants.

The CUDA kernel (`csrc/lab5_diag.cu`, kernel F) replaces the TPU kernel
`make_kernel`; `_diag_torch` is its plain twin (the hit test's fused
multiply-adds are where XLA:CPU fuses the JAX kernel, measured), and
the two are exactly equal on every variant.

Usage: python -m tinypathtracer_tpu_torch.tools.lab5_diag
       [--device cuda|cpu] [--n 262144] [--grid 2 --n-lat 16 --n-lon 32]
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from tinypathtracer_tpu_torch.ops.dense import hit_terms, origin_terms
from tinypathtracer_tpu_torch.ops.packet import precompute_packet
from tinypathtracer_tpu_torch.tools import common
from tinypathtracer_tpu_torch.utils import cuda_build

DELTA = float(np.float32(1e-4))
REAL_MAX = float(np.float32(3.4e38))
_I32_MAX = 2**31 - 1
TN = 256
PACKET = 8
CHUNK = 128
ROWS = 16
MAX_CHUNKS = 1024            # chunk ids fill the keys' low 10 bits
VARIANTS = ("empty", "epilogue", "boxtest", "boxvec", "select1", "walkfix",
            "walksel", "walk")
# packets per tile of the plain twin's hit tests: bounds its memory
_TILE_PACKETS = 2048


def diag_tables(tri_verts):
    """(planes [16 * C, 128], boxes [8, Cp]) of lab5_diag's layout for
    [F, 3, 3] triangles, C chunks of 128 slots."""
    pk = precompute_packet(tri_verts, tc=CHUNK, margin=0.0)
    c = pk.n_chunks
    planes = pk.woop.planes.view(c, CHUNK, 12).permute(0, 2, 1)
    planes = torch.cat([planes, planes.new_zeros((c, ROWS - 12, CHUNK))], 1)
    cp = -(-c // CHUNK) * CHUNK
    boxes = torch.nn.functional.pad(pk.boxes.T, (0, cp - c))
    return planes.reshape(c * ROWS, CHUNK).contiguous(), boxes.contiguous()


def _check(variant, rays, planes, boxes):
    n, cp = rays.shape[0], boxes.shape[1]
    c = planes.shape[0] // ROWS
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if (rays.shape[-1] != 8 or n % TN or planes.shape[1] != CHUNK
            or planes.shape[0] != c * ROWS or boxes.shape[0] != 8
            or cp % CHUNK or c > cp):
        raise ValueError(f"bad shapes rays {tuple(rays.shape)} (a multiple "
                         f"of {TN} rays), planes {tuple(planes.shape)}, "
                         f"boxes {tuple(boxes.shape)}")
    if cp > MAX_CHUNKS:
        raise ValueError(f"{cp} chunk boxes: the keys hold {MAX_CHUNKS}")
    if variant == "walkfix" and c < 16:
        raise ValueError(f"walkfix reads chunks 0-15; the scene has {c}")


def _keys(r, boxes):
    """(entry [P, 8, Cp], hit [P, 8, Cp], keys [P, 8, Cp] i32) of packed
    rays r [P, 8, 8]; hit has no validity check, keys do."""
    o, d = r[..., 0:3, None], r[..., 3:6, None]
    zero = d == 0.0
    iv = torch.where(zero, REAL_MAX, 1.0 / torch.where(zero, 1.0, d))
    t0 = (boxes[0:3] - o) * iv                       # [P, 8, 3, Cp]
    t1 = (boxes[3:6] - o) * iv
    near = torch.minimum(t0, t1).amax(dim=2)
    far = torch.maximum(t0, t1).amin(dim=2)
    hit = far >= near.clamp_min(DELTA)
    col = torch.arange(boxes.shape[1], dtype=torch.int32, device=r.device)
    key = ((near.clamp_min(DELTA).view(torch.int32) | 1023) ^ 1023) | col
    key = torch.where(hit & (boxes[6] != 0.0), key, _I32_MAX)
    return near, hit, key


def _best_t(r, planes, chunks, best):
    """best [P', 8] lowered by the hits of chunks [P', K] for the packed
    rays r [P', 8, 8], tile by tile."""
    w = planes.view(-1, ROWS, CHUNK)
    for p0 in range(0, r.shape[0], _TILE_PACKETS):
        ps = slice(p0, p0 + _TILE_PACKETS)
        pp = w[chunks[ps]][:, None]                  # [P'', 1, K, 16, 128]
        cols = [pp[:, :, :, k] for k in range(12)]
        o = [r[ps, :, k, None, None] for k in range(6)]  # [P'', 8, 1, 1]
        t, u, v = hit_terms(origin_terms(*o[:3], cols), *o[3:], cols)
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
              & (t < REAL_MAX))
        tmin = torch.where(ok, t, REAL_MAX).flatten(2).amin(dim=2)
        best[ps] = torch.minimum(best[ps], tmin)
    return best


def _select(key, best):
    """The packet's smallest live key [P] (2**31 - 1: none)."""
    ibt = best.view(torch.int32) | 1023
    live = torch.where(key <= ibt[..., None], key, _I32_MAX)
    return live.flatten(1).amin(dim=1)


def walk(r, planes, key):
    """The packet walk of packed rays r [P, 8, 8] from their keys:
    (best t [P, 8], visits [P], the chunks each packet tested)."""
    p = r.shape[0]
    best = torch.full((p, PACKET), REAL_MAX, device=r.device)
    visits = torch.zeros((p,), dtype=torch.int32, device=r.device)
    key = key.clone()
    m = _select(key, best)
    while True:
        act = (m < _I32_MAX).nonzero()[:, 0]
        if act.numel() == 0:
            return best, visits
        ck = (m[act] & 1023).long()
        best[act] = _best_t(r[act], planes, ck[:, None], best[act])
        key[act, :, ck] = _I32_MAX
        visits[act] += 1
        m[act] = _select(key[act], best[act])


def _diag_torch(variant, rays, planes, boxes):
    """Plain twin of kernel F: out [N, 1] f32 (module docstring)."""
    _check(variant, rays, planes, boxes)
    n = rays.shape[0]
    r = rays.view(n // PACKET, PACKET, 8)
    if variant == "empty":
        out = r[..., 0] + r[..., 3]
    elif variant == "epilogue":
        lane_t = torch.full((PACKET, CHUNK), REAL_MAX, device=rays.device)
        mrow = lane_t.amin(dim=1)
        lane = torch.arange(CHUNK, dtype=torch.int32, device=rays.device)
        cand = torch.where(lane_t == mrow[:, None], lane, _I32_MAX).amin(1)
        out = (mrow + cand.float()).expand(r.shape[0], PACKET)
    elif variant == "walkfix":
        p = torch.arange(r.shape[0], device=rays.device) % (TN // PACKET)
        chunks = (p[:, None] + torch.arange(8, device=rays.device)) % 16
        out = _best_t(r, planes, chunks,
                      torch.full(r.shape[:2], REAL_MAX, device=rays.device))
    else:
        near, hit, key = _keys(r, boxes)
        if variant == "boxvec":
            out = torch.where(hit, near, REAL_MAX).amin(dim=2)
        elif variant == "boxtest":
            out = key.amin(dim=2).float()
        elif variant == "select1":
            best = torch.full(r.shape[:2], REAL_MAX, device=rays.device)
            out = _select(key, best).float()[:, None].expand(-1, PACKET)
        elif variant == "walksel":
            # every select drops the chunk it picked, and with no hit test
            # the best t stays REAL_MAX: the chain ends at "no live key"
            out = torch.full(r.shape[:2], float(_I32_MAX), device=rays.device)
        else:
            out = walk(r, planes, key)[0]
    return out.reshape(n, 1).contiguous()


@functools.cache
def _lib():
    lib = cuda_build.load_library("lab5_diag")
    lib.tpt_lab5_diag.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.tpt_lab5_diag.restype = ctypes.c_int
    return lib


def diag_run(variant, rays, planes, boxes):
    """One variant of the stripped packet kernel over rays [N, 8] (o, d,
    1, 0; N a multiple of 256): kernel F on CUDA tensors, its plain twin
    on CPU tensors. Returns out [N, 1] f32."""
    _check(variant, rays, planes, boxes)
    if rays.device.type == "cpu":
        return _diag_torch(variant, rays, planes, boxes)
    if rays.device.type != "cuda":
        raise ValueError(f"diag_run has no kernel for {rays.device}")
    cuda_build.check_operands(rays, planes, boxes)
    n = rays.shape[0]
    out = torch.empty((n, 1), dtype=torch.float32, device=rays.device)
    if n:
        status = _lib().tpt_lab5_diag(
            VARIANTS.index(variant), rays.data_ptr(), planes.data_ptr(),
            boxes.data_ptr(), n, boxes.shape[1],
            out.data_ptr(), cuda_build.stream_ptr(rays.device))
        cuda_build.check_launch(status, "lab5_diag")
        diag_run.launches += 1
    return out


diag_run.launches = 0


def run_variant(variant, rays, planes, boxes, reps=8):
    """Time of one call of the variant in seconds (device time on the
    card, median of reps after a warm-up)."""
    return common.timed_ms(lambda: diag_run(variant, rays, planes, boxes),
                           rays.device, reps) / 1e3


def main(argv=None):
    from tinypathtracer_tpu_torch.models.envlight import gradient_sky
    from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
    from tinypathtracer_tpu_torch.tools.lab5 import make_rays

    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--grid", type=int, default=2)
    ap.add_argument("--n-lat", type=int, default=16)
    ap.add_argument("--n-lon", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    args, dev = common.parse(ap, argv, "lab5_diag")
    scene = sphere_grid_scene(args.grid, args.n_lat, args.n_lon,
                              env_radiance=gradient_sky(16, 32), device=dev)
    o, d, tv = make_rays(scene, args.n, "pixel8")
    n = o.shape[0]
    rays = torch.cat([o, d, torch.ones((n, 1), device=dev),
                      torch.zeros((n, 1), device=dev)], dim=1).contiguous()
    planes, boxes = diag_tables(tv)
    res = {"device": common.device_name(dev), "faces": tv.shape[0],
           "chunks": planes.shape[0] // ROWS, "rays": n}
    n_packets = n // PACKET
    for v in VARIANTS:
        t = run_variant(v, rays, planes, boxes, args.reps)
        res[v + "_ms"] = t * 1e3
        res[v + "_ns_per_packet"] = t / n_packets * 1e9
        print(json.dumps({v: res[v + "_ms"],
                          "ns/packet": res[v + "_ns_per_packet"]}),
              flush=True)
    print(json.dumps(res, indent=1), flush=True)
    return res


if __name__ == "__main__":
    main()
