"""Kernel lab 5: every intersector against scene size and ray
coherence. Port of `tinypathtracer_tpu/tools/lab5.py`.

Times the packet traversal (kernel C, `closest_hit_packet`), the dense
sweep (kernel A, `closest_hit_dense`) and the LBVH walk
(`closest_hit_bvh` on the host-built tree, stack 64) on in-repo
procedural scenes, for three ray classes that bracket the renderer's
workload:

  camera   one origin, a coherent direction grid (bounce 0)
  pixel8   8 rays per packet share an origin on the geometry, with
           random directions (bounce 1 and later: the renderer packs a
           pixel's samples into consecutive lanes)
  random   independent origins in the scene box and directions (worst
           case)

and kernel C's chunk visits per packet (mean, 95th percentile): pairs
tested per query = visits * tc, against the padded faces of the dense
sweep. On the card this is the dense/packet crossover data.

Scenes: `room` sphere_grid_scene(2, 8, 16) (1,804 faces), `gN`
sphere_grid_scene(N, 16, 32) (g2: 7,692, g4: 61,452, g5: 124,004
faces). The JAX tool's `box` loads a glTF file that is not in the
repository: it raises here.

Timing: CUDA events around each call, one warm-up, median of `--reps`
(one call for the LBVH walk; the TPU tool's scan and overhead
subtraction have no counterpart).

Usage: python -m tinypathtracer_tpu_torch.tools.lab5 [--device cuda|cpu]
       [--scenes room,g2,g4] [--impls packet,dense,bvh] [--n 262144]
       [--modes camera,pixel8,random]
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.ops.dense import (closest_hit_dense,
                                                precompute_woop)
from tinypathtracer_tpu_torch.ops.packet import (closest_hit_packet,
                                                 precompute_packet)
from tinypathtracer_tpu_torch.ops.traverse import closest_hit_bvh
from tinypathtracer_tpu_torch.render.integrator import TraceData
from tinypathtracer_tpu_torch.render.renderer import host_build_bvh
from tinypathtracer_tpu_torch.tools import common

ROOM = (2, 8, 16)
BVH_REPS = 1            # timed calls of the (slow, eager) LBVH walk


def make_scene(name, dev):
    """A lab scene by name: "room" or "g<grid>"; "box" needs the glTF
    reference scene, which is not in the repository."""
    if name == "box":
        raise FileNotFoundError(
            "scene 'box' loads the JAX lab's reference box.gltf, which the "
            "repository does not hold; use room, g2, g4 or g5")
    grid = ROOM if name == "room" else (int(name[1:]), 16, 32)
    return sphere_grid_scene(*grid, env_radiance=gradient_sky(16, 32),
                             device=dev)


def make_rays(scene, n, mode, seed=0):
    """(origins [N, 3], dirs [N, 3], tri_verts [F, 3, 3]) on the scene's
    device: the JAX tool's numpy streams for each mode."""
    tv_t = TraceData.from_scene(scene).tri_verts
    tv = tv_t.cpu().numpy()
    lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
    rng = np.random.default_rng(seed)
    if mode == "camera":
        c2w = scene.cam_to_world.cpu().numpy()
        side = int(np.sqrt(n))
        ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, side),
                             np.linspace(-0.7, 0.7, side), indexing="ij")
        d = np.stack([xs.ravel(), ys.ravel(), -np.ones(side * side)],
                     axis=1) @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = np.tile(d, (-(-n // d.shape[0]), 1))[:n]
        o = np.tile(c2w[:3, 3], (n, 1))
    elif mode == "pixel8":
        npk = n // 8
        fsel = rng.integers(0, tv.shape[0], npk)
        b = rng.random((npk, 2)).astype(np.float32)
        u = 1.0 - np.sqrt(b[:, 0:1])
        v = (1 - u) * b[:, 1:2]
        pts = tv[fsel, 0] * (1 - u - v) + tv[fsel, 1] * u + tv[fsel, 2] * v
        o = np.repeat(pts, 8, axis=0)
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif mode == "random":
        o = lo + rng.random((n, 3)) * (hi - lo)
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        raise ValueError(f"unknown ray mode {mode!r}")
    dev = scene.device
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev), tv_t)


def time_hit(hit_fn, o, d, reps=5):
    """Time of one closest-hit call on (o, d), in seconds."""
    return common.timed_ms(lambda: hit_fn(o, d), o.device, reps) / 1e3


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--scenes", default="room,g2,g4")
    ap.add_argument("--impls", default="packet,dense,bvh")
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--modes", default="camera,pixel8,random")
    ap.add_argument("--reps", type=int, default=5)
    args, dev = common.parse(ap, argv, "lab5")
    out = {"device": common.device_name(dev), "rays": args.n}
    for sname in args.scenes.split(","):
        scene = make_scene(sname, dev)
        f = int(scene.indices.shape[0])
        res = {}
        tables = {}
        for mode in args.modes.split(","):
            o, d, tv = make_rays(scene, args.n, mode)
            for impl in args.impls.split(","):
                reps = args.reps
                if impl == "packet":
                    pk = tables.get(impl) or precompute_packet(tv)
                    hit = functools.partial(closest_hit_packet, pk=pk)
                    vis = closest_hit_packet(o, d, pk, with_visits=True)[3]
                    vis = vis[::8].float().cpu().numpy()
                    res[f"{mode}.visits_mean"] = float(vis.mean())
                    res[f"{mode}.visits_p95"] = float(np.percentile(vis, 95))
                    res[f"{mode}.chunks_total"] = pk.n_chunks
                elif impl == "dense":
                    pk = tables.get(impl) or precompute_woop(tv)
                    hit = functools.partial(closest_hit_dense, woop=pk)
                elif impl == "bvh":
                    pk = tables.get(impl) or host_build_bvh(scene).to(dev)
                    hit = functools.partial(closest_hit_bvh, bvh=pk,
                                            stack_depth=64)
                    reps = BVH_REPS
                else:
                    raise ValueError(f"unknown intersector {impl!r}")
                tables[impl] = pk
                t = time_hit(hit, o, d, reps)
                res[f"{mode}.{impl}_ms"] = t * 1e3
                res[f"{mode}.{impl}_mrays_s"] = args.n / t / 1e6
        out[f"{sname}({f}f)"] = res
        print(json.dumps({f"{sname}({f}f)": res}, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
