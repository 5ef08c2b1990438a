"""Per-stage breakdown of one room frame. Port of
`tinypathtracer_tpu/tools/profile_stages.py`.

Stages:
  frame      the full Renderer frame (the default RenderConfig: the
             megakernel path on the room)
  intersect  the modular loop's closest-hit calls of one frame: 2 per
             bounce (main and extra emitter query) per chunk, on random
             rays of a chunk's width (kernel A)
  glue       the modular bounce loop of one chunk with the intersection
             stubbed out (raygen, keys, gathers, shading, carries), times
             the chunks of a frame

frame ~= intersect + glue + chunking overhead on the modular path; the
residual is reported. On the card every stage is device time between
CUDA events (median of --reps after a warm-up); the frame ends in the
image. The scene is the in-repo room, sphere_grid_scene(2, 8, 16) with
gradient_sky(64, 128) (the JAX tool's box.gltf is not in the
repository); the JAX tool's PROF_* environment variables are the flags.

Usage: python -m tinypathtracer_tpu_torch.tools.profile_stages
       [--device cuda|cpu] [--width 512 --height 512 --spp 16 --depth 8]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.ops.sampling import prng_key
from tinypathtracer_tpu_torch.render.integrator import trace_paths
from tinypathtracer_tpu_torch.render.renderer import (Renderer, hit_fn,
                                                      lane_rays, prepare_state)
from tinypathtracer_tpu_torch.tools import common

ROOM = (2, 8, 16)


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args, dev = common.parse(ap, argv, "profile_stages")
    w, h, spp, depth = args.width, args.height, args.spp, args.depth
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    scene = sphere_grid_scene(*ROOM, env_radiance=gradient_sky(64, 128),
                              device=dev)
    n_rays = w * h * spp
    chunk = min(cfg.rays_per_dispatch, n_rays)
    n_chunks = -(-n_rays // chunk)
    res = {"config": f"{w}x{h}@{spp}spp d{depth}", "n_rays": n_rays,
           "chunk": chunk, "device": common.device_name(dev)}

    # ---- full frame -----------------------------------------------------
    r = Renderer(cfg, device=dev.type)
    t_frame = common.timed_ms(lambda: r.render(scene, prng_key(1)), dev,
                              args.reps) / 1e3
    res["frame_s"] = t_frame
    res["rays_per_s"] = n_rays / t_frame

    # ---- the intersector: the frame's calls -----------------------------
    state = prepare_state(scene, cfg)
    closest_hit = hit_fn(state, cfg)
    rng = np.random.default_rng(2)
    o0 = torch.from_numpy((rng.random((chunk, 3)) * 2.0).astype(np.float32))
    d0 = rng.standard_normal((chunk, 3))
    d0 = torch.from_numpy(
        (d0 / np.linalg.norm(d0, axis=1, keepdims=True)).astype(np.float32))
    o0, d0 = o0.to(dev), d0.to(dev)
    calls = 2 * depth            # per chunk: main + extra emitter query
    with torch.inference_mode():
        t_hit = common.timed_ms(lambda: closest_hit(o0, d0), dev,
                                args.reps) / 1e3
    res["intersect_frame_s"] = t_hit * calls * n_chunks
    res["intersect_ms_per_dispatch"] = t_hit * 1e3

    # ---- glue: the bounce loop with a stub intersector -------------------
    n_faces = state.data.tri_verts.shape[0]

    def stub_hit(o, d, mask=None):
        m = o.shape[0]
        fid = torch.arange(m, device=o.device) % n_faces
        if mask is not None:
            fid = torch.where(mask, fid, -1)
        return (fid, torch.ones((m,), device=o.device),
                torch.zeros((m, 2), device=o.device))

    pix = torch.arange(chunk // spp, device=dev) % (w * h)
    with torch.inference_mode():
        def glue():
            o, d, keys = lane_rays(scene, cfg, pix, prng_key(5, dev))
            return trace_paths(state.data, cfg, stub_hit, o, d, keys,
                               shade_kernels=state.route.shade_kernels)

        t_glue = common.timed_ms(glue, dev, args.reps) / 1e3
    res["glue_frame_s"] = t_glue * n_chunks
    res["glue_ms_per_bounce"] = t_glue / depth * 1e3
    res["residual_s"] = (t_frame - res["intersect_frame_s"]
                         - res["glue_frame_s"])
    print(json.dumps(res, indent=2), flush=True)
    print(f"{'stage':22s} {'s/frame':>9s} {'% of frame':>11s}")
    for k in ("intersect_frame_s", "glue_frame_s", "residual_s"):
        print(f"{k:22s} {res[k]:9.3f} {100 * res[k] / t_frame:10.1f}%")
    print(f"{'frame':22s} {t_frame:9.3f}   {n_rays / t_frame:,.0f} rays/s",
          flush=True)
    return res


if __name__ == "__main__":
    main()
