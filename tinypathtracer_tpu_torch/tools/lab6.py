"""Kernel lab 6: the train step's cost split for the stored-hit backward.
Port of `tinypathtracer_tpu/tools/lab6.py`.

Times, on one 2**18-ray chunk of the room (512x512 @16 spp d8 camera
rays, one lane per pixel):

  mega_fwd     the megakernel forward, no hit residuals (kernel B)
  mega_save    the megakernel forward with the per-bounce hit residuals
               (kernel B's save_hits instance)
  replay_fwd   the shading-only replay on those residuals
               (`trace_paths(stored_hits=)`), primal only: the
               recompute half of the backward
  replay_vjp   value and gradient of sum(replay): the whole stored-hit
               backward
  full_vjp     value and gradient of sum(trace_paths_mega): the train
               path's per-chunk cost
  modular_fwd  the modular loop's forward on kernel A (context)

The room is the in-repo sphere_grid_scene(2, 8, 16) (1,804 faces); the
JAX tool's box.gltf is not in the repository. Timing: CUDA events, one
warm-up, the median of `--reps`.

Usage: python -m tinypathtracer_tpu_torch.tools.lab6 [--device cuda|cpu]
       [--n 262144] [--width 512 --height 512 --spp 16 --depth 8]
"""

from __future__ import annotations

import dataclasses
import functools
import json

import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.ops.dense import closest_hit_dense
from tinypathtracer_tpu_torch.ops.mega import (mega_operands, mega_trace,
                                               trace_paths_mega, unpack_hits)
from tinypathtracer_tpu_torch.ops.sampling import (fold_all, fold_lanes,
                                                   lane_uniform, prng_key)
from tinypathtracer_tpu_torch.render import raygen
from tinypathtracer_tpu_torch.render.integrator import TraceData, trace_paths
from tinypathtracer_tpu_torch.render.renderer import _CAM_TAG, prepare_state
from tinypathtracer_tpu_torch.tools import common

ROOM = (2, 8, 16)


def _with_grad(data: TraceData) -> TraceData:
    """The trace data with every float field a leaf that needs a grad."""
    return TraceData(**{
        f.name: (x.detach().requires_grad_() if x.is_floating_point() else x)
        for f in dataclasses.fields(data)
        for x in [getattr(data, f.name)]})


def _vjp(fn, data: TraceData):
    """sum(fn(data)) and its gradient with respect to every float field,
    folded into one scalar."""
    leaves = _with_grad(data)
    v = fn(leaves).sum()
    wrt = [x for x in (getattr(leaves, f.name)
                       for f in dataclasses.fields(leaves)) if x.requires_grad]
    grads = torch.autograd.grad(v, wrt, allow_unused=True)
    return v.detach() + sum(g.sum() for g in grads if g is not None)


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=4)
    args, dev = common.parse(ap, argv, "lab6")
    w, h = args.width, args.height
    cfg = RenderConfig(width=w, height=h, spp=args.spp, max_depth=args.depth)
    scene = sphere_grid_scene(*ROOM, env_radiance=gradient_sky(64, 128),
                              device=dev)
    state = prepare_state(scene, cfg)
    data, woop = state.data, state.woop
    pix = torch.arange(args.n, device=dev) % (w * h)
    keys = fold_lanes(prng_key(0, dev), pix)
    u_cam = lane_uniform(fold_all(keys, _CAM_TAG), 2)
    o, d = raygen.camera_rays_u(u_cam, scene.cam_to_world, scene.cam_yfov,
                                scene.cam_aspect, pix % w, pix // w, w, h)
    depth = cfg.max_depth
    with torch.no_grad():
        _, raw = mega_trace(*mega_operands(data, cfg, woop, o, d, keys),
                            depth=depth, n_lights=data.n_lights,
                            save_hits=True)
    hits = unpack_hits(raw, woop.perm, depth)

    def mega_save():
        return mega_trace(*mega_operands(data, cfg, woop, o, d, keys),
                          depth=depth, n_lights=data.n_lights,
                          save_hits=True)[0].sum()

    def replay(dd):
        return trace_paths(dd, cfg, None, o, d, keys, stored_hits=hits)

    stages = {
        "mega_fwd": lambda: trace_paths_mega(data, cfg, woop, o, d,
                                             keys).sum(),
        "mega_save": mega_save,
        "replay_fwd": lambda: replay(data).sum(),
        "replay_vjp": lambda: _vjp(replay, data),
        "full_vjp": lambda: _vjp(lambda dd: trace_paths_mega(
            dd, cfg, woop, o, d, keys), data),
        "modular_fwd": lambda: trace_paths(
            data, cfg, functools.partial(closest_hit_dense, woop=woop), o, d,
            keys, shade_kernels=state.route.shade_kernels).sum(),
    }
    res = {"device": common.device_name(dev)}
    for name, fn in stages.items():
        with torch.set_grad_enabled(name.endswith("vjp")):
            res[name + "_ms"] = common.timed_ms(fn, dev, args.reps)
        print(json.dumps({name + "_ms": res[name + "_ms"]}), flush=True)
    res["rays"] = args.n
    res["full_vjp_rays_per_s"] = args.n / (res["full_vjp_ms"] / 1e3)
    print(json.dumps(res, indent=1), flush=True)
    return res


if __name__ == "__main__":
    main()
