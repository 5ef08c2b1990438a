"""Command-line renderer (port of `tinypathtracer_tpu/tools/render_cli.py`).

Scene, resolution, spp, depth, estimator and intersector are runtime
flags; the options are the JAX CLI's, plus --device (the card unless
the caller asks for the CPU):

    python -m tinypathtracer_tpu_torch.tools.render_cli \\
        --scene room.gltf --out room.png --width 512 --height 512 --spp 16

--aov writes a debug AOV (render/aov.py) instead of the beauty pass;
--stats prints the render's RenderStats JSON (utils/metrics.py) to
stderr. --shard renders over a ("data", "sample") mesh of every rank
(parallel/): run one process a card with COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID set (none set: one rank); rank 0 writes
the PNG. On the CPU (--device cpu) the ranks use gloo. Every PNG has top-down rows: the JAX CLI writes its AOV PNGs in
raw bottom-up order, the port flips them like the beauty pass.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tinypathtracer-torch",
        description="differentiable path tracer (PyTorch + CUDA)")
    p.add_argument("--scene", required=True, help=".gltf scene file")
    p.add_argument("--out", default="out.png", help="output PNG path")
    p.add_argument("--env", default=None,
                   help="equirect env map (image or .npy); default: "
                        "procedural sky")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--mode", choices=["reference", "physical"],
                   default="reference")
    p.add_argument("--intersector",
                   choices=["dense", "bvh", "packet", "bruteforce"],
                   default="dense")
    p.add_argument("--bvh-source", choices=["device", "host"],
                   default="device",
                   help="where the LBVH is built (intersector=bvh): "
                        "'device' with the frame, 'host' once per scene on "
                        "the CPU (utils/native.py)")
    p.add_argument("--aov", choices=["normal", "depth", "hitmask"],
                   default=None,
                   help="render a debug AOV instead of the beauty pass "
                        "(reference RENDER_NORMAL path_tracer.cu:322-342 "
                        "/ hit-mask debug_utils.h:130-169)")
    p.add_argument("--tile-pixels", type=int, default=16384,
                   help="accepted and ignored: the deprecated pixel tiling "
                        "is not ported (lanes run in chunks of "
                        "RenderConfig.rays_per_dispatch rays)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shard", action="store_true",
                   help="shard pixels over every rank of a "
                        "torch.distributed group started from "
                        "COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID "
                        "(one rank when none is set)")
    p.add_argument("--stats", action="store_true",
                   help="print timing JSON to stderr")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from tinypathtracer_tpu_torch import (RenderConfig, Renderer, load_scene,
                                          prng_key)
    from tinypathtracer_tpu_torch.models.envlight import (gradient_sky,
                                                          load_env_image)
    from tinypathtracer_tpu_torch.render import film
    from tinypathtracer_tpu_torch.render.aov import render_aov
    from tinypathtracer_tpu_torch.render.renderer import resolve_device
    from tinypathtracer_tpu_torch.utils.metrics import (RenderStats,
                                                        synchronize,
                                                        timed_render)

    dev = resolve_device(args.device, "render_cli")
    if args.shard and not args.aov:     # an AOV is not sharded, as in JAX
        from tinypathtracer_tpu_torch.parallel import initialize

        initialize(device=dev)
    env = load_env_image(args.env) if args.env else gradient_sky(64, 128)
    flat = load_scene(args.scene).flatten(env_radiance=env, device=dev)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, mode=args.mode,
                       intersector=args.intersector,
                       bvh_source=args.bvh_source)
    key = prng_key(args.seed)
    if args.aov:
        t0 = time.perf_counter()
        img = render_aov(flat, cfg, key, args.aov, device=dev).flip(0)
        synchronize()
        dt = time.perf_counter() - t0
        stats = RenderStats(width=cfg.width, height=cfg.height, spp=cfg.spp,
                            max_depth=cfg.max_depth, seconds=dt,
                            stages={f"aov_{args.aov}": dt})
    elif args.shard:
        import torch.distributed as dist

        from tinypathtracer_tpu_torch.parallel import (make_mesh,
                                                       make_sharded_renderer)

        t0 = time.perf_counter()
        img = make_sharded_renderer(cfg, make_mesh(device=dev))(flat, key)
        synchronize()
        stats = RenderStats(width=cfg.width, height=cfg.height, spp=cfg.spp,
                            max_depth=cfg.max_depth,
                            seconds=time.perf_counter() - t0)
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return
    else:
        img, stats = timed_render(Renderer(cfg, device=dev), flat, key)
    film.write_png(args.out, img)
    if args.stats:
        print(stats.to_json(), file=sys.stderr)
    print(args.out)


if __name__ == "__main__":
    main()
