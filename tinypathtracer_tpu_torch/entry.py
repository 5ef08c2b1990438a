"""Entry points of the port, the counterpart of the JAX package's
`__graft_entry__.py` (which stays beside it, at the repository's root):
a forward room frame, and a dry run of one sharded train step on n
gloo ranks; both on the card unless asked for the CPU.

    python -m tinypathtracer_tpu_torch.entry                 # entry() once
    python -m tinypathtracer_tpu_torch.entry multichip [N]   # N ranks (8)
    ... [--device cpu]                                       # on the CPU

The room `sphere_grid_scene(2, 8, 16)` stands in for the JAX entry's
box.gltf, which the repository does not hold. Torch traces nothing, so
`fn` is called as it is (the JAX entry's caller jits it).
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile

import torch
import torch.distributed as dist

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.ops.sampling import prng_key
from tinypathtracer_tpu_torch.render.renderer import (render_frame,
                                                      resolve_device)

ROOM = (2, 8, 16)          # sphere_grid_scene(grid, n_lat, n_lon)


def _tiny_scene(device):
    return sphere_grid_scene(*ROOM, env_radiance=gradient_sky(16, 32),
                             device=device)


def entry(device="cuda"):
    """(fn, example_args): fn(scene, key) renders one forward room frame
    through render_frame (the radiance sum [64, 64, 3], raw bottom-up
    rows) at the JAX entry's config, 64x64 @2 spp d4 on the dense
    intersector: below 8,192 faces that is the megakernel route, as in
    the JAX package. The example arguments live on the card unless
    device="cpu"; a card that is not there raises."""
    dev = resolve_device(device, "entry")
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4,
                       intersector="dense")

    def fn(scene, key):
        return render_frame(scene, cfg, key)

    return fn, (_tiny_scene(dev), prng_key(0, dev))


def _launches() -> dict:
    """The launch counters of the kernels a train step can reach."""
    from tinypathtracer_tpu_torch.ops import dense, mega, packet

    return {"dense": dense.dense_hit.launches,
            "packet": packet.packet_hit.launches,
            "mega": mega.mega_trace.launches,
            "mega_save_hits": mega.mega_trace.launches_save_hits}


def _dryrun_rank(rank, world, tmp, n_sample, device):
    """A rank of dryrun_multichip: one make_sharded_train_step step
    (Adam 1e-2) at the JAX dry run's config, 16x16 @2 spp d2 on the
    dense intersector, zero target, key 7, on `device` (on the card,
    card rank modulo the cards present). Saves the loss, the mesh, the
    new parameters and the step's kernel launches to rank_file."""
    torch.set_num_threads(1)
    from tinypathtracer_tpu_torch.diff import (Params, adam,
                                               make_sharded_train_step)
    from tinypathtracer_tpu_torch.parallel import (initialize, make_mesh,
                                                   rank_file)

    initialize(f"file://{tmp}/store", world, rank, backend="gloo",
               device=device)
    try:
        mesh = make_mesh(world // n_sample, n_sample, device=device)
        cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2,
                           intersector="dense")
        scene = _tiny_scene(device)
        params = Params.from_scene(scene)
        opt = adam(1e-2)
        step = make_sharded_train_step(cfg, mesh, opt)
        before = _launches()
        params, _, loss = step(params, opt.init(params), scene,
                               torch.zeros(cfg.height, cfg.width, 3,
                                           device=device),
                               prng_key(7, device))
        launches = {k: v - before[k] for k, v in _launches().items()}
        torch.save({"loss": float(loss),
                    "params": [x.cpu() for x in params.leaves()],
                    "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                    "launches": launches}, rank_file(tmp, rank))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run one full sharded train step on n_devices ranks, each a process
    ("spawn") joined through a file:// store in a temporary directory,
    gloo between them (ranks may share one card), on the card unless
    device="cpu"; a card that is not there raises. Mesh ("data",
    "sample") = (n/2, 2) when n is even, else (n, 1), as the JAX dry
    run's. Raises if a rank fails or the ranks outlast
    parallel.spawn.RANK_TIMEOUT, if the loss is not finite, or if the
    ranks' losses or parameters differ; every rank has stopped when it
    returns. Prints the JAX dry run's line and returns {"mesh", "loss",
    "launches"}: the launches of each kernel summed over the ranks (none
    on the CPU, where the kernels' plain twins run)."""
    from tinypathtracer_tpu_torch.parallel import spawn_ranks

    dev = resolve_device(device, "dryrun_multichip")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1: {n_devices}")
    n_sample = 2 if n_devices % 2 == 0 else 1
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(_dryrun_rank, n_devices, tmp, n_sample,
                            dev.type)
    first = ranks[0]
    if not math.isfinite(first["loss"]):
        raise RuntimeError(f"non-finite loss {first['loss']}")
    for r, out in enumerate(ranks[1:], 1):
        if out["loss"] != first["loss"] or not all(
                torch.equal(a, b)
                for a, b in zip(out["params"], first["params"])):
            raise RuntimeError(f"rank {r}'s loss or parameters differ from "
                               f"rank 0's")
    print(f"dryrun_multichip({n_devices}): mesh={first['mesh']} "
          f"loss={first['loss']:.6f}")
    return {"mesh": first["mesh"], "loss": first["loss"],
            "launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in first["launches"]}}


def main(argv) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m tinypathtracer_tpu_torch.entry")
    parser.add_argument("mode", nargs="?", choices=["multichip"],
                        help="the sharded dry run instead of entry()")
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.mode == "multichip":
        dryrun_multichip(args.n_devices, args.device)
    else:
        fn, example = entry(args.device)
        out = fn(*example)
        print("entry ok:", tuple(out.shape), float(out.mean()))


if __name__ == "__main__":
    main(sys.argv[1:])
