"""Kernel lab: kernel B (the megakernel, csrc/mega.cu) by scene, lights
and instance.

On one chunk of --n paths of the 512x512 @16 spp d8 frame (the first
n / 16 pixels, as the renderer cuts them), for each scene (the room
sphere_grid_scene(2, 8, 16), 1,920 slots; the big room (2, 16, 32),
8,192 slots) and light count (0; 3: a point, a spot and a directional
light), it prints:

  fwd_ms, save_hits_ms    each instance's time (CUDA events, median of
                          --reps after one warm-up)
  *_bound_ms, *_bound_by  the least time for these paths' work (their
                          own residuals: camera query, live bounces,
                          lights), fp32 operations or bytes
  *_regs, *_local_bytes   registers and local memory (stack and spills)
                          per thread
  eff_thread              lane efficiency of one path per thread, warps
                          of 32 consecutive paths each as long as its
                          longest path (the former schedule), from the
                          residuals: sweeps / (32 x warp sweeps)
  eff_pool                lane efficiency of the refilled pool: sweeps /
                          (lanes x the rounds the kernel counted)
  blocks, rounds_mean, rounds_max
  no_refill_ms, eff_no_refill   the forward with one path per lane
                          (one block per mega_threads paths: no refill)
  tile_skip_share         what a warp-wide cull of 128-slot tiles could
                          skip: the share of (warp, tile) pairs in which
                          no lane's query enters the tile's box within
                          its running best (any-hits: before their first
                          occluder), counted on the modular loop's own
                          queries of SKIP_PATHS paths spread over the
                          frame, lanes grouped 32 at random as the pool
                          mixes them (a count, not a time)

With --variants (on the card only) it times instead the designs kernel B
did not keep, each a build of csrc/mega.cu with the edits VARIANTS
lists, in turns with the kernel (the kernel, each variant, then the same
in reverse order), per cell and instance, with each build's registers
and local memory; and it splits the cost of the interleaved pool's
scattered loads and stores from its schedule: the kernel and the
contiguous-pool build on one grid of SPLIT_BLOCKS (or fewer) blocks, the
latter on the paths permuted so that each of its blocks runs the very
pools, in the very order, of the kernel's block of that index (the same
rounds), each lane's 32 loads or stores then falling on consecutive
paths' columns.

Every variant's rows must equal the kernel's, and the counted rounds the
plain schedule model's (ops/mega._mega_schedule). With --device cpu the
plain twin runs at whatever --n gives: times are the host's, registers
are not measured (null), and eff_pool is the schedule model's for one
block.

Usage: python -m tinypathtracer_tpu_torch.tools.lab_mega [--device
       cuda|cpu] [--n 1048576] [--scenes room,big_room] [--lights 0,3]
       [--reps 3] [--variants]
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json

import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.ops import mega
from tinypathtracer_tpu_torch.ops.dense import (closest_hit_dense, hit_terms,
                                                origin_terms)
from tinypathtracer_tpu_torch.ops.sampling import prng_key
from tinypathtracer_tpu_torch.render.integrator import trace_paths
from tinypathtracer_tpu_torch.render.renderer import lane_rays, prepare_state
from tinypathtracer_tpu_torch.tools import common
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX

SCENES = {"room": (2, 8, 16), "big_room": (2, 16, 32)}
SKIP_PATHS = 1 << 14
SKIP_TILE = 128               # csrc/mega.cu kTile


def _block(lanes, min_blocks, stages):
    """Edits of csrc/mega.cu that give every instance these lanes, blocks
    an SM and ring depth (C expressions of `lights`)."""
    return [("  return lights <= 2 ? 512 : 256;", f"  return {lanes};"),
            ("  return lights <= 2 ? 2 : 3;", f"  return {min_blocks};"),
            ("  return lights <= 2 ? 16 : 4;", f"  return {stages};")]


# The designs kernel B did not keep: edits (text, replacement) of
# csrc/mega.cu, each text found exactly once.
VARIANTS = {
    # block b takes the paths [b P, (b + 1) P), P = ceil(N / blocks)
    "contiguous_pool": [
        ("  return (n - b + g - 1) / g;",
         "  const int p = (n + g - 1) / g;\n"
         "  return max(0, min(p, n - b * p));"),
        ("  return b + k * g;", "  return b * ((n + g - 1) / g) + k;")],
    # the first design's blocks: 256 lanes and a 4-deep ring for every
    # light count
    "lanes256_ring4": _block("256", "lights <= 2 ? 4 : 3", "4"),
    "lanes256_ring8": _block("256", "lights <= 2 ? 4 : 3", "8"),
    "lanes128_ring4": _block("128", "lights <= 2 ? 8 : 6", "4"),
    "lanes128_ring8": _block("128", "lights <= 2 ? 8 : 6", "8"),
    "lanes512_ring16": _block("512", "lights <= 2 ? 2 : 1", "16"),
    "lights_4_blocks": _block("lights <= 2 ? 512 : 256",
                              "lights <= 2 ? 2 : 4", "lights <= 2 ? 16 : 4"),
    "no_unroll": [("#pragma unroll 4\n", "")],
    "unroll2": [("#pragma unroll 4\n", "#pragma unroll 2\n")],
    "unroll8": [("#pragma unroll 4\n", "#pragma unroll 8\n")],
}
SPLIT_BLOCKS = 512
LIGHTS = 3                    # the most with_lights adds


def with_lights(scene, count: int = LIGHTS):
    """The scene with the first `count` of one point, one spot and one
    directional light."""
    dev = scene.device
    lights = dict(
        light_kind=torch.tensor([0, 2, 1], dtype=torch.int32),
        light_color=torch.tensor([[1.0, 0.9, 0.8], [0.5, 0.6, 1.0],
                                  [1.0, 1.0, 1.0]]),
        light_intensity=torch.tensor([4.0, 6.0, 0.7]),
        light_pos=torch.tensor([[0.0, 3.5, 0.0], [2.0, 2.0, -2.0],
                                [0.0, 0.0, 0.0]]),
        light_dir=torch.tensor([[0.0, -1.0, 0.0], [-0.5, -0.7071, 0.5],
                                [0.3015, -0.9045, 0.3015]]),
        light_cos_outer=torch.tensor([0.0, 0.8, 0.0]),
        light_inv_cone=torch.tensor([0.0, 5.0, 0.0]))
    return dataclasses.replace(
        scene, **{k: v[:count].to(dev) for k, v in lights.items()})


def mega_work(rays8, hits, shadeT, depth, n_lights, save_hits):
    """(operations, bytes) of kernel B on the paths whose camera rays are
    rays8 [8, N] and whose residuals are `hits` (from the save_hits
    instance on the same inputs: both instances trace the same queries).
    Counted from this run's data: the camera query of every lane (one
    origin transform per slot for each distinct camera origin), then
    per bounce on each live lane (hit, not emissive) one origin
    transform per slot, the next-direction
    query (not on the last bounce), the extra emitter query on diffuse
    lanes, and each delta light: a full sweep where unoccluded, at least
    one test where occluded (the sweep stops at its first occluder).
    Bytes: rays8, u8d, planes and the shading rows read, [16, N] written
    (and the [8 * depth, N] residuals with save_hits)."""
    fp, n = shadeT.shape[1], hits.shape[1]
    rows = hits.view(depth, 8, n)
    slot = rows[:, 0].long()
    s = slot.clamp_min(0)
    live = (slot >= 0) & (shadeT[24][s] <= 0.0)
    diffuse = ~((shadeT[25][s] >= 1.0) | (shadeT[26][s] > 0.0))
    occ = rows[:, 5].long()
    origins = common.origin_ids(rays8[0:3].T)[1] * fp   # the camera query
    directions = n * fp
    for dep in range(depth):
        lv = live[dep]
        origins += int(lv.sum()) * fp
        directions += (int(lv.sum()) * (dep + 1 < depth)
                       + int((lv & diffuse[dep]).sum())) * fp
        for li in range(n_lights):
            occluded = ((occ[dep] >> li) & 1) == 1
            directions += (int((lv & ~occluded).sum()) * fp
                           + int((lv & occluded).sum()))
    nbytes = n * (32 + 32 * depth + 64) + fp * (48 + 128)
    if save_hits:
        nbytes += n * 32 * depth
    return (origins * common.OPS_ORIGIN
            + directions * common.OPS_DIRECTION), nbytes


def thread_efficiency(lengths, warp: int = 32) -> float:
    """Lane efficiency of one path per thread: warps of `warp`
    consecutive paths, each sweeping as often as its longest path."""
    n = lengths.shape[0]
    padded = lengths.new_zeros((-(-n // warp) * warp,))
    padded[:n] = lengths
    spans = padded.view(-1, warp).amax(dim=1)
    return float(lengths.sum()) / float(warp * spans.sum())


def pool_efficiency(lengths, rounds, threads: int):
    """Lane efficiency of the refilled pool: the sweeps the paths need
    over the lane sweeps the blocks ran."""
    return float(lengths.sum()) / float(threads * rounds.long().sum())


def frame_operands(scene, cfg, key, n):
    """Kernel B's operands for the first n / spp pixels of the frame, as
    the renderer builds them, and the scene's light count."""
    state = prepare_state(scene, cfg)
    pix = torch.arange(n // cfg.spp, device=scene.device)
    o, d, keys = lane_rays(scene, cfg, pix, key)
    return (mega.mega_operands(state.data, cfg, state.woop, o, d, keys),
            state.data.n_lights)


def _tile_need(o, d, mask, planes, lo, hi, anyhit):
    """[N, tiles] bool: whether each masked query must test each tile: it
    enters the tile's box at or beyond DELTA, no later than its best t
    over the tiles before (a closest hit), or before any of them occluded
    it (an any-hit)."""
    n, nt = o.shape[0], lo.shape[0]
    t_tile = torch.full((n, nt), REAL_MAX, device=o.device)
    for k in range(nt):
        w = list(planes[k * SKIP_TILE:(k + 1) * SKIP_TILE].T[:, None, :])
        op = origin_terms(o[:, 0:1], o[:, 1:2], o[:, 2:3], w)
        t, u, v = hit_terms(op, d[:, 0:1], d[:, 1:2], d[:, 2:3], w)
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
        t_tile[:, k] = torch.where(ok, t, REAL_MAX).amin(dim=1)
    before = torch.cat([t_tile.new_full((n, 1), REAL_MAX),
                        t_tile.cummin(dim=1).values[:, :-1]], dim=1)
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(t0, t1).amax(dim=-1).clamp_min(DELTA)
    far = torch.maximum(t0, t1).amin(dim=-1)
    reach = before == REAL_MAX if anyhit else near <= before
    return (far >= near) & reach & mask[:, None]


def tile_skip_share(scene, cfg, key, n_paths, warp: int = 32,
                    seed: int = 0) -> float:
    """The share of (warp, tile) pairs a warp-wide tile cull could skip
    (see the module docstring), on n_paths paths spread over the frame."""
    state = prepare_state(scene, cfg)
    dev, woop, data = scene.device, state.woop, state.data
    pix = torch.linspace(0, cfg.n_pixels - 1, max(1, n_paths // cfg.spp),
                         device=dev).long()
    o, d, keys = lane_rays(scene, cfg, pix, key)
    calls = []

    def spy(o_, d_, mask=None):
        calls.append((o_, d_, torch.ones_like(o_[:, 0], dtype=torch.bool)
                      if mask is None else mask))
        return closest_hit_dense(o_, d_, woop, mask=mask)

    with torch.no_grad():
        trace_paths(data, cfg, spy, o, d, keys,
                    shade_kernels=state.route.shade_kernels)
    # the tiles' boxes, widened as ops/packet widens chunk boxes
    fp = woop.n_padded
    tv = data.tri_verts[woop.perm]
    valid = (torch.arange(fp, device=dev) < woop.n_faces)[:, None]
    lo = torch.where(valid, tv.amin(dim=1), REAL_MAX).view(
        -1, SKIP_TILE, 3).amin(dim=1)
    hi = torch.where(valid, tv.amax(dim=1), -REAL_MAX).view(
        -1, SKIP_TILE, 3).amax(dim=1)
    pad = 1e-5 * torch.clamp_min(lo.abs() + hi.abs(), 1.0)
    lo, hi = lo - pad, hi + pad
    # per bounce the modular loop asks: the ray's own query (the kernel's
    # camera or next-direction query), the extra emitter, each light
    per = 2 + data.n_lights
    need = [_tile_need(c[0], c[1], c[2], woop.planes, lo, hi,
                       k % per >= 2) for k, c in enumerate(calls)]
    # a lane's round: a fresh path's camera query, or one bounce's extra
    # emitter and lights with the next bounce's own query
    rounds = [(need[0], calls[0][2])]
    for first in range(1, len(calls), per):
        ks = range(first, min(first + per, len(calls)))
        rounds.append((torch.stack([need[k] for k in ks]).any(dim=0),
                       torch.stack([calls[k][2] for k in ks]).any(dim=0)))
    lanes = torch.cat([nd[held] for nd, held in rounds])
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(lanes.shape[0], generator=gen).to(dev)
    m = lanes.shape[0] // warp * warp
    busy = lanes[order[:m]].view(-1, warp, lanes.shape[1]).any(dim=1)
    return 1.0 - float(busy.float().mean())


def check_rows(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: rows differ from kernel B's on "
                             f"{int((got != want).any(dim=0).sum())} paths")


def measure(ops, depth, n_lights, dev, reps):
    """One cell: both instances' times and bounds, the lane efficiencies,
    and on the card the rounds against the model and the no-refill
    time."""
    cell = {}
    fwd = mega.mega_trace(*ops, depth=depth, n_lights=n_lights)
    _, hits = mega.mega_trace(*ops, depth=depth, n_lights=n_lights,
                              save_hits=True)
    lengths = mega.path_lengths(hits, ops[3], depth)
    n = lengths.shape[0]
    for inst, save in (("fwd", False), ("save_hits", True)):
        cell[f"{inst}_ms"] = common.timed_ms(
            lambda: mega.mega_trace(*ops, depth=depth,      # noqa: B023
                                    n_lights=n_lights, save_hits=save),
            dev, reps)
        b_ms, b_by = common.bound(*mega_work(ops[0], hits, ops[3], depth,
                                             n_lights, save))
        cell[f"{inst}_bound_ms"], cell[f"{inst}_bound_by"] = b_ms, b_by
        regs, local = (mega.kernel_resources(n_lights, save)
                       if dev.type == "cuda" else (None, None))
        cell[f"{inst}_regs"], cell[f"{inst}_local_bytes"] = regs, local
    cell["eff_thread"] = thread_efficiency(lengths)
    blocks = mega.mega_grid(n, n_lights) if dev.type == "cuda" else 1
    threads = mega.mega_threads(n_lights)
    rounds = mega._mega_schedule(lengths, blocks, threads)[0]
    single = -(-n // threads)
    cell["eff_no_refill"] = pool_efficiency(
        lengths, mega._mega_schedule(lengths, single, threads)[0], threads)
    if dev.type == "cuda":
        counted = torch.zeros((blocks,), dtype=torch.int32, device=dev)
        check_rows(mega._mega_cuda(*ops, depth, n_lights, False,
                                   rounds=counted), fwd, "counting launch")
        if not torch.equal(counted.cpu(), rounds.cpu()):
            raise AssertionError("kernel B's rounds per block differ from "
                                 "the schedule model's")
        check_rows(mega._mega_cuda(*ops, depth, n_lights, False,
                                   blocks=single), fwd, "no refill")
        cell["no_refill_ms"] = common.timed_ms(
            lambda: mega._mega_cuda(*ops, depth, n_lights, False,
                                    blocks=single), dev, reps)
    cell["blocks"] = blocks
    cell["rounds_mean"] = float(rounds.float().mean())
    cell["rounds_max"] = int(rounds.max())
    cell["eff_pool"] = pool_efficiency(lengths, rounds, threads)
    cell["sweeps_per_path"] = float(lengths.float().mean())
    return cell


@functools.cache
def build_variants():
    """{name: library} of every VARIANTS build of csrc/mega.cu
    (cuda_build.build_variants)."""
    return cuda_build.build_variants("mega", VARIANTS, mega._bind)


def run_lib(lib, ops, depth, n_lights, save_hits, blocks=0):
    """One launch of a build of kernel B (blocks <= 0: its own grid)."""
    rays8, u8d, planesT, shadeT, lights = ops
    shade_rows = shadeT.T.contiguous()
    n, dev = rays8.shape[1], rays8.device
    out = torch.empty((16, n), device=dev)
    hits = torch.empty((8 * depth, n), device=dev) if save_hits else None
    status = lib.tpt_mega_trace(
        rays8.data_ptr(), u8d.data_ptr(), planesT.data_ptr(),
        shade_rows.data_ptr(), lights.data_ptr(), n, planesT.shape[0], depth,
        n_lights, blocks, out.data_ptr(),
        hits.data_ptr() if save_hits else None, None,
        cuda_build.stream_ptr(dev))
    cuda_build.check_launch(status, "mega variant")
    return (out, hits) if save_hits else out


def resources(lib, n_lights, save_hits):
    regs, local = ctypes.c_int(), ctypes.c_int()
    cuda_build.check_launch(lib.tpt_mega_resources(
        n_lights, int(save_hits), ctypes.byref(regs), ctypes.byref(local)),
        "mega_resources")
    return regs.value, local.value


def split_perm(n, blocks, dev):
    """The permutation of n paths (n a multiple of blocks) under which
    contiguous pools of n / blocks paths hold the interleaved pools:
    column b * (n / blocks) + k takes path b + k * blocks."""
    return torch.arange(n, device=dev).view(n // blocks, blocks).T.reshape(-1)


def variant_cell(libs, ops, depth, n_lights, dev, reps):
    """One cell of --variants: per instance, every build's times in turns
    (kernel first and last), registers and local memory, its rows checked
    against the kernel's; then the scatter split (module docstring)."""
    cell = {}
    kernel = mega._lib()
    builds = {"kernel": kernel, **libs}
    order = list(builds) + list(builds)[::-1]
    for inst, save in (("fwd", False), ("save_hits", True)):
        want = run_lib(kernel, ops, depth, n_lights, save)
        for name, lib in builds.items():
            got = run_lib(lib, ops, depth, n_lights, save)
            check_rows(torch.cat(got) if save else got,
                       torch.cat(want) if save else want, f"{name} {inst}")
            cell[f"{name}.{inst}_regs_local"] = resources(lib, n_lights,
                                                          save)
        for name in order:
            cell.setdefault(f"{name}.{inst}_ms", []).append(common.timed_ms(
                functools.partial(run_lib, builds[name], ops, depth,
                                  n_lights, save), dev, reps))
        # the scatter split: the kernel's pools on both address layouts
        n = ops[0].shape[1]
        blocks = min(SPLIT_BLOCKS, mega.mega_grid(n, n_lights, save))
        while n % blocks:
            blocks -= 1
        perm = split_perm(n, blocks, dev)
        permuted = (ops[0][:, perm].contiguous(),
                    ops[1][:, perm].contiguous()) + tuple(ops[2:])
        runs = {"interleaved": functools.partial(
                    run_lib, kernel, ops, depth, n_lights, save, blocks),
                "contiguous": functools.partial(
                    run_lib, libs["contiguous_pool"], permuted, depth,
                    n_lights, save, blocks)}
        base, got = runs["interleaved"](), runs["contiguous"]()
        check_rows(torch.cat(got) if save else got,
                   torch.cat(base)[:, perm] if save else base[:, perm],
                   f"permuted contiguous pools {inst}")
        for name in ("interleaved", "contiguous", "contiguous",
                     "interleaved"):
            cell.setdefault(f"split{blocks}.{name}.{inst}_ms", []).append(
                common.timed_ms(runs[name], dev, reps))
    return cell


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--scenes", default="room,big_room")
    ap.add_argument("--lights", default="0,3")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", action="store_true",
                    help="time the builds VARIANTS lists (card only)")
    args, dev = common.parse(ap, argv, "lab_mega")
    if args.variants and dev.type != "cuda":
        raise ValueError("--variants builds kernel B's variants: card only")
    libs = build_variants() if args.variants else None
    cfg = RenderConfig(width=512, height=512, spp=16, max_depth=8)
    res = {"device": common.device_name(dev), "n": args.n}
    key = prng_key(0, dev)
    for name in args.scenes.split(","):
        base = sphere_grid_scene(*SCENES[name],
                                 env_radiance=gradient_sky(64, 128),
                                 device=dev)
        for lights in (int(x) for x in args.lights.split(",")):
            if not 0 <= lights <= LIGHTS:
                raise ValueError(f"--lights takes 0 to {LIGHTS}, not "
                                 f"{lights}")
            scene = with_lights(base, lights) if lights else base
            ops, n_lights = frame_operands(scene, cfg, key, args.n)
            if libs is not None:
                cell = variant_cell(libs, ops, cfg.max_depth, n_lights, dev,
                                    args.reps)
            else:
                cell = measure(ops, cfg.max_depth, n_lights, dev, args.reps)
                cell["tile_skip_share"] = tile_skip_share(
                    scene, cfg, key, min(args.n, SKIP_PATHS))
            res[f"{name}.lights{lights}"] = cell
            print(json.dumps({f"{name}.lights{lights}": cell}), flush=True)
    print(json.dumps(res, indent=1), flush=True)
    return res


if __name__ == "__main__":
    main()
