"""Traffic kind "frame": a closed loop of whole frames.

Each frame is one `Renderer(cfg).render(scene, key)` of the port, ended
by its image synchronised on the card, with a new key drawn from the
seed. Set-up builds the scene's arrays from the configuration file (its
tables are built on the card by the program) and warms up the shapes
the frames use: one full chunk of `rays_per_dispatch` lanes and the
ragged last chunk. The window then renders frames until `seconds` have
passed; each frame it started is finished and counted.

`frame_rays_per_s` is the camera paths (pixels x spp) of all those
frames over the host time from the first frame's start to the last
frame's end. After the window, `samples_per_chunk` pixels of every
chunk of the frame (the ragged last chunk too), each from a frame of
the window drawn from the seed, are compared with the plain reference;
the reference's path statistics on those lanes give the frame's work
for kernel B's roofline.

With --trace 1 the set-up is the same, then one frame is rendered
plainly and one under the profiler; the per-layer metrics read the
profiled one.
"""

from __future__ import annotations

import time
import types

import torch

from portbench import bench, compare, roofline, scenes
from portbench import trace as tr
from portbench.reference import tracer as ref


def frame_key(seed: int, i: int, device):
    """The key of the i-th frame of a run: fold_in(PRNGKey(seed), i)."""
    return ref.fold_in(ref.prng_key(seed, device), i)


def chunk_pixels(rcfg) -> int:
    """Pixels a chunk of the renderer holds (all spp of a pixel in one)."""
    return max(1, min(rcfg.n_pixels, rcfg.rays_per_dispatch // rcfg.spp))


def _warm_up(rend, scene, rcfg, job):
    """Render one full chunk and the ragged last chunk of the frame's
    pixels (only those shapes), and synchronise."""
    px_chunk = chunk_pixels(rcfg)
    n = rcfg.n_pixels
    count = n if n <= px_chunk else px_chunk + (n % px_chunk or px_chunk)
    with torch.inference_mode():
        state = rend.prepare_state(scene, rcfg)
        pix = torch.arange(count, dtype=torch.int64, device=job.device)
        rend.render_pixel_ids(state, rcfg, pix,
                              frame_key(job.seed, 2**31 - 1, job.device))
    job.sync()


def _render(renderer, scene, key, job):
    img = renderer.render(scene, key)
    job.sync()
    return img


def sample_pixels(images, seed: int, per_chunk: int, rcfg):
    """per_chunk pixels of every chunk of the frame, each drawn with its
    frame from the seed over the frames' images (top-down rows):
    (frame [n], raw pixel id [n] (row-major from the bottom row, as the
    renderer numbers pixels), chunk [n], values [n, 3] on the host)."""
    g = torch.Generator().manual_seed(seed % 2**63)
    px = chunk_pixels(rcfg)
    starts = torch.arange(0, rcfg.n_pixels, px)
    sizes = torch.clamp(rcfg.n_pixels - starts, max=px)
    chunk = torch.arange(len(starts)).repeat_interleave(per_chunk)
    off = (torch.rand(len(chunk), generator=g, dtype=torch.float64)
           * sizes[chunk]).long()
    pix = starts[chunk] + torch.minimum(off, sizes[chunk] - 1)
    which = torch.randint(len(images), (len(pix),), generator=g)
    rows, cols = rcfg.height - 1 - pix // rcfg.width, pix % rcfg.width
    vals = torch.empty((len(pix), 3))
    for f in range(len(images)):
        sel = (which == f).nonzero()[:, 0]
        if len(sel):
            dev = images[f].device
            vals[sel] = images[f][rows[sel].to(dev), cols[sel].to(dev)].cpu()
    return which, pix, chunk, vals


def reference_pixels(tab, keys, which, pix, rcfg, tf32=False, stats=None):
    """The reference's mean radiance [n, 3] (host) of the sampled pixels,
    frame f rendered with keys[f]."""
    dev = tab.tri.device
    out = torch.empty((pix.shape[0], 3))
    for f in sorted(set(which.tolist())):
        sel = (which == f).nonzero()[:, 0]
        out[sel] = ref.render_pixels(
            tab, keys[f], pix[sel].to(dev), rcfg.width, rcfg.height,
            rcfg.spp, rcfg.max_depth, tf32=tf32, stats=stats).cpu()
    return out


def run(job: bench.Run) -> bench.Outcome:
    import tinypathtracer_tpu_torch as T
    from tinypathtracer_tpu_torch.render import renderer as rend

    cell, dev = job.cell, job.device
    arrays = scenes.build(cell.config)
    rcfg = T.RenderConfig(**scenes.render_args(cell.config))
    scene = T.FlatScene.from_numpy(arrays, dev)
    renderer = T.Renderer(rcfg, device=dev)
    job.sync()
    bench.log(job, "the port imported, the scene on the device")
    _warm_up(rend, scene, rcfg, job)
    setup_s = job.since_start()
    bench.log(job, f"set-up done: {scene.indices.shape[0]} faces")

    images, keys, e2e, ctx = [], [], {}, None
    if not job.trace:
        t0 = time.perf_counter()
        ends = [t0]
        while not images or ends[-1] - t0 < job.seconds:
            keys.append(frame_key(job.seed, len(keys), dev))
            images.append(_render(renderer, scene, keys[-1], job))
            ends.append(time.perf_counter())
        wall = ends[-1] - t0
        bench.log(job, "frame seconds " + " ".join(
            f"{b - a:.4f}" for a, b in zip(ends, ends[1:])))
        rays = len(images) * rcfg.n_pixels * rcfg.spp
        e2e = {"frame_rays_per_s": rays / wall, "setup_s": setup_s}
    else:
        keys.append(frame_key(job.seed, 0, dev))
        images.append(_render(renderer, scene, keys[-1], job))
        keys.append(frame_key(job.seed, 1, dev))
        img, reduced = tr.profiled(
            lambda: _render(renderer, scene, keys[-1], job), dev)
        images.append(img)
        ctx = types.SimpleNamespace(trace=reduced, units=1, work=None)
    bench.log(job, f"window done: {len(images)} frames")
    bad = sum(int(not bool(torch.isfinite(im).all())) for im in images)
    peak = bench.peak_bytes(dev)

    # the sampled pixels of the window's frames, then the program's state
    # is freed before the reference runs
    which, pix, chunk, port = sample_pixels(
        images, job.seed, int(cell.traffic["samples_per_chunk"]), rcfg)
    del images, renderer, scene
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tab = ref.Tables.build(arrays, dev)
    stats = {}
    want = reference_pixels(tab, keys, which, pix, rcfg, stats=stats)
    numbers = compare.frame_numbers(port, want, chunk)
    bench.log(job, f"reference done: {len(pix)} pixels, path statistics "
              f"{stats}")

    breakdown = busy = window = None
    if ctx is not None:
        ctx.work = roofline.frame_work(stats, rcfg.width, rcfg.height,
                                       rcfg.spp, rcfg.max_depth,
                                       tab.n_faces, rcfg.rays_per_dispatch)
        breakdown = ctx.trace.breakdown()
        busy, window = ctx.trace.busy_s, ctx.trace.window_s
    return bench.Outcome(
        attempted=len(keys), failed=bad, end_to_end=e2e, layer_ctx=ctx,
        numbers=numbers, memory_peak_bytes=peak, busy_s=busy,
        window_s=window, breakdown=breakdown)
