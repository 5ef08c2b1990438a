#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (tinypathtracer_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure exits
non-zero):
  1. the card, the versions, and the build of both CUDA kernels from
     the sources in this checkout;
  2. kernel A (dense closest hit) against its plain PyTorch twin on the
     card: 65,536 rays from inside the 1,804-face room plus a ragged
     batch; (slot, t, u, v) must be exactly equal;
  3. kernel B (the megakernel) against its plain twin on the card:
     64x64 @ 4 spp, depth 8, on the room and on a 3-light variant,
     within atol 1e-5 (the bound of tests/test_torch_mega.py);
  4. the main path through the public entry point,
     Renderer(RenderConfig(512, 512, 16, 8), device="cuda").render, with
     the launch counters zeroed first: the megakernel frame, the modular
     frame on kernel A (compared with the megakernel frame), best-of-3
     times and camera rays/s of both, then one megakernel frame of the
     7,692-face room (8,192 padded faces);
  5. both kernels against their plain twins at the main path's shapes,
     one 2**20-lane chunk of the frame: kernel A on its camera rays
     (exact), kernel B on its rays and uniforms in the room and in the
     big room (atol 1e-5); then the kernels' times beside the twins'.
The last lines are the kernels JSON, the card's name and power limit,
and the result JSON.
"""

import dataclasses
import json
import subprocess
import sys
import time

import torch

ROOM = (2, 8, 16)          # sphere_grid_scene(grid, n_lat, n_lon): 1,804 faces
BIG_ROOM = (2, 16, 32)     # 7,692 faces, 8,192 padded
MEGA_ATOL = 1e-5


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """(mean device time of fn() over reps launches after one warm-up,
    the warm-up's result)."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def check_mega(got, want, what):
    """Kernel B's [16, N] rows against its twin's: finite and within
    MEGA_ATOL. Returns the max abs difference."""
    diff = float((got - want).abs().max())
    lanes = int((got != want).any(dim=0).sum())
    log(f"kernel B vs twin, {what} paths d8: max abs diff {diff:.3e} "
        f"({lanes} lanes not bit-equal), atol {MEGA_ATOL}")
    if not (diff <= MEGA_ATOL and torch.isfinite(got).all()):
        raise AssertionError(f"kernel B != twin on {what} paths: {diff}")
    return diff


def with_lights(scene):
    """The room with one point, one spot and one directional light."""
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
        scene, **{k: v.to(dev) for k, v in lights.items()})


def mega_frame_operands(scene, cfg, key, n_pix=None):
    """Kernel B's operands for the first n_pix pixels of a frame (all by
    default), as the renderer builds them."""
    from tinypathtracer_tpu_torch.ops.mega import mega_operands
    from tinypathtracer_tpu_torch.render.renderer import (lane_rays,
                                                          prepare_state)

    state = prepare_state(scene, cfg)
    pix = torch.arange(n_pix or cfg.n_pixels, device=scene.device)
    o, d, keys = lane_rays(scene, cfg, pix, key)
    return mega_operands(state.data, cfg, state.woop, o, d, keys), state


def compare_images(a, b):
    """(max abs diff, share of pixels beyond 1e-5, mean abs diff)."""
    diff = (a - b).abs().amax(dim=-1)
    return (float(diff.max()), float((diff > 1e-5).float().mean()),
            float(diff.mean()))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import tinypathtracer_tpu_torch as T
    from tinypathtracer_tpu_torch.models.envlight import gradient_sky
    from tinypathtracer_tpu_torch.ops import dense, mega
    from tinypathtracer_tpu_torch.render.integrator import TraceData

    dev = torch.device("cuda")
    # ---- 1. card, versions, kernel build --------------------------------
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    dense._lib()
    mega._lib()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

    # ---- 2. kernel A vs its plain twin ------------------------------------
    sky = gradient_sky(64, 128)
    room = T.sphere_grid_scene(*ROOM, env_radiance=sky, device=dev)
    data = TraceData.from_scene(room)
    woop = dense.precompute_woop(data.tri_verts)
    gen = torch.Generator().manual_seed(0)
    err_a = 0.0
    for n in (65536, 1037):
        o = torch.rand((n, 3), generator=gen) * 9.0 - 4.5
        d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                          dim=1)
        rays = torch.cat([o, d, torch.zeros((n, 2))], dim=1).to(dev)
        kt, ks, kuv = dense.dense_hit(rays, woop.planes)
        pt, ps, puv = dense._dense_torch(rays, woop.planes)
        torch.cuda.synchronize()
        if not (torch.equal(ks, ps) and torch.equal(kt, pt)
                and torch.equal(kuv, puv)):
            raise AssertionError(
                f"kernel A != twin at n={n}: {int((ks != ps).sum())} slots, "
                f"{int((kt != pt).sum())} t differ")
        err_a = max(err_a, float((kuv - puv).abs().max()))
        log(f"kernel A vs twin, {n} rays x {woop.n_faces} faces "
            f"({woop.n_padded} slots): exact; hit share "
            f"{float((ks >= 0).float().mean()):.4f}")

    # ---- 3. kernel B vs its plain twin ------------------------------------
    small = T.RenderConfig(width=64, height=64, spp=4, max_depth=8)
    err_b = 0.0
    for name, scene in (("room", room), ("room+3 lights", with_lights(room))):
        ops, state = mega_frame_operands(scene, small, T.prng_key(1, dev))
        n_lights = state.data.n_lights
        got = mega.mega_trace(*ops, depth=small.max_depth, n_lights=n_lights)
        want = mega._mega_torch(*ops, depth=small.max_depth,
                                n_lights=n_lights)
        torch.cuda.synchronize()
        err_b = max(err_b, check_mega(got, want, f"{name}, {got.shape[1]}"))

    # ---- 4. the main path -------------------------------------------------
    cfg = T.RenderConfig(width=512, height=512, spp=16, max_depth=8)
    n_rays = cfg.n_pixels * cfg.spp
    key = T.prng_key(0)
    host_room = T.sphere_grid_scene(*ROOM, env_radiance=sky)
    dense.dense_hit.launches = 0
    mega.mega_trace.launches = 0
    times, images = {}, {}
    for path, megakernel in (("megakernel", True), ("modular", False)):
        r = T.Renderer(dataclasses.replace(cfg, megakernel=megakernel),
                       device="cuda")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            img = r.render(host_room, key)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times[path], images[path] = best, img
        log(f"main path, {path}: {cfg.width}x{cfg.height} @{cfg.spp}spp "
            f"d{cfg.max_depth}, {n_rays} camera rays: "
            f"best of 3 {best * 1e3:.1f} ms, {n_rays / best:,.0f} rays/s, "
            f"image mean {float(img.mean()):.5f}")
    img = images["megakernel"]
    if not (img.shape == (cfg.height, cfg.width, 3)
            and torch.isfinite(img).all()
            and float(img.mean()) > 0.01):
        raise AssertionError("megakernel frame is not a finite, lit image")
    mx, share, mean = compare_images(img, images["modular"])
    log(f"megakernel vs modular frame: max abs diff {mx:.3e}, share of "
        f"pixels > 1e-5 {share:.2e}, mean abs diff {mean:.3e}")
    if not (share <= 0.005 and mean < 1e-5):
        raise AssertionError("megakernel and modular frames disagree")
    big = T.sphere_grid_scene(*BIG_ROOM, env_radiance=sky)
    r = T.Renderer(cfg, device="cuda")
    t0 = time.perf_counter()
    big_img = r.render(big, key)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    if not (torch.isfinite(big_img).all() and float(big_img.mean()) > 0.01):
        raise AssertionError("big-room frame is not a finite, lit image")
    log(f"main path, megakernel, 7,692-face room (8,192 slots): "
        f"{t_big * 1e3:.1f} ms, {n_rays / t_big:,.0f} rays/s")
    launches = {"dense": dense.dense_hit.launches,
                "mega": mega.mega_trace.launches}
    log(f"launches in the main path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # ---- 5. both kernels against their twins at the main path's shapes ----
    # one 2**20-lane chunk: its camera rays into kernel A, its rays8 / u8d
    # into kernel B (room and big room); outputs compared, then timed
    chunk = cfg.rays_per_dispatch // cfg.spp
    ops, _ = mega_frame_operands(room, cfg, key.to(dev), n_pix=chunk)
    rays = torch.cat([ops[0][0:3].T, ops[0][4:7].T,
                      torch.zeros((ops[0].shape[1], 2), device=dev)],
                     dim=1).contiguous()
    a_ms, got = cuda_ms(lambda: dense.dense_hit(rays, woop.planes), 3)
    a_plain, want = cuda_ms(lambda: dense._dense_torch(rays, woop.planes), 1)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel A != twin on {rays.shape[0]} camera "
                             "rays")
    err_a = max(err_a, float((got[2] - want[2]).abs().max()))
    log(f"kernel A vs twin, {rays.shape[0]} camera rays x {woop.n_padded} "
        f"slots: exact; {a_ms:.2f} ms (plain twin {a_plain:.1f} ms)")
    b_ms, got = cuda_ms(lambda: mega.mega_trace(*ops, depth=8, n_lights=0), 2)
    b_plain, want = cuda_ms(
        lambda: mega._mega_torch(*ops, depth=8, n_lights=0), 1)
    err_b = max(err_b, check_mega(got, want, f"room, {chunk * cfg.spp}"))
    log(f"kernel B, {got.shape[1]} paths d8: {b_ms:.2f} ms "
        f"(plain twin {b_plain:.1f} ms)")
    big_ops, big_state = mega_frame_operands(
        big.to(dev), cfg, key.to(dev), n_pix=chunk)
    got = mega.mega_trace(*big_ops, depth=8, n_lights=0)
    want = mega._mega_torch(*big_ops, depth=8, n_lights=0)
    torch.cuda.synchronize()
    err_b = max(err_b, check_mega(
        got, want, f"big room ({big_state.woop.n_padded} slots), "
        f"{got.shape[1]}"))

    kernels = [
        {"name": "dense_closest_hit", "route": "cuda",
         "source": "tinypathtracer_tpu_torch/csrc/dense.cu",
         "replaces": "tinypathtracer_tpu/ops/dense.py:197",
         "launches": launches["dense"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain},
        {"name": "mega_trace", "route": "cuda",
         "source": "tinypathtracer_tpu_torch/csrc/mega.cu",
         "replaces": "tinypathtracer_tpu/ops/mega.py:224",
         "launches": launches["mega"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
