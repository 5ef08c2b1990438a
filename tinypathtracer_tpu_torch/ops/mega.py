"""Reference-mode path-tracing megakernel (port of
`tinypathtracer_tpu/ops/mega.py`).

One kernel launch traces a whole chunk of paths through every bounce:
the camera closest hit, then per bounce the shading fetch of the hit
slot, (t, u, v) recomputed from the slot's planes, the interpolated
normal, emission and termination, the BSDF sample, the extra cosine
emitter query and up to 6 delta-light any-hits. All queries of a bounce
leave from the same hit point, so one pass over the triangles serves
them all. Per-bounce uniforms come precomputed (`u8d`, the exact draws
of the modular loop) and the env lookup of lanes that missed runs after
the kernel (the epilogue in `trace_paths_mega`), so the image equals the
modular path's (render/integrator.py) by key.

The CUDA kernel (`csrc/mega.cu`, kernel B) replaces the TPU kernel
`_make_mega_kernel`. `_mega_torch` is its plain PyTorch twin: same
inputs and outputs (the JAX package's [K, N] layouts), same arithmetic.
It shades each bounce with the modular path's own helpers
(`render.integrator.scatter` and `end_bounce`) and differs from it only
in how it queries hits. `mega_trace` dispatches on the tensors' device.
Kernel B runs persistent blocks of `mega_threads(n_lights)` lanes, each
lane taking the next path of its block's pool when its path ends;
`_mega_schedule` is the plain model of that schedule (the sweeps each
block runs, from each path's `path_lengths`), which chip_smoke.py holds
the kernel to.

With `save_hits` the kernel also records per-bounce hit residuals
(`unpack_hits` turns them into the integrator's stored-hit layout).
Under autograd, `trace_paths_mega` is a `torch.autograd.Function` whose
backward replays only the shading on those residuals
(`render.integrator.trace_paths(stored_hits=...)`): no intersection runs
in the backward pass. Each chunk of rays is its own node, so the replay
graph of one chunk at a time is alive during `backward()`.

Scope (`mega_available`): reference mode, <= 8192 padded faces, <= 6
delta lights. A textured scene runs the kernel too: texels modulate the
base color only, never a direction, a hit or a termination, so the
paths the kernel traces are the textured paths. `trace_paths_mega` runs
the save_hits instance hits-only, drops its radiance and returns the
shading replay on its hits (`trace_paths(stored_hits=...)`), which
applies the textures and is differentiable, texels included, with no
autograd.Function and no intersection in the backward pass; like every
replay under autograd it is rematerialised bounce by bounce, so a
chunk's graph holds only the carries between bounces. The JAX
package's "replay" backward is not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tinypathtracer_tpu_torch.ops.dense import (WoopTris, hit_terms,
                                                origin_terms, scan_queries)
from tinypathtracer_tpu_torch.ops.lights import MAX_LIGHTS, lights_block
from tinypathtracer_tpu_torch.ops.sampling import lane_draws
from tinypathtracer_tpu_torch.render.integrator import (Paths, TraceData,
                                                        end_bounce, env_miss,
                                                        scatter, trace_paths)
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import REAL_MAX
from tinypathtracer_tpu_torch.utils.metrics import span

MEGA_MAX_FACES = 8192
# shadeT row map (rows of the [32, Fp] fused table): rows 12-26 are the
# first 15 shade_packT rows (corner normals, base color, emission, eta,
# metallic); a textured scene's texcoord rows 15-20 stay out
_ROW_NRM = 12
_ROW_EM = 24
_ROW_METAL = 26
_SHADE_ROWS = 32


def _scene_blocks(data: TraceData, woop: WoopTris):
    """Slot-indexed planes [Fp, 12] and fused shading table [32, Fp]:
    rows 0-11 planes, 12-20 corner normals, 21-23 base color, 24
    emission, 25 eta, 26 metallic, 27-31 zero. Padding slots are zero."""
    fp = woop.n_padded
    valid = torch.arange(fp, device=woop.planes.device) < woop.n_faces
    shade_m = data.shade_packT[:15, woop.perm] * valid[None, :].float()
    shadeT = torch.cat([woop.planes.T, shade_m,
                        shade_m.new_zeros((_SHADE_ROWS - 27, fp))], dim=0)
    return woop.planes, shadeT.contiguous()


def mega_available(data: TraceData, cfg, woop: WoopTris = None) -> bool:
    """Static scope check: reference mode, few enough delta lights, and
    a scene small enough for the megakernel (<= 8192 padded faces, given
    woop), textured or not."""
    return (cfg.mode == "reference" and data.n_lights <= MAX_LIGHTS
            and (woop is None or woop.n_padded <= MEGA_MAX_FACES))


def _check_mega_args(rays8, u8d, planesT, shadeT, lights, depth, n_lights):
    n, fp = rays8.shape[1], planesT.shape[0]
    if (rays8.shape[0] != 8 or tuple(u8d.shape) != (8 * depth, n)
            or planesT.shape[1] != 12 or tuple(shadeT.shape) != (32, fp)
            or lights.shape[1] != 16 or lights.shape[0] < max(n_lights, 1)
            or not 0 <= n_lights <= MAX_LIGHTS):
        raise ValueError(
            f"bad megakernel operands: rays8 {tuple(rays8.shape)}, u8d "
            f"{tuple(u8d.shape)}, planesT {tuple(planesT.shape)}, shadeT "
            f"{tuple(shadeT.shape)}, lights {tuple(lights.shape)}, depth "
            f"{depth}, n_lights {n_lights}")


def _dead_hits(depth: int, n: int, like):
    """[8*depth, N] residual rows of bounces no lane reached: slot -1,
    t REAL_MAX, slot2 -1, the rest 0."""
    rows = like.new_zeros((depth, 8, n))
    rows[:, 0] = -1.0
    rows[:, 1] = REAL_MAX
    rows[:, 4] = -1.0
    return rows.reshape(8 * depth, n)


def _mega_torch(rays8, u8d, planesT, shadeT, lights, depth: int,
                n_lights: int, save_hits: bool = False):
    """Plain twin of kernel B. rays8 [8, N] (origin xyz, 0, dir xyz, 0);
    u8d [8*depth, N] (6 uniforms + 2 zero rows per bounce); planesT
    [Fp, 12]; shadeT [32, Fp]; lights [max(L, 1), 16]. Returns [16, N]:
    rows 0-2 radiance, 3-5 throughput at miss, 6-8 final direction; with
    save_hits also the [8*depth, N] hit residuals, per bounce the rows
    slot, t, u, v (of the lane's hit; slot -1 and t REAL_MAX on a dead or
    missing lane), slot2 (the extra emitter query's hit, -1 unless the
    lane goes on and the query counts), the occlusion bits (sum of
    2**li over occluded lights, 0 unless the lane goes on), 0, 0."""
    n = rays8.shape[1]
    shade = shadeT.T                                     # [Fp, 32]
    st = Paths.start((rays8[0], rays8[1], rays8[2]),
                     (rays8[4], rays8[5], rays8[6]))
    ((_, slot),), _ = scan_queries(planesT, st.o, [st.d], 1)
    zeros = rays8.new_zeros((n,))
    thr_miss = (zeros, zeros, zeros)
    hits = _dead_hits(depth, n, rays8) if save_hits else None
    for dep in range(depth):
        if not bool(st.alive.any()):
            break        # dead lanes never change state
        miss = slot < 0
        count_env = st.alive & miss
        thr_miss = tuple(torch.where(count_env, tc, m)
                         for tc, m in zip(st.thr, thr_miss))
        blk = shade[torch.clamp_min(slot, 0).long()].T   # [32, N]
        # (t, u, v) recomputed from the winner's planes with the scan's
        # arithmetic: bit-equal to the values the scan compared
        w = list(blk[:12])
        t, bu, bv = hit_terms(origin_terms(*st.o, w), *st.d, w)
        st, sc = scatter(st, miss, t, bu, bv, blk[_ROW_NRM:_ROW_METAL + 1],
                         u8d[8 * dep:8 * dep + 8], lights, n_lights)

        # One pass over the triangles for every query of the bounce, on
        # the live lanes only (the others' results are never read). The
        # next-direction query is skipped on the last bounce.
        idx = sc.live.nonzero()[:, 0]
        closest = [sc.d2] + ([sc.nd] if dep + 1 < depth else [])
        qdirs = [tuple(c[idx] for c in q)
                 for q in closest + [wi for wi, _ in sc.lights]]
        res, occ = scan_queries(planesT, tuple(c[idx] for c in sc.h), qdirs,
                                len(closest))
        slot2 = torch.full_like(slot, -1).index_put_((idx,), res[0][1])
        slot_n = torch.full_like(slot, -1)
        if dep + 1 < depth:
            slot_n.index_put_((idx,), res[1][1])
        unocc = [~torch.zeros_like(sc.live).index_put_((idx,), o)
                 for o in occ]
        if save_hits:
            hitm = st.alive & ~miss
            occm = zeros
            for li, free in enumerate(unocc):
                occm = occm + torch.where(sc.live & ~free, float(1 << li), 0.0)
            s2 = torch.where(sc.live & sc.do_extra & (slot2 >= 0), slot2, -1)
            hits[8 * dep:8 * dep + 8] = torch.stack([
                torch.where(st.alive, slot, -1).float(),
                torch.where(hitm, t, REAL_MAX), torch.where(hitm, bu, 0.0),
                torch.where(hitm, bv, 0.0), s2.float(), occm, zeros, zeros])
        st = end_bounce(st, sc, slot2.long(), shade[:, _ROW_EM], unocc)
        slot = slot_n
    out = torch.stack([*st.rad, *thr_miss, *st.d] + [zeros] * 7, dim=0)
    return (out, hits) if save_hits else out


def path_lengths(hits, shadeT, depth: int):
    """The sweeps each path needs, from its [8*depth, N] hit residuals:
    its camera query, then one per live bounce (hit, not emissive).
    int64 [N], each in 1..depth + 1."""
    slot = hits.view(depth, 8, -1)[:, 0].long()
    live = (slot >= 0) & (shadeT[_ROW_EM][slot.clamp_min(0)] <= 0.0)
    return 1 + live.sum(dim=0)


def mega_threads(n_lights: int) -> int:
    """Lanes of a block of kernel B's instances for n_lights
    (csrc/mega.cu `lanes`)."""
    return 512 if n_lights <= 2 else 256


def _mega_schedule(lengths, blocks: int, threads: int):
    """Plain model of kernel B's schedule, for the tests and chip_smoke.py
    only: no route calls it. Block b of `blocks` holds the pool of paths
    b, b + blocks, b + 2 blocks, ...; each round, lanes whose path has
    ended take the next paths of the pool in lane order, then every lane
    that holds a path sweeps once; a path holds its lane for
    lengths[path] rounds in a row (`path_lengths`). A block ends when its
    pool is spent and no lane holds a path.

    Returns (rounds int32 [blocks], the sweeps each block ran; lane int64
    [N], block * threads + the lane that ran each path; start int64 [N],
    the round of the block in which each path started)."""
    n, dev = lengths.shape[0], lengths.device
    length = lengths.long()
    ids = torch.arange(blocks, device=dev)
    pool = (n - ids + blocks - 1) // blocks
    left = torch.zeros((blocks, threads), dtype=torch.int64, device=dev)
    lane_id = torch.arange(blocks * threads, device=dev).view(blocks, threads)
    taken = torch.zeros_like(ids)
    rounds = torch.zeros((blocks,), dtype=torch.int32, device=dev)
    lane = torch.full((n,), -1, dtype=torch.int64, device=dev)
    start = torch.full((n,), -1, dtype=torch.int64, device=dev)
    r = 0
    while True:
        free = left == 0
        rank = free.long().cumsum(dim=1) - 1
        take = torch.minimum(free.sum(dim=1), pool - taken)
        got = free & (rank < take[:, None])
        path = (ids[:, None] + (taken[:, None] + rank) * blocks)[got]
        left[got] = length[path]
        lane[path] = lane_id[got]
        start[path] = r
        taken += take
        busy = left > 0
        running = busy.any(dim=1)
        if not bool(running.any()):
            break
        rounds += running.int()
        left -= busy.long()
        r += 1
    return rounds, lane, start


def _bind(lib):
    """Declares the C entry points of a build of csrc/mega.cu (this
    module's, or a lab variant's: tools/lab_mega.py)."""
    lib.tpt_mega_trace.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 4
    lib.tpt_mega_trace.restype = ctypes.c_int
    lib.tpt_mega_grid.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.tpt_mega_grid.restype = ctypes.c_int
    lib.tpt_mega_resources.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.tpt_mega_resources.restype = ctypes.c_int
    lib.tpt_mega_threads.argtypes = [ctypes.c_int]
    lib.tpt_mega_threads.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    lib = _bind(cuda_build.load_library("mega"))
    for n_lights in range(MAX_LIGHTS + 1):
        if lib.tpt_mega_threads(n_lights) != mega_threads(n_lights):
            raise RuntimeError(
                f"csrc/mega.cu runs {lib.tpt_mega_threads(n_lights)} lanes a "
                f"block with {n_lights} lights, mega_threads "
                f"{mega_threads(n_lights)}")
    return lib


def kernel_resources(n_lights: int, save_hits: bool):
    """(registers per thread, local spill bytes per thread) of one
    instance of kernel B, from cudaFuncGetAttributes."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    status = _lib().tpt_mega_resources(n_lights, int(save_hits),
                                       ctypes.byref(regs), ctypes.byref(local))
    cuda_build.check_launch(status, "mega_resources")
    return regs.value, local.value


def mega_grid(n: int, n_lights: int, save_hits: bool = False) -> int:
    """The blocks kernel B launches for n paths: as many as the card's
    SMs hold at once (from the instance's occupancy), at most one per
    mega_threads(n_lights) paths."""
    blocks = ctypes.c_int()
    status = _lib().tpt_mega_grid(n, n_lights, int(save_hits),
                                  ctypes.byref(blocks))
    cuda_build.check_launch(status, "mega_grid")
    return blocks.value


def _mega_cuda(rays8, u8d, planesT, shadeT, lights, depth: int,
               n_lights: int, save_hits: bool, rounds=None, blocks: int = 0):
    """Kernel B. With `rounds` (int32 [blocks] on the rays' device, blocks
    = mega_grid(N, ...) unless given) it also writes the sweeps each block
    ran; the route passes none. `blocks` in 1..N overrides the grid: N /
    mega_threads(n_lights) blocks or more give each lane one path, no
    refill (for tools/lab_mega.py)."""
    shade_rows = shadeT.T.contiguous()                   # [Fp, 32] face-major
    cuda_build.check_operands(rays8, u8d, planesT, shade_rows, lights)
    n, fp, dev = rays8.shape[1], planesT.shape[0], rays8.device
    out = torch.empty((16, n), dtype=torch.float32, device=dev)
    hits = (torch.empty((8 * depth, n), dtype=torch.float32, device=dev)
            if save_hits else None)
    if n == 0:
        return (out, hits) if save_hits else out
    if rounds is not None:
        g = blocks if blocks > 0 else mega_grid(n, n_lights, save_hits)
        if not (rounds.dtype == torch.int32 and rounds.device == dev
                and rounds.is_contiguous() and rounds.shape == (g,)):
            raise ValueError(f"rounds must be a contiguous int32 tensor of "
                             f"{g} on {dev}")
    with span("tpt.kernel_b"):
        status = _lib().tpt_mega_trace(
            rays8.data_ptr(), u8d.data_ptr(), planesT.data_ptr(),
            shade_rows.data_ptr(), lights.data_ptr(), n, fp, depth, n_lights,
            blocks, out.data_ptr(), hits.data_ptr() if save_hits else None,
            None if rounds is None else rounds.data_ptr(),
            cuda_build.stream_ptr(dev))
    cuda_build.check_launch(status, "mega_trace")
    if save_hits:
        mega_trace.launches_save_hits += 1
        return out, hits
    mega_trace.launches += 1
    return out


def mega_trace(rays8, u8d, planesT, shadeT, lights, depth: int,
               n_lights: int, save_hits: bool = False, rounds=None):
    """Trace paths to completion: kernel B on CUDA tensors, its plain
    twin on CPU tensors. Returns out, or (out, hits) with save_hits. See
    `_mega_torch` for the layouts. With `rounds` (int32 [mega_grid(N,
    n_lights, save_hits)] on the card) kernel B also writes the sweeps
    each of its blocks ran (`_mega_schedule` models them); the twin has
    no blocks and refuses it. Launches are counted per instance:
    `mega_trace.launches` (forward) and `mega_trace.launches_save_hits`."""
    _check_mega_args(rays8, u8d, planesT, shadeT, lights, depth, n_lights)
    if rays8.device.type == "cuda":
        return _mega_cuda(rays8, u8d, planesT, shadeT, lights, depth,
                          n_lights, save_hits, rounds)
    if rays8.device.type == "cpu":
        if rounds is not None:
            raise ValueError("rounds are counted by kernel B only: the "
                             "plain twin runs no blocks")
        with span("tpt.kernel_b"):
            return _mega_torch(rays8, u8d, planesT, shadeT, lights, depth,
                               n_lights, save_hits)
    raise ValueError(f"mega_trace has no kernel for device {rays8.device}")


mega_trace.launches = 0
mega_trace.launches_save_hits = 0


def unpack_hits(hits, perm, depth: int):
    """Kernel B's [8*depth, N] residuals -> the integrator's stored_hits:
    (fid [D, N], t [D, N], uv [D, N, 2], fid2 [D, N], occ [D, N]), slots
    turned into original face ids through the Woop permutation (-1 stays
    -1), as `closest_hit_dense` reports them."""
    hr = hits.reshape(depth, 8, -1)

    def face(slot_row):
        slot = slot_row.long()
        return torch.where(slot >= 0, perm[torch.clamp_min(slot, 0)], -1)

    return (face(hr[:, 0]), hr[:, 1], torch.stack([hr[:, 2], hr[:, 3]], -1),
            face(hr[:, 4]), hr[:, 5].long())


def bounce_uniforms(lane_keys, depth: int):
    """u8d [8*depth, N]: per bounce the modular loop's exact draws
    lane_uniform(fold_all(keys, bounce), 6), padded to 8 rows (one launch
    of csrc/keys.cu on the card)."""
    return lane_draws(lane_keys, 0, depth, 6, 8)


def mega_operands(data: TraceData, cfg, woop: WoopTris, origins, dirs,
                  lane_keys):
    """The positional operands of `mega_trace` for a ray batch: (rays8,
    u8d, planesT, shadeT, lights); depth and n_lights come from cfg and
    data."""
    n = origins.shape[0]
    planesT, shadeT = _scene_blocks(data, woop)
    z = origins.new_zeros((1, n))
    rays8 = torch.cat([origins.T, z, dirs.T, z], dim=0).contiguous()
    return (rays8, bounce_uniforms(lane_keys, cfg.max_depth), planesT,
            shadeT, lights_block(data))


def _env_epilogue(data: TraceData, cfg, out):
    """Radiance [N, 3] from kernel B's rows: a lane misses at most once
    (miss terminates), so the kernel returns the throughput at the miss
    and the final direction, and the env lookup runs here."""
    er, eg, eb = env_miss(data, cfg, out[6], out[7], out[8])
    return torch.stack([out[0] + out[3] * er, out[1] + out[4] * eg,
                        out[2] + out[5] * eb], dim=1)


_DATA_FIELDS = [f.name for f in dataclasses.fields(TraceData)]


class _MegaStored(torch.autograd.Function):
    """The megakernel forward with the stored-hit backward (JAX
    `trace_paths_mega`, mega_bwd="stored").

    Inputs after (cfg, woop, lane_keys): origins, dirs and the TraceData
    fields in declaration order, passed explicitly: a tensor the
    function only captured would get no gradient. The forward saves the
    hit residuals and the uniforms (8 * depth floats each per lane), so
    the backward neither intersects nor draws again."""

    @staticmethod
    def forward(ctx, cfg, woop, lane_keys, origins, dirs, *fields):
        data = TraceData(*fields)
        ops = mega_operands(data, cfg, woop, origins, dirs, lane_keys)
        out, hits = mega_trace(*ops, depth=cfg.max_depth,
                               n_lights=data.n_lights, save_hits=True)
        ctx.cfg = cfg
        ctx.save_for_backward(ops[1], hits, woop.perm, origins, dirs, *fields)
        return _env_epilogue(data, cfg, out)

    @staticmethod
    def backward(ctx, ct):
        u8d, hits, perm, *inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        cfg = ctx.cfg
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() if need else x
                      for x, need in zip(inputs, needs)]
            # differentiated at once: no per-bounce rematerialisation
            rad = trace_paths(TraceData(*leaves[2:]), cfg, None, leaves[0],
                              leaves[1], None,
                              unpack_hits(hits, perm, cfg.max_depth), u8d,
                              remat=False)
            wrt = [x for x, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(rad, wrt, ct, allow_unused=True))
        return (None, None, None) + tuple(next(grads) if need else None
                                          for need in needs)


def trace_paths_mega(data: TraceData, cfg, woop: WoopTris, origins, dirs,
                     lane_keys):
    """Megakernel trace of a ray batch; returns radiance [N, 3], equal by
    key to `render.integrator.trace_paths` on the dense intersector.
    Differentiable: when autograd records and an input needs a gradient,
    the forward runs the save_hits instance and the backward replays the
    shading on its residuals (`_MegaStored`). On a textured scene the
    kernel only records the hits: the radiance is the shading replay on
    them, under autograd as it stands."""
    if data.textured:
        with torch.no_grad():
            ops = mega_operands(data, cfg, woop, origins, dirs, lane_keys)
            _, hits = mega_trace(*ops, depth=cfg.max_depth,
                                 n_lights=data.n_lights, save_hits=True)
        return trace_paths(data, cfg, None, origins, dirs, None,
                           stored_hits=unpack_hits(hits, woop.perm,
                                                   cfg.max_depth),
                           uniforms=ops[1])
    fields = [getattr(data, name) for name in _DATA_FIELDS]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in [origins, dirs] + fields):
        return _MegaStored.apply(cfg, woop, lane_keys, origins, dirs, *fields)
    out = mega_trace(*mega_operands(data, cfg, woop, origins, dirs,
                                    lane_keys),
                     depth=cfg.max_depth, n_lights=data.n_lights)
    return _env_epilogue(data, cfg, out)
