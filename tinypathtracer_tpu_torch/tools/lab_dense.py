"""Kernel lab: kernel A (the dense closest hit, csrc/dense.cu) and its
SUPER gate.

Cells, each a batch of rays as the modular loop sends them (the 512x512
@16 spp d8 frame, cut into lanes as the renderer cuts it):

  room.camera      the first --n camera lanes of the room
                   (sphere_grid_scene(2, 8, 16), 1,920 slots: ungated)
  room.bounce      their first-bounce rays (origins at the camera rays'
                   hits, BSDF directions), masked where the path ended
  big_room.camera  the first --n camera lanes of the big room (2, 16, 32),
                   8,192 slots: gated, 8 runs
  large.camera     the first --large-n camera lanes of the large scene
                   (4, 16, 32), 65,536 slots: gated, 64 runs

For each it prints:

  ms                kernel A's time (CUDA events, median of --reps after
                    one warm-up; the plain twin's on the CPU)
  bound_ms, bound_by             the all-pairs bound: every live ray
                    against every real face, o' once per distinct origin
                    and face, whatever implements them (dense_pairs)
  tested_bound_ms, tested_bound_by   the tested-pairs bound: the faces
                    of the runs each warp tested (tested_runs), with the
                    gate's slab tests
  tested_share      (warp, run) pairs tested over all of them (warps
                    that hold rays)
  staged_share      (block, run) pairs staged over all of them
  live_share        the unmasked rays
  regs, local_bytes, blocks_per_sm   kernel A's (null on the CPU)

The counts come from a counting launch of kernel A (chip_smoke.py phase
2 holds them, and its outputs, to the plain model's,
ops/dense._dense_schedule); on the CPU from the model.

With --variants (on the card only) it times instead the designs kernel A
did not keep, each a build of csrc/dense.cu with the edits VARIANTS
lists, in turns with the kernel (the kernel, each variant, then the same
in reverse order), per cell, with each build's registers and local
memory. Every variant's outputs must equal the kernel's.

Usage: python -m tinypathtracer_tpu_torch.tools.lab_dense [--device
       cuda|cpu] [--n 1048576] [--large-n 65536]
       [--cells room.camera,room.bounce,big_room.camera,large.camera]
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
from tinypathtracer_tpu_torch.ops import dense
from tinypathtracer_tpu_torch.ops.sampling import prng_key
from tinypathtracer_tpu_torch.render.integrator import trace_paths
from tinypathtracer_tpu_torch.render.renderer import lane_rays, prepare_state
from tinypathtracer_tpu_torch.tools import common
from tinypathtracer_tpu_torch.utils import cuda_build

SCENES = {"room": (2, 8, 16), "big_room": (2, 16, 32), "large": (4, 16, 32)}
CELLS = ("room.camera", "room.bounce", "big_room.camera", "large.camera")

# The original kernel (one ray a thread, the planes read from global
# memory, no gate), launched in place of the kernel
_ORIGINAL = '''
__global__ void original_kernel(const float* __restrict__ rays,
                           const float* __restrict__ planes,
                           const unsigned char* __restrict__ live, int n,
                           int fp, float* __restrict__ t_out,
                           int* __restrict__ slot_out,
                           float* __restrict__ uv_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* r = rays + 8 * (size_t)i;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  float best_t = tpt::kRealMax, best_u = 0.f, best_v = 0.f;
  int best = -1;
  for (int f = 0; f < fp; ++f) {
    float w[12];
    tpt::load_planes(planes + 12 * (size_t)f, w);
    const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
    float t, u, v;
    if (tpt::hit_terms(op, dx, dy, dz, w, t, u, v) && t < best_t) {
      best_t = t;
      best = f;
      best_u = u;
      best_v = v;
    }
  }
  if (live != nullptr && live[i] == 0) {
    best_t = tpt::kRealMax;
    best = -1;
    best_u = best_v = 0.f;
  }
  t_out[i] = best_t;
  slot_out[i] = best;
  uv_out[2 * (size_t)i] = best_u;
  uv_out[2 * (size_t)i + 1] = best_v;
}

'''
_LAUNCH = '''  dense_hit_kernel<<<blocks, kThreads, kRunBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      rays, planes, boxes, n_boxes, live, n, fp, t, slot, uv, tested, staged);
'''
_ANCHOR = "// The run buffer's dynamic shared memory"
_NO_GATE = ("    if (boxes != nullptr) {", "    if (false) {")
_NO_ONE_ORIGIN = ("  const bool one_origin = __all_sync(kFull, same);",
                  "  const bool one_origin = false;")
# exact tests before the divide (t = -o'z / d'z cannot be > 0 when o'z
# and d'z share a sign, nor < best when |o'z| >= best |d'z| past the
# product's rounding); a warp skips the rest of a slot when they reject
# every pair of it
_REJECTED = """// Whether a pair certainly fails t > DELTA or t < best.
__device__ __forceinline__ bool rejected(float opz, float dpz, float best) {
  const bool one_sign =
      ((__float_as_uint(opz) ^ __float_as_uint(dpz)) & 0x80000000u) == 0u;
  const float p = best * fabsf(dpz);
  return one_sign || (p >= 0x1p-100f && fabsf(opz) >= p * (1.f + 0x1p-21f));
}

"""
_TILE_ANCHOR = "// The slots [base, base + m) of a staged tile"
_PAIR_LOOP = """#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      if (!kOneOrigin) op[q] = tpt::origin_terms(ox[q], oy[q], oz[q], w);
      float t, u, v;
"""
_PAIR_LOOP_REJECTING = """#pragma unroll
    for (int q = 0; q < kRays; ++q)
      if (!kOneOrigin) op[q] = tpt::origin_terms(ox[q], oy[q], oz[q], w);
    bool open = false;
#pragma unroll
    for (int q = 0; q < kRays; ++q)
      open |= !rejected(op[kOneOrigin ? 0 : q].z,
                        tpt::affine(dx[q], dy[q], dz[q], w[8], w[9], w[10]),
                        best_t[q]);
    if (!__any_sync(kFull, open)) continue;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      float t, u, v;
"""


def _rays_per_thread(r):
    return ("constexpr int kRays = 4;", f"constexpr int kRays = {r};")


# The designs kernel A did not keep: edits (text, replacement) of
# csrc/dense.cu, each text found exactly once.
VARIANTS = {
    "original": [(_ANCHOR, _ORIGINAL + _ANCHOR),
            (_LAUNCH, "  original_kernel<<<(n + 127) / 128, 128, 0,\n"
                      "               static_cast<cudaStream_t>(stream)>>>("
                      "rays, planes, live, n, fp, t, slot, uv);\n")],
    # the run staged by TMA, one ray a thread, no gate, no shared origin
    "staging_only": [_rays_per_thread(1), _NO_GATE, _NO_ONE_ORIGIN],
    "rays1": [_rays_per_thread(1)],
    "rays2": [_rays_per_thread(2)],
    "no_one_origin": [_NO_ONE_ORIGIN],
    "no_gate": [_NO_GATE],
    "prereject": [(_TILE_ANCHOR, _REJECTED + _TILE_ANCHOR),
                  (_PAIR_LOOP, _PAIR_LOOP_REJECTING)],
    "no_unroll": [("#pragma unroll 4\n  for (int j = 0;",
                   "  for (int j = 0;")],
    "unroll2": [("#pragma unroll 4\n  for (int j = 0;",
                 "#pragma unroll 2\n  for (int j = 0;")],
    # 128 threads (4 warps) a block, 4 blocks an SM; 256 threads, 2 blocks
    "threads128": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 128;"),
                   ("constexpr int kMinBlocks = 3;",
                    "constexpr int kMinBlocks = 4;")],
    "min_blocks2": [("constexpr int kMinBlocks = 3;",
                     "constexpr int kMinBlocks = 2;")],
    # 4 blocks an SM: at most 64 registers a thread
    "min_blocks4": [("constexpr int kMinBlocks = 3;",
                     "constexpr int kMinBlocks = 4;")],
    "rays3_blocks4": [_rays_per_thread(3),
                      ("constexpr int kMinBlocks = 3;",
                       "constexpr int kMinBlocks = 4;")],
    # every warp of a block tests each run the block stages
    "block_gate": [("    if (!warp_need) continue;\n    ++tested;\n",
                    "    ++tested;\n")],
    # masked rays vote and are tested as live ones; their outputs are
    # still misses
    "masked_in_sweep": [
        ("    on[q] = i < n && (live == nullptr || live[i] != 0);",
         "    on[q] = i < n;"),
        ("    const int slot = on[q] ? best[q] : -1;",
         "    const int slot =\n"
         "        (live == nullptr || live[i] != 0) ? best[q] : -1;")],
}


def first_bounce(state, cfg, o, d, keys):
    """The rays of the first bounce after the camera query (origins at
    the camera rays' hits, the BSDF directions) and their alive mask,
    recorded from the modular loop's own queries on kernel A."""
    seen = []

    def spy(o_, d_, mask=None):
        seen.append((o_, d_, mask))
        return dense.closest_hit_dense(o_, d_, state.woop, mask=mask)

    trace_paths(state.data, dataclasses.replace(cfg, max_depth=2), spy, o, d,
                keys, shade_kernels=state.route.shade_kernels)
    return seen[2]        # camera, extra emitter query, then bounce 1


def ray_rows(o, d):
    """The kernel's [N, 8] ray rows of origins and directions [N, 3]."""
    n = o.shape[0]
    return torch.cat([o, d, o.new_zeros((n, 2))], dim=1).contiguous()


def cell_inputs(name, cfg, key, n, large_n, dev):
    """(woop, rays [N, 8], mask or None) of one cell."""
    scene_name, kind = name.split(".")
    scene = sphere_grid_scene(*SCENES[scene_name],
                              env_radiance=gradient_sky(16, 32), device=dev)
    state = prepare_state(scene, dataclasses.replace(cfg, megakernel=False))
    count = large_n if scene_name == "large" else n
    pix = torch.arange(max(1, count // cfg.spp), device=dev)
    o, d, keys = lane_rays(scene, cfg, pix, key)
    if kind == "bounce":
        o, d, mask = first_bounce(state, cfg, o, d, keys)
        return state.woop, ray_rows(o, d), mask.contiguous()
    return state.woop, ray_rows(o, d), None


def counted(woop, rays, mask, lib=None):
    """A launch of kernel A that counts: ((t, slot, uv), tested [warps],
    staged [blocks])."""
    threads, per_thread = dense.geometry(lib)
    blocks = -(-rays.shape[0] // (threads * per_thread))
    tested = torch.zeros((blocks * threads // dense.LANES,),
                         dtype=torch.int32, device=rays.device)
    staged = torch.zeros((blocks,), dtype=torch.int32, device=rays.device)
    out = dense._dense_cuda(rays, woop, mask, tested, staged, lib)
    return out, tested, staged


def check_outputs(got, want, what):
    for g, w, nm in zip(got, want, ("t", "slot", "uv")):
        if not torch.equal(g, w):
            bad = (g != w).reshape(g.shape[0], -1).any(dim=1)
            raise AssertionError(f"{what}: {nm} differs on "
                                 f"{int(bad.sum())} rays")


def tested_runs(rays, woop, mask=None):
    """[warps, runs] bool: the runs each warp of kernel A tests on rays
    [N, 8], from each ray's closest hit in every run alone (its best t
    before a run is the least of those over the runs before it, as in
    the gated sweep: the widened boxes cull no hit) and the gate's rule
    (ops/dense.run_need); without the gate every run of a warp that
    holds a live ray. Its row sums are the kernel's runs tested per
    warp, which `measure` checks."""
    n, group = rays.shape[0], dense.LANES * dense.DENSE_RAYS
    runs = -(-woop.n_padded // dense.SUPER)
    live = (torch.ones((n,), dtype=torch.bool, device=rays.device)
            if mask is None else mask)
    if dense.gated(woop):
        o, iv = rays[:, 0:3], dense.reciprocals(rays[:, 3:6])
        best = torch.full((n,), dense.REAL_MAX, device=rays.device)
        need = []
        for r in range(runs):
            need.append(dense.run_need(o, iv, woop.sp_boxes[:, r], best,
                                       live))
            alone = dataclasses.replace(     # one run: an ungated launch
                woop, planes=woop.planes[r * dense.SUPER:
                                         (r + 1) * dense.SUPER])
            best = torch.minimum(best, dense.dense_hit(rays, alone, mask)[0])
        need = torch.stack(need, dim=1)
    else:
        need = live[:, None].expand(n, runs)
    warps = -(-n // group)
    need = torch.nn.functional.pad(need, (0, 0, 0, warps * group - n))
    return need.view(warps, group, runs).any(dim=1)


def dense_pairs(rays, woop, mask=None, tested=None):
    """(operations, bytes) of kernel A's function on rays [N, 8]
    (common.dense_work): on the live rays against the real faces, o'
    once per distinct origin. With tested None the all-pairs reading:
    every live ray against every face. With tested ([warps, runs] bool,
    `tested_runs`) the tested-pairs reading, what this run's data made
    the gate do: each live ray against the faces of the runs its warp
    tested, o' once per (distinct origin, face) among them, and on a
    gated scene one slab test per live ray and valid run."""
    n = rays.shape[0]
    live = (torch.ones((n,), dtype=torch.bool, device=rays.device)
            if mask is None else mask)
    idx = live.nonzero()[:, 0]
    ids, origins = common.origin_ids(rays[idx, 0:3])
    if tested is None:
        return common.dense_work(n, woop.n_faces, idx.shape[0] * woop.n_faces,
                                 origins * woop.n_faces)
    runs = tested.shape[1]
    real = (woop.n_faces - torch.arange(runs, device=rays.device)
            * dense.SUPER).clamp(0, dense.SUPER).double()
    per_ray = tested[idx // (dense.LANES * dense.DENSE_RAYS)]
    seen = torch.zeros((origins, runs), dtype=torch.int32,
                       device=rays.device).index_add_(0, ids, per_ray.int())
    slabs = (idx.shape[0] * int((real > 0).sum()) if dense.gated(woop)
             else 0)
    return common.dense_work(n, woop.n_faces,
                             int(per_ray.double().matmul(real).sum()),
                             int((seen > 0).double().matmul(real).sum()),
                             slabs, idx.shape[0])


def box_face_targets(woop, tri_verts):
    """[K, 3] points on the faces that set each run box's faces (its
    least and greatest x, y, z): their vertices and edge midpoints. A hit
    there lies on the box face, where the gate's slab test and the Woop
    test round differently."""
    faces = tri_verts[woop.perm[:woop.n_faces].to(tri_verts.device)]
    targets = []
    for r in range(-(-woop.n_faces // dense.SUPER)):
        run = faces[r * dense.SUPER:(r + 1) * dense.SUPER]
        for ax in range(3):
            for k in (run[:, :, ax].amin(dim=1).argmin(),
                      run[:, :, ax].amax(dim=1).argmax()):
                f = run[k]
                targets += [f[0], f[1], f[2], 0.5 * (f[0] + f[1]),
                            0.5 * (f[1] + f[2]), 0.5 * (f[2] + f[0])]
    return torch.stack(targets)


def measure(woop, rays, mask, dev, reps):
    """One cell: time, both bounds, the shares of runs tested and
    staged."""
    n = rays.shape[0]
    cell = {"n": n, "slots": woop.n_padded, "gated": dense.gated(woop)}
    if dev.type == "cuda":
        out, tested, staged = counted(woop, rays, mask)
        check_outputs(dense.dense_hit(rays, woop, mask), out,
                      "kernel A, uncounted vs counting launch")
        regs, local, per_sm = dense.kernel_resources()
    else:
        _, tested, staged = dense._dense_schedule(rays, woop, mask)
        regs = local = per_sm = None
    runs_tested = tested_runs(rays, woop, mask)
    rows = runs_tested.shape[0]
    if not (torch.equal(runs_tested.sum(dim=1, dtype=torch.int32),
                        tested[:rows]) and not tested[rows:].any()):
        raise AssertionError("tested_runs disagrees with the runs kernel A's "
                             "warps tested")
    cell["ms"] = common.timed_ms(lambda: dense.dense_hit(rays, woop, mask),
                                 dev, reps)
    cell["bound_ms"], cell["bound_by"] = common.bound(
        *dense_pairs(rays, woop, mask))
    cell["tested_bound_ms"], cell["tested_bound_by"] = common.bound(
        *dense_pairs(rays, woop, mask, runs_tested))
    runs = -(-woop.n_padded // dense.SUPER)
    warps = -(-n // (dense.LANES * dense.DENSE_RAYS))     # holding rays
    cell["tested_share"] = float(tested.double().sum()) / (warps * runs)
    cell["staged_share"] = float(staged.double().sum()) / (staged.shape[0]
                                                           * runs)
    cell["live_share"] = 1.0 if mask is None else float(mask.float().mean())
    cell["regs"], cell["local_bytes"], cell["blocks_per_sm"] = (regs, local,
                                                                per_sm)
    return cell


@functools.cache
def build_variants():
    """{name: library} of every VARIANTS build of csrc/dense.cu
    (cuda_build.build_variants)."""
    return cuda_build.build_variants("dense", VARIANTS, dense._bind)


def resources(lib):
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    cuda_build.check_launch(lib.tpt_dense_resources(
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(per_sm)),
        "dense_resources")
    return regs.value, local.value, per_sm.value


def variant_cell(libs, woop, rays, mask, dev, reps):
    """One cell of --variants: every build's outputs against the
    kernel's, its registers, local memory and blocks an SM, and its
    times in turns (the kernel first and last)."""
    kernel = dense._lib()
    builds = {"kernel": kernel, **libs}
    want = dense._dense_cuda(rays, woop, mask)
    cell = {}
    for name, lib in builds.items():
        check_outputs(dense._dense_cuda(rays, woop, mask, lib=lib), want,
                      f"variant {name}")
        # the original's build reports the kernel it no longer launches
        cell[f"{name}.regs_local_blocks"] = (None if name == "original"
                                             else resources(lib))
    for name in list(builds) + list(builds)[::-1]:
        cell.setdefault(f"{name}.ms", []).append(common.timed_ms(
            functools.partial(dense._dense_cuda, rays, woop, mask,
                              lib=builds[name]), dev, reps))
    return cell


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--large-n", type=int, default=1 << 16)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", action="store_true",
                    help="time the builds VARIANTS lists (card only)")
    args, dev = common.parse(ap, argv, "lab_dense")
    if args.variants and dev.type != "cuda":
        raise ValueError("--variants builds kernel A's variants: card only")
    libs = build_variants() if args.variants else None
    cfg = RenderConfig(width=512, height=512, spp=16, max_depth=8)
    res = {"device": common.device_name(dev), "n": args.n,
           "large_n": args.large_n}
    key = prng_key(0, dev)
    for name in args.cells.split(","):
        if name not in CELLS:
            raise ValueError(f"unknown cell {name!r}: one of {CELLS}")
        with torch.inference_mode():
            woop, rays, mask = cell_inputs(name, cfg, key, args.n,
                                           args.large_n, dev)
            cell = (variant_cell(libs, woop, rays, mask, dev, args.reps)
                    if libs is not None
                    else measure(woop, rays, mask, dev, args.reps))
        res[name] = cell
        print(json.dumps({name: cell}), flush=True)
    print(json.dumps(res, indent=1), flush=True)
    return res


if __name__ == "__main__":
    main()
