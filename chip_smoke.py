#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (tinypathtracer_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure exits
non-zero):
  1. the card, the versions, and the build of the CUDA kernels (seven
     sources, one nvcc each, all at once) from this checkout;
  2. kernel A (dense closest hit, SUPER-gated from 4,096 padded faces)
     against its plain PyTorch twin on the card, exactly ((slot, t, u,
     v)): on the room (ungated), the big room (gated, 8 runs) and the
     large scene (gated, 64 runs), each with 65,536 random rays, a
     ragged batch of 1,037, a half-masked batch of 65,536 and rays aimed
     at the vertices and edge midpoints of the faces that set each run
     box's faces, and on the big room its 2**20 camera rays (the gated
     one-origin path); the reference is the ungated twin, which the gated
     twin (the plain model, ops/dense._dense_schedule) must equal too;
     the runs each warp tested and each block staged must equal the
     model's; on the gated scenes it also counts the lanes a gate on
     unwidened boxes (the JAX package's) would get wrong against the
     ungated twin;
  3. kernel B (the megakernel), both instances, against its plain twin
     on the card: 64x64 @ 4 spp, depth 8, on the room, the big room and
     their 3-light variants, each whole and cut to a ragged 1,037 paths;
     the [16, N] rows within atol 1e-5 (the bound of
     tests/test_torch_mega.py), the hit rows exactly, the save_hits
     instance's [16, N] rows equal to the forward's; then each instance
     on a grid of 3 blocks, where lanes serve several paths (the ragged
     batch leaves the last pools partial): rows equal to the kernel's
     own grid's, rounds per block equal to the schedule model's
     (ops/mega._mega_schedule) on both grids, lane efficiency logged;
  4. the main path through the public entry point,
     Renderer(RenderConfig(512, 512, 16, 8), device="cuda").render, with
     the launch counters zeroed first: the megakernel frame, the modular
     frame on kernel A (compared with the megakernel frame), best-of-3
     times and camera rays/s of both, one profiled modular frame
     (kernel A's device time per launch), then one megakernel frame of the
     7,692-face room (8,192 padded faces) and one modular frame of it on
     the gated kernel A (compared with the megakernel frame);
  5. both kernels against their plain twins at the main path's shapes,
     one 2**20-lane chunk of the frame: kernel A on its camera rays
     (exact), kernel B on its rays and uniforms in the room and in the
     big room (atol 1e-5); then the kernels' times beside the twins';
  6. kernel B's registers and local memory (all 14 instances), its
     save_hits instance against its twin on the same 2**20-path room
     chunk (the hit rows exactly, the [16, N] rows equal to the forward
     instance's), times of both instances, each instance's rounds per
     block against the schedule model's and the lane efficiency of one
     path per thread beside the refilled pool's; then lab_mega's main:
     both instances on the room and the big room, with 0 and 3 lights,
     at 2**20 paths (times, bounds, lane efficiency, rounds against the
     model, registers, and the no-refill grid, whose rows must equal the
     kernel's);
  7. the train step, the second main path, through the public entry
     point make_train_step(cfg, adam(1e-2), device="cuda") on the room at
     512x512 @16 spp d8 with a zero target, launch counters zeroed: one
     warm-up step, best of 3 step times, fwd+bwd camera rays/s, loss, peak
     memory, a forward / backward / Adam split (CUDA events); the step
     must launch the save_hits instance once per chunk and no other
     kernel (no intersection in the backward), and give finite gradients;
  8. megakernel-path against modular-path gradients on the card, 64x64
     @4 spp d8, room and 3-light room (rtol 1e-5; CUDA's index backward
     sums with atomics in no fixed order);
  9. kernel C (the packet traversal) against its plain twin on the card
     in the 61,452-face scene (65,536 slots, 128 chunks): 65,536 random
     rays, a ragged batch and a half-masked batch; (fid, t, u, v) and
     the visit counts must be exactly equal; on the ragged and the
     half-masked batch the chunks each block staged must equal the plain
     schedule model's (ops/packet._packet_schedule);
 10. kernel C against kernel A at the main path's shapes: one 2**20-lane
     camera chunk of the large scene and that chunk's first-bounce rays;
     exactly equal; times of kernel C beside its bound and of kernel A on
     the same rays and of the twin, the visits per query, kernel C's
     stagings per block and plane bytes staged per query, its registers
     and shared memory, and the lanes kernel C would get wrong without
     its box margins;
 11. the large-scene main paths through the public entry points, launch
     counters zeroed before each and read after: the 512x512 @16 spp d8
     frame of the 61,452-face scene (which the renderer routes to the
     packet traversal) and its train step (one warm-up, 3 timed, peak
     memory), then one profiled run of each with kernel C's total and
     mean per launch; each must launch kernel C and neither kernel A
     nor B, the step (each bounce rematerialised: its backward reruns
     the queries) exactly twice a frame's launches; the frame's bounces
     shaded by csrc/shade.cu's two kernels (once each a bounce), the
     step's by the torch code (autograd records);
 12. the same frame through the modular loop on kernel A, forced through
     the pipeline state: bit-equal to the packet frame;
 13. kernels D (tensor-core transform by wgmma, both precisions; the
     HGMMA instructions of its SASS counted) and E (the z-row cull and
     compacted exact tests; the SASS of its fast-path and survivor loops
     counted) of the kernel lab against their twins and kernel A: 65,536
     rays, a ragged batch and lab4's full shape (2**20 rays x 1,948
     random triangles, 2,048 slots); E exact, and its counting launch's
     survivors and batches of every warp equal to the plain model's
     (lab4.vpu_rol_schedule); D (each precision) held to its twin's face
     ids and t and to kernel A's face ids by LAB4_LIMITS, "highest" on
     >= 99.9 % of kernel A's face ids; then lab4's main, the tc sweep
     beside kernel A, launch counters zeroed before and read after;
 14. kernel F (the stripped packet kernel, one warp a packet), every
     variant against its twin on 2**18 pixel8 rays of the big room,
     exactly, each variant's time logged, and a counting launch's
     chunks visited by each packet equal to `walk`'s; boxtest, select1
     and walk against their twins on 2**14 pixel8 rays of the large
     scene (512 chunk boxes); then lab5_diag's main, counters zeroed
     before and read after;
 15. the lab entry points through their public mains: lab_dense (kernel
     A on the room's 2**20 camera and first-bounce rays, the big room's
     2**20 camera rays and the large scene's 65,536: times, both bounds,
     the shares of runs tested and staged from a counting launch),
     kernel_lab, lab5 (room, g2, g4 x camera, pixel8, random x packet,
     dense, bvh at 2**18 rays: the dense/packet crossover), lab6 and
     profile_stages;
 16. the Renderer's oracle routes on the room at 64x64 @4 spp d8:
     intersector="bvh" (device and host tree) and "bruteforce"; their
     hits equal the brute force's, their frames each other's and the
     dense frame's within 1e-5 but for at most ORACLE_EDGE_PIXELS tied
     edge pixels (counted), no closest-hit kernel launches (kernels A,
     B, C and the labs' 0 times), and their bounces are shaded on the
     card by csrc/shade.cu's two kernels, as every reference-mode route
     of the modular loop there; the stack guard refuses a tree one
     level too deep for the stack;
 17. the scene-file entry point: the room, the 3-light room and the
     large scene written as glTF (write_gltf), loaded through load_scene
     and flattened onto the card, each equal to its procedural arrays;
     the loaded room's 512x512 @16 spp d8 reference frame through the
     one-shot render (megakernel), bit-equal to phase 4's;
 18. the three physical frames at full width through render(...,
     mode="physical"), launch counters zeroed before each scene's three
     frames and read after: kernel A (room, 3-light room) or C (large
     scene) exactly 8 x (3 + L) x 4 launches a frame, kernel B none;
     best of 3, spread, rays/s, one profiled frame of the room and of
     the large scene;
 19. kernel A against its twin on one 2**20-lane chunk's
     environment-NEE and area-NEE queries (masked to the diffuse lanes)
     of the physical room, bounces 0 and 1, kernel C on the large
     scene's (bounce 0), captured from the frame's trace; exactly; then
     each kernel's time and bound on every query of that chunk's trace
     (query_bounds: masked lanes cost nothing), by kind of query;
 20. the large physical frame forced onto kernel A: bit-equal to the
     packet frame;
 21. a 64x64 @4 spp d8 physical room frame on kernel A against the
     bruteforce route: every query of the kernel A trace answered by
     both, and where their faces differ one hit must be a self-hit
     (within SELF_HIT_T of the origin: a ray grazing the surface it
     leaves); the frames within 1e-5 but on at most
     PHYSICAL_ORACLE_PIXELS counted pixels;
 22. the physical room's train step at full width: a warm-up with its
     gradients checked finite, 3 timed steps, peak memory; kernel A
     exactly 2 x 8 x (3 + L) x 4 launches a step (the rematerialised
     backward reruns every query), nothing else;
 23. the textured room (sphere_grid_scene(2, 8, 16, textured=True), the
     64x64 checker atlas) at 512x512 @16 spp d8 through Renderer.render,
     launch counters zeroed before each route: the megakernel route
     (kernel B's save_hits instance once a chunk, hits only, then the
     shading replay) and the modular route (kernel A), best of 3 each,
     bit-equal; one bilinear-filtered frame; kernel B against its twin
     on the textured room's 64x64 @4 spp operands;
 24. the textured room's train step (Params.tex_atlas): a warm-up, 3
     timed steps, peak memory, save_hits only; the megakernel route's
     texel, albedo and env gradients against the modular route's at
     64x64 @4 spp d8 (rtol 1e-5);
 25. the textured large scene's frame (kernel C only), the textured
     room's physical frame (kernel A, 96 launches a frame), and the
     textured room written by write_gltf (its atlas as 8-bit PNG) and
     loaded: equal to the procedural room with the quantised atlas, its
     one-shot render(...) frame bit-equal to that room's;
 26. Renderer.progressive: the textured room as 2 steps of 8 spp with
     save / load between them, bit-equal to an uninterrupted run and
     within 1e-5 of Renderer.render; then the 1920x1080 @64 spp d8
     textured forward as 4 steps of 16 spp (ms a step, total, rays/s,
     peak memory);
 27. the normal, depth and hitmask AOVs at 512x512 @16 spp on the
     textured room (kernel A) and the textured large scene (kernel C),
     each equal at 64x64 to the AOV through the twin route;
 28. `python -m tinypathtracer_tpu_torch.tools.render_cli` as a
     subprocess on the written textured room, with --stats and with
     --aov normal: each PNG equal byte for byte to the in-process one;
 29. the large, physical and textured steps of phases 11, 22 and 24,
     each bounce rematerialised: best time and peak memory beside their
     readings before (STEPS_BEFORE_REMAT); each peak must be below;
 30. make_sharded_renderer (parallel/) on the room at 512x512 @16 spp
     d8: a one-rank NCCL group in this process, mesh (1, 1), bit-equal
     to phase 4's frame; two NCCL ranks on this one card, refused (the
     error logged); then gloo ranks spawned onto the card: meshes (2, 1)
     bit-equal to phase 4's frame, (1, 2) and (2, 2) within 1e-5, the
     large scene at (2, 1) bit-equal to phase 11's; per rank its
     launches (kernel B only on the room, C and the shade kernels only
     on the large scene), wall time and peak memory (ranks sharing one
     card measure no scaling);
 31. make_sharded_train_step on the room at 512x512 @16 spp d8 (Adam
     1e-2, zero target) at (2, 1) and (1, 2): loss within 1e-6 and
     parameters within rtol 1e-5 of phase 7's step, equal on every rank,
     the save_hits instance once per rank chunk and no other kernel,
     step time and peak per rank; then render_cli --shard as a one-rank
     subprocess, its PNG equal byte for byte to phase 28's;
 32. the flagship fwd+bwd: make_train_step(cfg, adam(1e-2)) on the room
     at 1920x1080 @16 spp d8 against a zero target, untextured and
     textured: a warm-up step (its host-device synchronisations
     counted) and 2 timed, best time, spread, fwd+bwd camera rays/s,
     peak memory, 32 save_hits launches a step and no other kernel; the
     loss equal bit for bit to a no-grad frame's MSE, the gradient
     within 1e-3 of a central difference in the emissive material's
     emission;
 33. the entry points of tinypathtracer_tpu_torch.entry on the card:
     entry() once, its frame equal bit for bit to render_frame's at the
     JAX entry's config (the megakernel route); dryrun_multichip(2),
     two gloo ranks on this card, mesh (1, 2): its loss within 1e-6 of
     the one-device step's at the dry run's config, save_hits launches
     on each rank and no other kernel;
 34. the threefry key chain (csrc/keys.cu) against the int64 chain on
     the card, torch.equal: lane keys and camera draws of a full 2**20-
     lane chunk of the Cornell cell's shape, a ragged batch of pixel ids
     up to 2**31 - 1 with a sample offset, and a batch whose samples
     wrap at 2**32; on each, the bounce draws at tags 0-7 (the
     megakernel's [64, N], zero rows included), from _CAM_TAG and across
     the 2**32 wrap, and the modular draws at m = 6 and 9; then the
     launch counters over one megakernel frame (one lane_keys and one
     lane_draws launch a chunk) and one modular frame (one lane_keys a
     chunk, a lane_draws a bounce run), and both kernels' times at a
     2**20-lane chunk beside their bound (the integer ALU pipe or bytes)
     and the int64 chain's;
 35. csrc/shade.cu's kernels (the modular loop's reference-mode
     shading) against their plain twins, the integrator's torch code
     (ops/shade `_shade_hits_torch`, `_close_bounce_torch`), on one
     2**20-lane chunk of the tetra-frame cell (the SPD tetra, 1920x1080
     @16 spp d8, kernel C, no light) and of the large scene with the
     point, spot and directional light under the gradient sky: every
     output of both kernels on every bounce of the chunk, launched op by
     op and replayed from a CUDA graph, equal value for value to the
     twins' on the same inputs, and the chunk's radiance through the
     kernels, op by op and as BounceGraphs, equal to the torch loop's
     (the rule forced off); then the launch counters zeroed just before
     a tetra-frame frame through Renderer.render (its third: every
     bounce a graph's replay) and read just after: each shade kernel
     once and kernel C twice a bounce's draw; and both kernels' times
     on every bounce of each chunk (device time a launch, replayed from
     a CUDA graph) beside their bound (SHADE_HITS_BYTES,
     CLOSE_BOUNCE_BYTES by the lanes that go on), and the twins' at
     bounce 0.
Each kernel's bound is the least time the card could take for the work
of this run's inputs: the larger of its fp32 operations over 67 TFLOP/s
and its bytes (inputs read once, outputs written once) over 3.35 TB/s;
kernel D's transform counts against the TF32 tensor-core peak. The last
lines are the kernels JSON, the card's name and power limit, and the
result JSON.
"""

import base64
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOM = (2, 8, 16)          # sphere_grid_scene(grid, n_lat, n_lon): 1,804 faces
BIG_ROOM = (2, 16, 32)     # 7,692 faces, 8,192 padded
LARGE = (4, 16, 32)        # 61,452 faces, 65,536 padded: the packet route
# kernel A against its twin: rays of the full and half-masked batches,
# and the big room's camera rays (the gated one-origin path)
TWIN_RAYS = 65536
GATED_CAMERA_RAYS = 1 << 20
# kernel C against its twin: (rays, half of them masked)
TWIN_BATCHES = ((65536, False), (1037, False), (65536, True))
# kernel C's outputs (ops/packet.packet_hit)
HIT_NAMES = ("fid", "t", "uv", "visits")
MEGA_ATOL = 1e-5
# kernel B's grid forced small in phase 3, so that each lane serves
# several paths of a small batch
REFILL_BLOCKS = 3
RAGGED = 1037              # paths of a batch that leaves a pool partial
GRAD_RTOL = 1e-5
LR = 1e-2

# The peaks, the bound and the operation counts of a pair test
# (OPS_ORIGIN, OPS_DIRECTION) and of a slab test (OPS_SLAB,
# OPS_RECIPROCALS) are tools/common.py's.
# kernel D: the transform's share of the pair test (o' 18 + d' 15) runs
# on the tensor cores, 3 TF32 passes for "highest"; the rest (t, u, v,
# u + v: 6) on the CUDA cores
OPS_TRANSFORM = 33
LAB4_F = 1948                # lab4's triangles (2,048 slots)
# kernel D's limits per precision: the least share of face ids equal to
# its twin's, the largest |dt| on those lanes (t is 1-100 here), the least
# share of face ids equal to kernel A's. Set from the H100 readings
# (highest: 0.999995, 2.44e-3, 0.999969; default, one TF32 pass:
# 0.999036, 2.71e-3, 0.924783), with margin.
LAB4_LIMITS = {"highest": (0.999, 1e-2, 0.999),
               "default": (0.995, 1e-2, 0.9)}
LAB4_BATCHES = (65536, 1037, 1 << 20)
# where kernel E's counting launch is held to the plain model (ragged and
# full; the model takes seconds a call, whatever the rays)
LAB4_COUNTED = (1037, 1 << 20)
LAB_RAYS = 1 << 18
# pixel8 rays of the large scene for kernel F (512 chunk boxes: blocks of
# 4 warps)
LARGE_DIAG_RAYS = 1 << 14
ORACLE = dict(width=64, height=64, spp=4, max_depth=8)
# a hit closer than this to its ray's origin is a self-hit: a ray grazing
# the surface it leaves (or, on a coarse sphere, the neighbouring facet),
# reported past the DELTA (2e-4) cutoff by one intersector's rounding and
# not by the other's (phase 21; measured up to 1.45e-3)
SELF_HIT_T = 5e-3
# pixels of the physical oracle frame allowed beyond 1e-5 of the kernel A
# frame: the NEE terms (1 / dist^2 and cosines near the emissive panel,
# self-hits) turn the two routes' ulp-level parting into more than 1e-5
# on a few paths (18 pixels on the H100 and 17 on the CPU at this key,
# max 2.0e-2; twice that allowed)
PHYSICAL_ORACLE_PIXELS = 36
# pixels of the oracle frame allowed beyond 1e-5 of the dense frame: the
# brute force and kernel A test a ray against a triangle by different
# arithmetic, and take different faces where two are tied at an edge
# (3 pixels on the H100 at this key; twice that allowed)
ORACLE_EDGE_PIXELS = 6
# the key chain (phase 34): a chunk of the Cornell cell (1920x1080 @16 spp,
# 2**20 lanes: 65,536 pixels), its 16th. Its bound: the rotates (funnel
# shifts) and xors of a threefry2x32's 20 rounds run only on the integer
# ALU pipe, 16 lanes a clock on each of an SM's 4 schedulers (132 SMs x 64
# x 1.98 GHz); its ~32 adds may issue on the IMAD pipe beside them, so 40
# ALU operations a hash is the least it needs
KEY_CHUNK_PIXELS = 65536
ALU_PEAK = 132 * 64 * 1.98e9
ALU_OPS_THREEFRY = 40
# csrc/shade.cu's bytes a lane (its header's count): shade_hits reads and
# writes 151 B, 12 B more a light, on every lane; close_bounce 151 B, 8 B
# more a light, on a lane that goes on and 98 B on one that does not. The
# shading rows and the environment stay in L2
SHADE_HITS_BYTES = (151, 12)
CLOSE_BOUNCE_BYTES = (151, 8, 98)


def log(*args):
    print(*args, flush=True)


# ---- glTF documents of procedural scenes -----------------------------------
# The smoke run and the tests (tests/_torch_scenes.py) write the scenes
# they load: a glTF 2.0 JSON document with one data-URI buffer.

def _quat_of(rot) -> list:
    """A quaternion (x, y, z, w) whose quat_to_mat3 (the reference's, not
    normalised) is the 3x3 rotation rot (float64)."""
    m = np.asarray(rot, np.float64)
    w = math.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    x = math.sqrt(max(0.0, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) / 2.0
    y = math.sqrt(max(0.0, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) / 2.0
    z = math.sqrt(max(0.0, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) / 2.0
    x = math.copysign(x, m[2, 1] - m[1, 2])
    y = math.copysign(y, m[0, 2] - m[2, 0])
    z = math.copysign(z, m[1, 0] - m[0, 1])
    return [x, y, z, w]


def _quat_aiming(d) -> list:
    """A quaternion whose quat_to_mat3 (not normalised) maps -z onto d,
    of any length (glTF lights shine down -z): its third column,
    (2(xz + wy), 2(yz - wx), 1 - 2(x^2 + y^2)), is c = -d. With x = y = r
    a zero component of c comes out exactly zero."""
    cx, cy, cz = (-float(v) for v in d)
    s = (1.0 - cz) / 2.0                 # x^2 + y^2
    if s == 0.0:
        return [0.0, 0.0, 0.0, 0.0]
    r = 0.5 if s == 0.5 else math.sqrt(s / 2.0)
    return [r, r, (cx + cy) / (4.0 * r), (cx - cy) / (4.0 * r)]


def _spot_cone(cos_outer: float, inv_cone: float) -> dict:
    """innerConeAngle and outerConeAngle that read back (as the reader
    computes them: cos(outer), 1 / (cos(inner) - cos(outer))) to these
    float32 values."""
    want = (np.float32(cos_outer), np.float32(inv_cone))
    if inv_cone <= 0.0:
        raise ValueError(f"a spot cone needs inv_cone > 0, got {inv_cone}")
    for c in (cos_outer, 1.0 - 1.0 / inv_cone):
        outer = math.acos(c)
        inner = math.acos(min(1.0, c + 1.0 / inv_cone))
        got = (np.float32(np.cos(outer)),
               np.float32(1.0 / (np.cos(inner) - np.cos(outer))))
        if got == want:
            return {"innerConeAngle": inner, "outerConeAngle": outer}
    raise ValueError(f"no cone angles read back to {want}")


def _f(x) -> list:
    """float32 values as JSON floats (exact: a double holds them)."""
    return [float(v) for v in np.asarray(x, np.float32).reshape(-1)]


def quantised_atlas(atlas) -> np.ndarray:
    """The atlas as its 8-bit PNG reads back: round(a * 255) / 255 in
    float32, values clipped to [0, 1]."""
    q = np.round(np.clip(np.asarray(atlas, np.float64), 0.0, 1.0) * 255.0)
    return q.astype(np.uint8).astype(np.float32) / 255.0


def _png_uri(layer) -> str:
    """An [H, W, 3] layer in [0, 1] as an 8-bit PNG data URI (PIL)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.round(np.clip(np.asarray(layer, np.float64), 0.0, 1.0)
                             * 255.0).astype(np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def gltf_document(arrays: dict) -> dict:
    """A glTF document that `load_scene(...).flatten(env)` turns back into
    the scene of `arrays` (a FlatScene's fields as numpy arrays, one
    object with an identity transform, as `sphere_grid_scene` makes):
    the same world vertices, normals and faces in the same order, the
    same material, delta-light and camera values; only the object
    tables differ (a mesh per run of faces of one material). Materials
    that no face uses are not written (the reader keeps only the
    materials of meshes), so material indices may shift. Each light is
    a KHR_lights_punctual node whose rotation aims -z at its direction;
    each value reads back to the same float32. A textured scene (an
    atlas that is not the [1, 1, 1, 3] sentinel) writes TEXCOORD_0 on
    every mesh (read back exactly) and each atlas layer as an 8-bit PNG
    texture that its materials reference as baseColorTexture: it reads
    back as quantised_atlas(tex_atlas)."""
    mats = np.asarray(arrays["vert_mats"])
    if not np.array_equal(mats, np.broadcast_to(np.eye(4), mats.shape)):
        raise ValueError("gltf_document writes scenes of identity objects")
    idx = np.asarray(arrays["indices"], np.int64)
    fm = np.asarray(arrays["face_mtl"])
    cut = np.flatnonzero(np.diff(fm)) + 1
    runs = np.split(np.arange(len(fm)), cut)
    starts = [int(idx[r].min()) for r in runs] + [len(arrays["vertices"])]
    atlas = np.asarray(arrays["tex_atlas"])
    textured = any(n > 1 for n in atlas.shape[:3])
    blob, views, accessors, meshes, nodes = bytearray(), [], [], [], []

    def add(data, ctype, typ):
        data = np.ascontiguousarray(data)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": data.nbytes})
        blob.extend(data.tobytes())
        while len(blob) % 4:
            blob.append(0)
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": len(data), "type": typ})
        return len(accessors) - 1

    for k, r in enumerate(runs):
        v0, v1 = starts[k], starts[k + 1]
        local = idx[r] - v0
        if local.min() < 0 or local.max() >= v1 - v0:
            raise ValueError("a run of faces uses vertices of another run")
        attrs = {"POSITION": add(np.asarray(arrays["vertices"][v0:v1],
                                            np.float32), 5126, "VEC3"),
                 "NORMAL": add(np.asarray(arrays["normals"][v0:v1],
                                          np.float32), 5126, "VEC3")}
        if textured:
            attrs["TEXCOORD_0"] = add(np.asarray(arrays["texcoords"][v0:v1],
                                                 np.float32), 5126, "VEC2")
        ind = add(local.reshape(-1).astype(np.uint32), 5125, "SCALAR")
        meshes.append({"primitives": [{"attributes": attrs, "indices": ind,
                                       "material": int(fm[r[0]])}]})
        nodes.append({"mesh": k})

    materials = []
    for m in range(len(arrays["mtl_emission"])):
        ext = {}
        if arrays["mtl_emission"][m] > 0:
            ext["KHR_materials_emissive_strength"] = {
                "emissiveStrength": _f(arrays["mtl_emission"][m])[0]}
        if arrays["mtl_eta"][m] > 0:
            ext["KHR_materials_ior"] = {"ior": _f(arrays["mtl_eta"][m])[0]}
        if arrays["mtl_specular"][m] != np.float32(0.5):
            ext["KHR_materials_transmission"] = {"transmissionFactor": 5.0 * (
                1.0 - _f(arrays["mtl_specular"][m])[0])}
        pbr = {"baseColorFactor": _f(arrays["mtl_base_color"][m]) + [1.0],
               "metallicFactor": _f(arrays["mtl_metallic"][m])[0],
               "roughnessFactor": _f(arrays["mtl_roughness"][m])[0]}
        if textured and int(arrays["mtl_tex_id"][m]) >= 0:
            pbr["baseColorTexture"] = {"index": int(arrays["mtl_tex_id"][m])}
        materials.append({"name": f"m{m:03d}", "pbrMetallicRoughness": pbr,
                          **({"extensions": ext} if ext else {})})

    lights = []
    kinds = {0: "point", 1: "directional", 2: "spot"}
    for li, kind in enumerate(np.asarray(arrays["light_kind"]).tolist()):
        light = {"type": kinds[kind], "color": _f(arrays["light_color"][li])}
        inten = _f(arrays["light_intensity"][li])[0]
        # point and spot intensities are read in candela (x 1/683 W)
        light["intensity"] = inten if kind == 1 else inten * 683.0
        if kind == 2:
            light["spot"] = _spot_cone(_f(arrays["light_cos_outer"][li])[0],
                                       _f(arrays["light_inv_cone"][li])[0])
        lights.append(light)
        nodes.append({"translation": _f(arrays["light_pos"][li]),
                      "rotation": _quat_aiming(_f(arrays["light_dir"][li])),
                      "extensions": {"KHR_lights_punctual": {"light": li}}})

    c2w = np.asarray(arrays["cam_to_world"], np.float64)
    nodes.append({"camera": 0, "translation": _f(c2w[:3, 3]),
                  "rotation": _quat_of(c2w[:3, :3])})
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(bytes(blob)).decode(),
                     "byteLength": len(blob)}],
        "bufferViews": views, "accessors": accessors, "meshes": meshes,
        "materials": materials,
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": _f(arrays["cam_yfov"])[0],
            "aspectRatio": _f(arrays["cam_aspect"])[0],
            "znear": _f(arrays["cam_znear"])[0]}}],
        "nodes": nodes, "scenes": [{"nodes": list(range(len(nodes)))}],
        "scene": 0}
    if textured:
        doc["images"] = [{"uri": _png_uri(layer)} for layer in atlas]
        doc["textures"] = [{"source": t} for t in range(len(atlas))]
    if lights:
        doc["extensionsUsed"] = ["KHR_lights_punctual"]
        doc["extensions"] = {"KHR_lights_punctual": {"lights": lights}}
    return doc


def write_gltf(path, arrays: dict) -> str:
    """Write gltf_document(arrays) to path; returns the path as a str."""
    with open(path, "w") as f:
        json.dump(gltf_document(arrays), f)
    return str(path)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps, warm=True):
    """(median device time of one fn() call over reps calls, each between
    its own pair of CUDA events, so that a gap in the host's enqueueing
    inflates one sample and not the result; the first result). With
    warm, one untimed call comes first."""
    out = fn() if warm else None
    pairs = []
    for _ in range(reps):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = fn()
        ev[1].record()
        pairs.append(ev)
        out = res if out is None else out
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2], out


def packet_work(origins, hits, pk):
    """(operations, bytes) of the packet traversal's function on rays
    from origins [N, 3] whose hits are kernel C's (fid, t, uv, visits):
    per visited chunk tc pair tests, o' at least once per (distinct
    origin, chunk) pair (common.origin_visits), and per live ray one
    slab test of each of the C boxes and its reciprocals. Bytes: the
    origin and direction rows and the mask read, (fid, t, u, v, visits)
    written, the planes and the boxes read once, and a hit's face id
    from the slot -> face table."""
    from tinypathtracer_tpu_torch.tools import common

    fid, visits = hits[0], hits[3]
    live = visits > 0
    ops = (common.pair_ops(int(visits.sum()) * pk.tc,
                           common.origin_visits(origins[live],
                                                visits[live]) * pk.tc)
           + int(live.sum()) * (pk.n_chunks * common.OPS_SLAB
                                + common.OPS_RECIPROCALS))
    nbytes = (visits.shape[0] * (25 + 24) + int((fid >= 0).sum()) * 8
              + pk.woop.n_padded * 48 + pk.n_chunks * 32)
    return ops, nbytes


def rescan_ops(visits, pk):
    """Operations kernel C's design spends beyond packet_work: after
    each visit a warp scans the C boxes again, lanes over boxes, for the
    ray's next key (the one scan per live ray is counted there) instead
    of keeping a sorted list."""
    from tinypathtracer_tpu_torch.tools import common

    return int(visits.sum()) * pk.n_chunks * common.OPS_SLAB


def check_equal(got, want, what, names):
    """Exact equality of a kernel's outputs and its reference's."""
    bad = [f"{nm}: {int((g != w).sum())} differ" for g, w, nm
           in zip(got, want, names) if not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"{what}: {', '.join(bad)}")


def max_abs_diff(got, want):
    """max |got - want| over a kernel's outputs, in float64."""
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def random_rays(n, gen, alive=None):
    """rays [n, 8] from inside the room in random directions, every 16th
    with a zero x component; the alive flag in column 6 (all alive by
    default)."""
    o = torch.rand((n, 3), generator=gen) * 9.0 - 4.5
    d = torch.randn((n, 3), generator=gen)
    d[::16, 0] = 0.0
    d = torch.nn.functional.normalize(d, dim=1)
    a = torch.ones((n, 1)) if alive is None else alive.float()[:, None]
    return torch.cat([o, d, a, torch.zeros((n, 1))], dim=1)


def box_face_rays(woop, tri_verts, gen, reps=4):
    """rays [N, 8] from random origins in the room aimed at the vertices
    and edge midpoints of the faces that set each SUPER run box's faces
    (lab_dense.box_face_targets): their hits lie on a box face, where the
    gate's slab test and the Woop test round differently."""
    from tinypathtracer_tpu_torch.tools.lab_dense import box_face_targets

    targets = box_face_targets(woop, tri_verts).cpu().repeat(reps, 1)
    o = torch.rand(targets.shape, generator=gen) * 9.8 - 4.9
    d = torch.nn.functional.normalize(targets - o, dim=1)
    return torch.cat([o, d, torch.zeros((o.shape[0], 2))], dim=1)


def dense_vs_twin(T, sky, dev):
    """Phase 2: kernel A against its twin and its gate against the plain
    model on the room, the big room and the large scene: outputs against
    the ungated twin, exactly (on the gated scenes the gated twin, the
    model, must equal it too), and the runs tested and staged against the
    model's. Returns the max |uv| error."""
    from tinypathtracer_tpu_torch.ops import dense
    from tinypathtracer_tpu_torch.render.integrator import TraceData
    from tinypathtracer_tpu_torch.tools.lab_dense import cell_inputs, counted

    gen = torch.Generator().manual_seed(0)
    err = 0.0
    for name, grid in (("room", ROOM), ("big room", BIG_ROOM),
                       ("large scene", LARGE)):
        tv = TraceData.from_scene(T.sphere_grid_scene(
            *grid, env_radiance=sky, device=dev)).tri_verts
        woop = dense.precompute_woop(tv)
        bare = dense.precompute_woop(tv, margin=0.0)
        gated = dense.gated(woop)
        half = torch.rand(TWIN_RAYS, generator=gen) < 0.5
        batches = [
            (f"{TWIN_RAYS} random rays", random_rays(TWIN_RAYS, gen), None),
            (f"{RAGGED} random rays", random_rays(RAGGED, gen), None),
            (f"{TWIN_RAYS} random rays, half masked",
             random_rays(TWIN_RAYS, gen), half),
            ("box-face rays", box_face_rays(woop, tv, gen), None)]
        if grid == BIG_ROOM:
            # the one-origin path under the gate at the main path's shape:
            # the first camera lanes of the 512x512 @16 spp frame
            _, rays, _ = cell_inputs(
                "big_room.camera",
                T.RenderConfig(width=512, height=512, spp=16, max_depth=8),
                T.prng_key(0, dev), GATED_CAMERA_RAYS, 0, dev)
            batches.append((f"{GATED_CAMERA_RAYS} camera rays", rays, None))
        for what, rays, mask in batches:
            rays = rays.to(dev)
            mask = None if mask is None else mask.to(dev)
            t0 = time.perf_counter()
            got, tested, staged = counted(woop, rays, mask)
            plain = dense.dense_hit(rays, woop, mask)
            model, m_tested, m_staged = dense._dense_schedule(rays, woop,
                                                              mask)
            want = dense._dense_torch(rays, woop.planes, None, mask)
            torch.cuda.synchronize()
            label = f"kernel A vs twin, {name}, {what}"
            names = ("t", "slot", "uv")
            check_equal(got, want, label, names)
            check_equal(plain, want, f"{label}, uncounted launch", names)
            check_equal(model, want, f"{label}, schedule model (the "
                        f"{'gated' if gated else 'ungated'} twin)", names)
            check_equal([tested, staged], [m_tested, m_staged],
                        f"{label}: runs tested and staged vs the schedule "
                        "model", ("tested", "staged"))
            err = max(err, max_abs_diff(got[2:], want[2:]))
            runs = -(-woop.n_padded // dense.SUPER)
            share_t = float(tested.float().mean()) / runs
            share_s = float(staged.float().mean()) / runs
            line = (f"{label} x {woop.n_padded} slots ({runs} runs, "
                    f"{'gated' if gated else 'ungated'}): exact, against "
                    f"the ungated twin; hit share "
                    f"{float((got[1] >= 0).float().mean()):.4f}; runs "
                    f"tested and staged = the schedule model's (shares "
                    f"{share_t:.4f}, {share_s:.4f})")
            if gated:
                unw = dense.dense_hit(rays, bare, mask)
                lost = (unw[1] != want[1]) | (unw[0] != want[0])
                line += (f"; a gate on unwidened boxes would get "
                         f"{int(lost.sum())} lanes wrong against the "
                         f"ungated twin")
            log(f"{line} ({time.perf_counter() - t0:.1f} s)")
    regs, local, per_sm = dense.kernel_resources()
    log(f"kernel A: {regs} registers, {local} B local memory per thread, "
        f"{per_sm} blocks an SM ({dense.DENSE_THREADS} threads x "
        f"{dense.DENSE_RAYS} rays)")
    return err


def packet_stagings(origins, dirs, mask, pk):
    """Kernel C's outputs on a query and the chunks each of its blocks
    staged (a launch that reports them; the route's launches do not)."""
    from tinypathtracer_tpu_torch.ops import packet

    n = origins.shape[0]
    stagings = torch.zeros((-(-n // packet.PACKET_BLOCK),),
                           dtype=torch.int32, device=origins.device)
    out = packet._packet_cuda(origins, dirs, mask, pk, stagings=stagings)
    return out, stagings


def packet_vs_twin(pk, dev):
    """Phase 9: kernel C against its twin on random rays: a full batch,
    a ragged one and a half-masked one; on the last two its per-block
    staging counts against the plain schedule model's. Returns the max
    |uv| error."""
    from tinypathtracer_tpu_torch.ops import packet

    gen = torch.Generator().manual_seed(1)
    err = 0.0
    for n, half in TWIN_BATCHES:
        alive = (torch.rand(n, generator=gen) < 0.5) if half else None
        rays = random_rays(n, gen, alive).to(dev)
        query = (rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous(),
                 None if alive is None else alive.to(dev))
        got = packet.packet_hit(*query, pk)
        want = packet._packet_torch(*query, pk)
        torch.cuda.synchronize()
        what = f"kernel C vs twin, {n} rays{', half masked' if half else ''}"
        check_equal(got, want, what, HIT_NAMES)
        err = max(err, float((got[2] - want[2]).abs().max()))
        v = got[3].float()
        log(f"{what} x {pk.woop.n_padded} slots ({pk.n_chunks} chunks of "
            f"{pk.tc}): exact, visits included; hit share "
            f"{float((got[0] >= 0).float().mean()):.4f}, visits per live ray "
            f"{float(v[v > 0].mean()):.2f} (max {int(v.max())})")
        if half and bool((got[3][~query[2]] != 0).any()):
            raise AssertionError("a dead lane of kernel C tested a chunk")
        if n % packet.PACKET_BLOCK or half:
            counted, stagings = packet_stagings(*query, pk)
            model, m_stagings, _ = packet._packet_schedule(*query, pk)
            torch.cuda.synchronize()
            check_equal(counted, want, f"{what}, counting launch",
                        HIT_NAMES)
            check_equal(model, want, f"schedule model, {what}", HIT_NAMES)
            check_equal([stagings], [m_stagings],
                        f"kernel C's stagings vs the schedule model, {what}",
                        ("stagings",))
            log(f"  kernel C's stagings per block = the schedule model's on "
                f"all {stagings.shape[0]} blocks: mean "
                f"{float(stagings.float().mean()):.1f}, max "
                f"{int(stagings.max())} (for {pk.n_chunks} chunks)")
    return err


def packet_vs_dense(T, cfg, host_scene, key, dev):
    """Phase 10: kernel C against kernel A on one 2**20-lane camera chunk
    of the large scene and on its first-bounce rays, exactly; times of
    C, A and the twin, kernel C's work and bound on each, its stagings
    per block and plane bytes staged, its registers and shared memory.
    Also counts the live lanes on which kernel C with the boxes not
    widened by their margins (the JAX package's slab test) would differ
    from kernel A. Returns {"camera": (ms, work), "first-bounce": (ms,
    work)}, the twin's ms on the camera rays and the max |uv| error."""
    from tinypathtracer_tpu_torch.ops import dense, packet
    from tinypathtracer_tpu_torch.render.renderer import (lane_rays,
                                                          prepare_state)
    from tinypathtracer_tpu_torch.tools.common import bound
    from tinypathtracer_tpu_torch.tools.lab_dense import first_bounce

    scene = host_scene.to(dev)
    state = prepare_state(scene, cfg)
    pk = state.packet
    bare = packet.precompute_packet(state.data.tri_verts.detach(), pk.tc,
                                    margin=0.0)
    chunk = cfg.rays_per_dispatch // cfg.spp
    o, d, keys = lane_rays(scene, cfg, torch.arange(chunk, device=dev), key)
    ob, db, alive = first_bounce(state, cfg, o, d, keys)
    err, res = 0.0, {}
    for name, (oo, dd, mask) in (("camera", (o, d, None)),
                                 ("first-bounce", (ob, db, alive))):
        n = oo.shape[0]
        query = (oo.contiguous(), dd.contiguous(),
                 None if mask is None else mask.contiguous())
        rays = torch.cat([oo, dd, oo.new_zeros((n, 2))], dim=1).contiguous()
        c_ms, got = cuda_ms(lambda: packet.packet_hit(*query, pk), 5)
        a_ms, raw = cuda_ms(lambda: dense.dense_hit(rays, pk.woop, query[2]),
                            5)
        want = dense.face_hits(*raw, pk.woop)
        live = torch.ones(n, dtype=torch.bool, device=dev) if mask is None \
            else mask
        check_equal(got, want, f"kernel C vs kernel A, {name} rays",
                    ("fid", "t", "uv"))
        check_equal(packet.closest_hit_packet(oo, dd, pk, mask=mask),
                    dense.closest_hit_dense(oo, dd, pk.woop, mask=mask),
                    f"closest_hit_packet vs closest_hit_dense, {name} rays",
                    ("fid", "t", "uv"))
        err = max(err, float((got[2][live] - want[2][live]).abs().max()))
        v = got[3][live].float()
        share = float((got[0][live] >= 0).float().mean())
        work = packet_work(query[0], got, pk)
        res[name] = (c_ms, work)
        ops, nbytes = work
        log(f"kernel C vs kernel A, {name} rays: {n} lanes, "
            f"{int(live.sum())} live, exact; hit share {share:.4f}; visits "
            f"per live ray {float(v.mean()):.3f} of {pk.n_chunks} chunks "
            f"(max {int(v.max())}); kernel C {c_ms:.2f} ms beside its bound "
            f"{bound(ops, nbytes)[0]:.3f} ms (work {ops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; the next-key scans add "
            f"{rescan_ops(got[3], pk) / 1e9:.2f} GFLOP), kernel A "
            f"{a_ms:.2f} ms on the same rays")
        counted, stagings = packet_stagings(*query, pk)
        check_equal(counted, got, f"kernel C counting stagings, {name} rays",
                    HIT_NAMES)
        s = stagings.float()
        staged = float(s.sum()) * pk.tc * 48
        streamed = float(got[3].float().sum()) * pk.tc * 48
        log(f"  stagings per block of {packet.PACKET_BLOCK} rays: mean "
            f"{float(s.mean()):.2f}, median {float(s.median()):.0f}, max "
            f"{int(s.max())}; rays served per staging "
            f"{float(got[3].float().sum() / s.sum()):.2f}; plane bytes "
            f"staged {staged / 1e9:.3f} GB per query (a private stream "
            f"per visit would read {streamed / 1e9:.2f} GB)")
        unw = packet.packet_hit(*query, bare)
        lost = ((unw[0] != want[0]) | (unw[1] != want[1])) & live
        log(f"  without the box margins kernel C would differ from kernel A "
            f"on {int(lost.sum())} of these live lanes")
        if name == "camera":
            plain_ms, twin = cuda_ms(lambda: packet._packet_torch(
                *query, pk), 1, warm=False)
            check_equal(got, twin, "kernel C vs twin, camera rays",
                        HIT_NAMES)
            log(f"kernel C vs twin, {n} camera rays: exact; plain twin "
                f"{plain_ms:.1f} ms")
    regs, static = packet.kernel_resources()
    log(f"kernel C: {regs} registers per thread; shared memory per block "
        f"{static} B static (ray state) + "
        f"{packet.stage_bytes(pk.n_chunks, pk.tc)} B dynamic (two stage "
        f"buffers of {pk.tc} slots, histogram of {pk.n_chunks} chunks)")
    return res, plain_ms, err


def zero_launches():
    from tinypathtracer_tpu_torch.ops import dense, mega, packet, shade
    from tinypathtracer_tpu_torch.tools import lab4, lab5_diag

    shade.shade_hits.launches = 0
    shade.close_bounce.launches = 0
    dense.dense_hit.launches = 0
    mega.mega_trace.launches = 0
    mega.mega_trace.launches_save_hits = 0
    packet.packet_hit.launches = 0
    lab4.mxu_closest_hit.launches = 0
    lab4.vpu_rol_closest_hit.launches = 0
    lab5_diag.diag_run.launches = 0


def read_launches():
    from tinypathtracer_tpu_torch.ops import dense, mega, packet, shade
    from tinypathtracer_tpu_torch.tools import lab4, lab5_diag

    return {"shade_hits": shade.shade_hits.launches,
            "close_bounce": shade.close_bounce.launches,
            "packet": packet.packet_hit.launches,
            "dense": dense.dense_hit.launches,
            "mega": mega.mega_trace.launches,
            "mega_save_hits": mega.mega_trace.launches_save_hits,
            "mxu": lab4.mxu_closest_hit.launches,
            "vpu_rol": lab4.vpu_rol_closest_hit.launches,
            "diag": lab5_diag.diag_run.launches}


def check_packet_route(launches, what):
    if not (launches["packet"] > 0 and launches["dense"] == 0
            and launches["mega"] == 0 and launches["mega_save_hits"] == 0):
        raise AssertionError(f"{what} must launch kernel C and neither "
                             f"kernel A nor B: {launches}")


def check_shaded(launches, what, shaded=True):
    """Where shaded, csrc/shade.cu's two kernels launched, once each a
    bounce run op by op or replayed (the modular loop's reference
    bounces on the card: the route's shade_kernels); else neither."""
    n = launches["shade_hits"]
    if (n != launches["close_bounce"]) or (n > 0) != shaded:
        raise AssertionError(f"{what} must launch the shade kernels "
                             f"{'once each a bounce' if shaded else 'never'}"
                             f": {launches}")


def large_scene_paths(T, cfg, host_scene, key, dev):
    """Phases 11-12: the large scene's frame and train step through the
    public entry points (packet route), then the frame forced onto
    kernel A. The step rematerialises each bounce: its backward reruns
    the forward's queries, so kernel C runs twice a frame's launches a
    step. Returns the frame's launches, the frame (on the host), and the
    step's best ms and peak GiB."""
    from tinypathtracer_tpu_torch.diff import invrender as inv
    from tinypathtracer_tpu_torch.render import film
    from tinypathtracer_tpu_torch.render.renderer import (prepare_state,
                                                          render_pixel_ids)

    n_rays = cfg.n_pixels * cfg.spp
    r = T.Renderer(cfg, device=dev.type)
    zero_launches()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        img = r.render(host_scene, key)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    frame_launches = read_launches()
    log(f"large scene, packet route: {cfg.width}x{cfg.height} @{cfg.spp}spp "
        f"d{cfg.max_depth}, {n_rays} camera rays: best of 3 "
        f"{best * 1e3:.1f} ms, {n_rays / best:,.0f} rays/s, image mean "
        f"{float(img.mean()):.5f}; launches in 3 frames {frame_launches}")
    check_packet_route(frame_launches, "the large-scene frame")
    check_shaded(frame_launches, "the large-scene frame")
    mean_ms = log_kernel_share("large-scene frame",
                               profile_step("large-scene frame", r.render,
                                            host_scene, key))
    # the same frame op by op: the Renderer's replays call no Python
    st = prepare_state(host_scene.to(dev), cfg)
    mean_bound, count = frame_packet_bound(
        lambda: render_pixel_ids(st, cfg, torch.arange(cfg.n_pixels,
                                                       device=dev),
                                 key.to(dev)), st.packet)
    log(f"  kernel C's bound in the frame, from each launch's visits: "
        f"{mean_bound:.3f} ms a launch over {count} launches (mean "
        f"{mean_ms:.2f} ms a launch, {mean_ms / mean_bound:.1f}x)")
    if not (img.shape == (cfg.height, cfg.width, 3)
            and torch.isfinite(img).all() and float(img.mean()) > 0.01):
        raise AssertionError("large-scene frame is not a finite, lit image")

    scene = host_scene.to(dev)
    params = inv.Params.from_scene(scene)
    state = inv.AdamState.init(params)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    step = inv.make_train_step(cfg, inv.adam(LR), device=dev.type)
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best_step = float("inf")
    for i in range(4):                    # one warm-up step, then 3 timed
        t0 = time.perf_counter()
        _, _, loss = step(params, state, scene, target, T.prng_key(i + 1, dev))
        loss = float(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i:
            best_step = min(best_step, dt)
        log(f"large-scene train step {i} "
            f"({'warm-up' if i == 0 else 'timed'}): {dt * 1e3:.1f} ms, "
            f"loss {loss:.6f}")
        if not math.isfinite(loss):
            raise AssertionError(f"large-scene loss is not finite: {loss}")
    peak = torch.cuda.max_memory_allocated()
    step_launches = read_launches()
    log(f"large-scene train step: best of 3 {best_step * 1e3:.1f} ms, "
        f"{n_rays / best_step:,.0f} fwd+bwd camera rays/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches in 4 steps {step_launches}")
    check_packet_route(step_launches, "the large-scene train step")
    check_shaded(step_launches, "the large-scene train step (autograd "
                 "records: the torch code shades)", shaded=False)
    want = 4 * 2 * frame_launches["packet"] // 3
    if step_launches["packet"] != want:
        raise AssertionError(f"4 rematerialised large-scene steps must "
                             f"launch kernel C {want} times (twice a "
                             f"frame's), got {step_launches['packet']}")
    log_kernel_share("large-scene train step",
                     profile_step("large-scene train step", step, params,
                                  state, scene, target, T.prng_key(1, dev)))

    with torch.inference_mode():
        st = prepare_state(scene, cfg)
        st = dataclasses.replace(st, route=dataclasses.replace(
            st.route, intersector="dense"))          # kernel A's sweep
        pix = torch.arange(cfg.n_pixels, device=dev)
        zero_launches()
        t0 = time.perf_counter()
        dense_img = film.to_image(render_pixel_ids(st, cfg, pix, key.to(dev))
                                  .reshape(cfg.height, cfg.width, 3), cfg.spp)
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
    launches = read_launches()
    log(f"large scene, modular loop forced onto kernel A: "
        f"{t_dense * 1e3:.1f} ms, {n_rays / t_dense:,.0f} rays/s; launches "
        f"{launches}")
    if launches["packet"] or not launches["dense"]:
        raise AssertionError(f"the forced frame must run kernel A only: "
                             f"{launches}")
    if not torch.equal(dense_img, img):
        mx, share, mean = compare_images(dense_img, img)
        raise AssertionError(f"packet and dense frames differ: max {mx}, "
                             f"share {share}, mean {mean}")
    log("large scene: the packet frame equals the kernel A frame bit for "
        "bit")
    return frame_launches, img.cpu(), best_step * 1e3, peak / 2**30


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


def check_hits(out, hits, fwd_out, twin_out, twin_hits, what):
    """The save_hits instance against the forward instance (its [16, N]
    rows, exactly) and the twin (the [16, N] rows within MEGA_ATOL, the
    hit rows exactly). Returns the max abs difference from the twin."""
    if not torch.equal(out, fwd_out):
        raise AssertionError(f"save_hits changed kernel B's rows on {what}")
    lanes = int((hits != twin_hits).any(dim=0).sum())
    diff = float((hits - twin_hits).abs().max())
    log(f"kernel B save_hits vs twin, {what} paths d8: hit rows "
        f"{'exact' if lanes == 0 else f'differ on {lanes} lanes'}; [16, N] "
        "rows equal to the forward instance's")
    if lanes or not torch.isfinite(hits).all():
        raise AssertionError(f"kernel B's hit rows != twin's on {what}")
    return max(diff, check_mega(out, twin_out, what))


def check_rounds(ops, n_lights, save_hits, lengths, what, blocks=0):
    """Kernel B's rounds per block, counted by one launch of the instance
    (on its own grid, or on `blocks`), against the plain schedule model's
    on the paths' sweeps `lengths`. Returns (the launch's rows, rounds)."""
    from tinypathtracer_tpu_torch.ops import mega

    n, dev = ops[0].shape[1], ops[0].device
    g = blocks or mega.mega_grid(n, n_lights, save_hits)
    rounds = torch.zeros((g,), dtype=torch.int32, device=dev)
    got = mega._mega_cuda(*ops, 8, n_lights, save_hits, rounds=rounds,
                          blocks=blocks)
    model = mega._mega_schedule(lengths.cpu(), g,
                                mega.mega_threads(n_lights))[0]
    check_equal([rounds.cpu()], [model],
                f"kernel B's rounds vs the schedule model, {what}, "
                f"save_hits={save_hits}, {g} blocks", ("rounds",))
    return got, rounds


def log_lanes(lengths, rounds, n_lights, what):
    """The lane efficiency of one path per thread (from the paths'
    sweeps) and of kernel B's refilled pool (from its rounds)."""
    from tinypathtracer_tpu_torch.ops import mega
    from tinypathtracer_tpu_torch.tools import lab_mega

    threads = mega.mega_threads(n_lights)
    log(f"  kernel B's rounds per block = the schedule model's on all "
        f"{rounds.shape[0]} blocks ({what}): mean "
        f"{float(rounds.float().mean()):.2f}, max {int(rounds.max())}; "
        f"sweeps per path {float(lengths.float().mean()):.3f}; lane "
        f"efficiency one path per thread "
        f"{lab_mega.thread_efficiency(lengths):.4f}, refilled pool "
        f"{lab_mega.pool_efficiency(lengths, rounds, threads):.4f}")


def mega_vs_twin(ops, n_lights, what):
    """Phase 3: kernel B, both instances, against its twin on one batch:
    the [16, N] rows within MEGA_ATOL, the save_hits instance's hit rows
    exactly and its [16, N] rows equal to the forward's; then both
    instances on REFILL_BLOCKS blocks, where lanes take several paths
    each: the rows equal to the kernel's own grid's and the rounds per
    block to the schedule model's (and on the kernel's own grid too).
    Returns the forward's and the save_hits instance's max abs error."""
    from tinypathtracer_tpu_torch.ops import mega

    fwd = mega.mega_trace(*ops, depth=8, n_lights=n_lights)
    out, hits = mega.mega_trace(*ops, depth=8, n_lights=n_lights,
                                save_hits=True)
    want_out, want_hits = mega._mega_torch(*ops, depth=8, n_lights=n_lights,
                                           save_hits=True)
    torch.cuda.synchronize()
    err_b = check_mega(fwd, want_out, what)
    err_h = check_hits(out, hits, fwd, want_out, want_hits, what)
    lengths = mega.path_lengths(want_hits, ops[3], 8)
    for save in (False, True):
        check_rounds(ops, n_lights, save, lengths, what)
        got, rounds = check_rounds(ops, n_lights, save, lengths, what,
                                   blocks=REFILL_BLOCKS)
        check_equal(got if save else [got], (out, hits) if save else [fwd],
                    f"kernel B on {REFILL_BLOCKS} blocks vs its own grid, "
                    f"{what}, save_hits={save}",
                    ("out", "hits") if save else ("out",))
    log_lanes(lengths, rounds, n_lights, f"{what}, {REFILL_BLOCKS} blocks")
    return err_b, err_h


def param_names(inv):
    return [f.name for f in dataclasses.fields(inv.Params)]


def train_phase(T, cfg, host_scene):
    """Phase 7: the full-width train step on the card. Returns the
    launches of its steps and, for phase 31, the first step's (key 1)
    loss, parameters after it and gradients, on the host."""
    from tinypathtracer_tpu_torch.diff import invrender as inv
    from tinypathtracer_tpu_torch.ops import dense, mega

    dev = torch.device("cuda")
    n_rays = cfg.n_pixels * cfg.spp
    n_chunks = -(-cfg.n_pixels // (cfg.rays_per_dispatch // cfg.spp))
    scene = host_scene.to(dev)
    params = inv.Params.from_scene(scene)
    state = inv.AdamState.init(params)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    step = inv.make_train_step(cfg, inv.adam(LR), device="cuda")
    dense.dense_hit.launches = 0
    mega.mega_trace.launches = 0
    mega.mega_trace.launches_save_hits = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best, n_steps = float("inf"), 4
    for i in range(n_steps):              # one warm-up step, then 3 timed
        t0 = time.perf_counter()
        new_params, new_state, loss = step(params, state, scene, target,
                                           T.prng_key(i + 1, dev))
        loss = float(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i:
            best = min(best, dt)
        else:
            first = {"loss": loss, "params": [x.cpu() for x in
                                              new_params.leaves()]}
        log(f"train step {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{dt * 1e3:.1f} ms, loss {loss:.6f}, Adam step "
            f"{new_state.step}")
        if not math.isfinite(loss):
            raise AssertionError(f"train step loss is not finite: {loss}")
    peak = torch.cuda.max_memory_allocated()
    launches = {"dense": dense.dense_hit.launches,
                "mega": mega.mega_trace.launches,
                "mega_save_hits": mega.mega_trace.launches_save_hits}
    log(f"train step, {cfg.width}x{cfg.height} @{cfg.spp}spp "
        f"d{cfg.max_depth}, {n_rays} camera paths, {n_chunks} chunks: best "
        f"of 3 {best * 1e3:.1f} ms, {n_rays / best:,.0f} fwd+bwd camera "
        f"rays/s; peak memory {peak / 2**30:.2f} GiB; launches in "
        f"{n_steps} steps {launches}")
    if launches != {"dense": 0, "mega": 0,
                    "mega_save_hits": n_steps * n_chunks}:
        raise AssertionError(f"the train step must launch the save_hits "
                             f"instance once per chunk and nothing else: "
                             f"{launches}")

    # the step's three parts, timed with CUDA events: forward (mse_loss),
    # backward (the stored-hit replay), Adam
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = inv.Params(*(x.detach().requires_grad_()
                          for x in params.leaves()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    loss = inv.mse_loss(leaves, scene, cfg, target, T.prng_key(1, dev))
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = leaves.grads()
    inv.adam_step(params, grads, state, LR)
    ev[3].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, adam = (ev[k].elapsed_time(ev[k + 1]) for k in range(3))
    log(f"train step split (CUDA events): forward {fwd:.1f} ms, backward "
        f"{bwd:.1f} ms, Adam {adam:.2f} ms; host wall {wall * 1e3:.1f} ms")
    profile_step("train step", step, params, state, scene, target,
                 T.prng_key(1, dev))
    for f, g in zip(param_names(inv), grads.leaves()):
        log(f"  grad {f}: shape {tuple(g.shape)}, max abs "
            f"{float(g.abs().max()) if g.numel() else 0.0:.4e}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"gradient of {f} is not finite")
        if f in ("mtl_base_color", "mtl_emission", "env_radiance") and \
                not bool((g != 0).any()):
            raise AssertionError(f"gradient of {f} is zero")
    first["grads"] = [g.cpu() for g in grads.leaves()]
    return launches, first


def profile_step(what, step, *args):
    """One step(*args) under torch.profiler: wall time, the device's busy
    share (kernel time over wall) and the kernels with the most time.
    Returns the rows (device ms, launches, kernel name)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    log(f"profiled {what}: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f} %)")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:9.1f} ms  {count:6d} x  {key[:90]}")
    return rows


def log_kernel_share(what, rows, label="C", symbol="packet_hit_kernel"):
    """A kernel's device time in a profile (kernel C's by default): total
    and mean per launch. Returns the mean per launch in ms."""
    ms = sum(r[0] for r in rows if symbol in r[2])
    count = sum(r[1] for r in rows if symbol in r[2])
    if not count:
        raise AssertionError(f"the profile of the {what} shows no kernel "
                             f"{label}")
    log(f"  kernel {label} in the profiled {what}: {ms:.1f} ms in {count} "
        f"launches, {ms / count:.2f} ms a launch")
    return ms / count


def frame_packet_bound(render, pk):
    """The bound of kernel C's mean launch in one render() of the large
    frame: each launch's work from its own visit counts (packet_hit is
    wrapped for that frame only). render() runs op by op: a CUDA graph's
    replay calls no packet_hit."""
    from tinypathtracer_tpu_torch.ops import packet
    from tinypathtracer_tpu_torch.tools.common import bound

    real, bounds = packet.packet_hit, []

    def recorded(origins, dirs, mask, tables):
        out = real(origins, dirs, mask, tables)
        bounds.append(bound(*packet_work(origins, out, pk))[0])
        return out

    recorded.launches = 0       # _packet_cuda counts on the module's name
    packet.packet_hit = recorded
    try:
        render()
        torch.cuda.synchronize()
    finally:
        packet.packet_hit = real
    return sum(bounds) / len(bounds), len(bounds)


def compare_grads(T, scene, cfg, name):
    """Phases 8 and 24: Params gradients of the MSE loss through the
    megakernel (stored-hit replay) against the modular path (kernel A
    hits, the same replay) on the card, rtol GRAD_RTOL plus 1e-6 of the
    largest gradient. Returns the megakernel route's gradients."""
    from tinypathtracer_tpu_torch.diff import invrender as inv

    dev = scene.device
    params = inv.Params.from_scene(scene)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    key = T.prng_key(2, dev)
    la, ga = inv.loss_and_grads(params, scene, cfg, target, key)
    lb, gb = inv.loss_and_grads(
        params, scene, dataclasses.replace(cfg, megakernel=False), target,
        key)
    g_all = max(float(g.abs().max()) for g in gb.leaves() if g.numel())
    worst = {}
    for f, a, b in zip(param_names(inv), ga.leaves(), gb.leaves()):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{name}: gradient of {f} is not finite")
        if a.numel() and not torch.allclose(a, b, rtol=GRAD_RTOL,
                                            atol=1e-6 * g_all):
            raise AssertionError(f"{name}: megakernel and modular gradients "
                                 f"of {f} disagree")
        worst[f] = float((a - b).abs().max()) if a.numel() else 0.0
    log(f"megakernel vs modular gradients, {name}, {cfg.width}x{cfg.height} "
        f"@{cfg.spp}spp d{cfg.max_depth}: losses {float(la):.8f} / "
        f"{float(lb):.8f}; max abs diff per leaf {worst} (largest gradient "
        f"{g_all:.4e})")
    if abs(float(la) - float(lb)) > 1e-6 * abs(float(lb)):
        raise AssertionError(f"{name}: megakernel and modular losses differ")
    return ga


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


def lab4_work(n, faces, precision):
    """(ms of the least time, bound_by) of the closest hit of n rays x
    `faces` triangles (padding slots need no work): the transform on the
    tensor cores (3 TF32 passes for "highest", 1 for "default"; None:
    fp32 on the CUDA cores, kernel E), the rest on the CUDA cores; rays8
    and the faces' planes read once, (t, fid) written."""
    from tinypathtracer_tpu_torch.tools import common

    pairs = n * faces               # lab4's rays: each from its own origin
    nbytes = n * (32 + 8) + faces * 48
    if precision is None:
        return common.bound(common.pair_ops(pairs, pairs), nbytes)
    passes = 3 if precision == "highest" else 1
    t_mma = pairs * OPS_TRANSFORM * passes / common.TF32_PEAK * 1e3
    t_fp32 = (common.pair_ops(pairs, pairs) - pairs * OPS_TRANSFORM) \
        / common.FP32_PEAK * 1e3
    t_bytes = nbytes / common.HBM_BYTES_PER_S * 1e3
    best = max(t_mma, t_fp32, t_bytes)
    return best, "bytes" if best == t_bytes else "operations"


def lab4_phase(dev):
    """Phase 13: kernels D and E against their twins and kernel A, and
    E's counting launch against the plain model of its cull and queue.
    Returns {name: (ms, plain ms, max |err|, bound)} at lab4's full
    shape, D's at "highest" with its "default" ms after them, E's with a
    dict of its design's readings; D's error is max |dt| over the lanes
    where it and its twin take the same face."""
    from tinypathtracer_tpu_torch.ops import dense
    from tinypathtracer_tpu_torch.tools import lab4

    out = {}
    err = {"mxu": 0.0, "vpu_rol": 0.0}
    hgmma = lab4.hgmma_count()
    log(f"kernel D: {hgmma} HGMMA instructions in the SASS of csrc/lab4.cu")
    if not hgmma:
        raise AssertionError("kernel D's SASS holds no HGMMA: no wgmma")
    sass = lab4.vpu_rol_sass()
    log(f"kernel E: SASS instructions of the fast path {sass['slot']} a "
        f"slot ({sass['pair']} a pair), of the survivor loop "
        f"{sass['batch']} a batch ({lab4.E_BATCH // 32} survivors a lane); "
        f"loops [first, last, instructions, divides]: {sass['loops']}")
    for n in LAB4_BATCHES:
        full = n == LAB4_BATCHES[-1]
        woop, rays, rays8 = lab4.test_data(n, LAB4_F, dev, seed=n)
        planes4, planesT = lab4.make_planes4(woop), lab4.make_planesT(woop)
        a_ms, (ta, sa, _) = cuda_ms(lambda: dense.dense_hit(rays, woop), 5)
        e_ms, got = cuda_ms(lambda: lab4.vpu_rol_closest_hit(rays8, planesT),
                            5)
        e_plain, want = cuda_ms(lambda: lab4._vpu_rol_torch(rays8, planesT),
                                1, warm=False)
        check_equal(got, want, f"kernel E vs twin, {n} rays", ("t", "fid"))
        err["vpu_rol"] = max(err["vpu_rol"], max_abs_diff(got, want))
        check_equal(got, (ta, sa), f"kernel E vs kernel A, {n} rays",
                    ("t", "slot"))
        hit = sa >= 0
        line = (f"kernels D, E vs twins and kernel A, {n} rays x "
                f"{woop.n_padded} slots: E exact (hit share "
                f"{float(hit.float().mean()):.4f})")
        if n in LAB4_COUNTED:
            t0 = time.perf_counter()
            model = lab4.vpu_rol_schedule(rays8, planesT)
            model_s = time.perf_counter() - t0
            card = lab4.counted(rays8, planesT)
            check_equal(card, model, f"kernel E's counting launch vs the "
                        f"model, {n} rays",
                        ("t", "fid", "survivors", "batches"))
            survivors, batches = int(card[2].sum()), int(card[3].sum())
            share = survivors / (n * LAB4_F)
            line += (f"; E's counts = the model's on all {card[2].shape[0]} "
                     f"warps ({model_s:.1f} s): survivor share {share:.5f} "
                     f"of the real pairs, {batches} batches, "
                     f"{survivors / (lab4.E_BATCH * max(batches, 1)):.4f} "
                     "full")
        for prec in ("highest", "default"):
            d_ms, (td, fd) = cuda_ms(lambda: lab4.mxu_closest_hit(
                rays8, planes4, precision=prec), 5)
            d_plain, (tw, fw) = cuda_ms(lambda: lab4._mxu_torch(
                rays8, planes4, precision=prec), 1, warm=False)
            same = (fd == fw) & (fw >= 0)
            twin_share = float((fd == fw).float().mean())
            twin_dt = float((td - tw)[same].abs().max())
            a_share, a_dt = lab4.agreement(td, fd, ta, sa)
            line += (f"; D {prec}: face ids = twin's on {twin_share:.6f}, "
                     f"max |dt| {twin_dt:.3e}, = kernel A's on {a_share:.6f},"
                     f" max |dt| on A's hits {a_dt:.3e}")
            min_twin, max_dt, min_a = LAB4_LIMITS[prec]
            if not (twin_share >= min_twin and twin_dt <= max_dt
                    and a_share >= min_a):
                raise AssertionError(
                    f"kernel D {prec}, {n} rays: face ids = twin's on "
                    f"{twin_share} (limit {min_twin}), max |dt| {twin_dt} "
                    f"(limit {max_dt}), = kernel A's on {a_share} (limit "
                    f"{min_a})")
            if prec == "highest":
                err["mxu"] = max(err["mxu"], twin_dt)
                if full:
                    out["mxu"] = (d_ms, d_plain, err["mxu"],
                                  lab4_work(n, LAB4_F, prec))
                    line += f" ({d_ms:.2f} ms, twin {d_plain:.1f} ms)"
            elif full:
                out["mxu"] += (d_ms,)
                line += f" ({d_ms:.2f} ms)"
        if full:
            e_bound = lab4_work(n, LAB4_F, None)
            out["vpu_rol"] = (e_ms, e_plain, err["vpu_rol"], e_bound, {
                "design": "z-row cull, survivors compacted into full warps "
                          "of the exact test; 256 threads x 4 rays, "
                          "TMA-staged ring",
                "kernel_a_ms": a_ms, "survivor_share": share,
                "batches": batches, "sass_slot": sass["slot"],
                "sass_pair": sass["pair"], "sass_batch": sass["batch"]})
            line += (f"; E {e_ms:.3f} ms (twin {e_plain:.1f} ms, bound "
                     f"{e_bound[0]:.3f} ms, {e_bound[0] / e_ms:.1%} of it), "
                     f"kernel A {a_ms:.3f} ms")
        log(line)
    return out


def diag_phase(T, dev):
    """Phase 14: kernel F, every variant against its twin on 2**18
    pixel8 rays of the big room, the chunks each packet visited against
    `walk`'s, and three variants on the large scene's 512 chunk boxes.
    Returns (walk ms, walk twin ms, max |err|, bound of the walk from its
    visits, {variant: ms}, mean visits a packet)."""
    from tinypathtracer_tpu_torch.models.envlight import gradient_sky
    from tinypathtracer_tpu_torch.tools import common, lab5, lab5_diag as diag

    def rays_of(grid, count):
        scene = T.sphere_grid_scene(*grid, env_radiance=gradient_sky(16, 32),
                                    device=dev)
        o, d, tv = lab5.make_rays(scene, count, "pixel8")
        m = o.shape[0]
        return (torch.cat([o, d, torch.ones((m, 1), device=dev),
                           torch.zeros((m, 1), device=dev)],
                          dim=1).contiguous(), *diag.diag_tables(tv))

    rays, planes, boxes = rays_of(BIG_ROOM, LAB_RAYS)
    n = rays.shape[0]
    res = {}
    err = 0.0
    for v in diag.VARIANTS:
        ms, got = cuda_ms(lambda: diag.diag_run(v, rays, planes, boxes), 5)
        plain, want = cuda_ms(lambda: diag._diag_torch(v, rays, planes, boxes),
                              1, warm=False)
        check_equal([got], [want], f"kernel F {v} vs twin", ("out",))
        err = max(err, max_abs_diff([got], [want]))
        res[v] = (ms, plain)
        log(f"kernel F {v:8s} vs twin, {n} pixel8 rays, "
            f"{planes.shape[0] // diag.ROWS} chunks ({boxes.shape[1]} boxes): "
            f"exact; {ms:.3f} ms, {ms * 1e6 / (n // diag.PACKET):.1f} ns per "
            f"packet (twin {plain:.1f} ms)")
    r = rays.view(-1, diag.PACKET, 8)
    _, visits = diag.walk(r, planes, diag._keys(r, boxes)[2])
    out, card_visits = diag.counted(rays, planes, boxes)
    check_equal([out, card_visits],
                [diag._diag_torch("walk", rays, planes, boxes), visits],
                "kernel F counting walk vs twin and walk's visits",
                ("out", "visits"))
    large = rays_of(LARGE, LARGE_DIAG_RAYS)
    for v in ("boxtest", "select1", "walk"):
        check_equal([diag.diag_run(v, *large)], [diag._diag_torch(v, *large)],
                    f"kernel F {v} vs twin, large scene", ("out",))
    log(f"kernel F on the large scene ({large[0].shape[0]} pixel8 rays, "
        f"{large[2].shape[1]} chunk boxes): boxtest, select1, walk exact; "
        f"visits of every packet on the big room = walk's")
    c, cp = planes.shape[0] // diag.ROWS, boxes.shape[1]
    # a packet's rays share an origin: o' at least once per (distinct
    # origin, chunk)
    ops = (common.pair_ops(int(visits.sum()) * diag.PACKET * diag.CHUNK,
                           common.origin_visits(r[:, 0, 0:3], visits)
                           * diag.CHUNK)
           + n * (cp * common.OPS_SLAB + common.OPS_RECIPROCALS))
    nbytes = n * (32 + 4) + c * diag.ROWS * diag.CHUNK * 4 + cp * 32
    log(f"kernel F walk: {float(visits.float().mean()):.3f} chunk visits per "
        f"packet (max {int(visits.max())}); work {ops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; bound {common.bound(ops, nbytes)}")
    return (res["walk"][0], res["walk"][1], err, common.bound(ops, nbytes),
            {v: ms for v, (ms, _) in res.items()},
            float(visits.float().mean()))


def run_main(what, fn, *args):
    """One lab's public main on the card, launch counters zeroed before
    and read after. Returns the launches."""
    zero_launches()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"{what}: {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def oracle_phase(T, host_room, dev):
    """Phase 16: the Renderer's "bvh" (device and host tree) and
    "bruteforce" routes on the room."""
    from tinypathtracer_tpu_torch.ops import lbvh
    from tinypathtracer_tpu_torch.ops.intersect import closest_hit_bruteforce
    from tinypathtracer_tpu_torch.ops.traverse import closest_hit_bvh
    from tinypathtracer_tpu_torch.render.renderer import (host_build_bvh,
                                                          lane_rays,
                                                          prepare_state)

    key = T.prng_key(3)
    dense_img = T.Renderer(T.RenderConfig(**ORACLE)).render(host_room, key)
    frames = {}
    zero_launches()
    for name, kw in (("bvh device", dict(intersector="bvh")),
                     ("bvh host", dict(intersector="bvh", bvh_source="host")),
                     ("bruteforce", dict(intersector="bruteforce"))):
        r = T.Renderer(T.RenderConfig(**ORACLE, **kw))
        t0 = time.perf_counter()
        frames[name] = r.render(host_room, key)
        torch.cuda.synchronize()
        log(f"oracle route {name}: {ORACLE}, "
            f"{time.perf_counter() - t0:.1f} s, "
            f"image mean {float(frames[name].mean()):.5f}")
    launches = read_launches()
    hit_kernels = {k: v for k, v in launches.items()
                   if k not in ("shade_hits", "close_bounce") and v}
    if hit_kernels:
        raise AssertionError(f"the oracle routes launched kernels: {launches}")
    # their bounces are shaded on the card as the dense route's are
    check_shaded(launches, "the oracle routes")
    for name in ("bvh device", "bvh host"):
        if not torch.equal(frames[name], frames["bruteforce"]):
            raise AssertionError(f"{name} frame != bruteforce frame")
    mx, share, mean = compare_images(frames["bruteforce"], dense_img)
    edge = round(share * ORACLE["width"] * ORACLE["height"])
    log(f"oracle frames: bvh (both trees) == bruteforce bit for bit; against "
        f"the dense frame max abs diff {mx:.3e}, {edge} pixels beyond 1e-5 "
        f"(tied edge lanes, limit {ORACLE_EDGE_PIXELS}), mean abs diff "
        f"{mean:.3e}")
    if edge > ORACLE_EDGE_PIXELS:
        raise AssertionError(f"oracle and dense frames differ beyond 1e-5 on "
                             f"{edge} pixels")

    scene = host_room.to(dev)
    cfg = T.RenderConfig(**ORACLE, intersector="bvh")
    state = prepare_state(scene, cfg)
    o, d, _ = lane_rays(scene, cfg, torch.arange(cfg.n_pixels, device=dev),
                        key.to(dev))
    want = closest_hit_bruteforce(o, d, state.data.tri_verts)
    for name, tree in (("device", state.bvh),
                       ("host", host_build_bvh(host_room).to(dev))):
        got = closest_hit_bvh(o, d, tree)
        check_equal(got, want, f"closest_hit_bvh ({name} tree) vs bruteforce",
                    ("fid", "t", "uv"))
    depth = lbvh.tree_depth(state.bvh)
    log(f"closest_hit_bvh == bruteforce on {o.shape[0]} camera rays, both "
        f"trees; the room's LBVH has depth {depth}")
    try:
        T.Renderer(T.RenderConfig(**ORACLE, intersector="bvh",
                                  stack_depth=depth)).render(host_room, key)
    except ValueError as e:
        log(f"stack guard, stack_depth={depth}: refused ({e})")
    else:
        raise AssertionError("the stack guard let an overflowing tree render")



def scene_arrays(scene) -> dict:
    """A FlatScene's fields as numpy arrays (gltf_document's input)."""
    return {f.name: getattr(scene, f.name).cpu().numpy()
            for f in dataclasses.fields(scene)}


def check_loaded(procedural, loaded, what):
    """Phases 17 and 25's check: a loaded glTF scene against the
    procedural scene it was written from, bit for bit: world geometry,
    faces, texcoords, per-face material values and texture layers, delta
    lights, camera, dome and atlas."""
    from tinypathtracer_tpu_torch.models.scene import FlatScene

    procedural = procedural.to(loaded.device)
    bad = [nm for nm, a, b in zip(("world vertices", "world normals"),
                                  procedural.world_geometry(),
                                  loaded.world_geometry())
           if not torch.equal(a, b)]
    fm_p, fm_l = procedural.face_mtl.long(), loaded.face_mtl.long()
    for f in dataclasses.fields(FlatScene):
        a, b = getattr(procedural, f.name), getattr(loaded, f.name)
        if f.name.startswith("mtl_"):
            a, b = a[fm_p], b[fm_l]
        elif f.name in ("vertices", "normals", "vert_mats", "normal_mats",
                        "obj_face_begin", "obj_mtl_idx", "face_mtl",
                        "vert_obj"):
            continue        # object tables: a mesh per material run
        if not torch.equal(a, b):
            bad.append(f.name)
    if bad:
        raise AssertionError(f"loaded {what} differs from the procedural "
                             f"scene in {bad}")


def gltf_phase(T, sky, dev, key, room_frame, tmp):
    """Phase 17: the room, the 3-light room and the large scene written as
    glTF, loaded through load_scene and flattened onto the card, each held
    to its procedural arrays; then the loaded room's full-width
    reference-mode frame through the one-shot render, on the megakernel,
    bit-equal to the procedural room's frame of phase 4. Returns the host
    Scenes by name."""
    from tinypathtracer_tpu_torch.tools import lab_mega

    room = T.sphere_grid_scene(*ROOM, env_radiance=sky)
    procedural = {"room": room, "room+3 lights": lab_mega.with_lights(room),
                  "large scene": T.sphere_grid_scene(*LARGE,
                                                     env_radiance=sky)}
    scenes = {}
    for name, flat in procedural.items():
        t0 = time.perf_counter()
        path = write_gltf(f"{tmp}/{name.replace(' ', '_')}.gltf",
                          scene_arrays(flat))
        t1 = time.perf_counter()
        scenes[name] = T.load_scene(path)
        loaded = scenes[name].flatten(sky, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check_loaded(flat, loaded, name)
        log(f"glTF {name}: {int(flat.indices.shape[0])} faces, "
            f"{len(scenes[name].doc.meshes)} meshes, "
            f"{int(flat.light_kind.shape[0])} lights; written in "
            f"{(t1 - t0) * 1e3:.1f} ms ({os.path.getsize(path)} B), loaded "
            f"and flattened onto the card in {(t2 - t1) * 1e3:.1f} ms; equal "
            f"to the procedural arrays")
    cfg = T.RenderConfig(width=512, height=512, spp=16, max_depth=8)
    zero_launches()
    t0 = time.perf_counter()
    img = T.render(scenes["room"], cfg, key, env_radiance=sky)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"one-shot render of the loaded room, reference mode: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches {launches}")
    if not (launches["mega"] and not launches["dense"]):
        raise AssertionError(f"the reference frame must run the megakernel: "
                             f"{launches}")
    if not torch.equal(img, room_frame):
        mx, share, mean = compare_images(img, room_frame)
        raise AssertionError(f"loaded and procedural room frames differ: max "
                             f"{mx}, share {share}, mean {mean}")
    log("loaded room: its reference frame equals the procedural room's bit "
        "for bit")
    return scenes


def physical_frames(T, scenes, sky, key, pcfg):
    """Phase 18: the three full-width physical frames through the
    one-shot render, launch counters zeroed before each scene's 3 frames
    and read after: kernel A (room, 3-light room) or C (large scene)
    exactly max_depth bounces x (3 + L) queries x chunks a frame (a chunk
    of 2**20 lanes always has a path left at the last bounce), kernel B
    never; best of 3, their spread, rays/s; one profiled frame of the
    room and of the large scene (kernel A's or C's mean ms a launch).
    Returns {name: (best ms, spread ms, launches of 3 frames, mean ms a
    launch or None)} and each scene's last frame."""
    n_rays = pcfg.n_pixels * pcfg.spp
    chunks = -(-n_rays // pcfg.rays_per_dispatch)
    out, frames = {}, {}
    for name, kernel in (("room", "dense"), ("room+3 lights", "dense"),
                         ("large scene", "packet")):
        n_lights = len(scenes[name].doc.lights)
        want = pcfg.max_depth * (3 + n_lights) * chunks
        zero_launches()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = T.render(scenes[name], pcfg, key, env_radiance=sky)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = read_launches()
        other = "packet" if kernel == "dense" else "dense"
        if not (launches[kernel] == 3 * want and launches[other] == 0
                and launches["mega"] == 0 and launches["mega_save_hits"] == 0):
            raise AssertionError(
                f"physical {name} frames: want {want} launches a frame of "
                f"kernel {'A' if kernel == 'dense' else 'C'} only, got "
                f"{launches} in 3 frames")
        if not (img.shape == (pcfg.height, pcfg.width, 3)
                and torch.isfinite(img).all() and float(img.mean()) > 0.01):
            raise AssertionError(f"physical {name} frame is not a finite, "
                                 f"lit image")
        label = "A" if kernel == "dense" else "C"
        symbol = "dense_hit_kernel" if kernel == "dense" else \
            "packet_hit_kernel"
        mean_ms = None
        if n_lights == 0:       # the profile's post-processing takes ~20 s
            mean_ms = log_kernel_share(
                f"physical {name} frame",
                profile_step(f"physical {name} frame", T.render,
                             scenes[name], pcfg, key, sky), label, symbol)
        best, spread = min(times), max(times) - min(times)
        log(f"physical {name}: {pcfg.width}x{pcfg.height} @{pcfg.spp}spp "
            f"d{pcfg.max_depth}, {n_rays} camera rays: best of 3 "
            f"{best * 1e3:.1f} ms (spread {spread * 1e3:.1f} ms), "
            f"{n_rays / best:,.0f} rays/s, image mean {float(img.mean()):.5f}; "
            f"kernel {label} {want} launches a frame ({pcfg.max_depth} x "
            f"(3 + {n_lights}) x {chunks})"
            + ("" if mean_ms is None else f", {mean_ms:.2f} ms a launch"))
        out[name] = (best * 1e3, spread * 1e3, launches[kernel], mean_ms)
        frames[name] = img
    return out, frames


def capture_queries(T, scene, cfg, key, n_lanes):
    """The closest-hit queries of one physical trace of the first n_lanes
    lanes of a frame, in call order: per bounce the main ray, each delta
    light, the environment NEE, the area NEE. Returns (state, [(origins,
    dirs, mask)])."""
    from tinypathtracer_tpu_torch.render.integrator import trace_paths
    from tinypathtracer_tpu_torch.render.renderer import (hit_fn, lane_rays,
                                                          prepare_state)

    queries = []
    with torch.inference_mode():
        st = prepare_state(scene, cfg)
        pix = torch.arange(n_lanes // cfg.spp, device=scene.device)
        o, d, keys = lane_rays(st.scene, cfg, pix, key)
        fn = hit_fn(st, cfg)

        def recording(orig, dirs, mask=None):
            queries.append((orig, dirs, mask))
            return fn(orig, dirs, mask=mask)

        trace_paths(st.data, cfg, recording, o, d, keys,
                    shade_kernels=st.route.shade_kernels)
    return st, queries


def query_bounds(st, queries, per):
    """Kernel A's (or, where the state holds packet tables, C's) time and
    bound on every captured query of one chunk's physical trace: per
    bounce the main ray, the delta lights, the environment NEE and the
    area NEE (`per` queries a bounce). The bound counts this run's work
    (tools/common.py): kernel A all pairs of the live (unmasked) rays
    and the real faces, o' once per distinct origin and face
    (lab_dense.dense_pairs); kernel C from each ray's visits
    (packet_work). Returns {kind: (queries, mean ms a launch, mean bound
    ms, the bound's kind)} with kinds "main", "light", "environment NEE",
    "area NEE" and "all": the count of captured queries of that kind,
    each timed apart from the main path's launch counts."""
    from tinypathtracer_tpu_torch.ops import dense, packet
    from tinypathtracer_tpu_torch.tools import lab_dense
    from tinypathtracer_tpu_torch.tools.common import bound

    rows = {}
    for q, (o, d, mask) in enumerate(queries):
        pos = q % per
        kind = ("main" if pos == 0 else "environment NEE" if pos == per - 2
                else "area NEE" if pos == per - 1 else "light")
        n = o.shape[0]
        if st.packet is None:
            rays = torch.cat([o, d, o.new_zeros((n, 2))], 1).contiguous()
            ms, _ = cuda_ms(lambda: dense.dense_hit(rays, st.woop, mask), 3)
            work = lab_dense.dense_pairs(rays, st.woop, mask)
        else:
            pk = st.packet
            query = (o.contiguous(), d.contiguous(), mask.contiguous())
            ms, out = cuda_ms(lambda: packet.packet_hit(*query, pk), 3)
            work = packet_work(query[0], out, pk)
        b_ms, b_by = bound(*work)
        for k in (kind, "all"):
            rows.setdefault(k, []).append((ms, b_ms, b_by))
    return {k: (len(v), sum(r[0] for r in v) / len(v),
                sum(r[1] for r in v) / len(v),
                max(set(r[2] for r in v), key=[r[2] for r in v].count))
            for k, v in rows.items()}


def nee_vs_twins(T, scenes, sky, key, pcfg, dev):
    """Phase 19: kernel A on one 2**20-lane chunk's environment-NEE and
    area-NEE queries of the physical room (bounces 0 and 1), kernel C on
    the large scene's (bounce 0), each captured from the frame's own
    trace, against its plain twin on the card, exactly; then each
    kernel's time and bound on every query of that chunk's trace
    (query_bounds). Returns (max |uv| error of A, of C, {"A": A's
    query_bounds on the room, "C": C's on the large scene})."""
    from tinypathtracer_tpu_torch.ops import dense, packet

    errs, query_rows = [], {}
    for name, bounces in (("room", (0, 1)), ("large scene", (0,))):
        scene = scenes[name].flatten(sky, device=dev)
        st, queries = capture_queries(T, scene, pcfg, key.to(dev),
                                      pcfg.rays_per_dispatch)
        per = 3 + scene.light_kind.shape[0]
        if len(queries) % per:
            raise AssertionError(f"{len(queries)} queries is not a whole "
                                 f"number of bounces of {per}")
        err = 0.0
        for b in bounces:
            for kind, q in (("environment NEE", per * b + per - 2),
                            ("area NEE", per * b + per - 1)):
                o, d, mask = queries[q]
                n = o.shape[0]
                if st.packet is None:
                    rays = torch.cat([o, d, o.new_zeros((n, 2))], 1)
                    got = dense.dense_hit(rays, st.woop, mask)
                    t0 = time.perf_counter()
                    want = dense._dense_torch(
                        rays, st.woop.planes,
                        st.woop.sp_boxes if dense.gated(st.woop) else None,
                        mask)
                    label = "A"
                    names = ("t", "slot", "uv")
                    hit = got[1] >= 0
                else:
                    pk = st.packet
                    query = (o.contiguous(), d.contiguous(),
                             mask.contiguous())
                    got = packet.packet_hit(*query, pk)
                    t0 = time.perf_counter()
                    want = packet._packet_torch(*query, pk)
                    label = "C"
                    names = HIT_NAMES
                    hit = got[0] >= 0
                torch.cuda.synchronize()
                what = (f"kernel {label} vs twin, physical {name}, bounce {b} "
                        f"{kind}, {n} lanes ({int(mask.sum())} live)")
                check_equal(got, want, what, names)
                err = max(err, float((got[2] - want[2]).abs().max()))
                log(f"{what}: exact; hit share of live lanes "
                    f"{float(hit[mask].float().mean()):.4f}; twin "
                    f"{time.perf_counter() - t0:.1f} s")
        errs.append(err)
        label = "A" if st.packet is None else "C"
        query_rows[label] = query_bounds(st, queries, per)
        for k, (count, ms, b_ms, b_by) in query_rows[label].items():
            log(f"kernel {label}, physical {name}, one 2**20-lane chunk's "
                f"{k} queries: {count} queries, {ms:.3f} ms a launch, bound "
                f"{b_ms:.3f} ms ({b_by}), {ms / b_ms:.1f}x")
        del queries, st
    return errs[0], errs[1], query_rows


def physical_large_on_a(T, scene, sky, key, pcfg, packet_frame, dev):
    """Phase 20: the large scene's physical frame through the modular
    loop forced onto kernel A: bit-equal to the packet frame."""
    from tinypathtracer_tpu_torch.render import film
    from tinypathtracer_tpu_torch.render.renderer import (prepare_state,
                                                          render_pixel_ids)

    with torch.inference_mode():
        st = prepare_state(scene.flatten(sky, device=dev), pcfg)
        st = dataclasses.replace(st, route=dataclasses.replace(
            st.route, intersector="dense"))
        pix = torch.arange(pcfg.n_pixels, device=dev)
        zero_launches()
        t0 = time.perf_counter()
        img = film.to_image(render_pixel_ids(st, pcfg, pix, key.to(dev))
                            .reshape(pcfg.height, pcfg.width, 3), pcfg.spp)
        torch.cuda.synchronize()
    launches = read_launches()
    log(f"large scene, physical frame forced onto kernel A: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches {launches}")
    if launches["packet"] or not launches["dense"]:
        raise AssertionError(f"the forced frame must run kernel A only: "
                             f"{launches}")
    if not torch.equal(img, packet_frame):
        mx, share, mean = compare_images(img, packet_frame)
        raise AssertionError(f"physical packet and dense frames differ: max "
                             f"{mx}, share {share}, mean {mean}")
    log("large scene, physical: the packet frame equals the kernel A frame "
        "bit for bit")


def oracle_disagreements(scene, cfg, key, dev):
    """Each closest-hit query of the kernel A trace of a frame answered by
    the brute force too. Returns (the (lane, query) pairs whose faces
    differ, those of them where neither hit lies within SELF_HIT_T of the
    origin)."""
    from tinypathtracer_tpu_torch.ops.intersect import closest_hit_bruteforce
    from tinypathtracer_tpu_torch.render.integrator import trace_paths
    from tinypathtracer_tpu_torch.render.renderer import (hit_fn, lane_rays,
                                                          prepare_state)

    counts = [0, 0]
    with torch.inference_mode():
        st = prepare_state(scene, cfg)
        o, d, keys = lane_rays(st.scene, cfg,
                               torch.arange(cfg.n_pixels, device=dev),
                               key.to(dev))
        dense_fn, tv = hit_fn(st, cfg), st.data.tri_verts

        def both(orig, dirs, mask=None):
            a = dense_fn(orig, dirs, mask=mask)
            b = closest_hit_bruteforce(orig, dirs, tv, mask=mask)
            bad = a[0] != b[0]
            counts[0] += int(bad.sum())
            counts[1] += int((bad & (torch.minimum(a[1], b[1])
                                     >= SELF_HIT_T)).sum())
            return a

        trace_paths(st.data, cfg, both, o, d, keys,
                    shade_kernels=st.route.shade_kernels)
    return tuple(counts)


def physical_oracle(T, scene, sky, dev):
    """Phase 21: a 64x64 @4 spp d8 physical room frame on kernel A against
    the bruteforce route. The two test a ray against a triangle by
    different arithmetic, so their hits differ by ulps and the paths part
    a little at every bounce; where a ray grazes the surface it leaves,
    one may report that surface just past the DELTA cutoff (a self-hit)
    and the other not. Every query of the kernel A trace is answered by
    both: where their faces differ, one hit must be a self-hit (within
    SELF_HIT_T of the origin). The frames may differ beyond 1e-5 on at
    most PHYSICAL_ORACLE_PIXELS pixels (counted)."""
    key = T.prng_key(3)
    cfg = T.RenderConfig(**ORACLE, mode="physical")
    dense_img = T.render(scene, cfg, key, env_radiance=sky)
    t0 = time.perf_counter()
    zero_launches()
    brute = T.render(scene, dataclasses.replace(cfg, intersector="bruteforce"),
                     key, env_radiance=sky)
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise AssertionError("the bruteforce route launched a kernel")
    t_brute = time.perf_counter() - t0
    mx, share, mean = compare_images(brute, dense_img)
    beyond = round(share * cfg.width * cfg.height)
    pairs, unexplained = oracle_disagreements(
        scene.flatten(sky, device=dev), cfg, key, dev)
    log(f"physical room {ORACLE} bruteforce route {t_brute:.1f} s; against "
        f"kernel A: max abs diff {mx:.3e}, {beyond} pixels beyond 1e-5 "
        f"(limit {PHYSICAL_ORACLE_PIXELS}), mean abs diff {mean:.3e}; on "
        f"the kernel A trace's queries {pairs} (lane, query) pairs whose "
        f"faces differ, {unexplained} of them without a self-hit "
        f"(t < {SELF_HIT_T})")
    if unexplained or beyond > PHYSICAL_ORACLE_PIXELS:
        raise AssertionError(
            f"physical bruteforce and kernel A frames: {unexplained} "
            f"differing hits without a self-hit, {beyond} pixels beyond 1e-5")


def physical_train(T, scene, sky, pcfg, dev):
    """Phase 22: the physical room's train step at full width through
    make_train_step: a warm-up (loss_and_grads and the Adam step, with the
    gradients checked finite), then 3 timed steps; peak memory. Each
    bounce is rematerialised, so a step launches kernel A twice a
    frame's max_depth x (3 + L) x chunks. Returns (best ms, peak GiB,
    launches of the 3 steps)."""
    from tinypathtracer_tpu_torch.diff import invrender as inv

    flat = scene.flatten(sky, device=dev)
    params = inv.Params.from_scene(flat)
    state = inv.AdamState.init(params)
    target = torch.zeros((pcfg.height, pcfg.width, 3), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = inv.loss_and_grads(params, flat, pcfg, target,
                                     T.prng_key(1, dev))
    params, state = inv.adam_step(params, grads, state, LR)
    torch.cuda.synchronize()
    bad = [nm for nm, g in zip(param_names(inv), grads.leaves())
           if not torch.isfinite(g).all()]
    if bad or not math.isfinite(float(loss)):
        raise AssertionError(f"physical step: loss {float(loss)}, non-finite "
                             f"gradients {bad}")
    log(f"physical room train step (warm-up): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss {float(loss):.6f}, "
        f"every gradient finite; |g| max per leaf "
        f"{[float(g.abs().max()) for g in grads.leaves() if g.numel()]}")
    step = inv.make_train_step(pcfg, inv.adam(LR), device=dev.type)
    zero_launches()
    best = float("inf")
    for i in range(3):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, flat, target,
                                   T.prng_key(i + 2, dev))
        loss = float(loss)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if not (math.isfinite(loss)
                and all(torch.isfinite(x).all() for x in params.leaves())):
            raise AssertionError(f"physical step {i}: loss {loss} or the "
                                 f"parameters are not finite")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_rays = pcfg.n_pixels * pcfg.spp
    log(f"physical room train step: best of 3 {best * 1e3:.1f} ms, "
        f"{n_rays / best:,.0f} fwd+bwd camera rays/s, loss {loss:.6f}; peak "
        f"memory {peak:.2f} GiB; launches in 3 steps {launches}")
    want = 3 * 2 * pcfg.max_depth * (3 + len(scene.doc.lights)) * (
        -(-n_rays // pcfg.rays_per_dispatch))
    if (launches["mega"] or launches["mega_save_hits"] or launches["packet"]
            or launches["dense"] != want):
        raise AssertionError(f"3 rematerialised physical steps must launch "
                             f"kernel A {want} times and nothing else: "
                             f"{launches}")
    return best * 1e3, peak, launches["dense"]


# ---- phases 23-28: textures, progressive rendering, AOVs, the CLI ----------

def add_launches(total, launches):
    """Add one run's launch counts to a running total (in place)."""
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def check_image(img, cfg, what, lit=0.01):
    """A frame of cfg's shape, finite, non-negative and lit."""
    if not (img.shape == (cfg.height, cfg.width, 3)
            and bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
            and float(img.mean()) > lit):
        raise AssertionError(f"{what} is not a finite, non-negative, lit "
                             f"image of {cfg.height}x{cfg.width}")


def timed_frames(render, reps):
    """(best s, spread s, the last result) of reps render() calls, each
    ended by a synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = render()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), max(times) - min(times), out


def chunks_of(cfg, spp=None):
    """The ray chunks of one pass of spp samples (cfg.spp by default):
    whole pixels of up to cfg.rays_per_dispatch lanes each."""
    spp = cfg.spp if spp is None else spp
    return -(-cfg.n_pixels // (cfg.rays_per_dispatch // spp))


def textured_room_frames(T, room_t, cfg, key, dev):
    """Phase 23: the textured room's full-width reference frame through
    Renderer.render, launch counters zeroed before each route's frames
    and read after: the megakernel route (kernel B's save_hits instance
    once a chunk, hits only, then the shading replay; no forward
    instance, no kernel A) and the modular route (kernel A, no kernel B),
    best of 3 each, bit-equal; one bilinear-filtered megakernel frame,
    which must differ from the point frame. Then kernel B against its
    twin on the textured room's 64x64 @4 spp operands. One profiled
    frame of each of the first two routes (its kernel's ms a launch).
    Returns ({route: (best ms, spread ms, launches, kernel ms a launch or
    None)}, the point megakernel frame, the launches, (kernel B's and its
    save_hits instance's max error))."""
    n_rays = cfg.n_pixels * cfg.spp
    chunks = chunks_of(cfg)
    out, images, total = {}, {}, {}
    for route, extra, reps in (("megakernel", {}, 3),
                               ("modular", {"megakernel": False}, 3),
                               ("bilinear megakernel",
                                {"tex_filter": "bilinear"}, 1)):
        r = T.Renderer(dataclasses.replace(cfg, **extra), device="cuda")
        zero_launches()
        best, spread, img = timed_frames(lambda: r.render(room_t, key), reps)
        launches = read_launches()
        add_launches(total, launches)
        check_image(img, cfg, f"textured room {route} frame")
        if route == "modular":
            ok = (launches["dense"] > 0 and launches["mega"] == 0
                  and launches["mega_save_hits"] == 0)
        else:
            ok = (launches["mega_save_hits"] == reps * chunks
                  and launches["mega"] == 0 and launches["dense"] == 0
                  and launches["packet"] == 0)
        if not ok:
            raise AssertionError(f"textured room {route} frames launched "
                                 f"{launches} in {reps} frames")
        log(f"textured room, {route}: {cfg.width}x{cfg.height} @{cfg.spp}spp "
            f"d{cfg.max_depth}, {n_rays} camera rays: best of {reps} "
            f"{best * 1e3:.1f} ms (spread {spread * 1e3:.1f} ms), "
            f"{n_rays / best:,.0f} rays/s, image mean {float(img.mean()):.5f}; "
            f"launches in {reps} frames {launches}")
        kernel_ms = None
        if reps > 1:            # where the frame's device time goes
            label, symbol = (("A", "dense_hit_kernel") if route == "modular"
                             else ("B", "mega_kernel"))
            kernel_ms = log_kernel_share(
                f"textured room {route} frame",
                profile_step(f"textured room {route} frame", r.render,
                             room_t, key), label, symbol)
        out[route] = (best * 1e3, spread * 1e3, launches, kernel_ms)
        images[route] = img
    if not torch.equal(images["megakernel"], images["modular"]):
        mx, share, mean = compare_images(images["megakernel"],
                                         images["modular"])
        raise AssertionError(f"textured megakernel and modular frames "
                             f"differ: max {mx}, share {share}, mean {mean}")
    mx, share, mean = compare_images(images["bilinear megakernel"],
                                     images["megakernel"])
    log(f"textured room: the megakernel frame equals the modular frame bit "
        f"for bit; bilinear against point: max abs diff {mx:.3e}, share of "
        f"pixels > 1e-5 {share:.3f}")
    if mx == 0.0:
        raise AssertionError("the bilinear frame equals the point frame")
    small = T.RenderConfig(width=64, height=64, spp=4, max_depth=8)
    ops, _ = mega_frame_operands(room_t.to(dev), small, T.prng_key(1, dev))
    errs = mega_vs_twin(ops, 0, f"textured room, {ops[0].shape[1]}")
    return out, images["megakernel"], total, errs


def textured_train(T, room_t, cfg, small, dev):
    """Phase 24: the textured room's full-width train step through
    make_train_step, Params.tex_atlas among the leaves: one warm-up step
    and 3 timed, peak memory; kernel B's save_hits instance once a chunk
    and nothing else (the forward replays the shading under autograd);
    the texels move. Then the megakernel route's gradients against the
    modular route's at 64x64 @4 spp d8 (compare_grads, rtol GRAD_RTOL),
    texels, albedo and env non-zero. Returns (best ms, peak GiB,
    launches)."""
    from tinypathtracer_tpu_torch.diff import invrender as inv

    scene = room_t.to(dev)
    params = inv.Params.from_scene(scene)
    state = inv.AdamState.init(params)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    step = inv.make_train_step(cfg, inv.adam(LR), device="cuda")
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best, n_steps = float("inf"), 4
    for i in range(n_steps):              # one warm-up step, then 3 timed
        t0 = time.perf_counter()
        new_params, _, loss = step(params, state, scene, target,
                                   T.prng_key(i + 1, dev))
        loss = float(loss)
        torch.cuda.synchronize()
        if i:
            best = min(best, time.perf_counter() - t0)
        if not (math.isfinite(loss) and all(
                torch.isfinite(x).all() for x in new_params.leaves())):
            raise AssertionError(f"textured step {i}: loss {loss} or the "
                                 f"parameters are not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    n_rays = cfg.n_pixels * cfg.spp
    moved = float((new_params.tex_atlas - params.tex_atlas).abs().max())
    log(f"textured room train step: best of 3 {best * 1e3:.1f} ms, "
        f"{n_rays / best:,.0f} fwd+bwd camera rays/s, loss {loss:.6f}; peak "
        f"memory {peak:.2f} GiB; texels moved by up to {moved:.3e}; launches "
        f"in {n_steps} steps {launches}")
    want = n_steps * chunks_of(cfg)
    if not (launches["mega_save_hits"] == want and launches["mega"] == 0
            and launches["dense"] == 0 and launches["packet"] == 0):
        raise AssertionError(f"the textured step must launch the save_hits "
                             f"instance once a chunk ({want}) and nothing "
                             f"else: {launches}")
    if not moved > 0.5 * LR:
        raise AssertionError("the textured step did not move the texels")
    grads = compare_grads(T, scene, small, "textured room")
    for f in ("tex_atlas", "mtl_base_color", "env_radiance"):
        if not bool((getattr(grads, f) != 0).any()):
            raise AssertionError(f"textured room: the gradient of {f} is 0")
    return best * 1e3, peak, launches


def textured_other_scenes(T, sky, key, cfg, room_t, large_t, tmp, dev):
    """Phase 25: the textured large scene's full-width frame (kernel C,
    neither A nor B), the textured room's physical frame (kernel A,
    max_depth x 3 x chunks launches a frame, no B), each best of 2; the
    textured room written by write_gltf (texcoords, the atlas as an 8-bit
    PNG) and loaded through load_scene: equal to the procedural room
    that carries the quantised atlas (check_loaded), and its one-shot
    render(...) frame equal to that room's frame bit for bit. Returns
    ({scene: (best ms, spread ms, launches)}, the .gltf path, the
    launches)."""
    n_rays = cfg.n_pixels * cfg.spp
    chunks = chunks_of(cfg)
    out, total = {}, {}
    pcfg = dataclasses.replace(cfg, mode="physical")
    for name, scene, c, kernel, want in (
            ("large scene", large_t, cfg, "packet",
             2 * cfg.max_depth * 2 * chunks),
            ("physical room", room_t, pcfg, "dense",
             2 * pcfg.max_depth * 3 * chunks)):
        r = T.Renderer(c, device="cuda")
        zero_launches()
        best, spread, img = timed_frames(lambda: r.render(scene, key), 2)
        launches = read_launches()
        add_launches(total, launches)
        check_image(img, c, f"textured {name} frame")
        other = "dense" if kernel == "packet" else "packet"
        if not (launches[kernel] == want and launches[other] == 0
                and launches["mega"] == 0 and launches["mega_save_hits"] == 0):
            raise AssertionError(f"textured {name}: want {want} launches of "
                                 f"{kernel} only in 2 frames, got {launches}")
        log(f"textured {name}: {c.width}x{c.height} @{c.spp}spp "
            f"d{c.max_depth}, {c.mode}: best of 2 {best * 1e3:.1f} ms (spread "
            f"{spread * 1e3:.1f} ms), {n_rays / best:,.0f} rays/s, image mean "
            f"{float(img.mean()):.5f}; launches in 2 frames {launches}")
        out[name] = (best * 1e3, spread * 1e3, launches)
    arrays = scene_arrays(room_t)
    t0 = time.perf_counter()
    path = write_gltf(f"{tmp}/textured_room.gltf", arrays)
    t1 = time.perf_counter()
    scene = T.load_scene(path)
    loaded = scene.flatten(sky, device="cuda")
    torch.cuda.synchronize()
    procedural = dataclasses.replace(room_t, tex_atlas=torch.from_numpy(
        quantised_atlas(arrays["tex_atlas"])))
    check_loaded(procedural, loaded, "textured room")
    log(f"glTF textured room: written in {(t1 - t0) * 1e3:.1f} ms "
        f"({os.path.getsize(path)} B, the atlas as {len(arrays['tex_atlas'])} "
        f"8-bit PNG), loaded and flattened onto the card in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms; equal to the procedural "
        f"room with the quantised atlas")
    zero_launches()
    t0 = time.perf_counter()
    img = T.render(scene, cfg, key, env_radiance=sky)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    add_launches(total, launches)
    if launches["mega_save_hits"] != chunks or launches["mega"]:
        raise AssertionError(f"the loaded textured room's frame must run the "
                             f"save_hits instance once a chunk: {launches}")
    want_img = T.Renderer(cfg, device="cuda").render(procedural, key)
    if not torch.equal(img, want_img):
        mx, share, mean = compare_images(img, want_img)
        raise AssertionError(f"loaded and procedural textured frames differ: "
                             f"max {mx}, share {share}, mean {mean}")
    log(f"one-shot render of the loaded textured room: {dt * 1e3:.1f} ms "
        f"(flatten included); launches {launches}; equal bit for bit to the "
        f"procedural room's frame")
    out["loaded textured room"] = (dt * 1e3, 0.0, launches)
    return out, path, total


def progressive_phase(T, room_t, cfg, key, room_frame, tmp):
    """Phase 26: Renderer.progressive. The textured room at cfg's shape as
    2 steps of cfg.spp / 2 samples, straight through and with save / load
    into a new accumulator between them: bit-equal radiance sums, the
    image within 1e-5 of phase 23's Renderer.render frame. Then the
    1920x1080 @64 spp d8 textured forward (132,710,400 paths) as 4 steps
    of 16 samples: ms a step, the total, rays/s, peak memory; finite and
    non-negative. Returns (its step times in ms, total ms, peak GiB, the
    launches)."""
    from tinypathtracer_tpu_torch.render import film

    half = cfg.spp // 2
    r = T.Renderer(cfg, device="cuda")
    total = {}
    zero_launches()
    straight = r.progressive()
    for _ in range(2):
        straight.step(room_t, key, half)
    part = r.progressive()
    part.step(room_t, key, half)
    path = f"{tmp}/progressive.npz"
    part.save(path)
    resumed = r.progressive()
    resumed.load(path)
    resumed.step(room_t, key, half)
    torch.cuda.synchronize()
    launches = read_launches()
    add_launches(total, launches)
    if not torch.equal(resumed.radiance_sum, straight.radiance_sum):
        raise AssertionError("the resumed progressive render differs from "
                             "the uninterrupted one")
    img = film.to_image(resumed.radiance_sum, resumed.samples_done)
    mx, share, mean = compare_images(img, room_frame)
    log(f"progressive textured room, 2 x {half} spp with save / load: equal "
        f"bit for bit to 2 uninterrupted steps; against Renderer.render: max "
        f"abs diff {mx:.3e}; launches {launches}")
    if mx > 1e-5 or launches["mega_save_hits"] != 4 * chunks_of(cfg, half):
        raise AssertionError(f"progressive room: max diff {mx}, launches "
                             f"{launches}")
    big = T.RenderConfig(width=1920, height=1080, spp=64, max_depth=8)
    rb = T.Renderer(big, device="cuda")
    prog = rb.progressive()
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(4):
        t0 = time.perf_counter()
        prog.step(room_t, key, 16)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    add_launches(total, launches)
    img = prog.image()
    check_image(img, big, "the 1920x1080 @64 spp textured frame")
    n_rays = big.n_pixels * big.spp
    log(f"1920x1080 @64spp d8 textured forward, 4 progressive steps of 16 "
        f"spp: {', '.join(f'{t:.1f}' for t in steps)} ms, total "
        f"{sum(steps):.1f} ms, {n_rays / (sum(steps) / 1e3):,.0f} rays/s "
        f"({n_rays} paths), peak memory {peak:.2f} GiB, image mean "
        f"{float(img.mean()):.5f}; launches {launches}")
    want = 4 * chunks_of(big, 16)
    if launches["mega_save_hits"] != want or launches["mega"] or \
            launches["dense"]:
        raise AssertionError(f"the 1920x1080 frame must launch the save_hits "
                             f"instance {want} times and nothing else: "
                             f"{launches}")
    return steps, sum(steps), peak, total


class twin_kernels:
    """Context: kernels A and C replaced, in ops/dense and ops/packet, by
    their plain twins on the same (card) tensors: the twin route of a
    comparison. The twins count no launch."""

    def __enter__(self):
        from tinypathtracer_tpu_torch.ops import dense, packet

        self.kernels = dense.dense_hit, packet.packet_hit
        dense.dense_hit = lambda rays, woop, mask=None: dense._dense_torch(
            rays, woop.planes, woop.sp_boxes if dense.gated(woop) else None,
            mask)
        packet.packet_hit = packet._packet_torch
        return self

    def __exit__(self, *exc):
        from tinypathtracer_tpu_torch.ops import dense, packet

        dense.dense_hit, packet.packet_hit = self.kernels
        return False


def aov_phase(T, scenes, cfg, key, dev):
    """Phase 27: the three AOVs through render_aov at cfg's shape on the
    textured room (kernel A) and the textured large scene (kernel C),
    launch counters zeroed before each and read after: one launch a
    chunk of the renderer's own hit kernel, no other; values in [0, 1],
    every pixel hit (both rooms are closed). Then each at 64x64 @2 spp
    against the same AOV through the twin route (twin_kernels), exactly.
    Returns ({(scene, kind): ms}, the launches)."""
    small = T.RenderConfig(width=64, height=64, spp=2, max_depth=8)
    out, total = {}, {}
    for name, scene, kernel in (("textured room", scenes[0], "dense"),
                                ("textured large scene", scenes[1],
                                 "packet")):
        flat = scene.to(dev)
        for kind in T.AOV_KINDS:
            zero_launches()
            t0 = time.perf_counter()
            img = T.render_aov(flat, cfg, key, kind, device=dev)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            add_launches(total, launches)
            other = "packet" if kernel == "dense" else "dense"
            if not (launches[kernel] == chunks_of(cfg)
                    and launches[other] == 0 and launches["mega"] == 0
                    and launches["mega_save_hits"] == 0):
                raise AssertionError(f"{name} {kind} AOV launched {launches}")
            if not (img.shape == (cfg.height, cfg.width, 3)
                    and float(img.min()) >= 0.0 and float(img.max()) <= 1.0
                    and bool((img.sum(-1) > 0).all())):
                raise AssertionError(f"{name} {kind} AOV: values out of [0, "
                                     f"1] or a pixel that hit nothing")
            got = T.render_aov(flat, small, key, kind, device=dev)
            with twin_kernels():
                want = T.render_aov(flat, small, key, kind, device=dev)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {kind} AOV differs from the "
                                     f"twin route's at 64x64")
            log(f"AOV {kind}, {name}: {cfg.width}x{cfg.height} @{cfg.spp}spp "
                f"{ms:.1f} ms, mean {float(img.mean()):.5f}; launches "
                f"{launches}; equal to the twin route's at 64x64 @2spp")
            out[(name, kind)] = ms
    return out, total


def cli_phase(T, path, sky, cfg, tmp):
    """Phase 28: `python -m tinypathtracer_tpu_torch.tools.render_cli` as
    a subprocess on the card, on the written textured room, with --stats
    and once with --aov normal: each PNG equal byte for byte to the
    in-process one-shot render (or render_aov, flipped to top-down rows)
    written by film.write_png. Returns the beauty run's stats."""
    from tinypathtracer_tpu_torch.render import film

    root = os.path.dirname(os.path.abspath(__file__))
    base = [sys.executable, "-m", "tinypathtracer_tpu_torch.tools.render_cli",
            "--scene", path, "--width", str(cfg.width), "--height",
            str(cfg.height), "--spp", str(cfg.spp), "--depth",
            str(cfg.max_depth), "--seed", "0"]
    key = T.prng_key(0)
    flat = T.load_scene(path).flatten(sky, device="cuda")
    refs = {"beauty": T.render(T.load_scene(path), cfg, key, env_radiance=sky),
            "normal": T.render_aov(flat, cfg, key, "normal").flip(0)}
    stats = None
    for name, extra in (("beauty", ["--stats"]), ("normal", ["--aov",
                                                             "normal"])):
        out = f"{tmp}/cli_{name}.png"
        t0 = time.perf_counter()
        proc = subprocess.run(base + ["--out", out] + extra, cwd=root,
                              capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"render_cli {name} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        ref = f"{tmp}/ref_{name}.png"
        film.write_png(ref, refs[name])
        with open(out, "rb") as a, open(ref, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"render_cli's {name} PNG differs from "
                                     f"the in-process one")
        if name == "beauty":
            stats = json.loads(proc.stderr.strip().splitlines()[-1])
        log(f"render_cli {name} (subprocess, {' '.join(extra)}): {dt:.1f} s "
            f"wall; PNG equal byte for byte to the in-process one"
            + (f"; stats {json.dumps(stats)}" if name == "beauty" else ""))
    return stats


# ---- phases 29-31: rematerialised steps, torch.distributed ---------------

# the large, physical and textured room steps (phases 11, 22, 24) as
# this script read them before each bounce was rematerialised: best ms,
# peak GiB (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5)
STEPS_BEFORE_REMAT = {"large scene": (1430.5, 13.41),
                      "physical room": (1287.6, 19.32),
                      "textured room": (1044.0, 15.87)}

def remat_phase(steps):
    """Phase 29: the large, physical and textured steps' best times and
    peaks (phases 11, 22, 24) beside their readings before the
    rematerialisation; each peak must be below its old one."""
    for name, (ms, peak) in steps.items():
        old_ms, old_peak = STEPS_BEFORE_REMAT[name]
        log(f"{name} step, each bounce rematerialised: {ms:.1f} ms "
            f"({ms / old_ms:.2f}x the {old_ms:.1f} before), peak "
            f"{peak:.2f} GiB ({peak / old_peak:.2f}x the {old_peak:.2f})")
        if not peak < old_peak:
            raise AssertionError(f"the {name} step's peak did not fall: "
                                 f"{peak:.2f} GiB")


def nccl_rank(rank, world, tmp):
    """A rank of an NCCL group whose ranks share one card: its first
    collective must be refused. Saves the error text."""
    import torch.distributed as dist

    from tinypathtracer_tpu_torch.parallel import initialize, rank_file

    initialize(f"file://{tmp}/nccl_store", world, rank)
    x = torch.ones(4, device="cuda")
    error = None
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
    except Exception as e:          # the refusal this rank is here to see
        error = f"{type(e).__name__}: {e}"
    torch.save({"error": error}, rank_file(tmp, rank))
    sys.stdout.flush()
    os._exit(0)       # skip tearing down a communicator that never formed


def shard_rank(rank, world, tmp, meshes, large_mesh, train_meshes):
    """A gloo rank on this card (phases 30-31): the room's 512x512 @16 spp
    d8 frame through make_sharded_renderer on each mesh, the large
    scene's on large_mesh, and one make_sharded_train_step step (Adam
    LR, zero target, key 1) on each of train_meshes; each timed after a
    warm-up, with its launch counters and peak memory."""
    import torch.distributed as dist

    import tinypathtracer_tpu_torch as T
    from tinypathtracer_tpu_torch.diff import (AdamState, Params, adam,
                                               make_sharded_train_step)
    from tinypathtracer_tpu_torch.models.envlight import gradient_sky
    from tinypathtracer_tpu_torch.parallel import (initialize, make_mesh,
                                                   make_sharded_renderer,
                                                   rank_file)

    initialize(f"file://{tmp}/gloo_store_{world}", world, rank,
               backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    sky = gradient_sky(64, 128)
    cfg = T.RenderConfig(width=512, height=512, spp=16, max_depth=8)
    scenes = {"room": T.sphere_grid_scene(*ROOM, env_radiance=sky),
              "large scene": T.sphere_grid_scene(*LARGE, env_radiance=sky)}
    out = {"device": str(dev), "frames": {}, "train": {}}

    def timed(fn):
        fn()                                      # warm-up
        torch.cuda.synchronize()
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (res, (time.perf_counter() - t0) * 1e3, read_launches(),
                torch.cuda.max_memory_allocated() / 2**30)

    for shape in meshes:
        render = make_sharded_renderer(cfg, make_mesh(*shape))
        names = ["room"] + (["large scene"] if shape == large_mesh else [])
        for name in names:
            img, ms, launches, peak = timed(
                lambda: render(scenes[name], T.prng_key(0)))
            out["frames"][(shape, name)] = (img.cpu(), ms, launches, peak)
    room = scenes["room"].to(dev)
    params = Params.from_scene(room)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    for shape in train_meshes:
        step = make_sharded_train_step(cfg, make_mesh(*shape), adam(LR))
        (new, state, loss), ms, launches, peak = timed(
            lambda: step(params, AdamState.init(params), room, target,
                         T.prng_key(1)))
        out["train"][shape] = {
            "loss": float(loss), "params": [x.cpu() for x in new.leaves()],
            "adam_step": state.step, "ms": ms, "launches": launches,
            "peak": peak}
    torch.save(out, rank_file(tmp, rank))
    dist.destroy_process_group()


def check_rank_launches(launches, kernel, what, shaded=False):
    """A rank's launches: kernel (a read_launches key) > 0, no other; where
    shaded, the shade kernels besides (`check_shaded`)."""
    if shaded:
        check_shaded(launches, what)
    others = {k: v for k, v in launches.items() if k != kernel and v
              and not (shaded and k in ("shade_hits", "close_bounce"))}
    if not launches[kernel] or others:
        raise AssertionError(f"{what}: want {kernel} launches only, got "
                             f"{launches}")


def shard_frames_phase(T, cfg, key, host_room, room_frame, large_frame,
                       tmp):
    """Phase 30: make_sharded_renderer on the room at 512x512 @16 spp d8
    (kernel B) and the large scene (kernel C). First in this process, a
    one-rank NCCL group, mesh (1, 1): bit-equal to phase 4's frame. Then
    two ranks with NCCL on this one card: refused, the error logged. Then
    gloo ranks spawned onto this card: meshes (2, 1) bit-equal to phase 4
    (room) and phase 11 (large scene), (1, 2) and (2, 2) within 1e-5;
    each rank's launches (B's forward instance only on the room, C only
    on the large scene), wall time and peak memory. Ranks sharing one
    card measure no scaling: their times are the card's time shared.
    Returns (the launches of the sharded frames by kernel, the pair's
    rank results)."""
    import torch.distributed as dist

    from tinypathtracer_tpu_torch.parallel import (initialize, make_mesh,
                                                   make_sharded_renderer,
                                                   spawn_ranks)

    initialize()                     # no variable set: one rank, NCCL
    mesh = make_mesh()
    zero_launches()
    t0 = time.perf_counter()
    img = make_sharded_renderer(cfg, mesh)(host_room, key)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = read_launches()
    log(f"sharded room frame, 1-rank {dist.get_backend()} group, mesh "
        f"{tuple(mesh.shape)}: {dt * 1e3:.1f} ms; launches {launched}")
    dist.destroy_process_group()
    check_rank_launches(launched, "mega", "the 1-rank sharded frame")
    if not torch.equal(img.cpu(), room_frame):
        raise AssertionError("the 1-rank sharded frame differs from phase "
                             "4's")
    total = {"mega": launched["mega"]}
    torch.cuda.empty_cache()

    errors = [r["error"] for r in spawn_ranks(nccl_rank, 2, tmp)]
    if not all(errors):
        raise AssertionError(f"NCCL accepted two ranks on one card: "
                             f"{errors}")
    log(f"NCCL, two ranks on one card, refused (one rank a card): "
        f"{errors[0][:600]}")

    pair = spawn_ranks(shard_rank, 2, tmp, [(2, 1), (1, 2)], (2, 1),
                       [(2, 1), (1, 2)])
    quad = spawn_ranks(shard_rank, 4, tmp, [(2, 2)], None, [])
    refs = {"room": room_frame, "large scene": large_frame}
    for ranks in (pair, quad):
        for (shape, name), first in ranks[0]["frames"].items():
            kernel = "mega" if name == "room" else "packet"
            for rank, r in enumerate(ranks):
                img, ms, launches, peak = r["frames"][(shape, name)]
                log(f"sharded {name} frame, mesh {shape}, rank {rank} of "
                    f"{len(ranks)} on {r['device']} (gloo): {ms:.1f} ms, "
                    f"peak {peak:.2f} GiB, launches {launches}")
                check_rank_launches(launches, kernel,
                                    f"rank {rank}, {name} {shape}",
                                    shaded=kernel == "packet")
                total[kernel] = total.get(kernel, 0) + launches[kernel]
                if not torch.equal(img, first[0]):
                    raise AssertionError(f"{name} {shape}: ranks' frames "
                                         f"differ")
            diff = float((first[0] - refs[name]).abs().max())
            exact = torch.equal(first[0], refs[name])
            log(f"sharded {name} frame, mesh {shape}: max abs diff "
                f"{diff:.3e} to the one-device frame"
                + (" (bit-equal)" if exact else ""))
            if shape[1] == 1 and not exact:
                raise AssertionError(f"the data-sharded {name} frame "
                                     f"{shape} is not bit-equal")
            if diff > 1e-5:
                raise AssertionError(f"the sharded {name} frame {shape} is "
                                     f"not within 1e-5")
    log("ranks sharing one card measure no scaling: each rank's time is "
        "its share of the one card's")
    return total, pair


def shard_train_phase(pair, reference, path, cfg, tmp):
    """Phase 31: make_sharded_train_step on the room at 512x512 @16 spp
    d8 (Adam LR, zero target, key 1) at (2, 1) and (1, 2), from
    shard_rank's results: the loss within 1e-6 and the parameters within
    rtol 1e-5 of phase 7's one-device step, equal on every rank; the
    save_hits instance once per rank chunk, no other kernel; the step's
    time and peak per rank. Where phase 7's gradient is rounding residue
    (|g| <= 1e-6 of the largest: the camera's, analytically zero without
    delta lights), Adam moves a parameter by LR times the residue's sign,
    so those elements are held to a move of at most LR instead. Then
    the CLI's --shard as a one-rank subprocess: its PNG equal byte for
    byte to phase 28's. Returns the save_hits launches."""
    g_max = max(float(g.abs().max()) for g in reference["grads"]
                if g.numel())
    chunks = 2                     # each rank: 2**21 lanes, 2**20 a chunk
    total = 0
    for shape in ((2, 1), (1, 2)):
        first = pair[0]["train"][shape]
        residue = 0
        for rank, r in enumerate(pair):
            t = r["train"][shape]
            log(f"sharded train step, mesh {shape}, rank {rank}: "
                f"{t['ms']:.1f} ms, peak {t['peak']:.2f} GiB, loss "
                f"{t['loss']:.8f} (one device {reference['loss']:.8f}), "
                f"launches {t['launches']}")
            check_rank_launches(t["launches"], "mega_save_hits",
                                f"rank {rank}, step {shape}")
            if t["launches"]["mega_save_hits"] != chunks:
                raise AssertionError(f"rank {rank}, step {shape}: want "
                                     f"{chunks} save_hits launches")
            total += chunks
            if not all(torch.equal(a, b) for a, b in zip(t["params"],
                                                         first["params"])):
                raise AssertionError(f"step {shape}: parameters differ "
                                     f"between ranks")
        if abs(first["loss"] - reference["loss"]) > 1e-6 * reference["loss"]:
            raise AssertionError(f"step {shape}: the loss is not within 1e-6")
        for got, want, g in zip(first["params"], reference["params"],
                                reference["grads"]):
            off = ~torch.isclose(got, want, rtol=1e-5, atol=1e-7)
            residue += int(off.sum())
            live = g.abs() > 1e-6 * g_max
            if bool((off & (live | ((got - want).abs()
                                    > 2 * LR * (1 + 1e-6)))).any()):
                raise AssertionError(f"step {shape}: parameters not within "
                                     f"rtol 1e-5 of the one-device step")
        log(f"sharded train step {shape}: loss and parameters agree with "
            f"phase 7's step; {residue} elements beyond rtol 1e-5, each "
            f"with a residue gradient (|g| <= 1e-6 of the largest) and a "
            f"move of at most LR")

    out, ref = f"{tmp}/cli_shard.png", f"{tmp}/ref_beauty.png"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tinypathtracer_tpu_torch.tools.render_cli",
         "--scene", path, "--width", str(cfg.width), "--height",
         str(cfg.height), "--spp", str(cfg.spp), "--depth",
         str(cfg.max_depth), "--seed", "0", "--shard", "--out", out],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"render_cli --shard exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with open(out, "rb") as a, open(ref, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("render_cli --shard's PNG differs from "
                                 "phase 28's")
    log(f"render_cli --shard (one rank, subprocess): "
        f"{time.perf_counter() - t0:.1f} s wall; PNG equal byte for byte "
        f"to phase 28's")
    return total


# ---- phases 32-33: the flagship fwd+bwd, the entry points -----------------

# the flagship step: 1920x1080 @16 spp d8, 33,177,600 camera paths in
# 32 chunks of 65,536 pixels (2**20 lanes)
FLAGSHIP = dict(width=1920, height=1080, spp=16, max_depth=8)
FLAGSHIP_CHUNKS = 32
FD_RTOL = 1e-3
# the config of the JAX package's entry() (__graft_entry__.py)
ENTRY_CFG = dict(width=64, height=64, spp=2, max_depth=4, intersector="dense")
# the config of its dryrun_multichip()
DRYRUN_CFG = dict(width=16, height=16, spp=2, max_depth=2, intersector="dense")


def count_syncs(fn):
    """(fn()'s result, the host-device synchronisations it made, as
    {"file:line": count} of the Python line that made each): under
    torch.cuda.set_sync_debug_mode("warn") each one is a warning. The
    mode is a prototype and may miss some."""
    import collections
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    root = os.path.dirname(os.path.abspath(__file__)) + os.sep
    return out, collections.Counter(
        f"{w.filename.replace(root, '')}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message))


def flagship_train(T, sky, dev):
    """Phase 32: the flagship fwd+bwd, make_train_step(cfg, adam(LR)) on
    the room at 1920x1080 @16 spp d8 against a zero target (bench.py's
    fwdbwd), untextured (kernel B's save_hits forward, the stored-hit
    replay backward) and textured (save_hits hits-only, the replay under
    autograd, each bounce rematerialised; texels among the leaves). Per
    variant: a warm-up step (its host-device synchronisations counted),
    then 2 timed steps, each ended by a synchronise; the save_hits
    instance FLAGSHIP_CHUNKS times a step and no other kernel; the peak
    memory (reset before the variant). The last step's loss must equal
    the MSE of a no-grad render_frame at its key bit for bit, and the
    gradient the optimiser received (an adam(LR) wrapped to record it)
    must agree within FD_RTOL with a central difference of the loss in
    the emissive material's emission (quadratic in it: exact up to the
    two losses' rounding). Returns {variant: numbers} and the save_hits
    launches of the steps."""
    from tinypathtracer_tpu_torch.diff import invrender as inv

    cfg = T.RenderConfig(**FLAGSHIP)
    n_rays = cfg.n_pixels * cfg.spp
    if chunks_of(cfg) != FLAGSHIP_CHUNKS:
        raise AssertionError(f"the flagship frame has {chunks_of(cfg)} "
                             f"chunks, want {FLAGSHIP_CHUNKS}")
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    out, total = {}, 0
    for variant, textured in (("untextured", False), ("textured", True)):
        scene = T.sphere_grid_scene(*ROOM, env_radiance=sky, device=dev,
                                    textured=textured)
        params = inv.Params.from_scene(scene)
        adam = inv.adam(LR)
        seen = []

        def recorded(p, g, s):
            seen[:] = [g]
            return adam.step(p, g, s)

        step = inv.make_train_step(cfg, inv.Optimizer(adam.init, recorded),
                                   device="cuda")
        state = adam.init(params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(3):                  # a warm-up step, then 2 timed
            key = T.prng_key(i + 1, dev)
            zero_launches()
            t0 = time.perf_counter()
            if i == 0:
                (new, new_state, loss), sites = count_syncs(
                    lambda: step(params, state, scene, target, key))
                syncs = sum(sites.values())
            else:
                new, new_state, loss = step(params, state, scene, target,
                                            key)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_launches()
            others = {k: v for k, v in launches.items()
                      if k != "mega_save_hits" and v}
            if launches["mega_save_hits"] != FLAGSHIP_CHUNKS or others:
                raise AssertionError(f"flagship {variant} step {i}: want "
                                     f"{FLAGSHIP_CHUNKS} save_hits launches "
                                     f"and nothing else, got {launches}")
            total += launches["mega_save_hits"]
            if not (math.isfinite(float(loss)) and all(
                    torch.isfinite(x).all() for x in new.leaves())):
                raise AssertionError(f"flagship {variant} step {i}: loss "
                                     f"{float(loss)} or the parameters are "
                                     f"not finite")
            log(f"flagship {variant} step {i} "
                f"({'warm-up' if i == 0 else 'timed'}): {dt * 1e3:.1f} ms, "
                f"loss {float(loss):.8f}, Adam step {new_state.step}")
            if i:
                times.append(dt)
        peak = torch.cuda.max_memory_allocated() / 2**30
        best, spread = min(times), max(times) - min(times)
        log(f"flagship {variant} train step, {cfg.width}x{cfg.height} "
            f"@{cfg.spp}spp d{cfg.max_depth}, {n_rays} camera paths, "
            f"{FLAGSHIP_CHUNKS} chunks: best of 2 {best * 1e3:.1f} ms "
            f"(spread {spread * 1e3:.1f} ms), {n_rays / best:,.0f} fwd+bwd "
            f"camera rays/s; peak memory {peak:.2f} GiB; "
            f"{FLAGSHIP_CHUNKS} save_hits launches a step; {syncs} "
            f"host-device synchronisations in the warm-up step, by line: "
            f"{dict(sites.most_common())}")

        with torch.no_grad():
            img = T.render_frame(scene, cfg, key) / cfg.spp
            want = torch.mean(torch.square(img - target))
        if not torch.equal(loss, want):
            raise AssertionError(f"flagship {variant}: the step's loss "
                                 f"{float(loss)!r} != the no-grad frame's "
                                 f"MSE {float(want)!r}")
        del img
        i_em = int(torch.argmax(scene.mtl_emission))
        if not float(scene.mtl_emission[i_em]) > 1.0:
            raise AssertionError("the room's emissive material is dim")

        def loss_at(delta):
            x = params.mtl_emission.clone()
            x[i_em] += delta
            with torch.no_grad():
                return float(inv.mse_loss(
                    dataclasses.replace(params, mtl_emission=x), scene, cfg,
                    target, key))

        fd = (loss_at(1.0) - loss_at(-1.0)) / 2.0
        g = float(seen[0].mtl_emission[i_em])
        rel = abs(fd - g) / abs(g)
        log(f"flagship {variant}: loss equal bit for bit to the no-grad "
            f"frame's MSE ({float(want):.8f}); d loss / d emission[{i_em}]: "
            f"step {g:.8e}, central difference {fd:.8e}, relative "
            f"difference {rel:.3e}")
        if not rel <= FD_RTOL:
            raise AssertionError(f"flagship {variant}: the gradient is not "
                                 f"within {FD_RTOL} of the central "
                                 f"difference")
        out[variant] = {"best_ms": best * 1e3, "spread_ms": spread * 1e3,
                        "rays_per_s": n_rays / best, "peak_gib": peak,
                        "syncs": syncs, "fd_rel": rel}
        del scene, params, new, state, new_state, seen, step
    return out, total


def keys_phase(T, sky, dev):
    """Phase 34: csrc/keys.cu bit-equal to the int64 chain on the card,
    the launch counters over a frame of each route, and the kernels'
    times beside their bound and the chain's. Returns the kernels JSON
    rows of lane_keys and lane_draws."""
    from tinypathtracer_tpu_torch.ops import dense, mega, sampling
    from tinypathtracer_tpu_torch.render.renderer import _CAM_TAG
    from tinypathtracer_tpu_torch.tools.common import HBM_BYTES_PER_S

    frame_key = sampling.fold_in(T.prng_key(3000000007, dev), 5)
    ids = torch.tensor([0, 1, 2, 3, 127, 128, 65535, 1 << 20, 2**31 - 3,
                        2**31 - 2, 2**31 - 1], device=dev)
    chunk_pix = torch.arange(KEY_CHUNK_PIXELS, device=dev) \
        + 16 * KEY_CHUNK_PIXELS
    cases = (("Cornell chunk", chunk_pix, 16, 0),
             ("ragged, ids to 2**31 - 1", (2**31 - 1) - torch.arange(
                 1037, device=dev), 3, 12345),
             ("samples wrapping at 2**32", ids, 16, 2**32 - 5))
    draws = ((0, 8, 6, 8), (_CAM_TAG, 1, 6, 6), (_CAM_TAG, 1, 9, 9),
             (3, 1, 9, 9), (2**32 - 3, 8, 6, 8))
    for what, pix, spp, offset in cases:
        keys, u_cam = sampling.lane_keys(frame_key, pix, spp, offset,
                                         _CAM_TAG)
        want = sampling._lane_keys_torch(frame_key, pix, spp, offset,
                                         _CAM_TAG)
        if not (torch.equal(keys, want[0]) and torch.equal(u_cam, want[1])):
            raise AssertionError(f"lane_keys differs from the int64 chain: "
                                 f"{what}")
        for args in draws:
            if not torch.equal(sampling.lane_draws(keys, *args),
                               sampling._lane_draws_torch(keys, *args)):
                raise AssertionError(f"lane_draws{args} differs from the "
                                     f"int64 chain: {what}")
        log(f"key chain, {what}: {keys.shape[0]} lanes, lane keys, camera "
            f"draws and draws {[a[:3] for a in draws]} bit-equal to the "
            "int64 chain")

    cfg = T.RenderConfig(width=512, height=512, spp=16, max_depth=8)
    room = T.sphere_grid_scene(*ROOM, env_radiance=sky)
    n_chunks = chunks_of(cfg)
    for route, megakernel in (("megakernel", True), ("modular", False)):
        zero_launches()
        sampling.lane_keys.launches = sampling.lane_draws.launches = 0
        T.Renderer(dataclasses.replace(cfg, megakernel=megakernel),
                   device="cuda").render(room, T.prng_key(0))
        torch.cuda.synchronize()
        counts = {"lane_keys": sampling.lane_keys.launches,
                  "lane_draws": sampling.lane_draws.launches,
                  "mega": mega.mega_trace.launches,
                  "dense": dense.dense_hit.launches}
        log(f"key chain launches, {route} frame of {n_chunks} chunks: "
            f"{counts}")
        draws_ok = (counts["lane_draws"] == n_chunks if megakernel else
                    n_chunks <= counts["lane_draws"]
                    <= n_chunks * cfg.max_depth)
        if not (counts["lane_keys"] == n_chunks and draws_ok
                and counts["mega" if megakernel else "dense"] > 0):
            raise AssertionError(f"the {route} frame did not draw its keys "
                                 f"through csrc/keys.cu: {counts}")

    n = KEY_CHUNK_PIXELS * 16
    keys = sampling.lane_keys(frame_key, chunk_pix, 16, 0, _CAM_TAG)[0]
    rows = []
    for name, kernel, twin, hashes, nbytes in (
            ("lane_keys",
             lambda: sampling.lane_keys(frame_key, chunk_pix, 16, 0,
                                        _CAM_TAG),
             lambda: sampling._lane_keys_torch(frame_key, chunk_pix, 16, 0,
                                               _CAM_TAG),
             5, KEY_CHUNK_PIXELS * 8 + n * (16 + 8)),
            ("lane_draws",
             lambda: sampling.lane_draws(keys, 0, 8, 6, 8),
             lambda: sampling._lane_draws_torch(keys, 0, 8, 6, 8),
             56, n * (16 + 64 * 4))):
        ms, _ = cuda_ms(kernel, 20)
        plain_ms, _ = cuda_ms(twin, 3)
        t_ops = n * hashes * ALU_OPS_THREEFRY / ALU_PEAK
        t_bytes = nbytes / HBM_BYTES_PER_S
        b_ms = max(t_ops, t_bytes) * 1e3
        b_by = "ALU pipe" if t_ops >= t_bytes else "bytes"
        log(f"{name}, 2**20-lane chunk: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {hashes} hashes a lane x {ALU_OPS_THREEFRY} ALU "
            f"operations, {nbytes / n:.1f} B a lane), {ms / b_ms:.2f}x its "
            f"bound; the int64 chain {plain_ms:.1f} ms")
        rows.append({"name": name, "route": "cuda",
                     "source": "tinypathtracer_tpu_torch/csrc/keys.cu",
                     "replaces": None, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "max_abs_err": 0.0})
    return rows


def same_values(a, b) -> bool:
    """a and b equal value for value, NaN where the other is NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def shade_outputs(out) -> dict:
    """shade_hits' `Shaded` or close_bounce's next carry, by name."""
    if isinstance(out, tuple):
        return dict(zip(("o", "d", "thr", "rad", "alive"), out))
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


def differing(got, want) -> dict:
    """The outputs of got that differ from want's: lanes that differ (the
    first axis of [N] and [N, 3], the second of [L, N, 3])."""
    bad = {}
    for name, w in shade_outputs(want).items():
        g = shade_outputs(got)[name]
        if g.shape != w.shape or not same_values(g, w):
            off = (g != w) & ~(g.isnan() & w.isnan()) \
                if g.is_floating_point() else g != w
            if off.dim() == 3:
                off = off.any(0)
            bad[name] = int(off.reshape(off.shape[0], -1).any(1).sum()) \
                if g.shape == w.shape else f"shape {tuple(g.shape)}"
    return bad


def replayed(fn, args):
    """fn(*args)'s outputs, fn captured in a CUDA graph on args (after a
    warm-up on a side stream) and the graph replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    return out


def graph_ms(fn, args, launches=10, reps=5):
    """Device ms of one fn(*args): a CUDA graph of `launches` calls
    replayed between CUDA events, the median of reps replays over
    launches (the host's enqueueing, longer than these kernels, stays
    out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn(*args)
    ms, _ = cuda_ms(graph.replay, reps)
    return ms / launches


def shaded_chunk(state, cfg, pix, key):
    """(radiance sums [P, 3], the calls of each bounce) of pixel ids pix
    through the kernels op by op: the loop of `integrator.shaded_bounce`
    driven here, a bounce's calls [shade_hits' arguments, its Shaded,
    close_bounce's arguments, its next carry]. The caller holds the sums
    to the route's."""
    from tinypathtracer_tpu_torch.ops import sampling, shade
    from tinypathtracer_tpu_torch.ops.lights import lights_block
    from tinypathtracer_tpu_torch.render import integrator
    from tinypathtracer_tpu_torch.render.renderer import hit_fn, lane_rays

    o, d, keys = lane_rays(state.scene, cfg, pix, key)
    hit, data = hit_fn(state, cfg), state.data
    lights = lights_block(data)
    carry = integrator._start_rows(o, d)
    calls = []
    for depth in range(cfg.max_depth):
        if not bool(carry[-1].any()):
            break
        o, d, thr, rad, alive = carry
        fid, t, uv = hit(o, d, mask=alive)
        h_args = (o, d, thr, rad, alive, fid, t, uv,
                  sampling.lane_draws(keys, depth, 1, 6), data, cfg, lights)
        sh = shade.shade_hits(*h_args)
        fid2 = hit(sh.h, sh.d2, mask=sh.extra)[0]
        occ = [hit(sh.h, wi, mask=sh.live)[0] for wi in sh.wi]
        c_args = (o, d, thr, sh, fid, fid2, occ, data, lights)
        carry = shade.close_bounce(*c_args)
        calls.append([h_args, sh, c_args, carry])
    torch.cuda.synchronize()
    return carry[3].reshape(pix.shape[0], cfg.spp, 3).sum(dim=1), calls


def shade_bound(args, sh, n_lights):
    """(shade_hits' bound, close_bounce's bound) in ms on the bounce whose
    shade_hits arguments and output are args and sh: their bytes over
    3.35 TB/s, close_bounce's by the lanes that go on."""
    from tinypathtracer_tpu_torch.tools.common import HBM_BYTES_PER_S

    n, live = args[0].shape[0], int(sh.live.sum())
    hits = n * (SHADE_HITS_BYTES[0] + SHADE_HITS_BYTES[1] * n_lights)
    close = (live * (CLOSE_BOUNCE_BYTES[0] + CLOSE_BOUNCE_BYTES[1] * n_lights)
             + (n - live) * CLOSE_BOUNCE_BYTES[2])
    return hits / HBM_BYTES_PER_S * 1e3, close / HBM_BYTES_PER_S * 1e3, live


def shade_phase(T, sky, dev):
    """Phase 35: csrc/shade.cu's kernels against their plain twins (the
    integrator's torch code, ops/shade `_shade_hits_torch` and
    `_close_bounce_torch`) at the main path's shapes, the counters over a
    tetra-frame frame, and the kernels' times beside their bound. Returns
    the kernels JSON rows of shade_hits and close_bounce."""
    import json as json_
    from pathlib import Path

    from portbench import scenes as bench_scenes
    from tinypathtracer_tpu_torch.ops import sampling, shade
    from tinypathtracer_tpu_torch.render.integrator import BounceGraphs
    from tinypathtracer_tpu_torch.render.renderer import (prepare_state,
                                                          render_pixel_ids)
    from tinypathtracer_tpu_torch.tools.lab_mega import with_lights

    config = json_.loads((Path(__file__).parent / "portbench" / "configs"
                          / "spd-tetra.json").read_text())
    tetra_cfg = T.RenderConfig(**bench_scenes.render_args(config))
    tetra = T.FlatScene.from_numpy(bench_scenes.build(config), "cpu")
    lit = with_lights(T.sphere_grid_scene(*LARGE, env_radiance=sky))
    lit_cfg = T.RenderConfig(width=512, height=512, spp=16, max_depth=8,
                             env_scale=0.8)
    key = T.prng_key(4000000007, dev)
    rows = {}
    for name, scene, cfg in (("tetra", tetra, tetra_cfg),
                             ("lit large scene", lit, lit_cfg)):
        px = cfg.rays_per_dispatch // cfg.spp        # one full chunk
        first = (cfg.height // 2) * cfg.width - px // 2
        pix = torch.arange(first, first + px, device=dev)
        with torch.inference_mode():
            state = prepare_state(scene.to(dev), cfg)
            n_lights = state.data.n_lights
            if not (state.route.intersector == "packet"
                    and state.route.shade_kernels):
                raise AssertionError(f"{name}: not on kernel C with the "
                                     f"shade kernels: {state.route}")
            got, calls = shaded_chunk(state, cfg, pix, key)
            routed = render_pixel_ids(state, cfg, pix, key)
            want = render_pixel_ids(dataclasses.replace(
                state, route=dataclasses.replace(state.route,
                                                 shade_kernels=False)),
                cfg, pix, key)
            bound = prepare_state(scene.to(dev), cfg,
                                  graphs=BounceGraphs(dev))
            for _ in range(3):           # warm-up, capture, replays only
                graphed = render_pixel_ids(bound, cfg, pix, key)
            torch.cuda.synchronize()
            if not (same_values(got, want) and same_values(routed, want)
                    and same_values(graphed, want)):
                raise AssertionError(
                    f"{name}: the chunk's radiance through the kernels "
                    f"differs from the torch loop's: the bounces driven "
                    f"here {compare_images(got, want)}, the route op by op "
                    f"{compare_images(routed, want)}, as graphs "
                    f"{compare_images(graphed, want)}")
            bad = {}
            for depth, (h_args, sh, c_args, nxt) in enumerate(calls):
                twin_sh = shade._shade_hits_torch(*h_args)
                twin_nxt = shade._close_bounce_torch(*c_args)
                for what, out, twin in (
                        ("shade_hits", sh, twin_sh),
                        ("close_bounce", nxt, twin_nxt),
                        ("shade_hits, graph",
                         replayed(shade.shade_hits, h_args), twin_sh),
                        ("close_bounce, graph",
                         replayed(shade.close_bounce, c_args), twin_nxt)):
                    diff = differing(out, twin)
                    if diff:
                        bad[f"bounce {depth}, {what}"] = diff
            if bad:
                raise AssertionError(f"{name}: the shade kernels differ from "
                                     f"their twins (lanes by output): {bad}")
            live = [int(c[1].live.sum()) for c in calls]
            log(f"shade kernels, {name} ({n_lights} lights, {pix.shape[0]} "
                f"pixels x {cfg.spp} spp = {pix.shape[0] * cfg.spp} lanes "
                f"from pixel {first}): every output of both kernels on each "
                f"of the chunk's {len(calls)} bounces (live lanes {live}), "
                f"launched op by op and replayed from a CUDA graph, equal to "
                f"the twins' on the same inputs; the chunk's radiance through "
                f"the kernels, op by op and as BounceGraphs, equal to the "
                f"torch loop's")
            # each kernel's time and bound on every bounce; its twin's at 0
            times = {"shade_hits": [], "close_bounce": []}
            bounds = {"shade_hits": [], "close_bounce": []}
            for h_args, sh, c_args, _ in calls:
                b_hits, b_close, _ = shade_bound(h_args, sh, n_lights)
                for kernel, args, b_ms in (("shade_hits", h_args, b_hits),
                                           ("close_bounce", c_args, b_close)):
                    times[kernel].append(graph_ms(getattr(shade, kernel),
                                                  args))
                    bounds[kernel].append(b_ms)
            h_args, _, c_args, _ = calls[0]
            for kernel, twin, args in (
                    ("shade_hits", shade._shade_hits_torch, h_args),
                    ("close_bounce", shade._close_bounce_torch, c_args)):
                plain_ms, _ = cuda_ms(lambda: twin(*args), 3)
                ms, b_ms = times[kernel][0], bounds[kernel][0]
                mean_ms = sum(times[kernel]) / len(calls)
                mean_b = sum(bounds[kernel]) / len(calls)
                log(f"{kernel}, {name}, a {h_args[0].shape[0]}-lane chunk: "
                    f"bounce 0 {ms:.4f} ms, bound {b_ms:.4f} ms (bytes), "
                    f"{ms / b_ms:.2f}x; the chunk's {len(calls)} bounces "
                    f"{[round(t, 4) for t in times[kernel]]} ms, mean "
                    f"{mean_ms:.4f} against a mean bound {mean_b:.4f} "
                    f"({mean_ms / mean_b:.2f}x); the twin {plain_ms:.2f} ms "
                    f"at bounce 0")
                rows.setdefault(kernel, {})[name] = (ms, plain_ms, b_ms,
                                                     mean_ms, mean_b)
            del calls, got, routed, want, graphed, bound, state
        torch.cuda.empty_cache()

    r = T.Renderer(tetra_cfg, device="cuda")
    tetra = tetra.to(dev)
    for k in (5, 6):       # the full chunks' warm-up and capture, the last's
        r.render(tetra, T.prng_key(k))
    torch.cuda.synchronize()
    zero_launches()
    sampling.lane_draws.launches = 0
    t0 = time.perf_counter()
    img = r.render(tetra, T.prng_key(7))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    draws = sampling.lane_draws.launches
    n_rays = tetra_cfg.n_pixels * tetra_cfg.spp
    log(f"tetra-frame frame (Renderer.render, graphs replayed): "
        f"{dt * 1e3:.1f} ms, {n_rays / dt:,.0f} rays/s; launches {launches}, "
        f"lane_draws {draws}")
    check_image(img, tetra_cfg, "the tetra frame")
    check_packet_route(launches, "the tetra frame")
    check_shaded(launches, "the tetra frame")
    if not (launches["shade_hits"] == draws
            and launches["packet"] == 2 * draws):
        raise AssertionError(f"the tetra frame must launch each shade kernel "
                             f"once, kernel C twice, a bounce's draw: "
                             f"{launches}, lane_draws {draws}")
    out = []
    for kernel in ("shade_hits", "close_bounce"):
        (ms, plain_ms, b_ms, mean_ms, mean_b), lit_ = (
            rows[kernel]["tetra"], rows[kernel]["lit large scene"])
        out.append({"name": kernel, "route": "cuda",
                    "source": "tinypathtracer_tpu_torch/csrc/shade.cu",
                    "replaces": None, "launches": launches[kernel],
                    "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": "bytes",
                    "library_ms": None, "mean_bounce_ms": mean_ms,
                    "mean_bounce_bound_ms": mean_b, "lit_ms": lit_[0],
                    "lit_plain_ms": lit_[1], "lit_bound_ms": lit_[2],
                    "lit_mean_bounce_ms": lit_[3],
                    "lit_mean_bounce_bound_ms": lit_[4]})
    return out


def entry_phase(T):
    """Phase 33: the entry points of tinypathtracer_tpu_torch.entry on
    the card. entry() called once: its frame equal bit for bit to
    render_frame's at the JAX entry's config on the same inputs, finite
    and lit. dryrun_multichip(2): two gloo ranks on this card, mesh
    (1, 2), a sharded Adam step whose loss must be within 1e-6 of the
    one-device make_train_step's at the dry run's config (the ranks'
    equality is checked inside), with save_hits launches only. Returns
    the launches of both, by kernel."""
    from tinypathtracer_tpu_torch.diff import Params, adam, make_train_step
    from tinypathtracer_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry()
    zero_launches()
    t0 = time.perf_counter()
    img = fn(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    cfg = T.RenderConfig(**ENTRY_CFG)
    want = T.render_frame(*args[:1], cfg, args[1])
    check_image(img / cfg.spp, cfg, "entry()'s frame")
    if not torch.equal(img, want):
        raise AssertionError("entry()'s frame differs from render_frame's")
    if not (launches["mega"] and launches["dense"] == 0):
        raise AssertionError(f"entry() must run the megakernel: {launches}")
    log(f"entry(): {cfg.width}x{cfg.height} @{cfg.spp}spp d{cfg.max_depth}, "
        f"{dt * 1e3:.1f} ms (first call), equal bit for bit to render_frame; "
        f"launches {launches}")

    t0 = time.perf_counter()
    dry = dryrun_multichip(2)
    dt = time.perf_counter() - t0
    check_rank_launches(dry["launches"], "mega_save_hits",
                        "dryrun_multichip(2)")
    scene, key = args[0], T.prng_key(7, "cuda")
    dcfg = T.RenderConfig(**DRYRUN_CFG)
    params = Params.from_scene(scene)
    opt = adam(1e-2)
    _, _, loss = make_train_step(dcfg, opt)(
        params, opt.init(params), scene,
        torch.zeros(dcfg.height, dcfg.width, 3, device="cuda"), key)
    rel = abs(dry["loss"] - float(loss)) / float(loss)
    log(f"dryrun_multichip(2) on this card: mesh {dry['mesh']}, loss "
        f"{dry['loss']:.8f} (one device {float(loss):.8f}, relative "
        f"difference {rel:.3e}), {dt:.1f} s with the ranks' start; "
        f"launches {dry['launches']}")
    if not rel <= 1e-6:
        raise AssertionError(f"dryrun_multichip(2)'s loss {dry['loss']} is "
                             f"not the one-device step's {float(loss)}")
    for k, v in dry["launches"].items():
        launches[k] += v
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import tinypathtracer_tpu_torch as T
    from tinypathtracer_tpu_torch.models.envlight import gradient_sky
    from tinypathtracer_tpu_torch.ops import dense, mega, packet
    from tinypathtracer_tpu_torch.render.integrator import TraceData

    dev = torch.device("cuda")
    clock = [time.perf_counter()]

    def phase_done(what):
        now = time.perf_counter()
        log(f"[{what}: {now - clock[0]:.1f} s]")
        clock[0] = now

    # ---- 1. card, versions, kernel build --------------------------------
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    from tinypathtracer_tpu_torch.tools import (common, lab4, lab5_diag,
                                                lab_dense, lab_mega)
    from tinypathtracer_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    from tinypathtracer_tpu_torch.ops import sampling, shade

    cuda_build.build_libraries(["dense", "mega", "packet", "lab4",
                                "lab5_diag", "keys", "shade"])
    for mod in (dense, mega, packet, lab4, lab5_diag, sampling, shade):
        mod._lib()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

    phase_done("phase 1")

    # ---- 2. kernel A vs its plain twin ------------------------------------
    sky = gradient_sky(64, 128)
    err_a = dense_vs_twin(T, sky, dev)
    room = T.sphere_grid_scene(*ROOM, env_radiance=sky, device=dev)
    woop = dense.precompute_woop(TraceData.from_scene(room).tri_verts)

    phase_done("phase 2")

    # ---- 3. kernel B vs its plain twin ------------------------------------
    small = T.RenderConfig(width=64, height=64, spp=4, max_depth=8)
    err_b = err_h = 0.0
    big_dev = T.sphere_grid_scene(*BIG_ROOM, env_radiance=sky, device=dev)
    for name, scene in (("room", room),
                        ("room+3 lights", lab_mega.with_lights(room)),
                        ("big room", big_dev),
                        ("big room+3 lights", lab_mega.with_lights(big_dev))):
        full, state = mega_frame_operands(scene, small, T.prng_key(1, dev))
        ragged = (full[0][:, :RAGGED].contiguous(),
                  full[1][:, :RAGGED].contiguous()) + full[2:]
        for ops in (full, ragged):
            e_b, e_h = mega_vs_twin(ops, state.data.n_lights,
                                    f"{name}, {ops[0].shape[1]}")
            err_b, err_h = max(err_b, e_b), max(err_h, e_h)
    del big_dev

    phase_done("phase 3")

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
    a_launch_ms = log_kernel_share(
        "modular room frame", profile_step("modular room frame", r.render,
                                           host_room, key),
        "A", "dense_hit_kernel")
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
    a_before = dense.dense_hit.launches
    r = T.Renderer(dataclasses.replace(cfg, megakernel=False), device="cuda")
    t0 = time.perf_counter()
    big_mod = r.render(big, key)
    torch.cuda.synchronize()
    t_big_mod = time.perf_counter() - t0
    mx, share, mean = compare_images(big_img, big_mod)
    log(f"main path, modular, 7,692-face room on the gated kernel A: "
        f"{t_big_mod * 1e3:.1f} ms, {n_rays / t_big_mod:,.0f} rays/s, "
        f"{dense.dense_hit.launches - a_before} launches; against the "
        f"megakernel frame: max abs diff {mx:.3e}, share of pixels > 1e-5 "
        f"{share:.2e}, mean abs diff {mean:.3e}")
    if not (dense.dense_hit.launches > a_before and share <= 0.005
            and mean < 1e-5):
        raise AssertionError("big-room megakernel and modular frames "
                             "disagree")
    launches = {"dense": dense.dense_hit.launches,
                "mega": mega.mega_trace.launches}
    log(f"launches in the main path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    room_frame = images["megakernel"]
    room_frame_host = room_frame.cpu()          # for phase 30
    del images, img, big_img, big_mod, r

    phase_done("phase 4")

    # ---- 5. both kernels against their twins at the main path's shapes ----
    # one 2**20-lane chunk: its camera rays into kernel A, its rays8 / u8d
    # into kernel B (room and big room); outputs compared, then timed
    chunk = cfg.rays_per_dispatch // cfg.spp
    ops, _ = mega_frame_operands(room, cfg, key.to(dev), n_pix=chunk)
    rays = torch.cat([ops[0][0:3].T, ops[0][4:7].T,
                      torch.zeros((ops[0].shape[1], 2), device=dev)],
                     dim=1).contiguous()
    a_ms, got = cuda_ms(lambda: dense.dense_hit(rays, woop), 5)
    a_plain, want = cuda_ms(lambda: dense._dense_torch(rays, woop.planes), 1,
                            warm=False)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel A != twin on {rays.shape[0]} camera "
                             "rays")
    err_a = max(err_a, float((got[2] - want[2]).abs().max()))
    log(f"kernel A vs twin, {rays.shape[0]} camera rays x {woop.n_padded} "
        f"slots: exact; {a_ms:.2f} ms (plain twin {a_plain:.1f} ms)")
    b_ms, room_out = cuda_ms(
        lambda: mega.mega_trace(*ops, depth=8, n_lights=0), 5)
    b_plain, room_want = cuda_ms(
        lambda: mega._mega_torch(*ops, depth=8, n_lights=0), 1, warm=False)
    err_b = max(err_b, check_mega(room_out, room_want,
                                  f"room, {chunk * cfg.spp}"))
    log(f"kernel B, {room_out.shape[1]} paths d8: {b_ms:.2f} ms "
        f"(plain twin {b_plain:.1f} ms)")
    big_ops, big_state = mega_frame_operands(
        big.to(dev), cfg, key.to(dev), n_pix=chunk)
    got = mega.mega_trace(*big_ops, depth=8, n_lights=0)
    want = mega._mega_torch(*big_ops, depth=8, n_lights=0)
    torch.cuda.synchronize()
    err_b = max(err_b, check_mega(
        got, want, f"big room ({big_state.woop.n_padded} slots), "
        f"{got.shape[1]}"))
    del big_ops, big_state, got, want

    phase_done("phase 5")

    # ---- 6. kernel B's save_hits instance vs its twin ----------------------
    for n_lights in range(mega.MAX_LIGHTS + 1):
        for save_hits in (False, True):
            regs, spill = mega.kernel_resources(n_lights, save_hits)
            log(f"kernel B instance lights={n_lights} save_hits={save_hits}: "
                f"{regs} registers, {spill} B local memory per thread")
    h_ms, (h_out, h_hits) = cuda_ms(lambda: mega.mega_trace(
        *ops, depth=8, n_lights=0, save_hits=True), 5)
    h_plain, (_, want_hits) = cuda_ms(lambda: mega._mega_torch(
        *ops, depth=8, n_lights=0, save_hits=True), 1, warm=False)
    err_h = max(err_h, check_hits(h_out, h_hits, room_out, room_want,
                                  want_hits, f"room, {h_hits.shape[1]}"))
    log(f"kernel B save_hits, {h_hits.shape[1]} paths d8: {h_ms:.2f} ms "
        f"(forward instance {b_ms:.2f} ms, plain twin {h_plain:.1f} ms)")
    lengths = mega.path_lengths(h_hits, ops[3], 8)
    for save in (False, True):
        _, rounds = check_rounds(ops, 0, save, lengths,
                                 f"room, {h_hits.shape[1]}")
    log_lanes(lengths, rounds, 0, f"room, {h_hits.shape[1]} paths")
    ops_b, bytes_b = lab_mega.mega_work(ops[0], h_hits, ops[3], 8, 0,
                                        save_hits=False)
    ops_h, bytes_h = lab_mega.mega_work(ops[0], h_hits, ops[3], 8, 0,
                                        save_hits=True)
    ops_a, bytes_a = lab_dense.dense_pairs(rays, woop)
    bounds = {"dense": common.bound(ops_a, bytes_a),
              "mega": common.bound(ops_b, bytes_b),
              "mega_save_hits": common.bound(ops_h, bytes_h)}
    log(f"work per 2**20-lane chunk: kernel A {ops_a / 1e9:.2f} GFLOP, "
        f"{bytes_a / 1e6:.1f} MB; kernel B {ops_b / 1e9:.2f} GFLOP, "
        f"{bytes_b / 1e6:.1f} MB (save_hits {bytes_h / 1e6:.1f} MB); "
        f"bounds {bounds}")
    del ops, rays, h_out, h_hits, want_hits, room_out, room_want
    # kernel B by scene, lights and instance: times, bounds, lane
    # efficiency, registers, the counted rounds against the model, and the
    # no-refill grid
    run_main("lab_mega main", lab_mega.main, [])

    phase_done("phase 6")

    # ---- 7. the train step at full width -----------------------------------
    train_launches, step_reference = train_phase(T, cfg, host_room)

    phase_done("phase 7")

    # ---- 8. megakernel vs modular gradients on the card --------------------
    for name, scene in (("room", room),
                        ("room+3 lights", lab_mega.with_lights(room))):
        compare_grads(T, scene, small, name)

    phase_done("phase 8")

    # ---- 9-12. the packet traversal and the large scene ---------------
    large = T.sphere_grid_scene(*LARGE, env_radiance=sky)
    pk = packet.precompute_packet(
        TraceData.from_scene(large.to(dev)).tri_verts)
    err_c = packet_vs_twin(pk, dev)
    c_res, c_plain, err = packet_vs_dense(T, cfg, large, key.to(dev), dev)
    err_c = max(err_c, err)
    c_ms, (ops_c, bytes_c) = c_res["camera"]
    fb_ms, fb_work = c_res["first-bounce"]
    bounds["packet"] = common.bound(ops_c, bytes_c)
    bounds["packet_first_bounce"] = common.bound(*fb_work)
    log(f"work of the packet traversal on the camera chunk: "
        f"{ops_c / 1e9:.2f} GFLOP, {bytes_c / 1e6:.1f} MB; bound "
        f"{bounds['packet']}; kernel C {c_ms:.2f} ms camera, {fb_ms:.2f} ms "
        f"first bounce (bound {bounds['packet_first_bounce'][0]:.3f} ms)")
    del pk
    packet_launches, large_frame, large_ms, large_peak = large_scene_paths(
        T, cfg, large, key, dev)

    phase_done("phases 9-12")

    # ---- 13-15. the kernel lab -------------------------------------------
    from tinypathtracer_tpu_torch.tools import (kernel_lab, lab5, lab6,
                                                profile_stages)

    lab = lab4_phase(dev)
    lab4_launches = run_main("lab4 main", lab4.main, [])
    phase_done("phase 13")
    lab["diag"] = diag_phase(T, dev)
    diag_launches = run_main("lab5_diag main", lab5_diag.main, [])
    if not (lab4_launches["mxu"] and lab4_launches["vpu_rol"]
            and diag_launches["diag"]):
        raise AssertionError(f"a lab kernel never ran in its lab's main: "
                             f"{lab4_launches}, {diag_launches}")
    zero_launches()
    t0 = time.perf_counter()
    dense_lab = lab_dense.main([])
    log(f"lab_dense main: {time.perf_counter() - t0:.1f} s; launches "
        f"{read_launches()}")
    if not read_launches()["dense"]:
        raise AssertionError("lab_dense's main never launched kernel A")
    run_main("kernel_lab main", kernel_lab.main, [])
    run_main("lab5 main", lab5.main, ["--scenes", "room,g2,g4", "--impls",
                                      "packet,dense,bvh",
                                      "--n", str(LAB_RAYS)])
    run_main("lab6 main", lab6.main, [])
    run_main("profile_stages main", profile_stages.main, [])

    phase_done("phases 14-15")

    # ---- 16. the oracle routes ---------------------------------------------
    oracle_phase(T, host_room, dev)

    phase_done("phase 16")

    # ---- 17-22. the scene-file entry point and the physical estimator ------
    pcfg = dataclasses.replace(cfg, mode="physical")
    with tempfile.TemporaryDirectory() as tmp:
        scenes = gltf_phase(T, sky, dev, key, room_frame, tmp)
    del room_frame
    phase_done("phase 17")
    physical, frames = physical_frames(T, scenes, sky, key, pcfg)
    phase_done("phase 18")
    err_a_nee, err_c_nee, nee_bounds = nee_vs_twins(T, scenes, sky, key,
                                                    pcfg, dev)
    err_a, err_c = max(err_a, err_a_nee), max(err_c, err_c_nee)
    phase_done("phase 19")
    physical_large_on_a(T, scenes["large scene"], sky, key, pcfg,
                        frames["large scene"], dev)
    del frames
    phase_done("phase 20")
    physical_oracle(T, scenes["room"], sky, dev)
    phase_done("phase 21")
    step_ms, step_peak, step_launches = physical_train(T, scenes["room"], sky,
                                                       pcfg, dev)
    phase_done("phase 22")

    # ---- 23-28. textures, progressive rendering, AOVs, the CLI -----------
    room_t = T.sphere_grid_scene(*ROOM, env_radiance=sky, textured=True)
    large_t = T.sphere_grid_scene(*LARGE, env_radiance=sky, textured=True)
    textured = {}                 # the launches of phases 23-27's main paths
    tex_frames, tex_frame, launched, (e_b, e_h) = textured_room_frames(
        T, room_t, cfg, key, dev)
    err_b, err_h = max(err_b, e_b), max(err_h, e_h)
    add_launches(textured, launched)
    phase_done("phase 23")
    tex_step = textured_train(T, room_t, cfg, small, dev)
    add_launches(textured, tex_step[2])
    phase_done("phase 24")
    with tempfile.TemporaryDirectory() as tmp:
        tex_other, tex_path, launched = textured_other_scenes(
            T, sky, key, cfg, room_t, large_t, tmp, dev)
        add_launches(textured, launched)
        phase_done("phase 25")
        big_steps, big_ms, big_peak, launched = progressive_phase(
            T, room_t, cfg, key, tex_frame, tmp)
        add_launches(textured, launched)
        del tex_frame
        phase_done("phase 26")
        aov_ms, launched = aov_phase(T, (room_t, large_t), cfg, key, dev)
        add_launches(textured, launched)
        phase_done("phase 27")
        cli_stats = cli_phase(T, tex_path, sky, cfg, tmp)
        phase_done("phase 28")

        # ---- 29-31. rematerialised steps, torch.distributed -------------
        remat_phase({"large scene": (large_ms, large_peak),
                     "physical room": (step_ms, step_peak),
                     "textured room": tex_step[:2]})
        phase_done("phase 29")
        sharded, pair = shard_frames_phase(T, cfg, key, host_room,
                                           room_frame_host, large_frame, tmp)
        phase_done("phase 30")
        sharded["mega_save_hits"] = shard_train_phase(
            pair, step_reference, tex_path, cfg, tmp)
        phase_done("phase 31")

    # ---- 32-33. the flagship fwd+bwd, the entry points -------------------
    flagship, flagship_launches = flagship_train(T, sky, dev)
    phase_done("phase 32")
    entry_launches = entry_phase(T)
    phase_done("phase 33")
    key_rows = keys_phase(T, sky, dev)
    phase_done("phase 34")
    shade_rows = shade_phase(T, sky, dev)
    phase_done("phase 35")
    log(f"launches of the main paths of phases 23-27: {textured}")
    for kernel in ("dense", "packet", "mega_save_hits"):
        if not textured.get(kernel):
            raise AssertionError(f"phases 23-27 never launched {kernel}: "
                                 f"{textured}")

    kernels = [
        {"name": "dense_closest_hit", "route": "cuda",
         "source": "tinypathtracer_tpu_torch/csrc/dense.cu",
         "replaces": "tinypathtracer_tpu/ops/dense.py:197",
         "launches": launches["dense"] + textured.get("dense", 0),
         "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": bounds["dense"][0],
         "bound_by": bounds["dense"][1], "library_ms": None,
         "modular_frame_ms_per_launch": a_launch_ms,
         "physical_room_launches": physical["room"][2],
         "physical_room_ms_per_launch": physical["room"][3],
         "physical_3_lights_launches": physical["room+3 lights"][2],
         "physical_step_launches": step_launches,
         "textured_launches": textured.get("dense", 0),
         **{f"physical_{k.replace(' ', '_')}_queries.{f}": v
            for k, row in nee_bounds["A"].items()
            for f, v in zip(("queries", "ms", "bound_ms", "bound_by"), row)},
         **{f"{cell}.{k}": dense_lab[cell][k] for cell in lab_dense.CELLS
            for k in ("ms", "tested_bound_ms", "tested_share")}},
        {"name": "mega_trace", "route": "cuda",
         "source": "tinypathtracer_tpu_torch/csrc/mega.cu",
         "replaces": "tinypathtracer_tpu/ops/mega.py:224",
         "launches": launches["mega"] + textured.get("mega", 0)
         + sharded["mega"] + entry_launches["mega"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": bounds["mega"][0],
         "bound_by": bounds["mega"][1], "library_ms": None,
         "sharded_launches": sharded["mega"],
         "entry_launches": entry_launches["mega"]},
        {"name": "mega_trace_save_hits", "route": "cuda",
         "source": "tinypathtracer_tpu_torch/csrc/mega.cu",
         "replaces": "tinypathtracer_tpu/ops/mega.py:224",
         "launches": train_launches["mega_save_hits"]
         + textured.get("mega_save_hits", 0) + sharded["mega_save_hits"]
         + flagship_launches + entry_launches["mega_save_hits"],
         "max_abs_err": err_h, "sharded_launches": sharded["mega_save_hits"],
         "flagship_launches": flagship_launches,
         "entry_launches": entry_launches["mega_save_hits"],
         "ms": h_ms, "plain_ms": h_plain,
         "bound_ms": bounds["mega_save_hits"][0],
         "bound_by": bounds["mega_save_hits"][1], "library_ms": None,
         "textured_launches": textured.get("mega_save_hits", 0)},
        {"name": "packet_closest_hit", "route": "cuda",
         "source": "tinypathtracer_tpu_torch/csrc/packet.cu",
         "replaces": "tinypathtracer_tpu/ops/packet.py:158",
         "launches": packet_launches["packet"] + textured.get("packet", 0)
         + sharded["packet"], "max_abs_err": err_c,
         "sharded_launches": sharded["packet"],
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": bounds["packet"][0],
         "bound_by": bounds["packet"][1], "library_ms": None,
         "first_bounce_ms": fb_ms,
         "first_bounce_bound_ms": bounds["packet_first_bounce"][0],
         "physical_large_launches": physical["large scene"][2],
         "physical_large_ms_per_launch": physical["large scene"][3],
         "textured_launches": textured.get("packet", 0),
         **{f"physical_{k.replace(' ', '_')}_queries.{f}": v
            for k, row in nee_bounds["C"].items()
            for f, v in zip(("queries", "ms", "bound_ms", "bound_by"), row)}},
    ]
    kernels += key_rows + shade_rows
    diag_ms, diag_visits = lab["diag"][4:]
    extra = {"mxu": {"design": "wgmma TF32 from TMA-staged planes, "
                               "3xTF32 folded into K = 16",
                     "default_ms": lab["mxu"][4]},
             "vpu_rol": lab["vpu_rol"][4],
             "diag": {"design": "one warp a packet, lanes over slots, "
                                "TMA-staged chunks",
                      "visits_mean": diag_visits,
                      **{f"{v}_ms": ms for v, ms in diag_ms.items()}}}
    for name, src, line, launched in (
            ("mxu", "lab4.cu", "tools/lab4.py:60", lab4_launches["mxu"]),
            ("vpu_rol", "lab4.cu", "tools/lab4.py:140",
             lab4_launches["vpu_rol"]),
            ("diag", "lab5_diag.cu", "tools/lab5_diag.py:58",
             diag_launches["diag"])):
        ms, plain, err, (b_ms, b_by) = lab[name][:4]
        kernels.append({
            "name": {"mxu": "mxu_closest_hit",
                     "vpu_rol": "vpu_rol_closest_hit",
                     "diag": "lab5_diag_walk"}[name],
            "route": "cuda", "source": f"tinypathtracer_tpu_torch/csrc/{src}",
            "replaces": f"tinypathtracer_tpu/{line}", "launches": launched,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, **extra[name]})
    log(f"physical frames (best, spread, launches of 3 frames, ms a launch): "
        f"{physical}; physical room step {step_ms:.1f} ms, "
        f"{step_peak:.2f} GiB")
    log(f"textured: room frames {tex_frames}; step {tex_step[0]:.1f} ms, "
        f"{tex_step[1]:.2f} GiB; other scenes {tex_other}; 1920x1080 @64spp "
        f"steps {big_steps} ms, total {big_ms:.1f} ms, {big_peak:.2f} GiB; "
        f"AOVs {aov_ms}; CLI stats {cli_stats}")
    log(f"flagship fwd+bwd 1920x1080 @16spp d8: {flagship}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
