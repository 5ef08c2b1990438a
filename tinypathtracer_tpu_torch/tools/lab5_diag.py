"""Kernel lab 5 diagnosis: stripped variants of the v1 packet kernel,
to attribute its fixed cost per packet (kernel F). Port of
`tinypathtracer_tpu/tools/lab5_diag.py`.

A packet is 8 consecutive rays; a 256-ray block holds 32. Each variant
computes, per ray, the output the JAX tool defines for it:

  empty      ox + dx
  epilogue   the cross-lane argmin epilogue alone, over a [8, 128]
             scratch of REAL_MAX: REAL_MAX + 0 (the JAX kernel reads
             scratch nothing wrote, undefined there; the port fills it)
  boxtest    the slab test of the C chunk boxes and the packed keys: the
             ray's smallest key, as a float
  boxvec     the slab test alone, no validity check: the ray's smallest
             entry over the boxes it hits, or REAL_MAX
  select1    one packet-wide select: the packet's smallest live key
  walkfix    the hit tests of 8 fixed chunks (p + i) % 16, p the packet's
             index in its block, no select: the ray's best t there
  walksel    the select chain alone, each select dropping the chunk it
             picked: 2**31 - 1 for every ray (timed only)
  walk       the real walk: the ray's closest t

Keys are the JAX kernel's int32 keys: the bits of max(entry, DELTA),
low 10 bits replaced by the chunk id (so at most 1024 chunks), or
2**31 - 1 where the box is missed or invalid. A key is live while it is
<= the bits of its ray's best t with the low 10 bits set. A packet
visits the chunk of its smallest live key for all 8 rays and drops that
chunk for all 8.

The tables are the JAX layout from the port's own
`precompute_packet(tv, tc=128, margin=0.0)` (the JAX package's boxes):
planes [16 * C, 128] (rows 0-11 of chunk c are the 12 plane
coefficients of its 128 slots), boxes [8, Cp] (bmin xyz, bmax xyz,
validity, 0; Cp = C padded to a multiple of 128 with zero boxes).
DELTA = 1e-4 and REAL_MAX = 3.4e38 are the tool's own constants.

The CUDA kernel (`csrc/lab5_diag.cu`, kernel F) replaces the TPU kernel
`make_kernel`; `_diag_torch` is its plain twin (the hit test's fused
multiply-adds are where XLA:CPU fuses the JAX kernel, measured), and
the two are exactly equal on every variant. The kernel runs one warp a
packet, lanes over slots; `warp_schedule` is the plain model of that
schedule, and `counted` launches `walk` with the chunks each packet
visited, which must equal `walk`'s.

With --variants (on the card only) it times instead the designs kernel
F did not keep, each a build of csrc/lab5_diag.cu with the edits
BUILDS lists ("thread_per_ray": the v1 design, one thread per ray and
4 packets a warp; "global_chunks": each lane loading its slots' plane
rows from global memory instead of a TMA-staged chunk), in
turns with the kernel (the kernel, each variant, then the same in
reverse order), every variant's outputs equal to the kernel's.

Usage: python -m tinypathtracer_tpu_torch.tools.lab5_diag
       [--device cuda|cpu] [--n 262144] [--grid 2 --n-lat 16 --n-lon 32]
       [--reps 8] [--variants]
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from tinypathtracer_tpu_torch.ops.dense import hit_terms, origin_terms
from tinypathtracer_tpu_torch.ops.packet import precompute_packet
from tinypathtracer_tpu_torch.tools import common
from tinypathtracer_tpu_torch.utils import cuda_build

DELTA = float(np.float32(1e-4))
REAL_MAX = float(np.float32(3.4e38))
_I32_MAX = 2**31 - 1
TN = 256
PACKET = 8
CHUNK = 128
ROWS = 16
MAX_CHUNKS = 1024            # chunk ids fill the keys' low 10 bits
VARIANTS = ("empty", "epilogue", "boxtest", "boxvec", "select1", "walkfix",
            "walksel", "walk")
# packets per tile of the plain twin's hit tests: bounds its memory
_TILE_PACKETS = 2048

# The v1 design: one thread per ray, a warp holding 4 packets that
# walk on their own, each ray reading every slot's 12 coefficients itself
# and scanning its own Cp keys ([Cp][thread] in shared memory) a select
_V1 = """// The v1 design: one thread per ray, 4 packets a warp.
__device__ __forceinline__ int v1_packet_min(int v, unsigned mask) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(mask, v, off));
  return v;
}

struct V1Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ void v1_slab(const V1Ray& r, float ivx, float ivy,
                                        float ivz,
                                        const float* __restrict__ b, int cp,
                                        int c, float& near, float& far) {
  const float tx0 = (__ldg(b + c) - r.ox) * ivx;
  const float ty0 = (__ldg(b + cp + c) - r.oy) * ivy;
  const float tz0 = (__ldg(b + 2 * cp + c) - r.oz) * ivz;
  const float tx1 = (__ldg(b + 3 * cp + c) - r.ox) * ivx;
  const float ty1 = (__ldg(b + 4 * cp + c) - r.oy) * ivy;
  const float tz1 = (__ldg(b + 5 * cp + c) - r.oz) * ivz;
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

__device__ __forceinline__ float v1_visit(const V1Ray& r,
                                          const float* __restrict__ planes,
                                          int ck, float best) {
  const float* p = planes + (size_t)ck * kRows * kChunk;
  for (int s = 0; s < kChunk; ++s) {
    float w[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = __ldg(p + k * kChunk + s);
    const float opx = tpt::affine(r.ox, r.oy, r.oz, w[0], w[1], w[2]) + w[3];
    const float opy = tpt::affine(r.ox, r.oy, r.oz, w[4], w[5], w[6]) + w[7];
    const float opz =
        tpt::affine(r.ox, r.oy, r.oz, w[8], w[9], w[10]) + w[11];
    const float dpx = tpt::affine(r.dx, r.dy, r.dz, w[0], w[1], w[2]);
    const float dpy = tpt::affine(r.dx, r.dy, r.dz, w[4], w[5], w[6]);
    const float dpz = tpt::affine(r.dx, r.dy, r.dz, w[8], w[9], w[10]);
    const float t = -opz / dpz;
    const float u = fmaf(t, dpx, opx), v = fmaf(t, dpy, opy);
    if ((fminf(u, v) >= 0.f) & (u + v <= 1.f) & (t > kDeltaL) &
        (t < best))
      best = t;
  }
  return best;
}

__device__ __forceinline__ int v1_select_key(const int* keys, int stride,
                                             int cp, float best,
                                             unsigned mask) {
  const int ibt = __float_as_int(best) | 1023;
  int m = kI32Max;
  for (int c = 0; c < cp; ++c) {
    const int k = keys[c * stride];
    m = min(m, k <= ibt ? k : kI32Max);
  }
  return v1_packet_min(m, mask);
}

template <int V>
__global__ void v1_kernel(const float* __restrict__ rays,
                          const float* __restrict__ planes,
                          const float* __restrict__ boxes, int cp,
                          float* __restrict__ out) {
  extern __shared__ int s_key[];  // [cp][blockDim.x]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* rp = rays + 8 * (size_t)i;
  const V1Ray r{rp[0], rp[1], rp[2], rp[3], rp[4], rp[5]};
  const unsigned mask = 0xFFu << (threadIdx.x & 24);
  if (V == kEmpty) {
    out[i] = r.ox + r.dx;
    return;
  }
  if (V == kEpilogue) {
    __shared__ float lane_t[kChunk];
    for (int k = threadIdx.x; k < kChunk; k += blockDim.x)
      lane_t[k] = kRealMaxL;
    __syncthreads();
    float m = lane_t[0];
    for (int k = 1; k < kChunk; ++k) m = fminf(m, lane_t[k]);
    int cand = kI32Max;
    for (int k = 0; k < kChunk; ++k)
      if (lane_t[k] == m) cand = min(cand, k);
    out[i] = m + (float)cand;
    return;
  }
  const float ivx = inv(r.dx), ivy = inv(r.dy), ivz = inv(r.dz);
  if (V == kBoxvec) {
    float m = kRealMaxL;
    for (int c = 0; c < cp; ++c) {
      float near, far;
      v1_slab(r, ivx, ivy, ivz, boxes, cp, c, near, far);
      if (far >= fmaxf(near, kDeltaL)) m = fminf(m, near);
    }
    out[i] = m;
    return;
  }
  if (V == kWalkfix) {
    const int p = (i % kTN) / kPacket;
    float best = kRealMaxL;
    for (int k = 0; k < 8; ++k) best = v1_visit(r, planes, (p + k) % 16, best);
    out[i] = best;
    return;
  }
  int* keys = s_key + threadIdx.x;
  const int stride = blockDim.x;
  int kmin = kI32Max;
  for (int c = 0; c < cp; ++c) {
    float near, far;
    v1_slab(r, ivx, ivy, ivz, boxes, cp, c, near, far);
    const float e = fmaxf(near, kDeltaL);
    const bool hit = (far >= e) & (__ldg(boxes + 6 * cp + c) != 0.f);
    const int k = hit ? (((__float_as_int(e) | 1023) ^ 1023) | c) : kI32Max;
    keys[c * stride] = k;
    kmin = min(kmin, k);
  }
  if (V == kBoxtest) {
    out[i] = (float)kmin;
    return;
  }
  float best = kRealMaxL;
  int m = v1_select_key(keys, stride, cp, best, mask);
  if (V == kSelect1) {
    out[i] = (float)m;
    return;
  }
  while (m < kI32Max) {
    const int ck = m & 1023;
    if (V == kWalk) best = v1_visit(r, planes, ck, best);
    keys[ck * stride] = kI32Max;
    m = v1_select_key(keys, stride, cp, best, mask);
  }
  out[i] = V == kWalk ? best : (float)m;
}

template <int V>
cudaError_t v1_launch(const float* rays, const float* planes,
                      const float* boxes, int n, int cp, float* out,
                      cudaStream_t stream) {
  const bool keyed = V != kEmpty && V != kEpilogue && V != kBoxvec &&
                     V != kWalkfix;
  const int threads = !keyed ? 128 : (cp <= 256 ? 64 : 32);
  const int smem = keyed ? cp * threads * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        v1_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  v1_kernel<V><<<n / threads, threads, smem, stream>>>(rays, planes, boxes,
                                                       cp, out);
  return cudaGetLastError();
}

"""
_V1_ANCHOR = "// warps a block: 8, fewer"
_LAUNCH_HEAD = ("  const bool staged = kTmaChunks && (V == kWalk || "
                "V == kWalkfix);\n")
# The designs kernel F did not keep, built by --variants: edits (text,
# replacement) of csrc/lab5_diag.cu, each text found exactly once.
BUILDS = {
    "thread_per_ray": [
        (_V1_ANCHOR, _V1 + _V1_ANCHOR),
        (_LAUNCH_HEAD, "  if (visits == nullptr)\n"
                       "    return v1_launch<V>(rays, planes, boxes, n, cp, "
                       "out, stream);\n" + _LAUNCH_HEAD)],
    "global_chunks": [("constexpr bool kTmaChunks = true;",
                       "constexpr bool kTmaChunks = false;")],
    "min_blocks3": [("__global__ void __launch_bounds__(256)\n",
                     "__global__ void __launch_bounds__(256, 3)\n")],
}


def diag_tables(tri_verts):
    """(planes [16 * C, 128], boxes [8, Cp]) of lab5_diag's layout for
    [F, 3, 3] triangles, C chunks of 128 slots."""
    pk = precompute_packet(tri_verts, tc=CHUNK, margin=0.0)
    c = pk.n_chunks
    planes = pk.woop.planes.view(c, CHUNK, 12).permute(0, 2, 1)
    planes = torch.cat([planes, planes.new_zeros((c, ROWS - 12, CHUNK))], 1)
    cp = -(-c // CHUNK) * CHUNK
    boxes = torch.nn.functional.pad(pk.boxes.T, (0, cp - c))
    return planes.reshape(c * ROWS, CHUNK).contiguous(), boxes.contiguous()


def _check(variant, rays, planes, boxes):
    n, cp = rays.shape[0], boxes.shape[1]
    c = planes.shape[0] // ROWS
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if (rays.shape[-1] != 8 or n % TN or planes.shape[1] != CHUNK
            or planes.shape[0] != c * ROWS or boxes.shape[0] != 8
            or cp % CHUNK or c > cp):
        raise ValueError(f"bad shapes rays {tuple(rays.shape)} (a multiple "
                         f"of {TN} rays), planes {tuple(planes.shape)}, "
                         f"boxes {tuple(boxes.shape)}")
    if cp > MAX_CHUNKS:
        raise ValueError(f"{cp} chunk boxes: the keys hold {MAX_CHUNKS}")
    if variant == "walkfix" and c < 16:
        raise ValueError(f"walkfix reads chunks 0-15; the scene has {c}")


def _keys(r, boxes):
    """(entry [P, 8, Cp], hit [P, 8, Cp], keys [P, 8, Cp] i32) of packed
    rays r [P, 8, 8]; hit has no validity check, keys do."""
    o, d = r[..., 0:3, None], r[..., 3:6, None]
    zero = d == 0.0
    iv = torch.where(zero, REAL_MAX, 1.0 / torch.where(zero, 1.0, d))
    t0 = (boxes[0:3] - o) * iv                       # [P, 8, 3, Cp]
    t1 = (boxes[3:6] - o) * iv
    near = torch.minimum(t0, t1).amax(dim=2)
    far = torch.maximum(t0, t1).amin(dim=2)
    hit = far >= near.clamp_min(DELTA)
    col = torch.arange(boxes.shape[1], dtype=torch.int32, device=r.device)
    key = ((near.clamp_min(DELTA).view(torch.int32) | 1023) ^ 1023) | col
    key = torch.where(hit & (boxes[6] != 0.0), key, _I32_MAX)
    return near, hit, key


def _best_t(r, planes, chunks, best):
    """best [P', 8] lowered by the hits of chunks [P', K] for the packed
    rays r [P', 8, 8], tile by tile."""
    w = planes.view(-1, ROWS, CHUNK)
    for p0 in range(0, r.shape[0], _TILE_PACKETS):
        ps = slice(p0, p0 + _TILE_PACKETS)
        pp = w[chunks[ps]][:, None]                  # [P'', 1, K, 16, 128]
        cols = [pp[:, :, :, k] for k in range(12)]
        o = [r[ps, :, k, None, None] for k in range(6)]  # [P'', 8, 1, 1]
        t, u, v = hit_terms(origin_terms(*o[:3], cols), *o[3:], cols)
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
              & (t < REAL_MAX))
        tmin = torch.where(ok, t, REAL_MAX).flatten(2).amin(dim=2)
        best[ps] = torch.minimum(best[ps], tmin)
    return best


def _select(key, best):
    """The packet's smallest live key [P] (2**31 - 1: none)."""
    ibt = best.view(torch.int32) | 1023
    live = torch.where(key <= ibt[..., None], key, _I32_MAX)
    return live.flatten(1).amin(dim=1)


def walk(r, planes, key):
    """The packet walk of packed rays r [P, 8, 8] from their keys:
    (best t [P, 8], visits [P], the chunks each packet tested)."""
    p = r.shape[0]
    best = torch.full((p, PACKET), REAL_MAX, device=r.device)
    visits = torch.zeros((p,), dtype=torch.int32, device=r.device)
    key = key.clone()
    m = _select(key, best)
    while True:
        act = (m < _I32_MAX).nonzero()[:, 0]
        if act.numel() == 0:
            return best, visits
        ck = (m[act] & 1023).long()
        best[act] = _best_t(r[act], planes, ck[:, None], best[act])
        key[act, :, ck] = _I32_MAX
        visits[act] += 1
        m[act] = _select(key[act], best[act])


def _diag_torch(variant, rays, planes, boxes):
    """Plain twin of kernel F: out [N, 1] f32 (module docstring)."""
    _check(variant, rays, planes, boxes)
    n = rays.shape[0]
    r = rays.view(n // PACKET, PACKET, 8)
    if variant == "empty":
        out = r[..., 0] + r[..., 3]
    elif variant == "epilogue":
        lane_t = torch.full((PACKET, CHUNK), REAL_MAX, device=rays.device)
        mrow = lane_t.amin(dim=1)
        lane = torch.arange(CHUNK, dtype=torch.int32, device=rays.device)
        cand = torch.where(lane_t == mrow[:, None], lane, _I32_MAX).amin(1)
        out = (mrow + cand.float()).expand(r.shape[0], PACKET)
    elif variant == "walkfix":
        p = torch.arange(r.shape[0], device=rays.device) % (TN // PACKET)
        chunks = (p[:, None] + torch.arange(8, device=rays.device)) % 16
        out = _best_t(r, planes, chunks,
                      torch.full(r.shape[:2], REAL_MAX, device=rays.device))
    else:
        near, hit, key = _keys(r, boxes)
        if variant == "boxvec":
            out = torch.where(hit, near, REAL_MAX).amin(dim=2)
        elif variant == "boxtest":
            out = key.amin(dim=2).float()
        elif variant == "select1":
            best = torch.full(r.shape[:2], REAL_MAX, device=rays.device)
            out = _select(key, best).float()[:, None].expand(-1, PACKET)
        elif variant == "walksel":
            # every select drops the chunk it picked, and with no hit test
            # the best t stays REAL_MAX: the chain ends at "no live key"
            out = torch.full(r.shape[:2], float(_I32_MAX), device=rays.device)
        else:
            out = walk(r, planes, key)[0]
    return out.reshape(n, 1).contiguous()


def warp_schedule(rays, planes, boxes):
    """Plain model of kernel F's walk schedule, one warp a packet: lane l
    holds the keys of chunks l + 32 j and tests slots l + 32 j of each
    visited chunk for all 8 rays, keeping a best t per ray that a
    min-reduction over the 32 lanes merges after the visit; the select
    is each lane's smallest live key, reduced over the lanes. Returns
    (best t [P, 8], visits [P], one [P] bool: the packet's 8 origins are
    equal, so that o' is computed once a slot)."""
    _check("walk", rays, planes, boxes)
    n, cp = rays.shape[0], boxes.shape[1]
    r = rays.view(n // PACKET, PACKET, 8)
    p = r.shape[0]
    key = _keys(r, boxes)[2].view(p, PACKET, cp // 32, 32).clone()
    w = planes.view(-1, ROWS, 4, 32)                 # slot l + 32 j: [j, l]
    o, d = r[..., 0:3], r[..., 3:6]
    one = (r[:, :, 0:3] == r[:, :1, 0:3]).all(dim=2).all(dim=1)
    best = torch.full((p, PACKET), REAL_MAX, device=rays.device)
    visits = torch.zeros((p,), dtype=torch.int32, device=rays.device)
    lanes = torch.arange(32, device=rays.device)

    def select(k, b):
        ibt = b.view(torch.int32) | 1023
        live = torch.where(k <= ibt[:, :, None, None], k, _I32_MAX)
        return live.amin(dim=(1, 2)).amin(dim=1)    # lanes, then the warp

    act = torch.arange(p, device=rays.device)
    m = select(key, best)
    while True:
        keep = m < _I32_MAX
        act, m = act[keep], m[keep]
        if act.numel() == 0:
            return best, visits, one
        ck = (m & 1023).long()
        pp = w[ck][:, None]                          # [A, 1, 16, 4, 32]
        cols = [pp[:, :, k] for k in range(12)]
        oa = [o[act, :, k, None, None] for k in range(3)]
        da = [d[act, :, k, None, None] for k in range(3)]
        t, u, v = hit_terms(origin_terms(*oa, cols), *da, cols)
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
              & (t < best[act][:, :, None, None]))
        lane_best = torch.where(ok, t, best[act][:, :, None, None]).amin(2)
        best[act] = lane_best.amin(dim=2)            # [A, 8, 32] -> [A, 8]
        # the lane that owns chunk ck drops its 8 keys
        owner = (ck % 32)[:, None] == lanes
        drop = owner[:, None, None, :] & (
            torch.arange(cp // 32, device=rays.device)[:, None]
            == (ck // 32)[:, None, None, None])
        key[act] = torch.where(drop, _I32_MAX, key[act])
        visits[act] += 1
        m = select(key[act], best[act])


@functools.cache
def _lib():
    return _bind(cuda_build.load_library("lab5_diag"))


def _bind(lib):
    lib.tpt_lab5_diag.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.tpt_lab5_diag.restype = ctypes.c_int
    return lib


def _diag_cuda(variant, rays, planes, boxes, visits=None, lib=None):
    """One launch of kernel F (or of the build `lib`): out [N, 1]; with
    visits [N / 8] i32, `walk` writes the chunks each packet visited."""
    cuda_build.check_operands(rays, planes, boxes)
    n = rays.shape[0]
    out = torch.empty((n, 1), dtype=torch.float32, device=rays.device)
    if n:
        status = (lib or _lib()).tpt_lab5_diag(
            VARIANTS.index(variant), rays.data_ptr(), planes.data_ptr(),
            boxes.data_ptr(), n, boxes.shape[1], out.data_ptr(),
            None if visits is None else visits.data_ptr(),
            cuda_build.stream_ptr(rays.device))
        cuda_build.check_launch(status, "lab5_diag")
    return out


def diag_run(variant, rays, planes, boxes):
    """One variant of the stripped packet kernel over rays [N, 8] (o, d,
    1, 0; N a multiple of 256): kernel F on CUDA tensors, its plain twin
    on CPU tensors. Returns out [N, 1] f32."""
    _check(variant, rays, planes, boxes)
    if rays.device.type == "cpu":
        return _diag_torch(variant, rays, planes, boxes)
    if rays.device.type != "cuda":
        raise ValueError(f"diag_run has no kernel for {rays.device}")
    out = _diag_cuda(variant, rays, planes, boxes)
    if rays.shape[0]:
        diag_run.launches += 1
    return out


diag_run.launches = 0


def counted(rays, planes, boxes):
    """(out [N, 1], visits [N / 8] i32) of `walk`: a counting launch of
    kernel F on the card (not counted as a launch of the main path),
    the plain model `warp_schedule` on the CPU."""
    _check("walk", rays, planes, boxes)
    if rays.device.type == "cpu":
        best, visits, _ = warp_schedule(rays, planes, boxes)
        return best.reshape(-1, 1), visits
    visits = torch.zeros((rays.shape[0] // PACKET,), dtype=torch.int32,
                         device=rays.device)
    return _diag_cuda("walk", rays, planes, boxes, visits), visits


def run_variant(variant, rays, planes, boxes, reps=8):
    """Time of one call of the variant in seconds (device time on the
    card, median of reps after a warm-up)."""
    return common.timed_ms(lambda: diag_run(variant, rays, planes, boxes),
                           rays.device, reps) / 1e3


def main(argv=None):
    from tinypathtracer_tpu_torch.models.envlight import gradient_sky
    from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
    from tinypathtracer_tpu_torch.tools.lab5 import make_rays

    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--grid", type=int, default=2)
    ap.add_argument("--n-lat", type=int, default=16)
    ap.add_argument("--n-lon", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--variants", action="store_true",
                    help="time the builds BUILDS lists (card only)")
    args, dev = common.parse(ap, argv, "lab5_diag")
    if args.variants and dev.type != "cuda":
        raise ValueError("--variants builds kernel F's designs: card only")
    scene = sphere_grid_scene(args.grid, args.n_lat, args.n_lon,
                              env_radiance=gradient_sky(16, 32), device=dev)
    o, d, tv = make_rays(scene, args.n, "pixel8")
    n = o.shape[0]
    rays = torch.cat([o, d, torch.ones((n, 1), device=dev),
                      torch.zeros((n, 1), device=dev)], dim=1).contiguous()
    planes, boxes = diag_tables(tv)
    res = {"device": common.device_name(dev), "faces": tv.shape[0],
           "chunks": planes.shape[0] // ROWS, "rays": n}
    n_packets = n // PACKET
    if args.variants:
        res.update(time_builds(rays, planes, boxes, args.reps))
        print(json.dumps(res, indent=1), flush=True)
        return res
    for v in VARIANTS:
        t = run_variant(v, rays, planes, boxes, args.reps)
        res[v + "_ms"] = t * 1e3
        res[v + "_ns_per_packet"] = t / n_packets * 1e9
        print(json.dumps({v: res[v + "_ms"],
                          "ns/packet": res[v + "_ns_per_packet"]}),
              flush=True)
    _, visits = counted(rays, planes, boxes)
    res["visits_mean"] = float(visits.float().mean())
    res["visits_max"] = int(visits.max())
    print(json.dumps(res, indent=1), flush=True)
    return res


def time_builds(rays, planes, boxes, reps):
    """--variants: every BUILDS design (and the kernel's own source,
    rebuilt with -Xptxas -v) against the kernel on each variant, outputs
    equal, then timed in turns: the kernel, each build, then the same in
    reverse order. Returns {"<build>.<variant>_ms": [ms, ms]} and each
    build's ptxas lines."""
    libs = cuda_build.build_variants("lab5_diag", {"kernel": [], **BUILDS},
                                     _bind, flags=("-Xptxas", "-v"))
    res = {f"{name}.ptxas": cuda_build.variant_resources("lab5_diag", name)
           for name in libs}
    builds = {"kernel": _lib(),
              **{k: v for k, v in libs.items() if k != "kernel"}}
    for v in VARIANTS:
        want = _diag_cuda(v, rays, planes, boxes)
        for name, lib in builds.items():
            got = _diag_cuda(v, rays, planes, boxes, lib=lib)
            if not torch.equal(got, want):
                raise AssertionError(f"build {name}, variant {v}: "
                                     f"{int((got != want).sum())} rays differ")
        for name in list(builds) + list(builds)[::-1]:
            res.setdefault(f"{name}.{v}_ms", []).append(common.timed_ms(
                functools.partial(_diag_cuda, v, rays, planes, boxes,
                                  lib=builds[name]), rays.device, reps))
        print(json.dumps({k: x for k, x in res.items()
                          if k.endswith(f".{v}_ms")}), flush=True)
    return res


if __name__ == "__main__":
    main()
