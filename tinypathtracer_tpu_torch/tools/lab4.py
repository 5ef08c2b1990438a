"""Kernel lab 4: the closest hit with the Woop transform on the tensor
cores (kernel D) and on the CUDA cores from staged triangles (kernel E),
beside the production dense kernel (kernel A). Port of
`tinypathtracer_tpu/tools/lab4.py`.

The TPU question was whether moving the transform's multiply-adds to the
matrix unit frees the vector unit for the epilogue. Here kernel D runs
them as wgmma TF32 products from TMA-staged shared memory
(csrc/lab4.cu) and kernel E on the CUDA cores from a TMA-staged ring of
tiles: a divide-free cull on o'z and d'z, and the exact test only on the
survivors, compacted into full warps (csrc/lab4.cu). `tc` is the lab's
sweep parameter: triangles per staged tile.

Precision of kernel D, per instance (not the TPU's: its DEFAULT is one
bf16 pass): "highest" splits each operand into two TF32 parts, a = big +
small, and sums big·small + small·big in one K = 8 step, then big·big in
a second (3xTF32, the card's nearest to fp32); "default" is the big·big
step alone, one TF32 pass. Operands are rounded to TF32 as
`cvt.rna.tf32.f32` rounds (to nearest, ties away from zero). The twin
`_mxu_torch` emulates each instance with those roundings, exact products
and fp32 sums: the 8 products of a step in the order k = 0..3 of
big_a·small_b, then k = 0..3 of small_a·big_b, the step's sum then added
to the accumulator. The tensor cores' own order of accumulation inside a
step is not specified, and kernel D's t = -o'z / d'z is the fast divide
(within 2 ulp; the twin's is IEEE), so kernel D is held to its twin and
to kernel A by tolerance and by the share of agreeing face ids. Kernel
E's arithmetic is kernel A's (the fused multiply-adds where XLA:CPU
fuses the JAX kernel, measured) and its cull rejects only pairs the
exact test cannot take: E equals its twin `_vpu_rol_torch` and kernel A
exactly. `vpu_rol_schedule` is the plain model of its cull and queue
(the survivors and batches of each warp); `counted` is the counting
launch, whose counts equal the model's.

With --variants (on the card only) it times instead the designs kernels
D and E did not keep, each a build of csrc/lab4.cu with the edits
VARIANTS and E_VARIANTS list (D: "mma_sync", the v1 design,
mma.sync.m16n8k4 from registers, with or without the fast divide;
"ieee_divide"; the others change the block's warpgroups, ray groups or
accumulator sets; "no_epilogue", timing only, runs the products without
the epilogue. E: "e_thread_per_ray", the v1 design; "e_rays4_ring", the
ring with every pair through the exact test; "e_cull_branch", the cull
with each survivor tested in its own lane; "e_delta_cull", the cull also
on t <= DELTA; the others change the block's warps, the rays a thread,
the ring's slots, the survivors a batch or the registers), in turns with
the kernel, D's at both precisions, at
every tc of the sweep, each build held to the kernel's twin.
`hgmma_count` compiles the source to a cubin and counts the HGMMA
instructions of its SASS (cuobjdump); `vpu_rol_sass` counts the SASS of
kernel E's fast-path and survivor loops.

Usage: python -m tinypathtracer_tpu_torch.tools.lab4 [--device cuda|cpu]
       [--n 1048576] [--f 1948] [--reps 10] [--variants]
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import re
import subprocess

import numpy as np
import torch

from tinypathtracer_tpu_torch.ops import dense
from tinypathtracer_tpu_torch.ops.dense import precompute_woop, scan_queries
from tinypathtracer_tpu_torch.tools import common
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX, fma

PRECISIONS = {"highest": 1, "default": 0}
_I32_MAX = 2**31 - 1
# (ray, triangle) pairs per tile of the plain twins: bounds their memory
_TILE_PAIRS = 1 << 21
# tc of the sweep (main, --variants)
SWEEP_TC = (256, 512, 1024)
# kernel E's block (csrc/lab4.cu kEThreads, kERays): warp w of a block the
# E_WARP_RAYS consecutive rays from E_WARP_RAYS w, lane l rays l + 32 q;
# a batch of the exact test is E_BATCH survivors
E_THREADS = 256
E_RAYS = 4
E_WARP_RAYS = 32 * E_RAYS
E_BATCH = 64
# the cull's margin on a ray's best (kBestUp)
BEST_UP = 1 + 2**-20

# The v1 design of kernel D: per 16 x 8 tile six mma.sync.m16n8k4
# products (x, y, z of o' and d'), 18 at "highest" (small·big, big·small,
# big·big), A fragments split from a tile staged by a plain load loop
# What the replaced designs stage with: a block of kThreads threads copies
# a tile by plain loads between two __syncthreads
_STAGE = """constexpr int kThreads = 128;  // 4 warps

// Stage planes rows [base, base + tc) of each of the ncomp row groups of
// `fp` rows (row width 4 floats) into smem [ncomp][tc][4].
__device__ __forceinline__ void stage(const float* __restrict__ planes,
                                      int fp, int base, int tc, int ncomp,
                                      float* smem) {
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(planes);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int k = threadIdx.x; k < ncomp * tc; k += blockDim.x) {
    const int c = k / tc, r = k - c * tc;
    dst[k] = __ldg(src + (size_t)c * fp + base + r);
  }
  __syncthreads();
}

"""
_V1 = _STAGE + """// The v1 design: mma.sync.m16n8k4 TF32, 32 rays a warp.
__device__ __forceinline__ void v1_split(float x, bool highest, uint32_t& big,
                                         uint32_t& small) {
  big = tf32(x);
  small = highest ? tf32(x - __uint_as_float(big)) : 0u;
}

__device__ __forceinline__ void v1_mma(float acc[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__global__ void __launch_bounds__(kThreads)
    v1_mxu_hit_kernel(const float* __restrict__ rays8,
                      const float* __restrict__ planes4, int n, int fp,
                      int tc, int highest, float* __restrict__ t_out,
                      int* __restrict__ fid_out) {
  extern __shared__ float4 smem4[];
  float* sp = reinterpret_cast<float*>(smem4);  // [3][tc][4]
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp_ray0 = blockIdx.x * kThreads + (threadIdx.x >> 5) * 32;
  uint32_t bo[4][2], bd[4][2];
  float best_t[4][2];
  int best_i[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = warp_ray0 + 8 * j + g;
    const float o = r < n ? rays8[(size_t)q * n + r] : 0.f;
    const float d = r < n ? rays8[(size_t)(4 + q) * n + r] : 0.f;
    v1_split(o, highest, bo[j][0], bo[j][1]);
    v1_split(d, highest, bd[j][0], bd[j][1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      best_t[j][c] = tpt::kRealMax;
      best_i[j][c] = 0;
    }
  }
  for (int base = 0; base < fp; base += tc) {
    stage(planes4, fp, base, tc, 3, sp);
    for (int g0 = 0; g0 < tc; g0 += 16) {
      uint32_t a[3][2][2];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v1_split(sp[(c * tc + g0 + g + 8 * h) * 4 + q], highest,
                   a[c][h][0], a[c][h][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc[6][4];
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          const int c = m % 3;
          const uint32_t* b = m < 3 ? bo[j] : bd[j];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
          if (highest) {
            v1_mma(acc[m], a[c][0][1], a[c][1][1], b[0]);
            v1_mma(acc[m], a[c][0][0], a[c][1][0], b[1]);
          }
          v1_mma(acc[m], a[c][0][0], a[c][1][0], b[0]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = -acc[2][e] / acc[5][e];
          const float u = fmaf(t, acc[3][e], acc[0][e]);
          const float v = fmaf(t, acc[4][e], acc[1][e]);
          const bool ok = (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                          (t > tpt::kDelta);
          const int col = e & 1;
          if (ok && t < best_t[j][col]) {
            best_t[j][col] = t;
            best_i[j][col] = base + g0 + g + 8 * (e >> 1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      float bt = best_t[j][col];
      int bi = best_i[j][col];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ot < bt || (ot == bt && oi < bi)) {
          bt = ot;
          bi = oi;
        }
      }
      const int r = warp_ray0 + 8 * j + 2 * q + col;
      if (g == 0 && r < n) {
        t_out[r] = bt;
        fid_out[r] = bt >= tpt::kRealMax ? -1 : bi;
      }
    }
}

"""
_LAUNCH_HEAD = ("  const cudaStream_t st = "
                "static_cast<cudaStream_t>(stream);\n")


def _knob(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# The v1 kernel in place of the kernel
_V1_EDITS = [
    ("}  // namespace", _V1 + "}  // namespace"),
    (_LAUNCH_HEAD, _LAUNCH_HEAD
     + "  v1_mxu_hit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, "
       "48 * tc, st>>>(\n      rays8, planes4, n, fp, tc, precision, t, "
       "fid);\n  return static_cast<int>(cudaGetLastError());\n")]
# The designs kernel D did not keep: edits (text, replacement) of
# csrc/lab4.cu, each text found exactly once.
VARIANTS = {
    "mma_sync": _V1_EDITS,
    # the v1 design with the fast divide: what the divide alone buys it
    "mma_sync_fast_divide": _V1_EDITS + [
        ("          const float t = -acc[2][e] / acc[5][e];\n",
         "          const float t = __fdividef(-acc[2][e], acc[5][e]);\n")],
    "ieee_divide": [("__fdividef(-acc[2][e], acc[2][e + 1])",
                     "-acc[2][e] / acc[2][e + 1]")],
    "warpgroups3_groups4": [_knob("kWarpgroups", 2, 3),
                            _knob("kGroups", 8, 4)],
    "groups4": [_knob("kGroups", 8, 4)],
    "warpgroups4_groups2": [_knob("kWarpgroups", 2, 4),
                            _knob("kGroups", 8, 2)],
    "groups6": [_knob("kGroups", 8, 6)],
    "buffers3_groups6": [_knob("kBuffers", 2, 3), _knob("kGroups", 8, 6)],
    "buffers3_groups4": [_knob("kBuffers", 2, 3), _knob("kGroups", 8, 4)],
    # timing only: the products alone, no epilogue
    "no_epilogue": [("      epilogue(acc[g % kBuffers], row0, g, b);\n",
                     "      b.t[g][0] = fminf(b.t[g][0], "
                     "acc[g % kBuffers][2][g]);\n")],
}
# builds whose outputs are not the kernel's
TIMING_ONLY = ("no_epilogue",)

# The v1 design of kernel E: one thread per ray, blocks of 4 warps, a tile
# staged by plain loads between two __syncthreads, every pair through the
# exact test
_E_V1 = _STAGE + """__global__ void __launch_bounds__(kThreads)
    v1_vpu_rol_kernel(const float* __restrict__ rays8,
                      const float* __restrict__ planesT, int n, int fp,
                      int tc, float* __restrict__ t_out,
                      int* __restrict__ fid_out) {
  extern __shared__ float4 smem4[];
  const float* sp = reinterpret_cast<const float*>(smem4);  // [tc][12]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int rr = r < n ? r : n - 1;  // idle lanes still stage
  const float ox = rays8[rr], oy = rays8[(size_t)n + rr],
              oz = rays8[2 * (size_t)n + rr];
  const float dx = rays8[4 * (size_t)n + rr], dy = rays8[5 * (size_t)n + rr],
              dz = rays8[6 * (size_t)n + rr];
  float best_t = tpt::kRealMax;
  int best = 0;
  for (int base = 0; base < fp; base += tc) {
    // [Fp, 12] is [3 * Fp, 4] in float4 rows: one group of 3 * tc rows
    stage(planesT + (size_t)base * 12, 3 * tc, 0, 3 * tc, 1,
          reinterpret_cast<float*>(smem4));
    for (int f = 0; f < tc; ++f) {
      const float* w = sp + 12 * f;
      const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
      float t, u, v;
      if (tpt::hit_terms(op, dx, dy, dz, w, t, u, v) && t < best_t) {
        best_t = t;
        best = base + f;
      }
    }
  }
  if (r < n) {
    t_out[r] = best_t;
    fid_out[r] = best_t >= tpt::kRealMax ? -1 : best;
  }
}

"""
# The designs without the queue: the exact test of a pair in the lane that
# holds its ray, which alone lowers the ray's key
_E_IN_LANE = """// The exact test of a pair in the lane of its ray.
__device__ __forceinline__ void in_lane(const float (&w)[12], int slot,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        unsigned long long* key, float& nbu) {
  float t, u, v;
  if (tpt::hit_terms(tpt::origin_terms(ox, oy, oz, w), dx, dy, dz, w, t, u,
                     v)) {
    const unsigned long long k = pack(t, slot);
    if (k < *key) {
      *key = k;
      nbu = neg_best_up(k);
    }
  }
}

"""
_E_LAUNCH = ("  const cudaStream_t est = "
             "static_cast<cudaStream_t>(stream);\n")
_E_APPEND = """        const unsigned b = __ballot_sync(kFull, keep);
        if (keep)
          asm volatile("st.shared.b32 [%0], %1;\\n" ::"r"(
                           qs | ((tail + 4 * __popc(b & below)) & 1023u)),
                       "r"((j << 7) | (lane + 32 * q))
                       : "memory");
        tail += 4 * __popc(b);
"""
_E_IN_LANE_CALL = ("in_lane(w, base + j, ox[q], oy[q], oz[q], dx[q], dy[q], "
                   "dz[q],\n                key + lane + 32 * q, nbu[q]);\n")
_E_NO_QUEUE = [
    ("// kCount: the counting instance", _E_IN_LANE
     + "// kCount: the counting instance"),
    ("      const float4 z = *z4;\n",
     "      float w[12];\n      tpt::load_planes_shared(tp + 12 * j, w);\n"
     "      const float4 z = make_float4(w[8], w[9], w[10], w[11]);\n")]
# The rays as rows in a scratch of the library, [2^20][2] float4: copied
# at the kernel's start, read by the exact test
_E_ROWS = [
    ("// One batch of the queue's first m",
     "constexpr int kRowsCap = 1 << 20;\n"
     "__device__ float4 g_rows[2 * kRowsCap];\n\n"
     "// One batch of the queue's first m"),
    ("""    const float* const ray = rays8 + first + r;
    const float ox = __ldg(ray), oy = __ldg(ray + sn),
                oz = __ldg(ray + 2 * sn), dx = __ldg(ray + 4 * sn),
                dy = __ldg(ray + 5 * sn), dz = __ldg(ray + 6 * sn);
""", """    const float4 a = g_rows[2 * (first + r)],
                 b = g_rows[2 * (first + r) + 1];
    const float ox = a.x, oy = a.y, oz = a.z, dx = a.w, dy = b.x, dz = b.y;
"""),
    ("    dz[q] = on ? __ldg(rays8 + 6 * sn + i) : 0.f;\n",
     "    dz[q] = on ? __ldg(rays8 + 6 * sn + i) : 0.f;\n"
     "    if (on) {\n"
     "      g_rows[2 * i] = make_float4(ox[q], oy[q], oz[q], dx[q]);\n"
     "      g_rows[2 * i + 1] = make_float4(dy[q], dz[q], 0.f, 0.f);\n"
     "    }\n"),
    ("  const int blocks = (n + kEBlockRays - 1) / kEBlockRays;\n",
     "  if (n > kRowsCap) return static_cast<int>(cudaErrorInvalidValue);\n"
     "  const int blocks = (n + kEBlockRays - 1) / kEBlockRays;\n")]
# The designs kernel E did not keep (lab4 --variants times them with the
# kernel): edits of csrc/lab4.cu as VARIANTS'.
E_VARIANTS = {
    # the replaced kernel
    "e_thread_per_ray": [
        ("}  // namespace", _E_V1 + "}  // namespace"),
        (_E_LAUNCH, _E_LAUNCH
         + "  v1_vpu_rol_kernel<<<(n + kThreads - 1) / kThreads, kThreads, "
           "48 * tc, est>>>(\n      rays8, planesT, n, fp, tc, t, fid);\n"
           "  return static_cast<int>(cudaGetLastError());\n")],
    # 4 rays a thread over the TMA ring, every pair through the exact test
    "e_rays4_ring": _E_NO_QUEUE + [
        (_E_APPEND, "        " + _E_IN_LANE_CALL)],
    # the cull, a survivor tested by its own lane (a per-lane branch)
    "e_cull_branch": _E_NO_QUEUE + [
        (_E_APPEND, "        if (keep)\n          " + _E_IN_LANE_CALL)],
    # the cull also rejects t <= DELTA: |o'z| < RN(DELTA_LO |d'z|) with
    # DELTA_LO = RN(DELTA (1 - 2^-20)) <= DELTA / (1 + 2^-24) (for a
    # subnormal bound the float |o'z| is <= it - 2^-149)
    "e_delta_cull": [(
        "  return (xs < 0.f) & (xs >= nbu * fabsf(y));\n",
        "  return (xs <= -0x1.a36e14p-13f * fabsf(y)) & (xs < 0.f) &\n"
        "         (xs >= nbu * fabsf(y));\n")],
    # blocks of 12 and of 4 warps (the ring shared by more or fewer warps)
    "e_threads384": [_knob("kEThreads", 256, 384)],
    "e_threads128": [_knob("kEThreads", 256, 128)],
    # a ring of 3 tiles
    "e_stages3": [_knob("kEStages", 2, 3)],
    # batches of 32 and of 128 survivors, one and four a lane
    "e_batch32": [_knob("kBatch", 64, 32)],
    "e_batch128": [_knob("kBatch", 64, 128)],
    # the exact test reads the rays from rows (origin, direction as two
    # float4) that the kernel copies to a scratch, not from rays8's columns
    "e_rows_scratch": _E_ROWS,
    # 2 rays a thread (512 a block)
    "e_rays2": [_knob("kERays", 4, 2)],
    # 4 blocks an SM (64 registers a thread)
    "e_min_blocks4": [
        ("__launch_bounds__(kEThreads, 2)",
         "__launch_bounds__(kEThreads, 4)")],
}


def make_planes4(woop) -> torch.Tensor:
    """WoopTris -> [3 * Fp, 4] component-major plane rows [w0 w1 w2 c]:
    the x rows of every slot, then the y rows, then the z rows."""
    return torch.cat([woop.planes[:, 0:4], woop.planes[:, 4:8],
                      woop.planes[:, 8:12]], dim=0).contiguous()


def make_planesT(woop) -> torch.Tensor:
    """WoopTris -> [Fp, 12] triangle-major rows [wx0..3 | wy0..3 |
    wz0..3]: kernel A's plane table."""
    return woop.planes.contiguous()


def _check(rays8, planes, rows: int, tc: int, what: str):
    fp = planes.shape[0] // rows
    if (rays8.dim() != 2 or rays8.shape[0] != 8
            or planes.shape[-1] != 12 // rows or planes.shape[0] != rows * fp
            or tc % 16 or not 16 <= tc <= 1024 or fp % tc):
        raise ValueError(f"{what}: bad shapes rays8 {tuple(rays8.shape)}, "
                         f"planes {tuple(planes.shape)}, tc {tc} (a multiple "
                         "of 16 up to 1024 that divides the slots)")
    return fp


def _closest(tcand, best_t, best_i, base):
    """Fold the [R, T] candidates of slots base.. into the running best:
    the lowest slot among a tile's minima, taken on a strictly smaller t."""
    cmin = tcand.amin(dim=1)
    iota = torch.arange(base, base + tcand.shape[1], device=tcand.device,
                        dtype=torch.int32)
    cid = torch.where(tcand == cmin[:, None], iota, _I32_MAX).amin(dim=1)
    better = cmin < best_t
    return torch.where(better, cmin, best_t), torch.where(better, cid, best_i)


def _scan(rays8, fp, tile_fn):
    """Closest hit of every ray over fp slots, tile by tile, with kernel
    D's arithmetic: tile_fn(rs, f0, f1) -> (t, u, v) [R, f1 - f0] of the
    rays rs."""
    n = rays8.shape[1]
    tf = max(1, min(fp, 2048))
    tn = max(1, _TILE_PAIRS // tf)
    best_t = torch.full((n,), REAL_MAX, device=rays8.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=rays8.device)
    for r0 in range(0, n, tn):
        rs = slice(r0, r0 + tn)
        for f0 in range(0, fp, tf):
            t, u, v = tile_fn(rs, f0, min(fp, f0 + tf))
            ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
            best_t[rs], best_i[rs] = _closest(torch.where(ok, t, REAL_MAX),
                                              best_t[rs], best_i[rs], f0)
    return best_t, torch.where(best_t >= REAL_MAX, -1, best_i)


def _vpu_rol_torch(rays8, planesT, tc: int = 512):
    """Plain twin of kernel E: (t [N], fid [N] i32), kernel A's scan.
    `tc` only tiles the kernel's work; the result does not depend on it."""
    _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    ((t, fid),), _ = scan_queries(planesT, tuple(rays8[0:3]),
                                  [tuple(rays8[4:7])], 1)
    return t, fid


def vpu_rol_schedule(rays8, planesT, tc: int = 512, pairs: bool = False):
    """Plain model of kernel E's cull and survivor queue, for the tests
    and chip_smoke.py only: no route calls it. Rays are cut into blocks
    of E_THREADS * E_RAYS and warps of E_WARP_RAYS (ray l + 32 q of a
    warp in lane l); per slot, in ascending order, a warp culls each of
    its pairs with the kernel's fp32 test on o'z, d'z and the ray's best
    (csrc/lab4.cu `survives`), appends the survivors in ray order and
    drains the queue in batches of E_BATCH while it holds that many, and
    all of it at a tile's last slot; a drained hit lowers the ray's best
    (t, then the lower slot), which the next slot's cull reads.
    Returns (t [N], fid [N] i32: the twin's; survivors [W] i32, batches
    [W] i32 of the W = ceil(N / 1024) * 8 warps), and with `pairs` also
    kept [N, Fp] bool, the pairs the cull let through."""
    fp = _check(rays8, planesT, 1, tc, "vpu_rol_schedule")
    n, dev = rays8.shape[1], rays8.device
    warps = -(-n // (E_THREADS * E_RAYS)) * (E_THREADS // 32)
    m = warps * E_WARP_RAYS
    cols = torch.nn.functional.pad(rays8, (0, m - n)).view(8, warps,
                                                           E_WARP_RAYS, 1)
    o, d = list(cols[0:3]), list(cols[4:7])
    valid = (torch.arange(m, device=dev) < n).view(warps, E_WARP_RAYS)
    inf = float("inf")
    neg_up = torch.tensor(-BEST_UP, dtype=torch.float32, device=dev)
    # a ray past n: best -inf, so that the cull keeps none of its pairs
    best_t = torch.where(valid, REAL_MAX, -inf)
    best_s = torch.zeros((warps, E_WARP_RAYS), dtype=torch.int32, device=dev)
    pend_t, pend_s = torch.full_like(best_t, inf), torch.zeros_like(best_s)
    count = torch.zeros((warps,), dtype=torch.int64, device=dev)
    survivors, batches = torch.zeros_like(count), torch.zeros_like(count)
    kept = torch.zeros((m, fp), dtype=torch.bool, device=dev) if pairs \
        else None
    # slots whose exact tests are computed at once (a divisor of tc)
    step = max(1, min(tc, (dense._TILE_PAIRS_CUDA if dev.type == "cuda"
                           else _TILE_PAIRS) // m))
    while tc % step:
        step -= 1
    for f0 in range(0, fp, step):
        w = list(planesT[f0:f0 + step].T[:, None, None, :])  # [1, 1, S]
        op = dense.origin_terms(*o, w)
        t, u, v = dense.hit_terms(op, *d, w)
        hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
        cand = torch.where(hit, t, inf)               # [W, 128, S]
        y = dense._affine(*d, w[8], w[9], w[10])      # d'z, as hit_terms
        ay = y.abs()
        # o'z with its sign flipped where d'z's sign bit is set
        xs = (op[2].view(torch.int32) ^ (y.view(torch.int32) & -2**31)
              ).view(torch.float32)
        neg = xs < 0.0
        for k in range(step):
            j = f0 + k
            nbu = best_t * neg_up
            keep = neg[..., k] & (xs[..., k] >= nbu * ay[..., k])
            if pairs:
                kept[:, j] = keep.view(-1)
            new = keep.sum(dim=1)
            survivors += new
            total = count + new
            end = j % tc == tc - 1
            drained = total if end else total // E_BATCH * E_BATCH
            batches += -(-drained // E_BATCH)
            # this slot's first drained - count survivors go with the
            # pending ones
            rank = keep.cumsum(dim=1) - keep.long()
            now = keep & (rank < (drained - count)[:, None])
            c = cand[..., k]
            flush = (drained > 0)[:, None]
            take = flush & (pend_t < best_t)
            best_t = torch.where(take, pend_t, best_t)
            best_s = torch.where(take, pend_s, best_s)
            take = now & (c < best_t)
            best_t = torch.where(take, c, best_t)
            best_s = torch.where(take, j, best_s)
            pend_t = torch.where(flush, inf, pend_t)
            take = keep & ~now & (c < pend_t)
            pend_t = torch.where(take, c, pend_t)
            pend_s = torch.where(take, j, pend_s)
            count = total - drained
    t = best_t.view(-1)[:n]
    fid = torch.where(t >= REAL_MAX, -1, best_s.view(-1)[:n])
    out = (t, fid, survivors.int(), batches.int())
    return out + (kept[:n],) if pairs else out


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away
    from zero), as cvt.rna.tf32.f32 computes it."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | (bits & -0x80000000)).view(torch.float32)


def _split(x, highest: bool):
    big = tf32_round(x)
    return big, (tf32_round(x - big) if highest else torch.zeros_like(x))


def _step(acc, a, b):
    """acc + sum_k a[k] b[k] in fp32: one K = 8 step, its products summed
    in order first, then the accumulator; TF32 products are exact in
    fp32 (the step's products of zero rows are left out: they add 0)."""
    s = a[0] * b[0]
    for k in range(1, len(a)):
        s = s + a[k] * b[k]
    return s + acc


def _mxu_torch(rays8, planes4, tc: int = 512, precision: str = "highest"):
    """Plain twin of kernel D: (t [N], fid [N] i32) with the kernel's
    TF32 roundings (module docstring)."""
    fp = _check(rays8, planes4, 3, tc, "mxu_closest_hit")
    highest = precision == "highest"
    o = [_split(rays8[k][:, None], highest) for k in range(4)]
    d = [_split(rays8[4 + k][:, None], highest) for k in range(4)]
    p = [[_split(planes4[c * fp:(c + 1) * fp, k][None], highest)
          for k in range(4)] for c in range(3)]

    def product(rs, cols, ray):
        """One component of o' or d' [R, T]: the kernel's wgmma steps,
        [a_big | a_small] . [b_small; b_big], then . [b_big; 0]."""
        a_big, a_small = [c[0] for c in cols], [c[1] for c in cols]
        r_big, r_small = [r[0][rs] for r in ray], [r[1][rs] for r in ray]
        acc = 0.0
        if highest:
            acc = _step(acc, a_big + a_small, r_small + r_big)
        return _step(acc, a_big, r_big)

    def tile(rs, f0, f1):
        pc = [[(pk[0][:, f0:f1], pk[1][:, f0:f1]) for pk in comp]
              for comp in p]
        op = [product(rs, pc[c], o) for c in range(3)]
        dp = [product(rs, pc[c], d) for c in range(3)]
        t = -op[2] / dp[2]
        return t, fma(t, dp[0], op[0]), fma(t, dp[1], op[1])

    return _scan(rays8, fp, tile)


@functools.cache
def _lib():
    return _bind(cuda_build.load_library("lab4"))


def _bind(lib):
    lib.tpt_mxu_hit.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 4
    lib.tpt_mxu_hit.restype = ctypes.c_int
    lib.tpt_vpu_rol_hit.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.tpt_vpu_rol_hit.restype = ctypes.c_int
    lib.tpt_vpu_rol_count.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    lib.tpt_vpu_rol_count.restype = ctypes.c_int
    return lib


@functools.cache
def _sass(src: str) -> str:
    """The SASS of the CUDA source `src` compiled with the kernels' flags
    to a cubin, as cuobjdump (beside nvcc) prints it."""
    cubin = cuda_build.BUILD_DIR / f"{os.path.basename(src)}.cubin"
    cuda_build.BUILD_DIR.mkdir(exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([cuda_build._nvcc(), *flags, f"-I{cuda_build.CSRC}",
                    "-cubin", "-o", str(cubin), src], check=True,
                   capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                             "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout


def hgmma_count(source=None) -> int:
    """HGMMA instructions in the SASS of csrc/lab4.cu (or of the CUDA
    source `source`): kernel D issues wgmma."""
    sass = _sass(str(source or cuda_build.CSRC / "lab4.cu"))
    return sum("HGMMA" in line for line in sass.splitlines())


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"BRA\s.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def sass_loops(sass: str, function: str) -> list:
    """[[first, last, instructions, MUFU.RCP], ...] of every loop of the
    SASS function whose name holds `function` (its first match): a
    backward branch and its target bound the loop; NOPs not counted."""
    body = None
    for part in sass.split("Function : ")[1:]:
        if function in part.split("\n", 1)[0]:
            body = part
            break
    if body is None:
        raise ValueError(f"no SASS function matching {function!r}")
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = _SASS_LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _SASS_INSN.search(line)
        if ins:
            addr = int(ins.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, ins.group(2)))
    loops = []
    for addr, text in insns:
        tgt = _SASS_TARGET.search(text)
        if not tgt:
            continue
        start = labels.get(tgt.group(1)) if tgt.group(1) else int(
            tgt.group(2), 16)
        if start is None or start > addr:
            continue
        inside = [x for a, x in insns if start <= a <= addr
                  and not x.startswith("NOP")]
        loops.append([start, addr, len(inside),
                      sum("MUFU.RCP" in x for x in inside)])
    return loops


def e_loop_counts(loops) -> dict:
    """Kernel E's two inner loops among `loops` (sass_loops): `batch`,
    the drain loop (the smallest loop holding the divide), one batch:
    E_BATCH / 32 exact tests a lane; `slot`, the rest of the smallest loop around it, the
    fast path of one slot against a lane's E_RAYS rays (`pair` = slot /
    E_RAYS)."""
    size = lambda lp: lp[1] - lp[0]                           # noqa: E731
    div = min((lp for lp in loops if lp[3]), key=size)
    outer = min((lp for lp in loops if lp[0] <= div[0] and lp[1] >= div[1]
                 and size(lp) > size(div)), key=size)
    slot = outer[2] - div[2]
    return {"slot": slot, "pair": slot / E_RAYS, "batch": div[2]}


def vpu_rol_sass(source=None) -> dict:
    """e_loop_counts of kernel E's instance (not the counting one) in the
    SASS of csrc/lab4.cu (or of `source`), with its `loops`."""
    loops = sass_loops(_sass(str(source or cuda_build.CSRC / "lab4.cu")),
                       "vpu_rol_kernelILb0E")
    return {**e_loop_counts(loops), "loops": loops}


def _outputs(rays8):
    n = rays8.shape[1]
    return (torch.empty((n,), dtype=torch.float32, device=rays8.device),
            torch.empty((n,), dtype=torch.int32, device=rays8.device))


def _mxu_cuda(rays8, planes4, tc, precision, lib=None):
    """Kernel D (or the build `lib`) on CUDA tensors: (t, fid). The
    planes are split into a scratch tensor first, in the same stream."""
    fp = _check(rays8, planes4, 3, tc, "mxu_closest_hit")
    cuda_build.check_operands(rays8, planes4)
    t, fid = _outputs(rays8)
    if rays8.shape[1]:
        scratch = torch.empty((24 * fp,), dtype=torch.float32,
                              device=rays8.device)
        status = (lib or _lib()).tpt_mxu_hit(
            rays8.data_ptr(), planes4.data_ptr(), rays8.shape[1], fp, tc,
            PRECISIONS[precision], t.data_ptr(), fid.data_ptr(),
            scratch.data_ptr(), cuda_build.stream_ptr(rays8.device))
        cuda_build.check_launch(status, "mxu_closest_hit")
    return t, fid


def mxu_closest_hit(rays8, planes4, tc: int = 512,
                    precision: str = "highest"):
    """Closest hit with the transform on the tensor cores: kernel D on
    CUDA tensors, its plain twin on CPU tensors. rays8 [8, N] (rows ox oy
    oz 1 dx dy dz 0), planes4 [3 * Fp, 4] (`make_planes4`); tc divides
    Fp. Returns (t [N], REAL_MAX on a miss; fid [N] i32, the slot, -1 on
    a miss)."""
    fp = _check(rays8, planes4, 3, tc, "mxu_closest_hit")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {list(PRECISIONS)}")
    if rays8.device.type == "cpu":
        return _mxu_torch(rays8, planes4, tc, precision)
    if rays8.device.type != "cuda":
        raise ValueError(f"mxu_closest_hit has no kernel for {rays8.device}")
    t, fid = _mxu_cuda(rays8, planes4, tc, precision)
    if rays8.shape[1]:
        mxu_closest_hit.launches += 1
    return t, fid


mxu_closest_hit.launches = 0


def _vpu_rol_cuda(rays8, planesT, tc, lib=None, counts=False):
    """Kernel E (or the build `lib`) on CUDA tensors: (t, fid), and with
    `counts` the counting launch's survivors and batches [W] of each
    warp (`vpu_rol_schedule`'s)."""
    fp = _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    cuda_build.check_operands(rays8, planesT)
    t, fid = _outputs(rays8)
    n = rays8.shape[1]
    warps = -(-n // (E_THREADS * E_RAYS)) * (E_THREADS // 32)
    surv, batches = (torch.zeros((2, warps), dtype=torch.int32,
                                 device=rays8.device) if counts
                     else (None, None))
    if n:
        args = (rays8.data_ptr(), planesT.data_ptr(), n, fp, tc,
                t.data_ptr(), fid.data_ptr())
        stream = cuda_build.stream_ptr(rays8.device)
        status = ((lib or _lib()).tpt_vpu_rol_count(
            *args, surv.data_ptr(), batches.data_ptr(), stream) if counts
            else (lib or _lib()).tpt_vpu_rol_hit(*args, stream))
        cuda_build.check_launch(status, "vpu_rol_closest_hit")
    return (t, fid, surv, batches) if counts else (t, fid)


def vpu_rol_closest_hit(rays8, planesT, tc: int = 512):
    """The same closest hit on the CUDA cores, triangles staged tc at a
    time in shared memory: kernel E on CUDA tensors, its plain twin on
    CPU tensors. planesT [Fp, 12] (`make_planesT`). Returns (t, fid) as
    `mxu_closest_hit`."""
    _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    if rays8.device.type == "cpu":
        return _vpu_rol_torch(rays8, planesT, tc)
    if rays8.device.type != "cuda":
        raise ValueError(f"vpu_rol_closest_hit has no kernel for "
                         f"{rays8.device}")
    t, fid = _vpu_rol_cuda(rays8, planesT, tc)
    if rays8.shape[1]:
        vpu_rol_closest_hit.launches += 1
    return t, fid


vpu_rol_closest_hit.launches = 0


def counted(rays8, planesT, tc: int = 512):
    """(t, fid, survivors [W], batches [W]) of kernel E: its counting
    launch on the card (a launch of kernel E), the plain model
    `vpu_rol_schedule` on the CPU."""
    _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    if rays8.device.type == "cpu":
        return vpu_rol_schedule(rays8, planesT, tc)
    out = _vpu_rol_cuda(rays8, planesT, tc, counts=True)
    if rays8.shape[1]:
        vpu_rol_closest_hit.launches += 1
    return out


def test_data(n, f, dev, seed=0):
    """(woop, rays [N, 8] for kernel A, rays8 [8, N]): f random triangles
    in [0, 100]^3, n rays from random origins there in random directions,
    made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    tv = torch.from_numpy((rng.random((f, 3, 3)) * 100.0).astype(np.float32))
    o = (rng.random((n, 3)) * 100.0).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    woop = precompute_woop(tv.to(dev))
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ones = torch.ones((n, 1), device=dev)
    zeros = torch.zeros((n, 1), device=dev)
    rays = torch.cat([o, d, zeros, zeros], dim=1).contiguous()
    rays8 = torch.cat([o, ones, d, zeros], dim=1).T.contiguous()
    return woop, rays, rays8


def agreement(t, fid, t_ref, slot_ref):
    """(share of lanes with the reference's slot, max |dt| on the lanes
    where the reference hits)."""
    match = float((fid == slot_ref).float().mean())
    hit = slot_ref >= 0
    dt = float((t - t_ref)[hit].abs().max()) if bool(hit.any()) else 0.0
    return match, dt


def check_correctness(n=4096, f=1948, dev=torch.device("cuda")):
    """Kernels D (both instances) and E against kernel A's hits on the
    same rays: the share of equal slots and the max |dt| on hits.
    Returns {label: (share, max |dt|)}."""
    woop, rays, rays8 = test_data(n, f, dev)
    t_ref, slot_ref, _ = dense.dense_hit(rays, woop)
    planes4 = make_planes4(woop)
    res = {}
    for label, (t, fid) in (
            ("mxu highest", mxu_closest_hit(rays8, planes4,
                                            precision="highest")),
            ("mxu default", mxu_closest_hit(rays8, planes4,
                                            precision="default")),
            ("vpu_rol", vpu_rol_closest_hit(rays8, make_planesT(woop)))):
        res[label] = agreement(t, fid, t_ref, slot_ref)
        print(f"  {label}: fid match {res[label][0]:.6f}, max |dt| on hits "
              f"{res[label][1]:.3e}", flush=True)
    return res


def _rate(fn, n, fp, dev, reps):
    ms = common.timed_ms(fn, dev, reps)
    return ms, n * fp / (ms * 1e-3)


def mxu_rate(n=1 << 20, f=1948, tc=512, precision="highest",
             dev=torch.device("cuda"), reps=10):
    """(ms per call, pairs/s) of kernel D on n rays x f triangles."""
    woop, _, rays8 = test_data(n, f, dev)
    planes4 = make_planes4(woop)
    return _rate(lambda: mxu_closest_hit(rays8, planes4, tc, precision), n,
                 woop.n_padded, dev, reps)


def vpu_rol_rate(n=1 << 20, f=1948, tc=512, dev=torch.device("cuda"),
                 reps=10):
    """(ms per call, pairs/s) of kernel E."""
    woop, _, rays8 = test_data(n, f, dev)
    planesT = make_planesT(woop)
    return _rate(lambda: vpu_rol_closest_hit(rays8, planesT, tc), n,
                 woop.n_padded, dev, reps)


def baseline_rate(n=1 << 20, f=1948, dev=torch.device("cuda"), reps=10):
    """(ms per call, pairs/s) of kernel A, the production dense kernel."""
    woop, rays, _ = test_data(n, f, dev)
    return _rate(lambda: dense.dense_hit(rays, woop), n,
                 woop.n_padded, dev, reps)


def _in_turns(res, builds, key, call, dev, reps):
    """Time call(lib) of every build in turns (the builds, then the same
    in reverse order) into res["<build>.<key>"]."""
    for name in list(builds) + list(builds)[::-1]:
        res.setdefault(f"{name}.{key}", []).append(common.timed_ms(
            functools.partial(call, builds[name]), dev, reps))
    print(json.dumps({f"{name}.{key}": res[f"{name}.{key}"]
                      for name in builds}), flush=True)


def time_variants(n, f, dev, reps):
    """--variants: every VARIANTS build of kernel D and E_VARIANTS build
    of kernel E (and the kernel's own source, rebuilt with -Xptxas -v),
    each at every tc of the sweep, D's at both precisions: D's face ids
    against the twin's on the first 4,096 rays, E's (t, fid) equal to
    the twin's there, then the times in turns (the kernel, each build,
    then the same in reverse order). Returns {"<build>.<precision>.tc<tc>
    _ms" or "<build>.tc<tc>_ms": [ms, ms], ...} with each build's ptxas
    lines, D's HGMMA counts and the kernel's E loops (vpu_rol_sass)."""
    libs = cuda_build.build_variants(
        "lab4", {"kernel": [], **VARIANTS, **E_VARIANTS}, _bind,
        flags=("-Xptxas", "-v"))
    res = {}
    for name in libs:
        res[f"{name}.ptxas"] = cuda_build.variant_resources("lab4", name)
        if name not in E_VARIANTS:
            res[f"{name}.hgmma"] = hgmma_count(
                cuda_build.BUILD_DIR / "variants" / f"lab4_{name}.cu")
        print(json.dumps({k: v for k, v in res.items()
                          if k.startswith(f"{name}.")}), flush=True)
    res["kernel.e_sass"] = {k: v for k, v in vpu_rol_sass().items()
                            if k != "loops"}
    kernel = {"kernel": _lib()}
    d_builds = {**kernel, **{k: v for k, v in libs.items() if k in VARIANTS}}
    e_builds = {**kernel, **{k: v for k, v in libs.items()
                             if k in E_VARIANTS}}
    woop, _, rays8 = test_data(n, f, dev)
    planes4, planesT = make_planes4(woop), make_planesT(woop)
    few = rays8[:, :4096].contiguous()
    for prec in PRECISIONS:
        _, want = _mxu_torch(few, planes4, precision=prec)
        for tc in SWEEP_TC:
            for name, lib in d_builds.items():
                if name in TIMING_ONLY:
                    continue
                share = float((_mxu_cuda(few, planes4, tc, prec, lib)[1]
                               == want).float().mean())
                if share < 0.999 - 0.004 * (prec == "default"):
                    raise AssertionError(f"build {name} {prec} tc {tc}: "
                                         f"face ids = twin's on {share}")
            _in_turns(res, d_builds, f"{prec}.tc{tc}_ms",
                      lambda lib: _mxu_cuda(rays8, planes4, tc, prec, lib),
                      dev, reps)
    want = _vpu_rol_torch(few, planesT)
    for tc in SWEEP_TC:
        for name, lib in e_builds.items():
            got = _vpu_rol_cuda(few, planesT, tc, lib)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"build {name} tc {tc}: (t, fid) differ "
                                     "from the twin's")
        _in_turns(res, e_builds, f"tc{tc}_ms",
                  lambda lib: _vpu_rol_cuda(rays8, planesT, tc, lib), dev,
                  reps)
    return res


def cull_counts(n=1 << 20, f=1948, tc=512, dev=torch.device("cuda")):
    """Kernel E's counting launch (the model on the CPU) on n rays x f
    triangles: {"survivor_share": survivors over the n f pairs of real
    faces, "batches": exact-test batches, "batch_fill": survivors over
    E_BATCH a batch}."""
    woop, _, rays8 = test_data(n, f, dev)
    _, _, surv, batches = counted(rays8, make_planesT(woop), tc)
    total, nb = int(surv.sum()), int(batches.sum())
    return {"survivor_share": total / (n * f), "batches": nb,
            "batch_fill": total / (E_BATCH * max(nb, 1))}


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--f", type=int, default=1948)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", action="store_true",
                    help="time the builds VARIANTS and E_VARIANTS list "
                         "(card only)")
    args, dev = common.parse(ap, argv, "lab4")
    if args.variants and dev.type != "cuda":
        raise ValueError("--variants builds kernels D's and E's designs: "
                         "card only")
    if args.variants:
        res = {"device": common.device_name(dev), "n_rays": args.n,
               **time_variants(args.n, args.f, dev, args.reps)}
        print(json.dumps(res, indent=2), flush=True)
        return res
    kw = dict(n=args.n, f=args.f, dev=dev, reps=args.reps)
    print("correctness (vs production dense kernel):", flush=True)
    check_correctness(min(args.n, 4096), args.f, dev)
    res = {"device": common.device_name(dev), "n_rays": args.n}
    if dev.type == "cuda":
        res["hgmma"] = hgmma_count()
        res["vpu_rol_sass"] = {k: v for k, v in vpu_rol_sass().items()
                               if k != "loops"}
    t, rate = baseline_rate(**kw)
    res["baseline_1Mx2048_ms"] = t
    res["baseline_gpairs_per_s"] = rate / 1e9
    for tc in SWEEP_TC:
        t, rate = mxu_rate(tc=tc, **kw)
        res[f"mxu_tc{tc}_highest_ms"] = t
        res[f"mxu_tc{tc}_highest_gpairs_per_s"] = rate / 1e9
    t, rate = mxu_rate(tc=512, precision="default", **kw)
    res["mxu_tc512_default_ms"] = t
    res["mxu_tc512_default_gpairs_per_s"] = rate / 1e9
    for tc in SWEEP_TC:
        t, rate = vpu_rol_rate(tc=tc, **kw)
        res[f"vpu_rol_tc{tc}_ms"] = t
        res[f"vpu_rol_tc{tc}_gpairs_per_s"] = rate / 1e9
    res.update({f"vpu_rol_{k}": v for k, v in cull_counts(
        args.n, args.f, dev=dev).items()})
    print(json.dumps(res, indent=2), flush=True)
    return res


if __name__ == "__main__":
    main()
