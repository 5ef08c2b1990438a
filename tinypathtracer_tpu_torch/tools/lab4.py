"""Kernel lab 4: the closest hit with the Woop transform on the tensor
cores (kernel D) and on the CUDA cores from staged triangles (kernel E),
beside the production dense kernel (kernel A). Port of
`tinypathtracer_tpu/tools/lab4.py`.

The TPU question was whether moving the transform's multiply-adds to the
matrix unit frees the vector unit for the epilogue. Here kernel D runs
them as wgmma TF32 products from TMA-staged shared memory
(csrc/lab4.cu) and kernel E as plain fp32 from a shared-memory tile that
every thread of a block reads (a broadcast). `tc` is the lab's sweep
parameter: triangles per staged tile.

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
fuses the JAX kernel, measured): E equals its twin `_vpu_rol_torch` and
kernel A exactly.

With --variants (on the card only) it times instead the designs kernel D
did not keep, each a build of csrc/lab4.cu with the edits VARIANTS lists
("mma_sync": the v1 design, mma.sync.m16n8k4 from registers, with or
without the fast divide; "ieee_divide"; the others change the block's
warpgroups, ray groups or accumulator sets; "no_epilogue", timing only,
runs the products without the epilogue), in turns with the kernel, at
both precisions and every tc of the sweep, each build's face ids held
to the kernel's twin. `hgmma_count` compiles the source to a cubin and
counts the HGMMA instructions of its SASS (cuobjdump).

Usage: python -m tinypathtracer_tpu_torch.tools.lab4 [--device cuda|cpu]
       [--n 1048576] [--f 1948] [--reps 10] [--variants]
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
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

# The v1 design of kernel D: per 16 x 8 tile six mma.sync.m16n8k4
# products (x, y, z of o' and d'), 18 at "highest" (small·big, big·small,
# big·big), A fragments split from a tile staged by a plain load loop
_V1 = """// The v1 design: mma.sync.m16n8k4 TF32, 32 rays a warp.
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
    return lib


def hgmma_count(source=None) -> int:
    """HGMMA instructions in the SASS of csrc/lab4.cu (or of the CUDA
    source `source`) compiled with the kernels' flags to a cubin, read by
    cuobjdump beside nvcc: kernel D issues wgmma."""
    src = source or cuda_build.CSRC / "lab4.cu"
    cubin = cuda_build.BUILD_DIR / f"{os.path.basename(src)}.cubin"
    cuda_build.BUILD_DIR.mkdir(exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([cuda_build._nvcc(), *flags, f"-I{cuda_build.CSRC}",
                    "-cubin", "-o", str(cubin), str(src)], check=True,
                   capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


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


def vpu_rol_closest_hit(rays8, planesT, tc: int = 512):
    """The same closest hit on the CUDA cores, triangles staged tc at a
    time in shared memory: kernel E on CUDA tensors, its plain twin on
    CPU tensors. planesT [Fp, 12] (`make_planesT`). Returns (t, fid) as
    `mxu_closest_hit`."""
    fp = _check(rays8, planesT, 1, tc, "vpu_rol_closest_hit")
    if rays8.device.type == "cpu":
        return _vpu_rol_torch(rays8, planesT, tc)
    if rays8.device.type != "cuda":
        raise ValueError(f"vpu_rol_closest_hit has no kernel for "
                         f"{rays8.device}")
    cuda_build.check_operands(rays8, planesT)
    t, fid = _outputs(rays8)
    if rays8.shape[1]:
        status = _lib().tpt_vpu_rol_hit(
            rays8.data_ptr(), planesT.data_ptr(), rays8.shape[1], fp, tc,
            t.data_ptr(), fid.data_ptr(), cuda_build.stream_ptr(rays8.device))
        cuda_build.check_launch(status, "vpu_rol_closest_hit")
        vpu_rol_closest_hit.launches += 1
    return t, fid


vpu_rol_closest_hit.launches = 0


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


def time_variants(n, f, dev, reps):
    """--variants: every VARIANTS build of kernel D (and the kernel's own
    source, rebuilt with -Xptxas -v) at both precisions and each tc of
    the sweep: face ids against the twin's on the first 4,096 rays, then
    the times in turns (the kernel, each build, then the same in reverse
    order). Returns {"<build>.<precision>.tc<tc>_ms": [ms, ms], ...} with
    each build's ptxas lines and HGMMA count."""
    libs = cuda_build.build_variants("lab4", {"kernel": [], **VARIANTS},
                                     _bind, flags=("-Xptxas", "-v"))
    res = {}
    for name in libs:
        res[f"{name}.ptxas"] = cuda_build.variant_resources("lab4", name)
        res[f"{name}.hgmma"] = hgmma_count(
            cuda_build.BUILD_DIR / "variants" / f"lab4_{name}.cu")
        print(json.dumps({k: v for k, v in res.items()
                          if k.startswith(f"{name}.")}), flush=True)
    builds = {"kernel": _lib(),
              **{k: v for k, v in libs.items() if k != "kernel"}}
    woop, _, rays8 = test_data(n, f, dev)
    planes4 = make_planes4(woop)
    few = rays8[:, :4096].contiguous()
    for prec in PRECISIONS:
        _, want = _mxu_torch(few, planes4, precision=prec)
        for tc in SWEEP_TC:
            for name, lib in builds.items():
                if name in TIMING_ONLY:
                    continue
                share = float((_mxu_cuda(few, planes4, tc, prec, lib)[1]
                               == want).float().mean())
                if share < 0.999 - 0.004 * (prec == "default"):
                    raise AssertionError(f"build {name} {prec} tc {tc}: "
                                         f"face ids = twin's on {share}")
            key = f"{prec}.tc{tc}_ms"
            for name in list(builds) + list(builds)[::-1]:
                res.setdefault(f"{name}.{key}", []).append(common.timed_ms(
                    functools.partial(_mxu_cuda, rays8, planes4, tc, prec,
                                      builds[name]), dev, reps))
            print(json.dumps({k: v for k, v in res.items()
                              if k.endswith(key)}), flush=True)
    return res


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--f", type=int, default=1948)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", action="store_true",
                    help="time the builds VARIANTS lists (card only)")
    args, dev = common.parse(ap, argv, "lab4")
    if args.variants and dev.type != "cuda":
        raise ValueError("--variants builds kernel D's designs: card only")
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
    for tc in (256, 512):
        t, rate = vpu_rol_rate(tc=tc, **kw)
        res[f"vpu_rol_tc{tc}_ms"] = t
        res[f"vpu_rol_tc{tc}_gpairs_per_s"] = rate / 1e9
    print(json.dumps(res, indent=2), flush=True)
    return res


if __name__ == "__main__":
    main()
