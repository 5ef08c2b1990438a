"""Per-lane threefry key chain, bit-exact with `jax.random`, and the
Monte-Carlo samplers (port of `tinypathtracer_tpu/ops/sampling.py`).

Every random draw of
a frame derives from a (frame key, pixel, sample, tag) chain, so an
image depends only on its key and never on chunking. The port keeps
that contract by reproducing jax's threefry2x32 bit for bit: the keys
are `[..., 2]` int64 tensors holding uint32 words (int64 with
`& 0xFFFFFFFF` because torch's uint32 lacks shifts and adds).

The recipe (jax 0.9, `jax_threefry_partitionable=True`, which is the
default there):
  * `PRNGKey(seed)`        -> (seed >> 32, seed & 0xFFFFFFFF);
  * `fold_in(key, d)`      -> threefry2x32(key, (0, d));
  * `uniform(key, shape)`  -> word j (row-major flat index) = x0 ^ x1 of
                              threefry2x32(key, (0, j)), then
                              float((w >> 9) | 0x3F800000) - 1;
  * `split(key, n)[i]`     -> threefry2x32(key, (0, i)) = fold_in(key, i).

The frame's own chain runs through two entry points: `lane_keys` (each
lane's key and camera draws) and `lane_draws` (a lane's bounce draws).
On CUDA tensors each is one launch of `csrc/keys.cu`, the chain in
32-bit registers; on CPU tensors, their plain twins `_lane_keys_torch`
and `_lane_draws_torch`, the int64 chain above. Under a profiler both
record the span `tpt.keys`.

The samplers take raw uniforms (`*_u`) or a key, and work on (..., 3)
tensors; the bounce loop's component-form versions are in
ops/shading_c.py, which these share.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tinypathtracer_tpu_torch.ops import shading_c
from tinypathtracer_tpu_torch.ops.shading_c import INV_PI, PI
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import sqrt
from tinypathtracer_tpu_torch.utils.metrics import span

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    of uint32 words. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device="cpu"):
    """The raw key of `jax.random.PRNGKey(seed)` as an int64 [2] tensor."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(keys, data):
    """`jax.random.fold_in` on [..., 2] keys; `data` (an int or an int
    tensor broadcastable to keys[..., 0]) is taken modulo 2**32."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & _MASK
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_lanes(key, ids):
    """One key per lane: fold_in(key, ids[i]). key [2], ids [N] ints."""
    return fold_in(key, ids)


def fold_all(keys, tag: int):
    """Fold the same scalar tag into a [N, 2] key array."""
    return fold_in(keys, tag)


def _to_unit(b0, b1):
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def lane_uniform(keys, m: int):
    """[N, m] U[0,1) float32 draws, column j of lane i depending only on
    keys[i] (`jax.random.uniform(keys[i], (m,))`)."""
    j = torch.arange(m, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(j), j)
    return _to_unit(b0, b1)


def _lane_keys_torch(key, pix, spp: int, sample_offset: int, cam_tag: int):
    """Plain twin of `lane_keys`: the int64 chain."""
    lane_pix = pix.repeat_interleave(spp)
    lane_s = sample_offset + torch.arange(
        spp, dtype=torch.int64, device=pix.device).repeat(pix.shape[0])
    keys = fold_in(fold_lanes(key, lane_pix), lane_s)
    return keys, lane_uniform(fold_all(keys, cam_tag), 2)


def _lane_draws_torch(keys, first_tag: int, n_tags: int, m: int, rows: int):
    """Plain twin of `lane_draws`: the int64 chain."""
    out = keys.new_zeros((n_tags * rows, keys.shape[0]), dtype=torch.float32)
    for b in range(n_tags):
        out[b * rows:b * rows + m] = lane_uniform(
            fold_all(keys, first_tag + b), m).T
    return out


@functools.cache
def _lib():
    lib = cuda_build.load_library("keys")
    lib.tpt_lane_keys.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_uint32] * 2 + [ctypes.c_void_p] * 3
    lib.tpt_lane_keys.restype = ctypes.c_int
    lib.tpt_lane_draws.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_uint32] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    lib.tpt_lane_draws.restype = ctypes.c_int
    return lib


def _check_ints(what, t, ndim: int, dev):
    """Key-chain operands: contiguous int64 tensors of ndim dimensions on
    dev, which is the CPU or a card."""
    if not (t.dtype == torch.int64 and t.dim() == ndim and t.is_contiguous()
            and t.device == dev and dev.type in ("cpu", "cuda")):
        raise ValueError(
            f"{what} must be a contiguous {ndim}-d int64 tensor on the CPU "
            f"or a card, beside the other operands (got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous="
            f"{t.is_contiguous()}; the operands are on {dev})")


def lane_keys(key, pix, spp: int, sample_offset: int, cam_tag: int):
    """The keys and camera draws of the lanes of pixel ids pix [P], one
    lane per (pixel, sample), pixel-major: lane i is pixel pix[i // spp]
    at absolute sample sample_offset + i % spp. Returns (keys [P*spp, 2]
    int64, fold_in(fold_in(key, pixel), sample); u_cam [P*spp, 2]
    float32, lane_uniform(fold_all(keys, cam_tag), 2)). key [2] and pix
    are int64 on one device: one launch of csrc/keys.cu on a card (counted
    by `lane_keys.launches`), the int64 chain on the CPU."""
    _check_ints("pix", pix, 1, pix.device)
    _check_ints("key", key, 1, pix.device)
    if key.shape[0] != 2 or spp < 1:
        raise ValueError(f"lane_keys: key of shape {tuple(key.shape)} (not "
                         f"[2]) or spp {spp} < 1")
    with span("tpt.keys"):
        if pix.device.type == "cpu":
            return _lane_keys_torch(key, pix, spp, sample_offset, cam_tag)
        n = pix.shape[0] * spp
        if n >= 1 << 31:
            raise ValueError(f"lane_keys: {n} lanes need 64-bit indices")
        keys = torch.empty((n, 2), dtype=torch.int64, device=pix.device)
        u_cam = torch.empty((n, 2), dtype=torch.float32, device=pix.device)
        if n == 0:
            return keys, u_cam
        status = _lib().tpt_lane_keys(
            key.data_ptr(), pix.data_ptr(), n, spp, sample_offset & _MASK,
            cam_tag & _MASK, keys.data_ptr(), u_cam.data_ptr(),
            cuda_build.stream_ptr(pix.device))
        cuda_build.check_launch(status, "lane_keys")
        lane_keys.launches += 1
        return keys, u_cam


def lane_draws(keys, first_tag: int, n_tags: int, m: int,
               rows: int | None = None):
    """[n_tags * rows, N] float32 draws of lane keys [N, 2] (int64), one
    band of rows (m by default) a tag first_tag + b, b < n_tags: rows
    0..m-1 of band b are lane_uniform(fold_all(keys, first_tag + b), m).T,
    the rest zero. One launch of csrc/keys.cu on a card (counted by
    `lane_draws.launches`), the int64 chain on the CPU."""
    rows = m if rows is None else rows
    _check_ints("keys", keys, 2, keys.device)
    if keys.shape[1] != 2 or n_tags < 1 or not 1 <= m <= rows:
        raise ValueError(f"lane_draws: keys {tuple(keys.shape)}, {n_tags} "
                         f"tags, m {m}, rows {rows}")
    with span("tpt.keys"):
        if keys.device.type == "cpu":
            return _lane_draws_torch(keys, first_tag, n_tags, m, rows)
        n = keys.shape[0]
        if n >= 1 << 31 or keys.data_ptr() % 16:
            raise ValueError(f"lane_draws: {n} keys at {keys.data_ptr():#x} "
                             "(the kernel takes < 2**31, 16-byte aligned)")
        out = torch.empty((n_tags * rows, n), dtype=torch.float32,
                          device=keys.device)
        if n == 0:
            return out
        status = _lib().tpt_lane_draws(
            keys.data_ptr(), n, first_tag & _MASK, n_tags, m, rows,
            out.data_ptr(), cuda_build.stream_ptr(keys.device))
        cuda_build.check_launch(status, "lane_draws")
        lane_draws.launches += 1
        return out


lane_keys.launches = 0
lane_draws.launches = 0


def uniform(key, shape):
    """U[0,1) float32 draws of the given shape from one [2] key
    (`jax.random.uniform(key, shape)`)."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"uniform: {n} draws need 64-bit counters")
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(j), j)
    return _to_unit(b0, b1).reshape(shape)


def split(key, num: int = 2):
    """`jax.random.split(key, num)`: [num, 2] keys."""
    return fold_in(key, torch.arange(num, dtype=torch.int64,
                                     device=key.device))


def uniform2(key, shape):
    """Two independent U[0,1) tensors of the given shape from one key."""
    u = uniform(key, tuple(shape) + (2,))
    return u[..., 0], u[..., 1]


def _frame(u_phi, cos_t, sin_t, normal):
    """cos(phi) sin_t t + cos_t n + sin(phi) sin_t b, phi = 2 pi u_phi,
    in the reference's tangent frame (t, b) of normals [..., 3]."""
    tx, ty, tz, bx, by, bz = shading_c.build_onb_c(*normal.unbind(dim=-1))
    phi = 2.0 * PI * u_phi
    a, c = torch.cos(phi) * sin_t, torch.sin(phi) * sin_t
    nx, ny, nz = normal.unbind(dim=-1)
    return torch.stack([(a * tx + cos_t * nx) + c * bx,
                        (a * ty + cos_t * ny) + c * by,
                        (a * tz + cos_t * nz) + c * bz], dim=-1)


def hemisphere_cosine_u(u1, u2, normal):
    """Cosine-weighted hemisphere sample around unit normals [..., 3]
    from raw uniforms (sampler.h:75-89): phi = 2 pi u1, cos(theta) =
    sqrt(u2). Returns (direction [..., 3], pdf = cos(theta) / pi)."""
    cos_t = sqrt(u2)
    sin_t = sqrt(torch.clamp_min(1.0 - u2, 0.0))
    return _frame(u1, cos_t, sin_t, normal), cos_t * INV_PI


def hemisphere_cosine(key, normal):
    """Key-based wrapper over hemisphere_cosine_u."""
    return hemisphere_cosine_u(*uniform2(key, normal.shape[:-1]), normal)


def hemisphere_uniform_u(u1, u2, normal):
    """Uniform hemisphere sample (sampler.h:50-66): cos(theta) = u1,
    phi = 2 pi u2. Returns (direction, pdf = 1 / (2 pi))."""
    sin_t = sqrt(torch.clamp_min(1.0 - u1 * u1, 0.0))
    d = _frame(u2, u1, sin_t, normal)
    return d, torch.full_like(u1, 1.0 / (2.0 * PI))


def hemisphere_uniform(key, normal):
    """Key-based wrapper over hemisphere_uniform_u."""
    return hemisphere_uniform_u(*uniform2(key, normal.shape[:-1]), normal)


def coin_flip_u(u, p):
    """Bernoulli(p) from a raw uniform (sampler.h:98-101)."""
    return u < p


def coin_flip(key, p):
    """Key-based wrapper over coin_flip_u."""
    return uniform(key, tuple(p.shape)) < p


def triangle_uniform_u(u1, u2, v0, v1, v2):
    """Uniform point on triangles (v0, v1, v2) [..., 3] (sampler.h:30-37)."""
    su = sqrt(u1)
    a = su * (1.0 - u2)
    b = su * u2
    return (a[..., None] * v0 + b[..., None] * v1) \
        + (1.0 - a - b)[..., None] * v2


def triangle_uniform(key, v0, v1, v2):
    """Key-based wrapper over triangle_uniform_u."""
    return triangle_uniform_u(*uniform2(key, v0.shape[:-1]), v0, v1, v2)
