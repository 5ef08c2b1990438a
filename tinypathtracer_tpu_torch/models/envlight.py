"""Environment (dome) light (port of `tinypathtracer_tpu/models/envlight.py`).

An equirect [H, W, 3] float32 radiance map, row 0 = zenith side, +Y up
(env_light.cuh:72-78: u = atan2(z, x) / 2pi wrapped to [0, 1),
v = 1 - acos(y) / pi). The miss lookup is a point sample; the physical
estimator's NEE draws directions from luminance * sin(theta) tables
(marginal over rows, conditional within a row), inverted by search.

The tables round as the JAX package's do on XLA:CPU (measured): the
luminance is fma(0.0722, b, fma(0.2126, r, 0.7152 g)), the weight
fma(luma, sin(theta), 1e-12), the sums and
prefix sums run in XLA's order (`utils/math3d.xla_sum`, `xla_cumsum`),
(w / total) / sa becomes w / (total * sa), and the sines and cosines of
the texel centres are glibc's `sinf` / `cosf`, which XLA:CPU's compiled
sin and cos equal on every angle measured. So for power-of-two maps the
tables, and each lane's (row, col) pick, are the JAX package's bit for
bit on the CPU.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from tinypathtracer_tpu_torch.ops.sampling import uniform
from tinypathtracer_tpu_torch.ops.shading_c import (INV_2PI, INV_PI, PI,
                                                    env_texel_c)
from tinypathtracer_tpu_torch.utils.math3d import (fma_diff, xla_cumsum,
                                                   xla_sum)


def load_env_image(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 3] float32 (top-down rows): .npy
    arrays as they are (HDR), other formats through PIL as uint8 / 255."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim != 3 or arr.shape[2] < 3:
            raise ValueError(f"expected [H, W, 3] array in {path}")
        return np.ascontiguousarray(arr[:, :, :3])
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def gradient_sky(height: int = 64, width: int = 128,
                 horizon=(0.8, 0.75, 0.7), zenith=(0.25, 0.45, 0.85),
                 device="cpu") -> torch.Tensor:
    """Procedural sky dome [H, W, 3] float32, row 0 = zenith. Built with
    numpy in float64 exactly as the JAX package builds it."""
    t = np.linspace(1.0, 0.0, height)[:, None, None]
    sky = t * np.asarray(zenith)[None, None, :] \
        + (1 - t) * np.asarray(horizon)[None, None, :]
    sky = np.broadcast_to(sky, (height, width, 3)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(sky)).to(device)


@functools.cache
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


@functools.cache
def _centre_trig(n: int, span: float) -> tuple:
    """(sinf, cosf) of the n texel centres (i + 0.5) * (span / n), as
    float32 numpy arrays."""
    ang = ((np.arange(n, dtype=np.float32) + np.float32(0.5))
           * np.float32(span / n))
    lib = _libm()
    return (np.array([lib.sinf(float(a)) for a in ang], np.float32),
            np.array([lib.cosf(float(a)) for a in ang], np.float32))


def _trig(n: int, span: float, device, which: int) -> torch.Tensor:
    return torch.from_numpy(_centre_trig(n, span)[which]).to(device)


def dir_to_uv(dirs):
    """[..., 3] directions -> equirect (u, v) in [0, 1)."""
    u = torch.atan2(dirs[..., 2], dirs[..., 0]) * INV_2PI
    u = torch.where(u < 0.0, u + 1.0, u)
    v = 1.0 - torch.acos(torch.clamp(dirs[..., 1], -1.0, 1.0)) * INV_PI
    return u, v


def env_lookup(env_radiance, dirs):
    """Point-sample the dome [H, W, 3] along unit directions [N, 3]
    (nearest texel, path_tracer.cu:288-294). Returns [N, 3]. The texel
    choice is detached; gradients reach the map through the gather."""
    texel = env_texel_c(env_radiance.shape[0], env_radiance.shape[1],
                        *dirs.detach().unbind(dim=-1))
    return torch.index_select(env_radiance.reshape(-1, 3), 0, texel)


@dataclasses.dataclass
class EnvSamplingTables:
    """Row-marginal and per-row-conditional CDFs for importance sampling."""

    marginal_cdf: torch.Tensor     # [H] inclusive scan of row weights
    conditional_cdf: torch.Tensor  # [H, W] inclusive scan within rows
    pdf: torch.Tensor              # [H, W] solid-angle pdf of each texel


def build_env_tables(env_radiance) -> EnvSamplingTables:
    """Luminance * sin(theta) sampling tables (the correct solid-angle
    weight; the reference's unused tables weight by theta,
    env_light.cu:17-18). Differentiable in env_radiance through the pdf."""
    h, w = env_radiance.shape[0], env_radiance.shape[1]
    r, g, b = env_radiance.unbind(dim=-1)
    luma = fma_diff(torch.full_like(b, 0.0722), b, fma_diff(
        torch.full_like(r, 0.2126), r, 0.7152 * g))
    sin_t = _trig(h, PI, env_radiance.device, 0)[:, None]
    weights = fma_diff(luma, sin_t.expand_as(luma), torch.full_like(luma, 1e-12))
    marginal_cdf = xla_cumsum(xla_sum(weights))
    total = marginal_cdf[-1]
    conditional_cdf = xla_cumsum(weights)
    texel_sa = ((2.0 * PI / w) * (PI / h)) * sin_t
    pdf = weights / (total * torch.clamp_min(texel_sa, 1e-12))
    return EnvSamplingTables(marginal_cdf=marginal_cdf,
                             conditional_cdf=conditional_cdf, pdf=pdf)


def _row_search(conditional_cdf, row, value):
    """searchsorted(conditional_cdf[row[i]], value[i]) (left side) for
    every lane, by a binary search that reads one entry a lane a step
    (the JAX package gathers each lane's whole [W] row)."""
    w = conditional_cdf.shape[1]
    flat = conditional_cdf.reshape(-1)
    base = row.long() * w
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, w)
    for _ in range(max(1, w.bit_length())):
        mid = (lo + hi) >> 1
        open_ = lo < hi
        below = flat[base + torch.clamp_max(mid, w - 1)] < value
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    return lo


def sample_env_u(u, tables: EnvSamplingTables):
    """Directions drawn ~ the dome's luminance from raw uniforms u
    [N, 2]. Returns (dirs [N, 3], pdf [N]) with the pdf in solid-angle
    measure. The (row, col) picks are discrete; the pdf keeps its
    gradient to the map."""
    h = tables.marginal_cdf.shape[0]
    w = tables.conditional_cdf.shape[1]
    marginal = tables.marginal_cdf.detach()
    cond = tables.conditional_cdf.detach()
    row = torch.clamp(torch.searchsorted(marginal, u[:, 0] * marginal[-1]),
                      0, h - 1)
    row_total = cond[:, -1][row]
    col = torch.clamp(_row_search(cond, row, u[:, 1] * row_total), 0, w - 1)
    dev = u.device
    sin_t = _trig(h, PI, dev, 0)[row]
    cos_t = _trig(h, PI, dev, 1)[row]
    sin_p = _trig(w, 2.0 * PI, dev, 0)[col]
    cos_p = _trig(w, 2.0 * PI, dev, 1)[col]
    dirs = torch.stack([sin_t * cos_p, cos_t, sin_t * sin_p], dim=-1)
    return dirs, torch.index_select(tables.pdf.reshape(-1), 0, row * w + col)


def sample_env(key, tables: EnvSamplingTables, n: int):
    """Key-based wrapper over sample_env_u."""
    return sample_env_u(uniform(key, (n, 2)), tables)
