"""Textures: mip pyramids and point / bilinear sampling (port of
`tinypathtracer_tpu/models/texture.py`).

A texture is its tensors: a mip chain of [H_l, W_l, 3] levels, built by
2x point decimation that keeps the even texel of each pair, as the JAX
package does. Fetches are gathers (`index_select` on the flattened
level), so texels are differentiable parameters like every other scene
value. `build_atlas_mips` flattens the chain of a [T, H, W, 3] atlas
into one array per channel, the layout the integrator's bilinear branch
reads (render/integrator.py `texture_base`, which fetches through
`wrap_point` and `wrap_bilinear` as the samplers here do).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def load_image(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 3] float32 in [0, 1] (PIL)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def build_mip_pyramid(img, max_levels: int = 16) -> Tuple[torch.Tensor, ...]:
    """Mip chain by 2x point decimation: each level keeps the upper-left
    texel of each 2x2 block (point, not box, filtering)."""
    levels = [torch.as_tensor(img, dtype=torch.float32)]
    while len(levels) < max_levels:
        prev = levels[-1]
        if prev.shape[0] <= 1 and prev.shape[1] <= 1:
            break
        levels.append(prev[::2, ::2, :])
    return tuple(levels)


def _fetch(level, y, x):
    """level[y, x] as a gather of the flattened level: [N, 3]."""
    w = level.shape[1]
    return torch.index_select(level.reshape(-1, 3), 0, (y * w + x).long())


def wrap_point(u, v, h: int, w: int):
    """(y, x) int64 of the nearest texel at texcoords u, v [N] on an
    h x w level, with wrap addressing (cudaFilterModePoint)."""
    x = torch.clamp((torch.remainder(u, 1.0) * w).long(), 0, w - 1)
    y = torch.clamp((torch.remainder(v, 1.0) * h).long(), 0, h - 1)
    return y, x


def wrap_bilinear(u, v, h, w):
    """The four taps (y, x, weight) of a bilinear fetch at texcoords u, v
    [N] on an h x w level, with wrap addressing: (x0, y0), (x1, y0),
    (x0, y1), (x1, y1). h and w are ints, or [N] int64 (a level a lane,
    as the integrator's mip chain has). Every bilinear fetch of the port
    goes through here, so the filter has one arithmetic."""
    uu = torch.remainder(u, 1.0) * w - 0.5
    vv = torch.remainder(v, 1.0) * h - 0.5
    x0, y0 = torch.floor(uu), torch.floor(vv)
    fx, fy = uu - x0, vv - y0
    x0i, y0i = x0.long(), y0.long()
    x0w, x1w = torch.remainder(x0i, w), torch.remainder(x0i + 1, w)
    y0w, y1w = torch.remainder(y0i, h), torch.remainder(y0i + 1, h)
    return [(y0w, x0w, (1.0 - fx) * (1.0 - fy)), (y0w, x1w, fx * (1.0 - fy)),
            (y1w, x0w, (1.0 - fx) * fy), (y1w, x1w, fx * fy)]


def sample_point(level, uv):
    """Nearest-texel fetch. level: [H, W, 3]; uv: [N, 2] in [0, 1]
    (wrapping), as cudaFilterModePoint with wrap addressing."""
    return _fetch(level, *wrap_point(uv[:, 0], uv[:, 1], level.shape[0],
                                     level.shape[1]))


def sample_bilinear(level, uv):
    """Bilinear fetch with wrap addressing."""
    out = None
    for y, x, wt in wrap_bilinear(uv[:, 0], uv[:, 1], level.shape[0],
                                  level.shape[1]):
        term = wt[:, None] * _fetch(level, y, x)
        out = term if out is None else out + term
    return out


def mip_level_shapes(h: int, w: int, max_levels: int = 16):
    """The (H_l, W_l) chain of build_mip_pyramid's [::2] decimation (each
    level is ceil(prev / 2))."""
    shapes = [(h, w)]
    while len(shapes) < max_levels and (h > 1 or w > 1):
        h, w = max(1, (h + 1) // 2), max(1, (w + 1) // 2)
        shapes.append((h, w))
    return shapes


def build_atlas_mips(atlas):
    """The mip chain of a [T, H, W, 3] atlas as one flat tensor per
    channel: each level (point-decimated, keeping the even texel of each
    pair) flattened to [T * H_l * W_l], the levels concatenated. A
    level's offset and shape follow from `mip_level_shapes(H, W)`.
    Returns (mips_r, mips_g, mips_b)."""
    chans = ([], [], [])
    level = atlas
    for (hl, wl) in mip_level_shapes(atlas.shape[1], atlas.shape[2]):
        assert level.shape[1] == hl and level.shape[2] == wl
        for c in range(3):
            chans[c].append(level[..., c].reshape(-1))
        level = level[:, ::2, ::2, :]
    return tuple(torch.cat(ch) for ch in chans)


def sample_mip(levels: Sequence, uv, level_idx, bilinear: bool = True):
    """Fetch [N, 3] from mip level level_idx (clamped to the chain): an
    int or a tensor, of one level for all lanes or [N], one a lane. Each
    level present is one gather over its lanes (the JAX package switches
    over the levels with lax.switch)."""
    fetch = sample_bilinear if bilinear else sample_point
    n = uv.shape[0]
    idx = torch.as_tensor(level_idx, device=uv.device).clamp(
        0, len(levels) - 1).expand(n)
    out = uv.new_zeros((n, 3))
    for li, lv in enumerate(levels):
        lanes = (idx == li).nonzero()[:, 0]
        if lanes.numel():
            out = out.index_copy(0, lanes, fetch(lv, uv[lanes]))
    return out
