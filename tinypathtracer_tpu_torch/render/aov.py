"""AOV / debug render modes (port of `tinypathtracer_tpu/render/aov.py`).

  * normal: the first hit's interpolated normal, per component absolute
    value, averaged over spp; misses contribute black (the reference's
    RENDER_NORMAL path, path_tracer.cu:322-342);
  * hitmask: 125/255 where the camera ray hit anything, black elsewhere
    (`checkHitStatus`, debug_utils.h:130-169);
  * depth: 1 / (1 + t) of the first hit, 0 on a miss.

An AOV does not depend on the shading, so a change that moves an AOV is
in the geometry or the intersector, and one that leaves it alone is in
the shading. The camera rays are the renderer's (`lane_rays`, the same
lanes and keys) and the closest hit is the renderer's own (`hit_fn`):
kernel A up to 8,192 padded faces, kernel C above, their twins on the
CPU. The JAX package's `render_aov_jit` has no counterpart: nothing
here is traced, so `render_aov` is the one entry point.
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.ops import shading_c
from tinypathtracer_tpu_torch.render.integrator import gather

AOV_KINDS = ("normal", "depth", "hitmask")


def render_aov(scene: FlatScene, cfg: RenderConfig, key, kind: str,
               device="cuda"):
    """One AOV image [H, W, 3] float32 in [0, 1], in raw (bottom-up) row
    order as the JAX package's. The scene and key move to the device,
    the card unless the caller asks for "cpu" (the twins); a card that
    is not there raises. The lanes run in chunks of up to
    cfg.rays_per_dispatch rays, whole pixels each."""
    if kind not in AOV_KINDS:
        raise ValueError(f"unknown AOV {kind!r}; one of {AOV_KINDS}")
    from tinypathtracer_tpu_torch.render.renderer import (hit_fn, lane_rays,
                                                          prepare_state,
                                                          resolve_device)

    dev = resolve_device(device, "render_aov")
    w, h, spp = cfg.width, cfg.height, cfg.spp
    scene, key = scene.to(dev), key.to(dev)
    with torch.inference_mode():
        state = prepare_state(scene, cfg)
        closest_hit = hit_fn(state, cfg)
        pix = torch.arange(w * h, dtype=torch.int64, device=dev)
        px_chunk = max(1, min(w * h, cfg.rays_per_dispatch // spp))
        out = []
        for start in range(0, w * h, px_chunk):
            o, d, _ = lane_rays(scene, cfg, pix[start:start + px_chunk], key)
            fid, t, uv = closest_hit(o, d)
            out.append(_aov_values(state.data, kind, fid, t, uv)
                       .reshape(-1, spp, 3).mean(dim=1))
        return torch.cat(out).reshape(h, w, 3)


def _aov_values(data, kind, fid, t, uv):
    """[N, 3] per-lane values of an AOV from the lanes' closest hits."""
    hit = fid >= 0
    n = fid.shape[0]
    if kind == "hitmask":
        return torch.where(hit, 125.0 / 255.0, 0.0)[:, None].expand(n, 3)
    if kind == "depth":
        return torch.where(hit, 1.0 / (1.0 + t), 0.0)[:, None].expand(n, 3)
    row = gather(data.shade_packT, 1, torch.clamp_min(fid, 0))
    bu, bv = uv[:, 0], uv[:, 1]
    bw = 1.0 - bu - bv
    nrm = shading_c.normalize_c(
        *[(bw * row[c] + bu * row[c + 3]) + bv * row[c + 6]
          for c in range(3)], eps=1e-20)
    return torch.where(hit[:, None], torch.stack(nrm, dim=1).abs(), 0.0)
