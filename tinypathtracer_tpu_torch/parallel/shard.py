"""Sharded rendering over a ("data", "sample") device mesh (port of
`tinypathtracer_tpu/parallel/shard.py`).

Pixels shard over "data", samples over "sample", the scene is
replicated: each rank renders its pixel shard for its sample range.
Every lane's key depends on its (pixel, absolute sample) ids only, so
data sharding reproduces the one-device frame bit for bit, and sample
sharding differs from it only in the order of the sample sum. The
collectives are the radiance all-reduce over "sample" and the image
gather over "data" (`all_gather` into a list, which NCCL and gloo both
serve on CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.parallel.mesh import (DATA_AXIS, SAMPLE_AXIS,
                                                    axis)
from tinypathtracer_tpu_torch.render import film
from tinypathtracer_tpu_torch.render import renderer as rend


def _padded_pixels(cfg: RenderConfig, n_data: int, device=None):
    """(pixel ids [total], total): ceil(n_pixels / n_data) pixels a data
    shard; the padding lanes re-render pixel 0 and are discarded."""
    n = cfg.n_pixels
    total = -(-n // n_data) * n_data
    pix = torch.arange(total, dtype=torch.int64, device=device)
    return torch.where(pix < n, pix, 0), total


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sample_split(cfg: RenderConfig, mesh: DeviceMesh):
    """(samples a rank, this rank's first sample) of the "sample" axis."""
    n_sample, s_rank, _ = axis(mesh, SAMPLE_AXIS)
    if cfg.spp % n_sample:
        raise ValueError(f"spp={cfg.spp} not divisible by sample axis "
                         f"{n_sample}")
    spp_local = cfg.spp // n_sample
    return spp_local, s_rank * spp_local


def pixel_shard(cfg: RenderConfig, mesh: DeviceMesh, device):
    """(this rank's pixel ids [per], the mask of its real pixels [per])."""
    n_data, d_rank, _ = axis(mesh, DATA_AXIS)
    pix, total = _padded_pixels(cfg, n_data, device)
    per = total // n_data
    ids = torch.arange(d_rank * per, (d_rank + 1) * per, device=device)
    return pix[d_rank * per:(d_rank + 1) * per], ids < cfg.n_pixels


def render_frame_sharded(scene: FlatScene, cfg: RenderConfig, key,
                         mesh: DeviceMesh):
    """Distributed render_frame: the radiance SUM image [H, W, 3] over
    cfg.spp samples, on every rank. Call on every rank of the mesh with
    the same scene and key, on this rank's device."""
    spp_local, offset = sample_split(cfg, mesh)
    n_sample, _, sample_group = axis(mesh, SAMPLE_AXIS)
    n_data, _, data_group = axis(mesh, DATA_AXIS)
    state = rend.prepare_state(scene, cfg)
    pix, _ = pixel_shard(cfg, mesh, scene.device)
    rad = rend.render_pixel_ids(state, cfg, pix, key, spp=spp_local,
                                sample_offset=offset)
    if n_sample > 1:
        dist.all_reduce(rad, group=sample_group)
    if n_data > 1:
        parts = [torch.empty_like(rad) for _ in range(n_data)]
        dist.all_gather(parts, rad, group=data_group)
        rad = torch.cat(parts)
    return rad[:cfg.n_pixels].reshape(cfg.height, cfg.width, 3)


def make_sharded_renderer(cfg: RenderConfig, mesh: DeviceMesh):
    """Distributed renderer: fn(scene, key) -> the mean image [H, W, 3],
    top-down rows (as `Renderer.render`), on every rank. The scene and
    key move to this rank's device; it runs under inference mode."""
    dev = mesh_device(mesh)

    def render(scene: FlatScene, key):
        with torch.inference_mode():
            rad = render_frame_sharded(scene.to(dev), cfg, key.to(dev), mesh)
            return film.to_image(rad, cfg.spp)

    return render
