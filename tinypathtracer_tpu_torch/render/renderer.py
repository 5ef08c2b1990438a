"""Renderer: scene -> image (port of `tinypathtracer_tpu/render/renderer.py`).

Per frame: world geometry and shading tables (`prepare_state`), then
the (pixel, sample) lanes flattened into one ray axis and traced in
chunks of up to `cfg.rays_per_dispatch` rays. Each lane derives its key
from (frame key, pixel id, sample id), so images are identical under any
chunking. A chunk runs the megakernel (ops/mega.py) when the scene
qualifies and `cfg.megakernel` is set, else the modular bounce loop
(render/integrator.py) on the dense closest hit (ops/dense.py) or,
above 8192 padded faces or on request, the packet traversal
(ops/packet.py): `resolve_intersector`.

Kernels run where the scene's tensors live: on CUDA the hand-written
kernels, on the CPU their plain PyTorch twins. `render_pixel_ids` and
`render_frame` are differentiable (diff/invrender.py differentiates
them); `Renderer.render` runs under `torch.inference_mode()`. Entry
points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.ops.dense import (WoopTris, closest_hit_dense,
                                                precompute_woop)
from tinypathtracer_tpu_torch.ops.mega import (MEGA_MAX_FACES, mega_available,
                                               trace_paths_mega)
from tinypathtracer_tpu_torch.ops.packet import (PacketTris,
                                                 closest_hit_packet,
                                                 precompute_packet)
from tinypathtracer_tpu_torch.ops.sampling import (fold_all, fold_in,
                                                   fold_lanes, lane_uniform)
from tinypathtracer_tpu_torch.render import film, raygen
from tinypathtracer_tpu_torch.render.integrator import TraceData, trace_paths

# Key-derivation tag for the camera-jitter draw; bounces use their depth
# (0..max_depth-1) as the tag, so any large constant is collision-free.
_CAM_TAG = 0x00CA_0CA1


@dataclasses.dataclass
class PipelineState:
    """What the per-pixel render needs: the scene, its world-space trace
    data, the Woop triangles (kernels A and B) and, on the packet route,
    the packet traversal's chunk tables (whose `woop` is `woop`)."""

    scene: FlatScene
    data: TraceData
    woop: WoopTris
    packet: Optional[PacketTris] = None


def resolve_intersector(cfg: RenderConfig, n_faces: int) -> str:
    """The intersector a config uses on a scene of n_faces faces (the
    JAX package's policy): "dense" resolves to "packet" when the faces,
    padded to 128, exceed the megakernel's 8192."""
    padded = -(-n_faces // 128) * 128
    if cfg.intersector == "dense" and padded > MEGA_MAX_FACES:
        return "packet"
    return cfg.intersector


def prepare_state(scene: FlatScene, cfg: RenderConfig) -> PipelineState:
    data = TraceData.from_scene(scene)
    # the intersector's tables carry no gradient (hit ids are detached)
    tri_verts = data.tri_verts.detach()
    if resolve_intersector(cfg, tri_verts.shape[0]) == "packet":
        pk = precompute_packet(tri_verts)
        return PipelineState(scene=scene, data=data, woop=pk.woop, packet=pk)
    return PipelineState(scene=scene, data=data,
                         woop=precompute_woop(tri_verts))


def hit_fn(state: PipelineState):
    """The modular loop's closest_hit: the packet traversal where the
    state holds its tables, else the dense closest hit."""
    if state.packet is not None:
        return functools.partial(closest_hit_packet, pk=state.packet)
    return functools.partial(closest_hit_dense, woop=state.woop)


def lane_rays(scene: FlatScene, cfg: RenderConfig, pix, key):
    """Camera rays and lane keys of pixel ids pix [P] (row-major
    y * width + x): one lane per (pixel, sample), pixel-major. The lane
    key is fold_in(fold_in(key, pixel), sample), so every draw is
    independent of batch layout. Returns (origins, dirs [P*spp, 3],
    keys [P*spp, 2])."""
    lane_pix = pix.repeat_interleave(cfg.spp)
    lane_s = torch.arange(cfg.spp, dtype=torch.int64,
                          device=pix.device).repeat(pix.shape[0])
    keys = fold_in(fold_lanes(key, lane_pix), lane_s)
    u_cam = lane_uniform(fold_all(keys, _CAM_TAG), 2)
    o, d = raygen.camera_rays_u(
        u_cam, scene.cam_to_world, scene.cam_yfov, scene.cam_aspect,
        lane_pix % cfg.width, lane_pix // cfg.width, cfg.width, cfg.height)
    return o, d, keys


def render_pixel_ids(state: PipelineState, cfg: RenderConfig, pix, key):
    """Radiance SUM over cfg.spp samples for pixel ids pix [P] (row-major
    y * width + x). Returns [P, 3] float32."""
    spp = cfg.spp
    data = state.data
    use_mega = (cfg.megakernel and state.packet is None
                and mega_available(data, cfg, state.woop))
    hit = hit_fn(state)
    n = pix.shape[0]
    # all spp of a pixel stay in one chunk (the sample sum is in-chunk)
    px_chunk = max(1, min(n, cfg.rays_per_dispatch // spp))
    out = []
    for start in range(0, n, px_chunk):
        chunk_pix = pix[start:start + px_chunk]
        m = chunk_pix.shape[0]
        o, d, keys = lane_rays(state.scene, cfg, chunk_pix, key)
        if use_mega:
            rad = trace_paths_mega(data, cfg, state.woop, o, d, keys)
        else:
            rad = trace_paths(data, cfg, hit, o, d, keys)
        out.append(rad.reshape(m, spp, 3).sum(dim=1))
    return torch.cat(out, dim=0)


def render_frame(scene: FlatScene, cfg: RenderConfig, key):
    """Render one frame; returns the radiance SUM image [H, W, 3]."""
    state = prepare_state(scene, cfg)
    pix = torch.arange(cfg.n_pixels, dtype=torch.int64, device=scene.device)
    return render_pixel_ids(state, cfg, pix, key).reshape(
        cfg.height, cfg.width, 3)


def resolve_device(device, caller: str) -> torch.device:
    """torch.device of an entry point: "cuda" or "cpu". A card that is
    not there raises rather than the work running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={device!r}): CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Renderer:
    """Render pipeline for a fixed config on one device, the card by
    default (device="cpu" runs the plain twins).

    `render` moves the scene and key to the device; a device that is
    not available raises here rather than rendering elsewhere.
    """

    def __init__(self, cfg: RenderConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device, "Renderer")

    def render(self, scene: FlatScene, key):
        """Returns the mean-radiance image [H, W, 3], top-down rows."""
        with torch.inference_mode():
            rad_sum = render_frame(scene.to(self.device), self.cfg,
                                   key.to(self.device))
            return film.to_image(rad_sum, self.cfg.spp)
