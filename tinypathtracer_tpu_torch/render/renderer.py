"""Renderer: scene -> image (port of `tinypathtracer_tpu/render/renderer.py`).

`render(scene, cfg, key)` is the one-shot entry point for a loaded glTF
`Scene` (models/scene.load_scene); `Renderer` renders FlatScenes.

Per frame: world geometry and shading tables (`prepare_state`), then
the (pixel, sample) lanes flattened into one ray axis and traced in
chunks of up to `cfg.rays_per_dispatch` rays. Each lane derives its key
from (frame key, pixel id, sample id), so images are identical under any
chunking. A chunk runs the megakernel (ops/mega.py) when the scene
qualifies and `cfg.megakernel` is set, else the modular bounce loop
(render/integrator.py) on the dense closest hit (ops/dense.py) or,
above 8192 padded faces or on request, the packet traversal
(ops/packet.py): `resolve_intersector`. On the card, in reference mode
on an untextured scene, csrc/shade.cu shades the modular loop's bounces
and `Renderer.render` replays them on kernel A or C as CUDA graphs. A
frame's `Route` (`decide_route`) holds these choices.
Physical mode always runs the modular loop (the megakernel is reference
mode only). The oracles "bvh" (the LBVH
walk, ops/traverse.py) and "bruteforce" (ops/intersect.py) run the
modular loop only; `Renderer` refuses a tree deeper than the bvh walk's
stack holds.

Under a torch profiler the frame records its layers as ranges
(`utils.metrics.span`): `tpt.frame` (one render), `tpt.prepare` (the
frame's tables), `tpt.chunk` (one chunk), `tpt.keys` (the threefry key
chain), `tpt.kernel_b` (the megakernel's launch), `tpt.bounce` (one
bounce of the modular loop, its closing host sync included),
`tpt.kernel_c` (one launch of the packet traversal), `tpt.shade` (one
launch of a shade kernel) and `tpt.film`.

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

import numpy as np
import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene, Scene
from tinypathtracer_tpu_torch.ops.dense import (WoopTris, closest_hit_dense,
                                                precompute_woop)
from tinypathtracer_tpu_torch.ops.intersect import closest_hit_bruteforce
from tinypathtracer_tpu_torch.ops.lbvh import BVH, build_lbvh, tree_depth
from tinypathtracer_tpu_torch.ops.mega import (MAX_LIGHTS, MEGA_MAX_FACES,
                                               mega_available,
                                               trace_paths_mega)
from tinypathtracer_tpu_torch.ops.packet import (PacketTris,
                                                 closest_hit_packet,
                                                 precompute_packet)
from tinypathtracer_tpu_torch.ops.sampling import lane_keys
from tinypathtracer_tpu_torch.ops.traverse import closest_hit_bvh
from tinypathtracer_tpu_torch.render import film, raygen
from tinypathtracer_tpu_torch.render.integrator import (BounceGraphs,
                                                        TraceData,
                                                        trace_paths)
from tinypathtracer_tpu_torch.utils import native
from tinypathtracer_tpu_torch.utils.metrics import span

# Key-derivation tag for the camera-jitter draw; bounces use their depth
# (0..max_depth-1) as the tag, so any large constant is collision-free.
_CAM_TAG = 0x00CA_0CA1


@dataclasses.dataclass(frozen=True)
class Route:
    """What a frame runs (`decide_route`): the modular loop's intersector,
    whether kernel B traces each chunk, whether csrc/shade.cu shades the
    modular loop's bounces that query their hits, and whether those
    replay as the caller's CUDA graphs (`BounceGraphs`)."""

    intersector: str
    megakernel: bool = False
    shade_kernels: bool = False
    graphs: bool = False


@dataclasses.dataclass
class PipelineState:
    """What the per-pixel render needs: the scene, its world-space trace
    data, its route and its intersector's tables: the packet traversal's
    chunk tables (whose `woop` is `woop`), the LBVH, the Woop triangles
    of the dense closest hit (kernels A and B), or none (brute force).
    graphs: those the bounces replay as, whose buffers data and the
    tables are (`bind_graphs`); None: op by op."""

    scene: FlatScene
    data: TraceData
    route: Route
    woop: Optional[WoopTris] = None
    packet: Optional[PacketTris] = None
    bvh: Optional[BVH] = None
    graphs: Optional[BounceGraphs] = None


def resolve_intersector(cfg: RenderConfig, n_faces: int) -> str:
    """The intersector a config uses on a scene of n_faces faces (the
    JAX package's policy): "dense" resolves to "packet" when the faces,
    padded to 128, exceed the megakernel's 8192."""
    padded = -(-n_faces // 128) * 128
    if cfg.intersector == "dense" and padded > MEGA_MAX_FACES:
        return "packet"
    return cfg.intersector


def decide_route(data: TraceData, cfg: RenderConfig, device,
                 recording: bool = False, graphs: bool = False) -> Route:
    """The route of a frame of data under cfg, its lanes on device.
    recording: grad enabled and a scene tensor requires a gradient;
    graphs: the caller keeps CUDA graphs across frames. The card serves
    where autograd does not record, in reference mode, untextured: the
    shade kernels up to MAX_LIGHTS lights, graphs on kernel A or C."""
    isect = resolve_intersector(cfg, data.tri_verts.shape[0])
    mega = cfg.megakernel and isect == "dense" and mega_available(data, cfg)
    serves = (torch.device(device).type == "cuda" and not recording
              and cfg.mode == "reference" and not data.textured)
    return Route(isect, mega, serves and data.n_lights <= MAX_LIGHTS,
                 serves and graphs and not mega
                 and isect in ("dense", "packet"))


def prepare_state(scene: FlatScene, cfg: RenderConfig,
                  prebuilt_bvh: Optional[BVH] = None,
                  graphs: Optional[BounceGraphs] = None) -> PipelineState:
    """Trace data, route and intersector tables of one frame. prebuilt_bvh
    (the "bvh" route): a tree built elsewhere (host_build_bvh), used with
    this frame's triangles. graphs: bound where the route replays them."""
    with span("tpt.prepare"):
        data = TraceData.from_scene(scene)
        recording = torch.is_grad_enabled() and any(
            t.requires_grad for t in vars(scene).values())
        route = decide_route(data, cfg, scene.device, recording,
                             graphs is not None)
        # the intersector's tables carry no gradient (hit ids are detached)
        tri_verts = data.tri_verts.detach()
        state = PipelineState(scene=scene, data=data, route=route)
        if route.intersector == "packet":
            state.packet = precompute_packet(tri_verts)
            state.woop = state.packet.woop
        elif route.intersector == "dense":
            state.woop = precompute_woop(tri_verts)
        elif route.intersector == "bvh":
            state.bvh = (build_lbvh(tri_verts) if prebuilt_bvh is None
                         else dataclasses.replace(
                             prebuilt_bvh.to(scene.device),
                             tri_verts=tri_verts))
    return bind_graphs(graphs, state) if route.graphs else state


def host_build_bvh(scene: FlatScene, pad_rel: float = 1e-5) -> BVH:
    """The LBVH of the scene's world-space triangles, built on the host
    by the C++ builder (utils/native.py; raises if it does not build).
    Boxes are widened by pad_rel * max(1, |bmin| + |bmax|), so that
    rounding differences between this transform and the frame's can
    never cull a true hit (box tests need only be conservative). On the
    CPU; the renderer moves it to the frame's device."""
    wv, _ = scene.to("cpu").world_geometry()
    tri = wv[scene.indices.cpu().long()].numpy()
    out = native.build_lbvh_host(tri)
    pad = pad_rel * np.maximum(1.0, np.abs(out["bmax"]) + np.abs(out["bmin"]))
    out.update(bmin=out["bmin"] - pad, bmax=out["bmax"] + pad, tri_verts=tri)
    return BVH.from_numpy(out, "cpu")


def hit_fn(state: PipelineState, cfg: RenderConfig):
    """The modular loop's closest_hit: the route's, on the state's tables."""
    isect = state.route.intersector
    if isect == "packet":
        return functools.partial(closest_hit_packet, pk=state.packet)
    if isect == "bvh":
        return functools.partial(closest_hit_bvh, bvh=state.bvh,
                                 stack_depth=cfg.stack_depth)
    if isect == "dense":
        return functools.partial(closest_hit_dense, woop=state.woop)
    tri_verts = state.data.tri_verts.detach()
    return functools.partial(closest_hit_bruteforce, tri_verts=tri_verts,
                             chunk=min(512, max(8, tri_verts.shape[0])))


def lane_rays(scene: FlatScene, cfg: RenderConfig, pix, key,
              spp: Optional[int] = None, sample_offset: int = 0):
    """Camera rays and lane keys of pixel ids pix [P] (row-major
    y * width + x): one lane per (pixel, sample), pixel-major, for the
    samples sample_offset .. sample_offset + spp - 1 (spp defaults to
    cfg.spp). The lane key is fold_in(fold_in(key, pixel), absolute
    sample), so every draw is independent of batch layout and of how
    the samples are split into passes (`ops.sampling.lane_keys`: one
    launch of csrc/keys.cu on the card). Returns (origins, dirs [P*spp,
    3], keys [P*spp, 2])."""
    spp = cfg.spp if spp is None else spp
    keys, u_cam = lane_keys(key.to(pix.device), pix, spp, sample_offset,
                            _CAM_TAG)
    lane_pix = pix.repeat_interleave(spp)
    o, d = raygen.camera_rays_u(
        u_cam, scene.cam_to_world, scene.cam_yfov, scene.cam_aspect,
        lane_pix % cfg.width, lane_pix // cfg.width, cfg.width, cfg.height)
    return o, d, keys


def bind_graphs(graphs: BounceGraphs, state: PipelineState) -> PipelineState:
    """The state bound to graphs, its trace data and closest-hit tables
    (kernel C's or A's) in their buffers (`BounceGraphs.bind`)."""
    if state.packet is not None:
        data, packet = graphs.bind(state.data, state.packet)
        return dataclasses.replace(state, data=data, packet=packet,
                                   woop=packet.woop, graphs=graphs)
    data, woop = graphs.bind(state.data, state.woop)
    return dataclasses.replace(state, data=data, woop=woop, graphs=graphs)


def render_pixel_ids(state: PipelineState, cfg: RenderConfig, pix, key,
                     spp: Optional[int] = None, sample_offset: int = 0):
    """Radiance SUM over spp samples (cfg.spp by default), the absolute
    sample indices sample_offset .. sample_offset + spp - 1, for pixel
    ids pix [P] (row-major y * width + x). Returns [P, 3] float32. The
    sum form keeps progressive accumulation exact: passes over disjoint
    sample ranges add up to one pass over their union. A state bound to
    graphs (`bind_graphs`) runs the modular loop's bounces as CUDA
    graphs; the image is the same bit for bit as op by op."""
    spp = cfg.spp if spp is None else spp
    data, route = state.data, state.route
    hit = hit_fn(state, cfg)
    n = pix.shape[0]
    # all spp of a pixel stay in one chunk (the sample sum is in-chunk)
    px_chunk = max(1, min(n, cfg.rays_per_dispatch // spp))
    out = []
    for start in range(0, n, px_chunk):
        with span("tpt.chunk"):
            chunk_pix = pix[start:start + px_chunk]
            m = chunk_pix.shape[0]
            o, d, keys = lane_rays(state.scene, cfg, chunk_pix, key, spp,
                                   sample_offset)
            if route.megakernel:
                rad = trace_paths_mega(data, cfg, state.woop, o, d, keys)
            else:
                rad = trace_paths(data, cfg, hit, o, d, keys,
                                  shade_kernels=route.shade_kernels,
                                  graphs=state.graphs)
            out.append(rad.reshape(m, spp, 3).sum(dim=1))
    return torch.cat(out, dim=0)


def render_frame(scene: FlatScene, cfg: RenderConfig, key,
                 prebuilt_bvh: Optional[BVH] = None,
                 spp: Optional[int] = None, sample_offset: int = 0,
                 graphs: Optional[BounceGraphs] = None):
    """Render one frame; returns the radiance SUM image [H, W, 3] over
    spp samples from sample_offset on (render_pixel_ids). graphs: a
    `BounceGraphs` kept across frames (`prepare_state`)."""
    state = prepare_state(scene, cfg, prebuilt_bvh, graphs)
    pix = torch.arange(cfg.n_pixels, dtype=torch.int64, device=scene.device)
    return render_pixel_ids(state, cfg, pix, key, spp, sample_offset).reshape(
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
        self._bvh_cache = {}
        self._stack_checked = set()
        # the bounces' CUDA graphs, kept from frame to frame
        self._graphs = (BounceGraphs(self.device)
                        if self.device.type == "cuda" else None)

    def _validate_stack(self, scene: FlatScene):
        """The stack guard of the "bvh" walk: a Karras LBVH can
        degenerate to depth ~F (collinear centroids build a comb), and a
        fixed stack too small for it would drop subtrees silently. The
        walk pushes both children per pop, so a tree of depth D needs
        D + 1 slots: measure the scene's tree once and refuse to render
        when cfg.stack_depth could overflow."""
        cfg = self.cfg
        if cfg.intersector != "bvh" or id(scene) in self._stack_checked:
            return
        if cfg.bvh_source == "host":
            bvh = self._bvh_for(scene)
        else:
            bvh = build_lbvh(
                TraceData.from_scene(scene.to(self.device)).tri_verts)
        depth = tree_depth(bvh)
        if depth + 1 > cfg.stack_depth:
            raise ValueError(
                f"bvh stack_depth={cfg.stack_depth} can overflow: this "
                f"scene's LBVH has depth {depth} (needs {depth + 1} "
                f"slots). Raise RenderConfig.stack_depth.")
        self._stack_checked.add(id(scene))

    def _bvh_for(self, scene: FlatScene) -> Optional[BVH]:
        """The host-built tree of the "bvh" route with bvh_source="host",
        cached for the last scene; None otherwise."""
        cfg = self.cfg
        if not (cfg.intersector == "bvh" and cfg.bvh_source == "host"):
            return None
        bvh = self._bvh_cache.get(id(scene))
        if bvh is None:
            bvh = host_build_bvh(scene).to(self.device)
            self._bvh_cache = {id(scene): bvh}       # single-entry cache
        return bvh

    def _frame(self, scene: FlatScene, key, graphs=None, spp=None,
               sample_offset: int = 0, image: bool = False):
        """render_frame's radiance sum under inference mode in a
        `tpt.frame` span, or with image the mean-radiance image."""
        with torch.inference_mode(), span("tpt.frame"):
            self._validate_stack(scene)
            rad_sum = render_frame(scene.to(self.device), self.cfg,
                                   key.to(self.device), self._bvh_for(scene),
                                   spp, sample_offset, graphs)
            if not image:
                return rad_sum
            with span("tpt.film"):
                return film.to_image(rad_sum, self.cfg.spp)

    def render(self, scene: FlatScene, key):
        """Returns the mean-radiance image [H, W, 3], top-down rows."""
        return self._frame(scene, key, self._graphs, image=True)

    def progressive(self, width=None, height=None):
        """A resumable accumulator bound to this pipeline
        (utils/checkpoint.ProgressiveRender): each step renders the next
        samples of the frame by their absolute indices (no graphs).
        width and height are accepted as the JAX package's are and
        ignored: the image is cfg's."""
        from tinypathtracer_tpu_torch.utils.checkpoint import \
            ProgressiveRender

        def fn(scene, key, sample_offset, n_samples):
            return self._frame(scene, key, None, n_samples, sample_offset)

        return ProgressiveRender(fn, self.cfg.width, self.cfg.height,
                                 self.device)


def render(scene: Scene, cfg: RenderConfig, key, env_radiance=None,
           device="cuda"):
    """One-shot: flatten a loaded scene onto the device (the card unless
    the caller asks for "cpu") and render its mean-radiance image
    [H, W, 3], top-down rows."""
    dev = resolve_device(device, "render")
    flat = scene.flatten(env_radiance=env_radiance, device=dev)
    return Renderer(cfg, device=dev).render(flat, key)
