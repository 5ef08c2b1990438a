"""Reference-mode path-tracing integrator, modular form (port of
`tinypathtracer_tpu/render/integrator.py`).

The bounce loop runs over a whole ray batch, one closest-hit query per
bounce and direction (ops/dense.py, kernel A on CUDA), carrying the
path state (`Paths`) in component form. A bounce is shaded by `scatter`
and closed by `end_bounce`; the megakernel's plain twin (ops/mega.py)
shares both. The reference estimator's quirks are kept on purpose:

  * delta-light NEE adds baseColor * incomingRadiance with NO cosine or
    1/pi BRDF factor (path_tracer.cu:281);
  * one extra BSDF-sampled "direct" ray per diffuse bounce adds the raw
    scalar emissionFactor of whatever emissive it hits
    (path_tracer.cu:387-401), with no env contribution on miss;
  * hitting an emissive surface terminates the path and contributes the
    scalar emissionFactor, NOT scaled by that bounce's BSDF;
  * miss terminates with the env lookup (path_tracer.cu:358-362);
  * shadow rays use full closest-hit occlusion with no max-distance
    clip: geometry beyond a point light still shadows it.

Forward only: physical mode, textures and the stored-hit replay (the
backward pass) are later port items.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.ops import shading_c
from tinypathtracer_tpu_torch.ops.lights import (lights_block,
                                                 sample_delta_light)
from tinypathtracer_tpu_torch.ops.sampling import fold_all, lane_uniform


@dataclasses.dataclass
class TraceData:
    """World-space geometry and shading tables of one frame (the
    reference-mode fields of the JAX package's TraceData)."""

    tri_verts: torch.Tensor      # [F, 3, 3] world-space triangle vertices
    # [15, F]: corner normals (9), base color (3), emission, eta, metallic
    shade_packT: torch.Tensor
    face_emission: torch.Tensor  # [F]
    light_kind: torch.Tensor
    light_color: torch.Tensor
    light_intensity: torch.Tensor
    light_pos: torch.Tensor
    light_dir: torch.Tensor
    light_cos_outer: torch.Tensor
    light_inv_cone: torch.Tensor
    env_radiance: torch.Tensor   # [He, We, 3]
    env_r: torch.Tensor          # [He * We] flattened env channels
    env_g: torch.Tensor
    env_b: torch.Tensor

    @staticmethod
    def from_scene(scene: FlatScene) -> "TraceData":
        if scene.has_textures:
            raise NotImplementedError(
                "textured scenes are not ported yet (ROADMAP.md, port item "
                "'Textures')")
        wv, wn = scene.world_geometry()
        idx = scene.indices.long()
        fm = scene.face_mtl.long()
        f = idx.shape[0]
        face_emission = scene.mtl_emission[fm]
        shade_packT = torch.cat([
            wn[idx].reshape(f, 9),
            scene.mtl_base_color[fm],
            face_emission[:, None],
            scene.mtl_eta[fm][:, None],
            scene.mtl_metallic[fm][:, None]], dim=1).T.contiguous()
        env_flat = scene.env_radiance.reshape(-1, 3)
        return TraceData(
            tri_verts=wv[idx], shade_packT=shade_packT,
            face_emission=face_emission,
            light_kind=scene.light_kind, light_color=scene.light_color,
            light_intensity=scene.light_intensity,
            light_pos=scene.light_pos, light_dir=scene.light_dir,
            light_cos_outer=scene.light_cos_outer,
            light_inv_cone=scene.light_inv_cone,
            env_radiance=scene.env_radiance,
            env_r=env_flat[:, 0].contiguous(),
            env_g=env_flat[:, 1].contiguous(),
            env_b=env_flat[:, 2].contiguous())

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]


def env_miss(data: TraceData, cfg: RenderConfig, dx, dy, dz):
    """Env radiance (r, g, b) seen along a direction (point sampled)."""
    eh, ew = data.env_radiance.shape[0], data.env_radiance.shape[1]
    etex = shading_c.env_texel_c(eh, ew, dx, dy, dz)
    return (data.env_r[etex] * cfg.env_scale, data.env_g[etex] * cfg.env_scale,
            data.env_b[etex] * cfg.env_scale)


Vec = tuple  # three [N] tensors: xyz or rgb


@dataclasses.dataclass
class Paths:
    """Per-lane path state in component form."""

    o: Vec               # ray origin
    d: Vec               # ray direction
    thr: Vec             # throughput
    rad: Vec             # radiance gathered so far
    alive: torch.Tensor  # [N] bool

    @staticmethod
    def start(o: Vec, d: Vec) -> "Paths":
        n = o[0].shape[0]
        return Paths(o=tuple(o), d=tuple(d),
                     thr=tuple(o[0].new_ones((n,)) for _ in range(3)),
                     rad=tuple(o[0].new_zeros((n,)) for _ in range(3)),
                     alive=torch.ones((n,), dtype=torch.bool,
                                      device=o[0].device))


@dataclasses.dataclass
class Scatter:
    """One bounce shaded at its hit points, before the queries that
    leave them: what `end_bounce` and those queries need."""

    live: torch.Tensor      # the path goes on: alive, hit, not emissive
    h: Vec                  # hit point, the origin of every query
    nd: Vec                 # next direction (the BSDF sample)
    weight: Vec             # throughput weight, base color * BSDF ratio
    base: Vec               # base color
    do_extra: torch.Tensor  # diffuse lanes: the extra emitter query counts
    d2: Vec                 # the extra emitter query's direction
    lights: list            # per delta light: (direction toward it, radiance)


def scatter(st: Paths, miss, t, bu, bv, row, u, lights, n_lights: int):
    """Shade the hits of one bounce.

    miss, t, bu, bv [N]: the closest hit along st.d (miss lanes' values
    are never read); row: the hit face's 15 shading values [15, N]
    (`shade_packT` rows); u: the bounce's uniforms (rows 0-1 BSDF
    hemisphere, 2 Fresnel coin, 3-4 the extra emitter draw); lights:
    the [L, 16] table. Returns st with the emission of emissive hits
    added to its radiance (such a hit ends the path), and the Scatter.
    """
    t = torch.where(miss, 1.0, t)
    bw = 1.0 - bu - bv
    nx = (bw * row[0] + bu * row[3]) + bv * row[6]
    ny = (bw * row[1] + bu * row[4]) + bv * row[7]
    nz = (bw * row[2] + bu * row[5]) + bv * row[8]
    nx, ny, nz = shading_c.normalize_c(nx, ny, nz, eps=1e-20)
    (ox, oy, oz), (dx, dy, dz) = st.o, st.d
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    base = (row[9], row[10], row[11])
    emission, eta, metallic = row[12], row[13], row[14]

    # Terminal: an emissive hit adds the raw scalar emission
    emissive = emission > 0.0
    hit_em = torch.where(st.alive & ~miss & emissive, emission, 0.0)
    rad = tuple(r + tc * hit_em for r, tc in zip(st.rad, st.thr))

    ndx, ndy, ndz, ratio, _ = shading_c.sample_bsdf_c(
        u[0], u[1], u[2], dx, dy, dz, nx, ny, nz, eta, metallic)
    # Extra direct-emitter sample on diffuse lanes: a cosine draw around
    # the incident-side normal; adds the emission it hits.
    sgn = torch.where(shading_c.dot_c(dx, dy, dz, nx, ny, nz) > 0.0,
                      -1.0, 1.0)
    d2x, d2y, d2z, _ = shading_c.hemisphere_cosine_c(
        u[3], u[4], nx * sgn, ny * sgn, nz * sgn)
    lw = [sample_delta_light(hx, hy, hz, lights[li]) for li in range(n_lights)]
    return dataclasses.replace(st, rad=rad), Scatter(
        live=st.alive & ~miss & ~emissive, h=(hx, hy, hz),
        nd=(ndx, ndy, ndz), weight=tuple(b * ratio for b in base), base=base,
        do_extra=~((eta >= 1.0) | (metallic > 0.0)), d2=(d2x, d2y, d2z),
        lights=[(l_[:3], l_[3:]) for l_ in lw])


def end_bounce(st: Paths, sc: Scatter, hit2, em_table, unocc) -> Paths:
    """Add the bounce's direct light and step the paths that go on.

    hit2 [N]: the face (or slot) the extra emitter query hit, -1 on a
    miss, indexing em_table, the emission per face; unocc: per delta
    light, [N] bool, nothing between the hit point and the light.
    """
    em2 = em_table[torch.clamp_min(hit2, 0)]
    em2 = torch.where((hit2 >= 0) & sc.do_extra, em2, 0.0)
    direct = [em2, em2, em2]
    # Delta-light NEE (quirk: no cos / BRDF weighting)
    for (_, lrad), free in zip(sc.lights, unocc):
        direct = [dc + torch.where(free, b * lc, 0.0)
                  for dc, b, lc in zip(direct, sc.base, lrad)]
    live = sc.live
    # the direct term enters weighted by this bounce's BSDF too
    # (path_tracer.cu:427)
    rad = tuple(r + torch.where(live, tc * wc * dc, 0.0)
                for r, tc, wc, dc in zip(st.rad, st.thr, sc.weight, direct))
    return Paths(
        o=tuple(torch.where(live, h, o) for h, o in zip(sc.h, st.o)),
        d=tuple(torch.where(live, n, d) for n, d in zip(sc.nd, st.d)),
        thr=tuple(torch.where(live, tc * wc, tc)
                  for tc, wc in zip(st.thr, sc.weight)),
        rad=rad, alive=live)


# closest_hit(origins [N, 3], dirs [N, 3], mask=[N] bool or None)
#   -> (fid [N], t [N], uv [N, 2]); mask=False lanes report miss.
HitFn = Callable[..., tuple]


def trace_paths(data: TraceData, cfg: RenderConfig, closest_hit: HitFn,
                origins, dirs, lane_keys):
    """Trace a batch of rays to completion; returns radiance [N, 3].

    lane_keys: [N, 2] keys, one per ray lane. Every draw of a bounce
    comes from the lane's key (`lane_uniform(fold_all(keys, depth), 6)`),
    so results do not depend on batching. The loop stops when every lane
    is dead: dead lanes never change state.
    """
    st = Paths.start(origins.unbind(dim=1), dirs.unbind(dim=1))
    lights = lights_block(data)
    for depth in range(cfg.max_depth):
        if not bool(st.alive.any()):
            break
        u = lane_uniform(fold_all(lane_keys, depth), 6).T
        fid, t, uv = closest_hit(torch.stack(st.o, dim=1),
                                 torch.stack(st.d, dim=1), mask=st.alive)
        miss = fid < 0
        # Terminal: environment on miss
        env = env_miss(data, cfg, *st.d)
        count_env = st.alive & miss
        st.rad = tuple(r + tc * torch.where(count_env, e, 0.0)
                       for r, tc, e in zip(st.rad, st.thr, env))
        st, sc = scatter(st, miss, t, uv[:, 0], uv[:, 1],
                         data.shade_packT[:, torch.clamp_min(fid, 0)], u,
                         lights, data.n_lights)
        h3 = torch.stack(sc.h, dim=1)
        fid2, _, _ = closest_hit(h3, torch.stack(sc.d2, dim=1),
                                 mask=sc.live & sc.do_extra)
        unocc = [closest_hit(h3, torch.stack(wi, dim=1), mask=sc.live)[0] < 0
                 for wi, _ in sc.lights]
        st = end_bounce(st, sc, fid2, data.face_emission, unocc)
    return torch.stack(st.rad, dim=1)
