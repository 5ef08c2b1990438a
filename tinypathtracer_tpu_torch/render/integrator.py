"""Path-tracing integrator, modular form (port of
`tinypathtracer_tpu/render/integrator.py`).

The bounce loop runs over a whole ray batch, one closest-hit query per
bounce and direction (ops/dense.py, kernel A on CUDA), carrying the
path state (`Paths`) in component form. Two estimators, by cfg.mode.
On the card, with no gradient recorded, a frame's bounces can run as
CUDA graphs (`BounceGraphs`): the same kernels, one replay a bounce.
There, in reference mode, two hand-written kernels shade a bounce
between its queries (`shaded_bounce`, ops/shade.py), the torch code
below being their plain twin; the caller picks (the renderer's `Route`).

"reference" keeps the CUDA reference estimator's quirks on purpose. A
bounce is shaded by `scatter` and closed by `end_bounce`; the
megakernel's plain twin (ops/mega.py) shares both.

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

"physical" is the physically correct estimator (`physical_bounce`): on
diffuse lanes, NEE toward each delta light with the cosine, toward the
environment by importance sampling (models/envlight.py) and toward a
power-sampled point on an emissive face, weighted by the balance
heuristic against the BSDF draw; an emissive hit carries the matching
MIS weight, the environment is counted on a miss only after a camera or
specular bounce, and Russian roulette is optional. A bounce makes
3 + L closest-hit queries (L delta lights) where reference mode makes
2 + L.

Gradients follow the JAX package's path-replay convention: hit ids
are detached (every intersector call sees detached rays), and the
surface point stays differentiable through `_HitSurface`, whose backward
recomputes (t, u, v) with Moller-Trumbore. Each `lax.stop_gradient` of
the JAX integrator is a `.detach()` here, in the same place.
`trace_paths(..., stored_hits=...)` replays the reference-mode shading
alone on hits recorded by the megakernel (the backward pass of
ops/mega.py); no intersector runs there.

Base-color textures modulate the hit face's base color right after its
shading row is gathered (`texture_base`), before the split between the
estimators: the texcoords are interpolated under `detach()`, then a
point fetch with wrap addressing (cfg.tex_filter "point", the
reference's) or a bilinear fetch from the atlas mip chain at a level
picked from the hit distance and the pixel's ray spread ("bilinear").
Texel gradients flow through the gathers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.envlight import (EnvSamplingTables,
                                                      build_env_tables,
                                                      env_lookup, sample_env_u)
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.models.texture import (build_atlas_mips,
                                                     mip_level_shapes,
                                                     wrap_bilinear, wrap_point)
from tinypathtracer_tpu_torch.ops import shading_c
from tinypathtracer_tpu_torch.ops.dense import dense_hit
from tinypathtracer_tpu_torch.ops.lights import (MAX_LIGHTS, lights_block,
                                                 sample_delta_light)
from tinypathtracer_tpu_torch.ops.packet import packet_hit
from tinypathtracer_tpu_torch.ops.sampling import (lane_draws,
                                                   triangle_uniform_u)
from tinypathtracer_tpu_torch.ops.shade import close_bounce, shade_hits
from tinypathtracer_tpu_torch.ops.shading_c import INV_PI, dot_c
from tinypathtracer_tpu_torch.ops.traverse import _ray_tri_single
from tinypathtracer_tpu_torch.utils.math3d import (f32_reciprocal, fma, sqrt,
                                                   vcross, vdot, xla_cumsum)
from tinypathtracer_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class TraceData:
    """World-space geometry and shading tables of one frame (the fields
    of the JAX package's TraceData that the port's bounce loop reads)."""

    tri_verts: torch.Tensor      # [F, 3, 3] world-space triangle vertices
    # [15, F]: corner normals (9), base color (3), emission, eta,
    # metallic; a textured scene adds its corner texcoords (6), [21, F]
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
    # physical mode: the environment's importance-sampling tables
    # (models/envlight.py), each face's world area, the inclusive cdf of
    # emission * area over all faces (zero-power faces carry no mass)
    # and its total, the power
    env_marginal_cdf: torch.Tensor     # [He]
    env_conditional_cdf: torch.Tensor  # [He, We]
    env_pdf: torch.Tensor              # [He, We]
    face_area: torch.Tensor      # [F]
    em_cdf: torch.Tensor         # [F]
    em_power: torch.Tensor       # []
    # base-color texturing: the atlas layer of each face (-1 = none), the
    # atlas ([1, 1, 1, 3] = the scene has no textures: the bounce loop
    # then skips texture work), its channels flattened [T * Ht * Wt], its
    # mip chain flattened one tensor a channel (models/texture.py
    # build_atlas_mips), each face's uv density sqrt(uv area / world
    # area) and 2 tan(yfov / 2), the view's extent a unit of distance:
    # the last two pick the "bilinear" filter's mip level
    face_tex: torch.Tensor       # [F] i32
    tex_atlas: torch.Tensor      # [T, Ht, Wt, 3]
    atlas_r: torch.Tensor
    atlas_g: torch.Tensor
    atlas_b: torch.Tensor
    atlas_mips_r: torch.Tensor
    atlas_mips_g: torch.Tensor
    atlas_mips_b: torch.Tensor
    face_duv: torch.Tensor       # [F]
    cam_spread: torch.Tensor     # []

    @staticmethod
    def from_scene(scene: FlatScene) -> "TraceData":
        wv, wn = scene.world_geometry()
        idx = scene.indices.long()
        fm = scene.face_mtl.long()
        f = idx.shape[0]
        face_emission = material_rows(scene.mtl_emission[:, None], fm)[:, 0]
        cols = [wn[idx].reshape(f, 9),
                material_rows(scene.mtl_base_color, fm),
                face_emission[:, None], scene.mtl_eta[fm][:, None],
                scene.mtl_metallic[fm][:, None]]
        tri_verts = wv[idx]
        # 0.5 |e1 x e2|, fused as XLA:CPU fuses the JAX package's
        normal = vcross(tri_verts[:, 1] - tri_verts[:, 0],
                        tri_verts[:, 2] - tri_verts[:, 0])
        face_area = 0.5 * sqrt(vdot(normal, normal))
        if scene.has_textures:
            cuv = scene.texcoords[idx]                      # [F, 3, 2]
            cols.append(cuv.reshape(f, 6))
            e1u, e2u = cuv[:, 1] - cuv[:, 0], cuv[:, 2] - cuv[:, 0]
            area_u = 0.5 * torch.abs(fma(e1u[:, 0], e2u[:, 1],
                                         -(e1u[:, 1] * e2u[:, 0])))
            face_duv = sqrt(area_u / torch.clamp_min(face_area, 1e-20))
        else:
            face_duv = face_area.new_zeros((f,))
        shade_packT = torch.cat(cols, dim=1).T.contiguous()
        env_flat = scene.env_radiance.reshape(-1, 3)
        em_cdf = xla_cumsum(face_emission * face_area)
        tables = build_env_tables(scene.env_radiance)
        atlas = scene.tex_atlas
        mips = build_atlas_mips(atlas)
        return TraceData(
            tri_verts=tri_verts, shade_packT=shade_packT,
            face_emission=face_emission,
            light_kind=scene.light_kind, light_color=scene.light_color,
            light_intensity=scene.light_intensity,
            light_pos=scene.light_pos, light_dir=scene.light_dir,
            light_cos_outer=scene.light_cos_outer,
            light_inv_cone=scene.light_inv_cone,
            env_radiance=scene.env_radiance,
            env_r=env_flat[:, 0].contiguous(),
            env_g=env_flat[:, 1].contiguous(),
            env_b=env_flat[:, 2].contiguous(),
            env_marginal_cdf=tables.marginal_cdf,
            env_conditional_cdf=tables.conditional_cdf, env_pdf=tables.pdf,
            face_area=face_area, em_cdf=em_cdf,
            em_power=em_cdf[-1] if f > 0 else face_area.new_zeros(()),
            face_tex=scene.mtl_tex_id[fm], tex_atlas=atlas,
            atlas_r=atlas[..., 0].reshape(-1),
            atlas_g=atlas[..., 1].reshape(-1),
            atlas_b=atlas[..., 2].reshape(-1),
            atlas_mips_r=mips[0], atlas_mips_g=mips[1], atlas_mips_b=mips[2],
            face_duv=face_duv,
            cam_spread=2.0 * torch.tan(0.5 * scene.cam_yfov))

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    @property
    def textured(self) -> bool:
        """The scene has a texture atlas (not the [1, 1, 1, 3] sentinel)."""
        return any(n > 1 for n in self.tex_atlas.shape[:3])

    @property
    def env_tables(self) -> EnvSamplingTables:
        return EnvSamplingTables(self.env_marginal_cdf,
                                 self.env_conditional_cdf, self.env_pdf)


def material_rows(table, fm):
    """Each face's row of a per-material table [M, C], differentiable:
    an embedding lookup, whose backward sums each material's face
    cotangents in one fixed order on the CPU and on the card. The
    backward of table[fm] is an accumulating index_put_, which the CPU
    runs in parallel with racing adds, so a gradient could differ in its
    last bits between two calls on the same inputs."""
    return torch.nn.functional.embedding(fm, table)


def gather(table, dim: int, idx):
    """table indexed by idx along dim. index_select, not table[idx]: its
    backward is index_add_ (atomics on CUDA). The backward of advanced
    indexing is a sorted accumulate that adds each run of equal indices
    serially, and a few faces and env texels take most lanes' hits."""
    return torch.index_select(table, dim, idx)


def env_miss(data: TraceData, cfg: RenderConfig, dx, dy, dz):
    """Env radiance (r, g, b) seen along a direction (point sampled)."""
    eh, ew = data.env_radiance.shape[0], data.env_radiance.shape[1]
    etex = shading_c.env_texel_c(eh, ew, dx, dy, dz)
    return tuple(gather(ch, 0, etex) * cfg.env_scale
                 for ch in (data.env_r, data.env_g, data.env_b))


def texture_base(data: TraceData, cfg: RenderConfig, fid, t, bu, bv, row):
    """The base color (r, g, b) of each lane's hit with its face's
    texture applied (JAX integrator.py:496-585): row's base color times
    the texel at the hit's texcoords, on faces with a texture. The
    texcoords are interpolated from row's rows 15-20 and detached;
    "point" fetches the level-0 texel with wrap addressing (glTF's uv
    origin is top-left, so v maps to rows); "bilinear" picks a mip
    level per lane, texels a pixel ~ t * pixel angle * face uv density
    * atlas height, and filters in that level of the flat chain.
    Gradients flow to the texels through the gathers."""
    fid_c = torch.clamp_min(fid, 0)
    bw = 1.0 - bu - bv
    ut = ((bw * row[15] + bu * row[17]) + bv * row[19]).detach()
    vt = ((bw * row[16] + bu * row[18]) + bv * row[20]).detach()
    tid = gather(data.face_tex, 0, fid_c)
    layer = torch.clamp_min(tid, 0).long()
    n_tex, th, tw = data.tex_atlas.shape[:3]
    if cfg.tex_filter == "bilinear":
        shapes = mip_level_shapes(th, tw)
        offs = [0]
        for hl_, wl_ in shapes[:-1]:
            offs.append(offs[-1] + n_tex * hl_ * wl_)
        table = torch.tensor([[h_ for h_, _ in shapes], [w_ for _, w_ in shapes],
                              offs], dtype=torch.int64, device=fid.device)
        duv = gather(data.face_duv, 0, fid_c)
        px_angle = data.cam_spread * f32_reciprocal(cfg.height)
        texels_px = t.detach() * px_angle * duv * th
        lod = torch.floor(torch.log2(torch.clamp_min(texels_px, 1e-20)))
        lvl = torch.clamp(lod.long(), 0, len(shapes) - 1)
        hl, wl, off = (gather(r_, 0, lvl) for r_ in table)
        lay = off + layer * (hl * wl)
        taps = [(lay + y * wl + x, wt)
                for y, x, wt in wrap_bilinear(ut, vt, hl, wl)]

        def fetch(ch):
            out = None
            for i, wt in taps:
                term = wt * gather(ch, 0, i)
                out = term if out is None else out + term
            return out

        tex = [fetch(ch) for ch in (data.atlas_mips_r, data.atlas_mips_g,
                                    data.atlas_mips_b)]
    else:
        ty, tx = wrap_point(ut, vt, th, tw)
        flat = layer * (th * tw) + ty * tw + tx
        tex = [gather(ch, 0, flat) for ch in (data.atlas_r, data.atlas_g,
                                              data.atlas_b)]
    textured = tid >= 0
    return tuple(b * torch.where(textured, tc, 1.0)
                 for b, tc in zip(row[9:12], tex))


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


def surface(st: Paths, miss, t, bu, bv, row):
    """The interpolated unit shading normal and the hit point of each
    lane: ((nx, ny, nz), (hx, hy, hz)); miss lanes get t = 1."""
    t = torch.where(miss, 1.0, t)
    bw = 1.0 - bu - bv
    nx = (bw * row[0] + bu * row[3]) + bv * row[6]
    ny = (bw * row[1] + bu * row[4]) + bv * row[7]
    nz = (bw * row[2] + bu * row[5]) + bv * row[8]
    n = shading_c.normalize_c(nx, ny, nz, eps=1e-20)
    return n, tuple(o + t * d for o, d in zip(st.o, st.d))


def scatter(st: Paths, miss, t, bu, bv, row, u, lights, n_lights: int):
    """Shade the hits of one bounce.

    miss, t, bu, bv [N]: the closest hit along st.d (miss lanes' values
    are never read); row: the hit face's 15 shading values [15, N]
    (`shade_packT` rows); u: the bounce's uniforms (rows 0-1 BSDF
    hemisphere, 2 Fresnel coin, 3-4 the extra emitter draw); lights:
    the [L, 16] table. Returns st with the emission of emissive hits
    added to its radiance (such a hit ends the path), and the Scatter.
    """
    (nx, ny, nz), (hx, hy, hz) = surface(st, miss, t, bu, bv, row)
    dx, dy, dz = st.d
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
    em2 = gather(em_table, 0, torch.clamp_min(hit2, 0))
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

def _unit(v):
    """v [N, 3] / max(|v|, 1e-20)."""
    return v / torch.clamp_min(sqrt(dot_c(*v.unbind(1), *v.unbind(1))),
                               1e-20)[:, None]


def physical_bounce(data: TraceData, cfg: RenderConfig, st: Paths, prev_spec,
                    prev_pdf, fid, miss, t, bu, bv, row, u, lights,
                    hit_query, depth: int):
    """Shade and close one bounce of the physical estimator (JAX
    integrator.py:587-792).

    fid, miss, t, bu, bv [N]: the closest hit along st.d; row: the hit
    face's 15 shading values; u: the bounce's 9 uniform rows (0-1 BSDF
    hemisphere, 2 Fresnel coin, 3-4 environment NEE, 5 Russian roulette,
    6 the emissive-face pick, 7-8 its surface point); hit_query(o, d,
    mask) -> (fid, t, uv) detached. prev_spec [N] bool: the last bounce
    was a camera ray or specular; prev_pdf [N]: its solid-angle pdf (0
    there). Returns (paths, prev_spec, prev_pdf) after the bounce.
    """
    (nx, ny, nz), h = surface(st, miss, t, bu, bv, row)
    dx, dy, dz = st.d
    base = (row[9], row[10], row[11])
    emission, eta, metallic = row[12], row[13], row[14]
    n_faces = data.tri_verts.shape[0]

    # Terminal: an emissive hit adds its emission, weighted in MIS
    # against the emissive-face NEE below (solid-angle pdf p_nee =
    # (emission / W) t^2 / cos_light); prev_pdf == 0 (camera or
    # specular predecessor: NEE never samples those paths) keeps full
    # weight. The geometric normal is the NEE sampler's, so the two
    # balance weights of a path sum to 1.
    emissive = emission > 0.0
    hit_em = torch.where(st.alive & ~miss & emissive, emission, 0.0)
    if cfg.area_nee:
        w_power = data.em_power.detach()
        tv_h = gather(data.tri_verts, 0, torch.clamp_min(fid, 0)).detach()
        ng = _unit(vcross(tv_h[:, 1] - tv_h[:, 0], tv_h[:, 2] - tv_h[:, 0]))
        cos_l = torch.abs(dot_c(dx, dy, dz, *ng.unbind(1)))
        p_nee = torch.where(
            w_power > 0.0,
            (emission.detach() / torch.clamp_min(w_power, 1e-20))
            * t * t / torch.clamp_min(cos_l, 1e-8), 0.0)
        w_mis = torch.where(
            prev_pdf > 0.0,
            prev_pdf / torch.clamp_min(prev_pdf + p_nee, 1e-20), 1.0)
        hit_em = hit_em * w_mis.detach()
    rad = [r + tc * hit_em for r, tc in zip(st.rad, st.thr)]
    live = st.alive & ~miss & ~emissive

    ndx, ndy, ndz, ratio, is_spec = shading_c.sample_bsdf_c(
        u[0], u[1], u[2], dx, dy, dz, nx, ny, nz, eta, metallic)
    weight = [b * ratio for b in base]

    # NEE on diffuse lanes (f = albedo / pi, times the cosine); specular
    # lanes skip it (delta BSDF)
    sgn = torch.where(dot_c(dx, dy, dz, nx, ny, nz) > 0.0, -1.0, 1.0)
    n_side = (nx * sgn, ny * sgn, nz * sgn)
    f_diff = [b * INV_PI for b in base]
    diffuse = live & ~is_spec
    hit_pos = torch.stack(h, dim=1)
    direct = [torch.zeros_like(hit_em) for _ in range(3)]

    def add(visible, amount):
        for c in range(3):
            direct[c] = direct[c] + torch.where(visible, amount[c], 0.0)

    for li in range(data.n_lights):
        *wi, lr, lg, lb = sample_delta_light(*h, lights[li])
        cos_l = torch.clamp_min(dot_c(*wi, *n_side), 0.0)
        ofid = hit_query(hit_pos, torch.stack(wi, dim=1), diffuse)[0]
        add(ofid < 0, [fc * (cos_l * 1.0) * lc
                       for fc, lc in zip(f_diff, (lr, lg, lb))])

    # environment importance sampling
    wi_e, pdf_e = sample_env_u(u[3:5].T, data.env_tables)
    cos_e = torch.clamp_min(dot_c(*wi_e.unbind(1), *n_side), 0.0)
    efid = hit_query(hit_pos, wi_e, diffuse)[0]
    env_e = env_lookup(data.env_radiance, wi_e) * cfg.env_scale
    w_env = torch.where(pdf_e > 0.0, cos_e / torch.clamp_min(pdf_e, 1e-12),
                        0.0)
    add(efid < 0, [fc * w_env * env_e[:, c] for c, fc in enumerate(f_diff)])

    if cfg.area_nee:
        # a face picked by power (inverse cdf over all faces), a uniform
        # point on it, one shadow query, the balance heuristic against
        # the cosine-lobe pdf; the sampling is detached (path replay),
        # the radiance term is not
        cdf = data.em_cdf.detach()
        w_power = cdf[-1]
        fsel = torch.clamp(torch.searchsorted(cdf, u[6] * w_power), 0,
                           n_faces - 1)
        tv_s = gather(data.tri_verts, 0, fsel)
        y = triangle_uniform_u(u[7], u[8], tv_s[:, 0], tv_s[:, 1], tv_s[:, 2])
        d_vec = y.detach() - hit_pos
        dist2 = torch.clamp_min(dot_c(*d_vec.unbind(1), *d_vec.unbind(1)),
                                1e-12)
        wi_a = d_vec / sqrt(dist2)[:, None]
        n_s = _unit(vcross(tv_s[:, 1] - tv_s[:, 0], tv_s[:, 2] - tv_s[:, 0]))
        cos_x = torch.clamp_min(dot_c(*wi_a.unbind(1), *n_side), 0.0)
        cos_y = torch.abs(dot_c(*wi_a.unbind(1), *n_s.detach().unbind(1)))
        em_s = gather(data.face_emission, 0, fsel)
        want = diffuse & (w_power > 0.0) & (em_s > 0.0)
        sfid = hit_query(hit_pos, wi_a, want)[0]
        visible = want & (sfid == fsel)
        p_area = em_s.detach() / torch.clamp_min(w_power, 1e-20)
        p_nee_w = p_area * dist2 / torch.clamp_min(cos_y, 1e-8)
        w_mis = (p_nee_w / torch.clamp_min(p_nee_w + cos_x * INV_PI,
                                           1e-20)).detach()
        amt = (em_s * cos_x * cos_y
               / (dist2 * torch.clamp_min(p_area, 1e-20))) * w_mis
        add(visible, [fc * amt for fc in f_diff])
    rad = [r + torch.where(diffuse, tc * dc, 0.0)
           for r, tc, dc in zip(rad, st.thr, direct)]

    thr = [torch.where(live, tc * wc, tc) for tc, wc in zip(st.thr, weight)]
    o = tuple(torch.where(live, hc, oc) for hc, oc in zip(h, st.o))
    d = tuple(torch.where(live, n, dc) for n, dc in zip((ndx, ndy, ndz), st.d))
    prev_spec = torch.where(live, is_spec, prev_spec)
    # the diffuse draw's solid-angle pdf, 0 for specular (the emissive
    # MIS above then gives full weight); n_side is the pre-update side
    cos_nd = torch.clamp_min(dot_c(ndx, ndy, ndz, *n_side), 0.0)
    pdf_draw = torch.where(is_spec, 0.0, cos_nd * INV_PI)
    prev_pdf = torch.where(live, pdf_draw.detach(), prev_pdf)
    if cfg.russian_roulette:
        p_sur = torch.clamp(torch.maximum(torch.maximum(thr[0], thr[1]),
                                          thr[2]), 0.05, 1.0)
        late = depth >= 3
        kill = live & late & (u[5] >= p_sur)
        scale = torch.where(live & late, 1.0 / p_sur, 1.0)
        thr = [tc * scale for tc in thr]
        live = live & ~kill
    return (Paths(o=o, d=d, thr=tuple(thr), rad=tuple(rad), alive=live),
            prev_spec, prev_pdf)


class _HitSurface(torch.autograd.Function):
    """The intersector's own (t, u, v) as the primal hit data, with
    gradients from a Moller-Trumbore recompute that runs in the backward
    pass only (JAX `_hit_surface`). The hit face is not differentiable;
    the surface point is, with respect to the ray and the triangle."""

    @staticmethod
    def forward(ctx, o, d, tri_verts, fid, t_k, u_k, v_k):
        ctx.save_for_backward(o, d, tri_verts, fid)
        return t_k, u_k, v_k

    @staticmethod
    def backward(ctx, gt, gu, gv):
        o, d, tri_verts, fid = ctx.saved_tensors
        need_o, need_d, need_tv = ctx.needs_input_grad[:3]
        if not (need_o or need_d or need_tv):
            return (None,) * 7
        live = fid >= 0
        fid_c = torch.clamp_min(fid, 0)
        with torch.enable_grad():
            o_ = o.detach().requires_grad_()
            d_ = d.detach().requires_grad_()
            tv = tri_verts.detach()[fid_c].requires_grad_()
            t, u, v, _ = _ray_tri_single(o_, d_, tv[:, 0], tv[:, 1], tv[:, 2])
        # zero the miss lanes' incoming gradients BEFORE differentiating
        # the recompute: their face-0 stand-in is garbage
        cts = [torch.where(live, c, 0.0) for c in (gt, gu, gv)]
        go, gd, gtv = torch.autograd.grad((t, u, v), (o_, d_, tv), cts)
        g_tri = None
        if need_tv:
            gtv = torch.where(live[:, None, None], gtv, 0.0)
            g_tri = torch.zeros_like(tri_verts).index_add_(0, fid_c, gtv)
        return (go if need_o else None, gd if need_d else None, g_tri,
                None, None, None, None)


# closest_hit(origins [N, 3], dirs [N, 3], mask=[N] bool or None)
#   -> (fid [N], t [N], uv [N, 2]); mask=False lanes report miss.
HitFn = Callable[..., tuple]


def trace_paths(data: TraceData, cfg: RenderConfig, closest_hit: HitFn,
                origins, dirs, lane_keys, stored_hits=None, uniforms=None,
                shade_kernels: bool = False, graphs=None, remat=None):
    """Trace a batch of rays to completion; returns radiance [N, 3].

    lane_keys: [N, 2] keys, one per ray lane (contiguous int64). Every
    draw of a bounce comes from the lane's key (`lane_uniform(fold_all(
    keys, depth), m)`, m = 6 in reference mode, 9 in physical mode; one
    `ops.sampling.lane_draws` a bounce), so results do not
    depend on batching. uniforms (reference mode): those draws
    precomputed, [8 * max_depth, N] (ops/mega.py `bounce_uniforms`);
    lane_keys is then not read. The loop stops when every lane is dead:
    dead lanes never change state.

    stored_hits: per-bounce hits recorded by an identical trace (the
    megakernel forward, ops/mega.py `unpack_hits`): (fid [D, N], t
    [D, N], uv [D, N, 2], fid2 [D, N], occ [D, N], the delta-light
    occlusion bits). When given, no intersector runs (closest_hit may be
    None): the loop replays the shading on the recorded hits. Reference
    mode only.

    When autograd records (grad enabled and an input needs a gradient),
    each bounce is rematerialised, as the JAX integrator's
    `lax.scan(jax.checkpoint(bounce))`: only the [N]-sized carries
    between bounces persist, and the backward pass recomputes a bounce
    from them, its closest-hit queries included (stored hits are
    replayed, no kernel runs). Hit ids are detached and the intersectors
    deterministic, so the recompute equals the forward bit for bit.
    remat=False: not where the caller differentiates at once (the
    megakernel's stored-hit backward, ops/mega.py).

    shade_kernels: csrc/shade.cu's kernels shade the bounces
    (`shaded_bounce`), in reference mode on an untextured scene with at
    most MAX_LIGHTS lights, hits queried and autograd not recording;
    elsewhere they raise. graphs: the `BounceGraphs` whose buffers data
    and closest_hit's tables are (`BounceGraphs.bind`), where hits are
    queried and autograd does not record; elsewhere they raise.
    """
    fields = [getattr(data, f.name) for f in dataclasses.fields(data)]
    recording = torch.is_grad_enabled() and any(
        x.requires_grad for x in [origins, dirs] + fields)
    remat = recording if remat is None else remat
    physical = cfg.mode == "physical"
    replay = stored_hits is not None or uniforms is not None
    if physical and replay:
        raise ValueError("stored_hits and uniforms are reference mode only")
    if graphs is not None and (recording or replay):
        raise ValueError("graphs need queried hits, autograd not recording")
    if shade_kernels and (recording or replay or physical or data.textured
                          or data.n_lights > MAX_LIGHTS):
        raise ValueError("the shade kernels shade reference mode, untextured, "
                         f"<= {MAX_LIGHTS} lights, queried hits, no autograd")

    def hit_query(o, d, mask):
        # the discrete traversal is detached; _HitSurface restores the
        # surface point's gradient
        fid, t, uv = closest_hit(o.detach(), d.detach(), mask=mask)
        return fid, t.detach(), uv.detach()

    lights = lights_block(data) if graphs is None else graphs.lights
    if shade_kernels:
        # the radiance copied out: a graph's replay overwrites its outputs
        return _trace_loop(
            _start_rows, functools.partial(shaded_bounce, data, cfg,
                                           hit_query, lights),
            lambda c: c[3].clone(), origins, dirs, lane_keys, cfg.max_depth,
            graphs)

    def bounce(depth: int, keys, *carry):
        # carry: o, d, thr, rad (three [N] tensors each), the physical
        # estimator's prev_spec (the last bounce was a camera ray or
        # specular) and prev_pdf (its solid-angle pdf, 0 there), and alive
        # last (the loop reads it)
        st = Paths(o=carry[0:3], d=carry[3:6], thr=carry[6:9],
                   rad=carry[9:12], alive=carry[14])
        prev_spec, prev_pdf = carry[12], carry[13]
        if uniforms is None:
            u = lane_draws(keys, depth, 1, 9 if physical else 6)
        else:
            u = uniforms[8 * depth:8 * depth + 6]
        o3, d3 = torch.stack(st.o, dim=1), torch.stack(st.d, dim=1)
        if stored_hits is None:
            fid, t_k, uv = hit_query(o3, d3, st.alive)
        else:
            fid, t_k, uv = (h[depth] for h in stored_hits[:3])
        miss = fid < 0
        # Terminal: environment on miss; in physical mode only after a
        # camera or specular bounce (diffuse bounces count the dome by
        # its NEE)
        env = env_miss(data, cfg, *st.d)
        count_env = st.alive & miss
        if physical:
            count_env = count_env & prev_spec
        st.rad = tuple(r + tc * torch.where(count_env, e, 0.0)
                       for r, tc, e in zip(st.rad, st.thr, env))
        t, bu, bv = _HitSurface.apply(o3, d3, data.tri_verts, fid,
                                      torch.where(miss, 1.0, t_k),
                                      uv[:, 0], uv[:, 1])
        row = gather(data.shade_packT, 1, torch.clamp_min(fid, 0))
        if data.textured:
            row = (*row[:9], *texture_base(data, cfg, fid, t, bu, bv, row),
                   *row[12:15])
        if physical:
            st, prev_spec, prev_pdf = physical_bounce(
                data, cfg, st, prev_spec, prev_pdf, fid, miss, t, bu, bv, row,
                u, lights, hit_query, depth)
        else:
            st, sc = scatter(st, miss, t, bu, bv, row, u, lights,
                             data.n_lights)
            if stored_hits is None:
                h3 = torch.stack(sc.h, dim=1)
                fid2, _, _ = hit_query(h3, torch.stack(sc.d2, dim=1),
                                       mask=sc.live & sc.do_extra)
                unocc = [hit_query(h3, torch.stack(wi, dim=1),
                                   mask=sc.live)[0] < 0
                         for wi, _ in sc.lights]
            else:
                fid2, occ = stored_hits[3][depth], stored_hits[4][depth]
                unocc = [((occ >> li) & 1) == 0
                         for li in range(data.n_lights)]
            st = end_bounce(st, sc, fid2, data.face_emission, unocc)
        return (*st.o, *st.d, *st.thr, *st.rad, prev_spec, prev_pdf,
                st.alive)

    return _trace_loop(_start, bounce, lambda c: torch.stack(c[9:12], dim=1),
                       origins, dirs, lane_keys, cfg.max_depth, graphs, remat)


def _trace_loop(start, bounce, radiance, origins, dirs, lane_keys,
                max_depth: int, graphs, remat: bool = False):
    """radiance(the last carry) of trace_paths' loop over a chunk:
    carry = start(origins, dirs), then carry = bounce(depth, lane_keys,
    *carry) a bounce, each rematerialised where remat, as graphs'
    replays where graphs is given. A carry holds alive last."""
    if graphs is not None:
        return radiance(graphs.trace(start, bounce,
                                     (origins, dirs, lane_keys), max_depth))

    def step(depth, carry):
        if remat:
            # the keys ride in the function, not among the saved inputs
            return checkpoint(functools.partial(bounce, depth, lane_keys),
                              *carry, use_reentrant=False,
                              preserve_rng_state=False)
        return bounce(depth, lane_keys, *carry)

    carry = start(origins, dirs)
    return radiance(_bounce_loop(step, carry, bool(carry[-1].any()),
                                 max_depth))


def shaded_bounce(data: TraceData, cfg: RenderConfig, hit_query, lights,
                  depth: int, keys, o, d, thr, rad, alive):
    """One reference-mode bounce of trace_paths' loop with its shading
    in two kernels (ops/shade.py: `shade_hits` after the main query,
    `close_bounce` after the extra emitter and shadow queries): the same
    draws, queries and next carry, bit for bit, as the torch code. The
    carry (`_start_rows`) is o, d, thr, rad as [N, 3] rows, which the
    queries read as they are, and alive."""
    u = lane_draws(keys, depth, 1, 6)
    fid, t, uv = hit_query(o, d, alive)
    sh = shade_hits(o, d, thr, rad, alive, fid, t, uv, u, data, cfg, lights)
    fid2 = hit_query(sh.h, sh.d2, sh.extra)[0]
    occ = [hit_query(sh.h, wi, sh.live)[0] for wi in sh.wi]
    return close_bounce(o, d, thr, sh, fid, fid2, occ, data, lights)


def _start(origins, dirs):
    """The carry of trace_paths' torch loop before the first bounce."""
    st = Paths.start(origins.unbind(dim=1), dirs.unbind(dim=1))
    return (*st.o, *st.d, *st.thr, *st.rad, st.alive,
            torch.zeros_like(st.thr[0]), st.alive)


def _start_rows(origins, dirs):
    """The carry of `shaded_bounce` before the first bounce: `_start`'s
    paths as [N, 3] rows."""
    n = origins.shape[0]
    return (origins.contiguous(), dirs.contiguous(), origins.new_ones((n, 3)),
            origins.new_zeros((n, 3)),
            torch.ones((n,), dtype=torch.bool, device=origins.device))


def _bounce_loop(step, carry, alive: bool, max_depth: int):
    """carry = step(depth, carry) for depth 0, 1, ... while any lane is
    alive (alive: whether one is before the first; the carry holds it
    last). One host sync a bounce, whether any lane is alive; a bounce's
    span holds the sync that closes it (none after the last bounce)."""
    for depth in range(max_depth):
        if not alive:
            break
        with span("tpt.bounce"):
            carry = step(depth, carry)
            alive = depth + 1 < max_depth and bool(carry[-1].any())
    return carry


# the kernels a bounce may launch that count their launches
# (`<function>.launches`); a graph's replay adds what its capture counted
_COUNTED = (lane_draws, packet_hit, dense_hit, shade_hits, close_bounce)


class BounceGraphs:
    """CUDA graphs of the modular loop's bounces, kept from frame to frame
    by a renderer: a replay is one launch where a bounce runs ~400
    kernels op by op, so a chunk waits on the card and not on the host.

    A graph is kept a (lane count, depth). The first chunk of a lane
    count runs op by op and warms up its kernels; a later one captures
    each bounce it reaches that has run before, and from then on
    replays it. Bounce 0's graph starts the carry from the chunk's
    rays and keys, copied into the buffers it was captured on; bounce
    d's reads bounce d - 1's outputs, so it replays only after that
    graph did in the same chunk, and a chunk that leaves the graphs
    runs its remaining bounces op by op.

    A graph reads the tensors it was captured on, so each frame's trace
    data and closest-hit tables are copied into buffers that stay
    (`bind`), and the lights table is built there; a frame whose tables
    differ from the last in a shape, a type or a number takes new
    buffers and drops the graphs. All the graphs share one memory pool
    and replay one after another, on the stream of the caller.
    """

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.signature = None

    def bind(self, data: TraceData, tables):
        """(data, tables), the trace data and the closest hit's tables
        of a frame (dataclasses of tensors and numbers), as the buffers
        the graphs read, this frame's values copied in."""
        sig = _signature((data, tables))
        if sig == self.signature:
            _copy_into(self.bound, (data, tables))
            self.lights.copy_(lights_block(self.bound[0]))
            return self.bound
        torch.cuda.current_stream(self.device).synchronize()
        self.signature = sig
        self.pool = torch.cuda.graph_pool_handle()
        self.lanes = {}     # lane count -> (origins, dirs, keys) buffers
        self.graphs = {}    # (lane count, depth) -> (graph, carry, counts)
        self.warm = set()   # (lane count, depth) run op by op once
        self.bound = _clone((data, tables))
        self.lights = lights_block(self.bound[0]).clone()
        return self.bound

    def trace(self, start, bounce, lanes, max_depth: int):
        """The loop of trace_paths over a chunk's lanes (origins [N,
        3], dirs [N, 3], keys [N, 2]); returns its last carry."""
        n = lanes[0].shape[0]
        if n == 0 or max_depth < 1 or (n, 0) not in self.warm:
            # the first chunk of n lanes: op by op, warming up
            def warm_up(depth, carry):
                self.warm.add((n, depth))
                return bounce(depth, lanes[2], *carry)

            carry = start(*lanes[:2])
            return _bounce_loop(warm_up, carry, bool(carry[-1].any()),
                                max_depth)
        bufs = self.lanes.get(n)
        if bufs is None:
            bufs = self.lanes[n] = tuple(torch.empty_like(x) for x in lanes)
        for b, x in zip(bufs, lanes):
            b.copy_(x)
        chained = True      # the carry is the last graph's output

        def step(depth, carry):
            nonlocal chained
            key = (n, depth)
            if chained and key not in self.graphs and key in self.warm:
                if depth == 0:
                    self.graphs[key] = self._capture(
                        lambda: bounce(0, bufs[2], *start(*bufs[:2])))
                else:
                    self.graphs[key] = self._capture(
                        lambda: bounce(depth, bufs[2], *carry))
            if chained and key in self.graphs:
                graph, out, counts = self.graphs[key]
                graph.replay()
                for fn, c in zip(_COUNTED, counts):
                    fn.launches += c
                return out
            chained = False
            self.warm.add(key)
            if depth == 0:
                carry = start(*bufs[:2])
            return bounce(depth, bufs[2], *carry)

        return _bounce_loop(step, None, True, max_depth)

    def _capture(self, fn):
        """(graph, fn's outputs, the counted launches of one replay):
        fn captured on the side stream, not run."""
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        before = [fn_.launches for fn_ in _COUNTED]
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        main.wait_stream(self.stream)
        counts = [fn_.launches - b for fn_, b in zip(_COUNTED, before)]
        for fn_, b in zip(_COUNTED, before):
            fn_.launches = b
        return graph, out, counts


def _signature(x):
    """The shapes, types and numbers of a dataclass of tensors (nested)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device, x.stride())
    if dataclasses.is_dataclass(x):
        return (type(x),) + tuple(_signature(getattr(x, f.name))
                                  for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(_signature(v) for v in x)
    return x


def _clone(x):
    """A dataclass of tensors (nested) with every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x


def _copy_into(dst, src):
    """Copy the tensors of src into dst's, of the same signature."""
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(src):
        for f in dataclasses.fields(src):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(src, tuple):
        for d, x in zip(dst, src):
            _copy_into(d, x)
