"""Plain reference of the port's reference-mode path tracer.

The same semantics as `tinypathtracer_tpu_torch` in reference mode
(its `render/integrator.py` "reference" estimator, the one kernel B and
the packet route's modular loop both compute), written again in plain
PyTorch from the scene arrays alone:

  * keys: jax's threefry2x32 chain (frame key, pixel, sample, then the
    camera tag or the bounce), as the port's `ops/sampling.py` does;
  * camera rays: a jittered pinhole, `render/raygen.py`;
  * the closest hit: Woop's unit-triangle test (o' = W o + c, d' = W d,
    t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y; a hit iff u, v >= 0,
    u + v <= 1 and t > DELTA), faces in the morton slot order of their
    centroids and the lowest slot winning among equal t. The tables are
    built here from the triangles; each slot's test runs only on the rays
    whose segment enters the box of its cluster of slots (a box cull,
    conservative by a margin, so the result is the full sweep's);
  * shading: the reference estimator's quirks (an emissive hit ends the
    path with the raw scalar emission; one extra cosine-sampled ray per
    diffuse bounce adds the emission it hits; a miss ends with the
    equirect environment, point sampled), the film's mean over samples.

The arithmetic is float32 without fused multiply-adds, so t, u and v
differ from the kernels' in their last bits: a path parts from the
program's only where a ray passes within rounding of a silhouette.

`tf32=True` computes the path in TF32 (10 explicit mantissa bits): the
operands of the hit test's products, and every surface point, direction,
throughput and radiance sum of the path, rounded to TF32: the control
that the comparison must fail.

Imports torch and numpy only: nothing of the port, nothing of JAX.
Delta lights and textures are not implemented (no configuration has
them): `Tables` refuses such a scene.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
CAM_TAG = 0x00CA0CA1
DELTA = float(np.float32(2e-4))
BIG = float(np.finfo(np.float32).max)
PI = 3.141592653589793
INV_PI = float(np.float32(1.0) / np.float32(PI))
INV_2PI = float(np.float32(1.0) / np.float32(2.0 * PI))
# box margin of the cull, relative to the scene's extent
CULL_MARGIN = 1e-4


# ---------------------------------------------------------------------------
# keys and uniforms
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors of uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu"):
    """jax.random.PRNGKey(seed) as an int64 [2] tensor of uint32 words."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def fold_in(keys, data):
    """jax.random.fold_in on [..., 2] keys; data an int or int tensor."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & MASK
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def uniforms(keys, m: int):
    """[N, m] U[0, 1) float32: jax.random.uniform(keys[i], (m,))."""
    j = torch.arange(m, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(j), j)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ---------------------------------------------------------------------------
# scene tables
# ---------------------------------------------------------------------------

def _take(table, idx):
    """table's rows idx."""
    return torch.index_select(table, 0, idx)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _unit(a, eps=0.0):
    return a / torch.sqrt(torch.clamp_min(_dot(a, a), eps))[..., None]


def _expand_bits10(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def morton_order(tri):
    """Stable order of triangles [F, 3, 3] by the 30-bit morton code of
    their box centres in the scene's box (x | y << 1 | z << 2)."""
    lo, hi = tri.amin(dim=1), tri.amax(dim=1)
    cent = 0.5 * (lo + hi)
    smin, smax = lo.amin(dim=0), hi.amax(dim=0)
    q = (cent - smin) / torch.clamp_min(smax - smin, 1e-12)
    q = torch.clamp((q * 1024.0).to(torch.int64), 0, 1023)
    code = (_expand_bits10(q[:, 0]) | (_expand_bits10(q[:, 1]) << 1)
            | (_expand_bits10(q[:, 2]) << 2))
    return torch.argsort(code, stable=True)


def woop_planes(tri):
    """[F, 12] rows (W[0], c0, W[1], c1, W[2], c2) of the unit-triangle
    transform W = [e1 e2 n]^-1, c = -W v0 (zero rows for a degenerate
    triangle, which no ray hits)."""
    v0 = tri[:, 0]
    e1, e2 = tri[:, 1] - v0, tri[:, 2] - v0
    n = _cross(e1, e2)
    det = _dot(n, n)[:, None]
    ok = det > 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    w = torch.stack([_cross(e2, n) * inv, _cross(n, e1) * inv, n * inv], 1)
    c = -_dot(w, v0[:, None, :])
    return torch.cat([w, c[:, :, None]], dim=2).reshape(-1, 12)


@dataclasses.dataclass
class Tables:
    """What the tracer reads, built from the scene arrays: triangles and
    shading rows in slot order, the cull's clusters, the environment."""

    tri: torch.Tensor        # [F, 3, 3] world vertices, slot order
    planes: torch.Tensor     # [F, 12]
    cnormal: torch.Tensor    # [F, 3, 3] corner normals (unit)
    base: torch.Tensor       # [F, 3]
    emission: torch.Tensor   # [F]
    eta: torch.Tensor        # [F]
    metallic: torch.Tensor   # [F]
    env: torch.Tensor        # [He, We, 3]
    cam_to_world: torch.Tensor
    yfov: torch.Tensor
    aspect: torch.Tensor
    clusters: list           # (first slot, end slot, box [6] or None)
    face_mtl: torch.Tensor   # [F] material of each slot

    @staticmethod
    def build(arrays: dict, device, cluster=None) -> "Tables":
        """Tables of a scene's FlatScene arrays on a device."""
        def t(name, dtype=torch.float32):
            return torch.as_tensor(np.asarray(arrays[name]), dtype=dtype,
                                   device=device)

        if len(arrays["light_kind"]) or np.asarray(arrays["tex_atlas"]).size > 3:
            raise ValueError("the reference implements neither delta lights "
                             "nor textures")
        vobj = t("vert_obj", torch.int64)
        vm, nm = t("vert_mats")[vobj], t("normal_mats")[vobj]
        v, n = t("vertices"), t("normals")
        wv = _dot(vm[:, :3, :3], v[:, None, :]) + vm[:, :3, 3]
        wn = _unit(_dot(nm[:, :3, :3], n[:, None, :]))
        idx = t("indices", torch.int64)
        tri = wv[idx]
        order = morton_order(tri)
        tri, idx = tri[order], idx[order]
        fm = t("face_mtl", torch.int64)[order]
        f = tri.shape[0]
        return Tables(
            tri=tri, planes=woop_planes(tri).contiguous(), cnormal=wn[idx],
            base=t("mtl_base_color")[fm], emission=t("mtl_emission")[fm],
            eta=t("mtl_eta")[fm], metallic=t("mtl_metallic")[fm],
            env=t("env_radiance"), cam_to_world=t("cam_to_world"),
            yfov=t("cam_yfov"), aspect=t("cam_aspect"),
            clusters=_clusters(tri, cluster or max(64, f // 128)),
            face_mtl=fm)

    @property
    def n_faces(self) -> int:
        return self.tri.shape[0]


def _clusters(tri, size: int):
    """The cull's clusters: runs of `size` consecutive slots among the
    small triangles, each with its box widened by CULL_MARGIN of the
    scene's extent, and one cluster without a box (tested by every ray)
    per run of triangles whose box spans over a tenth of the scene."""
    lo, hi = tri.amin(dim=1), tri.amax(dim=1)
    extent = float((hi.amax(0) - lo.amin(0)).amax())
    big = ((hi - lo).amax(dim=1) > 0.1 * extent).cpu()
    margin = CULL_MARGIN * max(extent, 1.0)
    out, f, s = [], tri.shape[0], 0
    while s < f:
        if bool(big[s]):
            e = s
            while e < f and bool(big[e]):
                e += 1
            out.append((s, e, None))
        else:
            e = s
            while e < f and not bool(big[e]) and e - s < size:
                e += 1
            box = torch.cat([lo[s:e].amin(0) - margin, hi[s:e].amax(0) + margin])
            out.append((s, e, box))
        s = e
    return out


# ---------------------------------------------------------------------------
# closest hit
# ---------------------------------------------------------------------------

def to_tf32(x):
    """x rounded to TF32 (8-bit exponent, 10 explicit mantissa bits),
    round to nearest even, kept in float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _entry(o, inv, box):
    """(near, far) of rays (o, 1/d [n, 3]) against a box [6]."""
    t0 = (box[0:3] - o) * inv
    t1 = (box[3:6] - o) * inv
    near = torch.fmax(torch.fmin(t0, t1), torch.full_like(t0, -BIG))
    far = torch.fmin(torch.fmax(t0, t1), torch.full_like(t0, BIG))
    return near.amax(dim=1), far.amin(dim=1)


def _woop_test(o, dirs, planes, tf32):
    """(t [n, k], ok [n, k]) per direction of rays from origins o [n, 3]
    against k planes [k, 12]."""
    if tf32:
        o, planes = to_tf32(o), to_tf32(planes)
        dirs = [to_tf32(d) for d in dirs]
    w = planes.T[:, None, :]                          # 12 x [1, k]
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    opx = ((ox * w[0] + oy * w[1]) + oz * w[2]) + w[3]
    opy = ((ox * w[4] + oy * w[5]) + oz * w[6]) + w[7]
    opz = ((ox * w[8] + oy * w[9]) + oz * w[10]) + w[11]
    out = []
    for d in dirs:
        dx, dy, dz = (d[:, i:i + 1] for i in range(3))
        dpx = (dx * w[0] + dy * w[1]) + dz * w[2]
        dpy = (dx * w[4] + dy * w[5]) + dz * w[6]
        dpz = (dx * w[8] + dy * w[9]) + dz * w[10]
        t = -opz / dpz
        u, v = t * dpx + opx, t * dpy + opy
        out.append((t, (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                    & (t > DELTA)))
    return out


def closest_hit(tab: Tables, o, dirs, masks, tf32=False, pairs=1 << 23):
    """Closest hits of rays leaving origins o [N, 3] along each of dirs
    (a list of [N, 3]), each with its mask [N] bool (False = miss).
    Returns per direction (slot [N] i64, -1 = miss; t [N]): the least t,
    and the lowest slot among equal t. Tests run in blocks of about
    `pairs` (ray, slot) pairs."""
    n, dev = o.shape[0], o.device
    q = len(dirs)
    best_t = torch.full((q, n), BIG, device=dev)
    best_s = torch.full((q, n), -1, dtype=torch.int64, device=dev)
    invs = []
    for d in dirs:
        zero = d == 0.0
        invs.append(torch.where(zero, BIG, 1.0 / torch.where(zero, 1.0, d)))
    for s, e, box in tab.clusters:
        need = []
        for k in range(q):
            m = masks[k]
            if box is not None:
                near, far = _entry(o, invs[k], box)
                m = m & (far >= torch.clamp_min(near, DELTA)) \
                    & (near <= best_t[k])
            need.append(m)
        rows = torch.stack(need).any(dim=0).nonzero()[:, 0]
        block = max(1024, pairs // (e - s))
        for r0 in range(0, rows.shape[0], block):
            r = rows[r0:r0 + block]
            res = _woop_test(o[r], [d[r] for d in dirs], tab.planes[s:e],
                             tf32)
            for k, (t, ok) in enumerate(res):
                t = torch.where(ok & need[k][r][:, None], t, BIG)
                tmin, arg = t.min(dim=1)           # first minimum: lowest slot
                take = tmin < best_t[k, r]
                best_t[k, r] = torch.where(take, tmin, best_t[k, r])
                best_s[k, r] = torch.where(take, s + arg, best_s[k, r])
    return [(torch.where(best_t[k] < BIG, best_s[k], -1), best_t[k])
            for k in range(q)]


def surface_terms(tab: Tables, slot, t_hit, o, d):
    """(t, u, v) of the hits of rays (o, d): the Woop values at their
    slot; t = 1, u = v = 0 on a miss."""
    hit = slot >= 0
    w = tab.planes[torch.clamp_min(slot, 0)].T
    dpx = (d[:, 0] * w[0] + d[:, 1] * w[1]) + d[:, 2] * w[2]
    dpy = (d[:, 0] * w[4] + d[:, 1] * w[5]) + d[:, 2] * w[6]
    opx = ((o[:, 0] * w[0] + o[:, 1] * w[1]) + o[:, 2] * w[2]) + w[3]
    opy = ((o[:, 0] * w[4] + o[:, 1] * w[5]) + o[:, 2] * w[6]) + w[7]
    t = torch.where(hit, t_hit, 1.0)
    u = torch.where(hit, t * dpx + opx, 0.0)
    v = torch.where(hit, t * dpy + opy, 0.0)
    return t, u, v


# ---------------------------------------------------------------------------
# shading
# ---------------------------------------------------------------------------

def _onb(n):
    """The reference's tangent frame (t, b) of unit normals [N, 3]:
    t = normalize((1, 0, -n.x / n.z)), or (0, 0, 1) where n.z == 0."""
    nx, nz = n[:, 0], n[:, 2]
    zz = nz == 0.0
    rx = torch.where(zz, 0.0, 1.0)
    rz = torch.where(zz, 1.0, -nx / torch.where(zz, 1.0, nz))
    r = torch.stack([rx, torch.zeros_like(rx), rz], 1)
    t = _unit(r)
    return t, _cross(t, n)


def cosine_sample(u1, u2, n):
    """Cosine-weighted direction around unit normals n [N, 3] and its
    pdf: phi = 2 pi u1, cos(theta) = sqrt(u2)."""
    phi = 2.0 * PI * u1
    cos_t = torch.sqrt(u2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))
    t, b = _onb(n)
    a, c = (torch.cos(phi) * sin_t)[:, None], (torch.sin(phi) * sin_t)[:, None]
    return (a * t + cos_t[:, None] * n) + c * b, cos_t * INV_PI


def bsdf_sample(u1, u2, u3, d, n, eta, metallic):
    """(next direction [N, 3], throughput ratio [N]) of the Fresnel-coin
    dielectric (eta > 0), the mirror (metallic > 0) or the cosine
    diffuse BSDF; the weight is base color times the ratio."""
    cos_i = _dot(d, n)
    refl = d - (2.0 * cos_i)[:, None] * n
    exiting = cos_i > 0.0
    ior = torch.where(eta > 0.0, eta, 1.0)
    e = torch.where(exiting, ior, 1.0 / ior)
    side = torch.where(exiting, -1.0, 1.0)[:, None] * n
    ci = torch.abs(cos_i)
    sin2 = e * e * (1.0 - ci * ci)
    tir = sin2 >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - torch.where(tir, 0.0, sin2), 0.0))
    refr = torch.where(tir[:, None], 0.0,
                       e[:, None] * d + (ci * e - cos_t)[:, None] * side)
    f0 = ((1.0 - e) / (1.0 + e)) ** 2
    m = torch.clamp(1.0 - ci, 0.0, 1.0)
    fr = torch.where(tir, 1.0, f0 + (1.0 - f0) * m * m * m * m * m)
    dielectric_dir = torch.where((u3 < fr)[:, None], refl, refr)
    ns = torch.where(cos_i > 0.0, -1.0, 1.0)[:, None] * n
    h, pdf = cosine_sample(u1, u2, ns)
    diff_ratio = (torch.abs(_dot(h, ns)) * INV_PI) / torch.clamp_min(pdf, 1e-12)
    dielectric = eta > 0.0
    mirror = ~dielectric & (metallic > 0.0)
    nd = torch.where(dielectric[:, None], dielectric_dir,
                     torch.where(mirror[:, None], refl, h))
    return nd, torch.where(dielectric | mirror, 1.0, diff_ratio)


def env_radiance(env, d):
    """Equirect lookup along unit directions [N, 3] (+Y up, u = atan2(z,
    x) / 2 pi wrapped to [0, 1), v = 1 - acos(y) / pi), point sampled."""
    h, w = env.shape[0], env.shape[1]
    u = torch.atan2(d[:, 2], d[:, 0]) * INV_2PI
    u = torch.where(u < 0.0, u + 1.0, u)
    v = 1.0 - torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) * INV_PI
    col = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp(((1.0 - v) * h).to(torch.int32), 0, h - 1).long()
    return _take(env.reshape(-1, 3), row * w + col)


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------

def camera_rays(tab: Tables, pix, keys, width: int, height: int):
    """Camera rays [N, 3] (origin, direction) of lanes at pixel ids pix
    [N] (row-major from the bottom row), jittered by the lanes' camera
    draws."""
    u = uniforms(fold_in(keys, CAM_TAG), 2)
    sensor_h = 2.0 * torch.tan(0.5 * tab.yfov)
    sensor_w = tab.aspect * sensor_h
    sx = ((pix % width).float() + u[:, 0]) / width * sensor_w
    sy = ((pix // width).float() + u[:, 1]) / height * sensor_h
    c = torch.stack([sx - 0.5 * sensor_w, sy - 0.5 * sensor_h,
                     -torch.ones_like(sx)], 1)
    rot = tab.cam_to_world[:3, :3]
    d = _unit((c[:, 0:1] * rot[:, 0] + c[:, 1:2] * rot[:, 1])
              + c[:, 2:3] * rot[:, 2])
    return tab.cam_to_world[:3, 3].expand_as(d), d


def lane_keys(key, pix, spp: int):
    """The keys of the lanes (pixel-major, spp samples a pixel) of pixel
    ids pix [P]: fold_in(fold_in(key, pixel), sample)."""
    lane_pix = pix.repeat_interleave(spp)
    s = torch.arange(spp, dtype=torch.int64, device=pix.device).repeat(
        pix.shape[0])
    return fold_in(fold_in(key, lane_pix), s), lane_pix


def trace(tab: Tables, o, d, keys, depth: int, tf32=False, stats=None):
    """Radiance [N, 3] of the paths from rays (o, d) with lane keys
    [N, 2]. stats: None or a dict that gains, per bounce, the lanes that
    go on ("live", hit and not emissive) and those of them on a diffuse
    surface ("diffuse"), and the lanes traced ("lanes")."""
    n = o.shape[0]
    r = to_tf32 if tf32 else (lambda x: x)
    thr = torch.ones((n, 3), device=o.device)
    rad = torch.zeros((n, 3), device=o.device)
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + n
        stats.setdefault("live", [0] * depth)
        stats.setdefault("diffuse", [0] * depth)
    for bounce in range(depth):
        if not bool(alive.any()):
            break
        u = uniforms(fold_in(keys, bounce), 6).T
        (slot, t_hit), = closest_hit(tab, o, [d], [alive], tf32)
        miss = slot < 0
        rad = r(rad + thr * torch.where((alive & miss)[:, None],
                                        env_radiance(tab.env, d), 0.0))
        t, bu, bv = surface_terms(tab, slot, t_hit, o, d)
        sc = torch.clamp_min(slot, 0)
        cn = tab.cnormal[sc]
        bw = 1.0 - bu - bv
        nrm = _unit((bw[:, None] * cn[:, 0] + bu[:, None] * cn[:, 1])
                    + bv[:, None] * cn[:, 2], 1e-20)
        h = r(o + t[:, None] * d)
        em = _take(tab.emission, sc)
        emissive = em > 0.0
        rad = r(rad + thr * torch.where(alive & ~miss & emissive, r(em),
                                        0.0)[:, None])
        eta, metal = tab.eta[sc], tab.metallic[sc]
        nd, ratio = bsdf_sample(u[0], u[1], u[2], d, nrm, eta, metal)
        nd = r(nd)
        sgn = torch.where(_dot(d, nrm) > 0.0, -1.0, 1.0)[:, None]
        d2, _ = cosine_sample(u[3], u[4], nrm * sgn)
        d2 = r(d2)
        live = alive & ~miss & ~emissive
        extra = ~((eta >= 1.0) | (metal > 0.0))
        (slot2, _), = closest_hit(tab, h, [d2], [live & extra], tf32)
        em2 = torch.where((slot2 >= 0) & extra,
                          _take(tab.emission, torch.clamp_min(slot2, 0)), 0.0)
        weight = r(_take(tab.base, sc) * ratio[:, None])
        rad = r(rad + torch.where(live[:, None],
                                  thr * weight * r(em2)[:, None], 0.0))
        o = torch.where(live[:, None], h, o)
        d = torch.where(live[:, None], nd, d)
        thr = torch.where(live[:, None], r(thr * weight), thr)
        alive = live
        if stats is not None:
            stats["live"][bounce] += int(live.sum())
            stats["diffuse"][bounce] += int((live & extra).sum())
    return rad


def render_pixels(tab: Tables, key, pix, width, height, spp, depth,
                  tf32=False, stats=None):
    """Mean radiance [P, 3] over spp samples of pixel ids pix [P]."""
    keys, lane_pix = lane_keys(key, pix, spp)
    o, d = camera_rays(tab, lane_pix, keys, width, height)
    rad = trace(tab, o, d, keys, depth, tf32, stats)
    return rad.reshape(-1, spp, 3).sum(dim=1) / spp
