"""Brute-force ray-primitive intersection: the all-triangles oracles
(port of `tinypathtracer_tpu/ops/intersect.py`).

Plain PyTorch: the JAX versions are XLA programs, not Pallas kernels.
Moller-Trumbore over a [rays x triangles] tile reduced with min/argmin.
Hit semantics (reference path_tracer.cu:81-89): accept denom != 0,
u >= 0, v >= 0, u + v <= 1 and DELTA < t < best; among equal t the lower
face id wins. `ops/traverse.closest_hit_bvh` has the same semantics.

The cross and dot products round as XLA:CPU rounds the JAX package's
`jnp.cross` / `jnp.sum(a * b)` inside its compiled scan
(`utils/math3d.vcross`, `vdot`), so the hits are the JAX oracle's bit
for bit.
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX, vcross, vdot


def moller_trumbore(o, d, v0, v1, v2):
    """Moller-Trumbore on [..., 3] rays and triangles that broadcast
    against each other. Returns (t, u, v, valid) of the broadcast shape.
    No backface culling; rejects denom == 0, u < 0, v < 0, u + v > 1.
    The t > DELTA window is the caller's."""
    e1, e2, tvec = v1 - v0, v2 - v0, o - v0
    pvec, qvec = vcross(d, e2), vcross(tvec, e1)
    denom = vdot(pvec, e1)
    zero = denom == 0.0
    inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, denom))
    u = vdot(pvec, tvec) * inv
    v = vdot(qvec, d) * inv
    t = vdot(qvec, e2) * inv
    return t, u, v, ~zero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


def ray_triangle(origins, dirs, v0, v1, v2):
    """Moller-Trumbore for a [N-ray x C-tri] tile: origins, dirs [N, 3];
    v0/v1/v2 [C, 3]. Returns (t, u, v, valid), each [N, C]."""
    return moller_trumbore(origins[:, None], dirs[:, None], v0[None],
                           v1[None], v2[None])


def ray_aabb(origins, inv_dirs, box_min, box_max):
    """Slab test for a [N-ray x C-box] tile (geometry_queries.h:18-46):
    the ray as a full line, IEEE semantics of the multiply. Returns the
    hit mask [N, C]."""
    t0 = (box_min[None] - origins[:, None]) * inv_dirs[:, None]
    t1 = (box_max[None] - origins[:, None]) * inv_dirs[:, None]
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return near <= far


def closest_hit_bruteforce(origins, dirs, tri_verts, chunk: int = 512,
                           mask=None):
    """Exact closest hit against every triangle.

    origins, dirs: [N, 3]; tri_verts: [F, 3, 3]. Returns (fid [N] i64,
    -1 on a miss; t [N], REAL_MAX on a miss; uv [N, 2]). Lanes with
    mask=False report a miss (they are computed all the same). Faces are
    scanned `chunk` at a time, the running minimum carried across."""
    n, f = origins.shape[0], tri_verts.shape[0]
    dev = origins.device
    best_t = torch.full((n,), REAL_MAX, device=dev)
    best_fid = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_uv = torch.zeros((n, 2), device=dev)
    rows = torch.arange(n, device=dev)
    for f0 in range(0, f, chunk):
        tris = tri_verts[f0:f0 + chunk]
        t, u, v, valid = ray_triangle(origins, dirs, tris[:, 0], tris[:, 1],
                                      tris[:, 2])
        t = torch.where(valid & (t > DELTA), t, REAL_MAX)
        amin = torch.argmin(t, dim=1)                # first index of the min
        cand = t[rows, amin]
        better = cand < best_t
        best_uv = torch.where(better[:, None],
                              torch.stack([u[rows, amin], v[rows, amin]], 1),
                              best_uv)
        best_fid = torch.where(better, f0 + amin, best_fid)
        best_t = torch.where(better, cand, best_t)
    if mask is not None:
        best_fid = torch.where(mask, best_fid, -1)
        best_t = torch.where(mask, best_t, REAL_MAX)
        best_uv = torch.where(mask[:, None], best_uv, 0.0)
    return best_fid, best_t, best_uv


def any_hit_bruteforce(origins, dirs, tri_verts, chunk: int = 512):
    """Occlusion: does any triangle intersect with t > DELTA? No
    max-distance clip (the reference's quirk: geometry beyond a point
    light occludes it)."""
    fid, _, _ = closest_hit_bruteforce(origins, dirs, tri_verts, chunk=chunk)
    return fid >= 0


def gather_tri_verts(world_vertices, indices):
    """[F, 3, 3] face-major triangle vertices from a shared vertex buffer."""
    return world_vertices[indices.long()]
