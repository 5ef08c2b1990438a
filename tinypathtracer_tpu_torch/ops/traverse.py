"""Ray-triangle recompute of the backward pass (port of the part of
`tinypathtracer_tpu/ops/traverse.py` that the training slice runs).

Only `_ray_tri_single` is ported: the Moller-Trumbore test of one
triangle per ray lane, which the integrator's `_HitSurface` backward
differentiates to carry gradients from the hit point to the ray and the
triangle. The LBVH traversal is a later port item (ROADMAP.md, 'LBVH and
oracles').
"""

from __future__ import annotations

import torch


def _ray_tri_single(o, d, v0, v1, v2):
    """Moller-Trumbore, one triangle per ray lane ([N, 3] everywhere).
    Returns (t, u, v, ok) [N]."""
    e1 = v1 - v0
    e2 = v2 - v0
    tvec = o - v0
    pvec = torch.linalg.cross(d, e2, dim=-1)
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    denom = (pvec * e1).sum(dim=-1)
    # both wheres: the unselected 1 / 0 would turn the backward's
    # 0 * inf into NaN
    zero = denom == 0.0
    inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, denom))
    u = (pvec * tvec).sum(dim=-1) * inv
    v = (qvec * d).sum(dim=-1) * inv
    t = (qvec * e2).sum(dim=-1) * inv
    ok = ~zero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok
