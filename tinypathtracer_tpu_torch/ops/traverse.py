"""LBVH traversal and the ray-triangle recompute of the backward pass
(port of `tinypathtracer_tpu/ops/traverse.py`).

`closest_hit_bvh` is the lockstep stack walk: every lane advances one
node per step, its stack and running best hit in [N, ...] tensors, until
every stack is empty. It is an oracle for the LBVH build, not a fast
path: its hits are `ops/intersect.closest_hit_bruteforce`'s (the same
`moller_trumbore`), and the JAX package's bit for bit. Boxes behind the
origin or beyond the current best are culled; both children are tested
in one step and pushed left, then right.

`_ray_tri_single` is the unfused Moller-Trumbore of one triangle per
lane that the integrator's `_HitSurface` backward differentiates, to
carry gradients from the hit point to the ray and the triangle.
"""

from __future__ import annotations

import torch

from tinypathtracer_tpu_torch.ops.intersect import moller_trumbore
from tinypathtracer_tpu_torch.ops.lbvh import BVH
from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX


def _ray_box(o, inv_d, bmin, bmax, t_max):
    """Slab test with [DELTA, t_max] clipping. o, inv_d, bmin, bmax
    [N, 3], t_max [N]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (far >= near.clamp_min(DELTA)) & (near <= t_max)


def closest_hit_bvh(origins, dirs, bvh: BVH, stack_depth: int = 32,
                    mask=None):
    """Closest hit by the lockstep stack walk. origins, dirs: [N, 3].

    Returns (fid [N] i64, -1 on a miss; t [N], REAL_MAX on a miss; uv
    [N, 2]), as `closest_hit_bruteforce`. Lanes with mask=False start
    with an empty stack: no traversal, a miss. A stack of stack_depth
    slots holds a tree of depth stack_depth - 1 (the renderer checks)."""
    n, f = origins.shape[0], bvh.n_faces
    dev = origins.device
    n_leaf_base = f - 1                 # node >= this is a leaf
    zero_d = dirs == 0.0
    inv_d = torch.where(zero_d, REAL_MAX, 1.0 / torch.where(zero_d, 1.0, dirs))
    left, right = bvh.left.long(), bvh.right.long()
    leaf_fid = bvh.leaf_fid.long()
    rows = torch.arange(n, device=dev)

    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)   # [:, 0]: root 0
    if mask is not None:
        sp = torch.where(mask, sp, 0)
    best_t = torch.full((n,), REAL_MAX, device=dev)
    best_fid = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_uv = torch.zeros((n, 2), device=dev)

    while bool((sp > 0).any()):
        active = sp > 0
        node = stack[rows, (sp - 1).clamp_min(0)]
        sp = torch.where(active, sp - 1, sp)
        is_leaf = node >= n_leaf_base

        # leaf: one triangle test per lane
        fid = leaf_fid[(node - n_leaf_base).clamp(0, f - 1)]
        tri = bvh.tri_verts[fid]                           # [N, 3, 3]
        t, u, v, ok = moller_trumbore(origins, dirs, tri[:, 0], tri[:, 1],
                                      tri[:, 2])
        take = active & is_leaf & ok & (t > DELTA) & (t < best_t)
        best_uv = torch.where(take[:, None], torch.stack([u, v], -1), best_uv)
        best_fid = torch.where(take, fid, best_fid)
        best_t = torch.where(take, t, best_t)

        # internal: test both children, push the hit ones
        node_i = node.clamp(0, n_leaf_base - 1) if n_leaf_base > 0 else node
        intern = active & ~is_leaf
        for child in (left[node_i], right[node_i]):
            push = intern & _ray_box(origins, inv_d, bvh.bmin[child],
                                     bvh.bmax[child], best_t)
            slot = sp.clamp_max(stack_depth - 1)
            stack[rows, slot] = torch.where(push, child, stack[rows, slot])
            sp = torch.where(push, (sp + 1).clamp_max(stack_depth), sp)
    return best_fid, best_t, best_uv


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
