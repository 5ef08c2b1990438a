"""LBVH: morton codes, the Karras build and the tree depth (port of
`tinypathtracer_tpu/ops/lbvh.py`).

Plain PyTorch, vectorized over all nodes as the JAX package writes it:
30-bit scene-normalized morton codes, a stable sort (ties keep face
order), Karras 2012 ranges and splits as fixed-trip masked loops over
the internal nodes, with the sorted-index tiebreak for equal codes, and
the bottom-up box fit as union sweeps to a fixpoint. The topology and
the boxes equal the JAX build's exactly (integer arithmetic, min / max).

Node layout (reference bvh.cuh:52-67): internal nodes [0, F-1), leaves
[F-1, 2F-1); node i is a leaf iff i >= F-1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinypathtracer_tpu_torch.utils.math3d import REAL_MAX


@dataclasses.dataclass
class BVH:
    """SoA LBVH over triangles. Node space: [0, F-1) internal, the rest
    leaves."""

    left: torch.Tensor       # [max(F-1, 1)] i32 child node index
    right: torch.Tensor      # [max(F-1, 1)] i32
    parent: torch.Tensor     # [2F-1] i32 (-1 for the root)
    leaf_fid: torch.Tensor   # [F] i32 original face id of leaf k (node F-1+k)
    bmin: torch.Tensor       # [2F-1, 3] f32
    bmax: torch.Tensor       # [2F-1, 3] f32
    tri_verts: torch.Tensor  # [F, 3, 3] f32, original face order

    @property
    def n_faces(self) -> int:
        return self.leaf_fid.shape[0]

    @classmethod
    def from_numpy(cls, arrays, device) -> "BVH":
        """From a dict of the fields as numpy arrays (a tree built by
        either package)."""
        out = {}
        for f in dataclasses.fields(cls):
            dtype = np.float32 if f.name in ("bmin", "bmax", "tri_verts") \
                else np.int32
            out[f.name] = torch.from_numpy(
                np.array(arrays[f.name], dtype=dtype, order="C")).to(device)
        return cls(**out)

    def to(self, device) -> "BVH":
        return BVH(**{f.name: getattr(self, f.name).to(device)
                      for f in dataclasses.fields(self)})


def tree_depth(bvh: BVH) -> int:
    """Max leaf depth (root = 0): a lockstep parent chase from every
    leaf. Validates traversal stack sizes before rendering: a Karras
    LBVH degenerates to depth ~F on adversarial inputs (collinear
    centroids build a comb)."""
    f = bvh.n_faces
    dev = bvh.parent.device
    nodes = (torch.arange(f - 1, 2 * f - 1, device=dev) if f > 1
             else torch.zeros((1,), dtype=torch.int64, device=dev))
    parent = bvh.parent.long()
    depth = 0
    while bool((nodes > 0).any()):
        live = nodes > 0
        nodes = torch.where(live, parent[nodes.clamp_min(0)], nodes)
        depth += 1
    return depth


def _expand_bits10(x):
    """Spread 10 bits to every 3rd bit of a 30-bit int32 (cf. bvh.cu:14-21)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(centroids, scene_min, scene_max):
    """30-bit int32 morton codes of centroids normalized to the scene
    AABB. Bit order matches bvh.cu:60: x | y<<1 | z<<2."""
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    q = (centroids - scene_min) / extent
    q = torch.clamp((q * 1024.0).to(torch.int32), 0, 1023)
    return (_expand_bits10(q[:, 0])
            | (_expand_bits10(q[:, 1]) << 1)
            | (_expand_bits10(q[:, 2]) << 2))


def clz32(x):
    """Count leading zeros of NON-NEGATIVE 32-bit values (any integer
    dtype), as the JAX package's shift ladder computes them."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        y = x >> s
        keep = y != 0
        n = torch.where(keep, n, n + s)
        x = torch.where(keep, y, x)
    return n + (x == 0).to(x.dtype)


def _make_delta(codes):
    """delta(i, j): common-prefix length of the codes of sorted leaves i
    and j, 32 + clz(i ^ j) on equal codes, -1 for j out of range."""
    f = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < f)
        js = j.clamp(0, f - 1)
        x = codes[i] ^ codes[js]
        d = torch.where(x == 0, 32 + clz32(i ^ js), clz32(x))
        return torch.where(valid, d, -1)

    return delta


def build_lbvh(tri_verts) -> BVH:
    """Build the LBVH of [F, 3, 3] world-space triangles."""
    f = tri_verts.shape[0]
    dev = tri_verts.device
    fb_min = tri_verts.amin(dim=1)                   # [F, 3] per-face AABB
    fb_max = tri_verts.amax(dim=1)
    centroids = 0.5 * (fb_min + fb_max)
    codes = morton30(centroids, fb_min.amin(dim=0), fb_max.amax(dim=0))
    order = torch.argsort(codes, stable=True)        # leaf k -> face id
    leaf_fid = order.int()
    if f == 1:                   # node 0 is the leaf and the root
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        return BVH(left=zero, right=zero.clone(), parent=zero - 1,
                   leaf_fid=leaf_fid, bmin=fb_min[order], bmax=fb_max[order],
                   tri_verts=tri_verts)

    # int64 indices; every value stays within int32, as in the JAX build
    delta = _make_delta(codes[order].long())
    i = torch.arange(f - 1, device=dev)
    # direction: +1 iff the right neighbour shares the longer prefix
    d = torch.where(delta(i, i + 1) >= delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)
    # exponential search for the range's upper bound: 24 doublings
    lmax = torch.full_like(i, 2)
    active = torch.ones_like(i, dtype=torch.bool)
    for _ in range(24):
        active = active & (delta(i, i + lmax * d) > delta_min)
        lmax = torch.where(active, lmax << 1, lmax)
    # binary search for the exact range end
    l, t = torch.zeros_like(i), lmax >> 1
    for _ in range(32):
        grow = (t > 0) & (delta(i, (l + t) * d + i) > delta_min)
        l, t = torch.where(grow, l + t, l), t >> 1
    j = i + l * d
    delta_node = delta(i, j)
    # split search (Karras gamma)
    s = torch.zeros_like(i)
    t = torch.where(l > 1, (l + 1) >> 1, l.clamp_max(1))
    for _ in range(32):
        step = (t > 0) & (delta(i, (s + t) * d + i) > delta_node)
        s = torch.where(step, s + t, s)
        t = torch.where(t > 1, (t + 1) >> 1, 0)
    gamma = i + s * d + d.clamp_max(0)
    left = torch.where(torch.minimum(i, j) == gamma, gamma + (f - 1), gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, gamma + f,
                        gamma + 1)
    parent = torch.full((2 * f - 1,), -1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i

    # bottom-up box fit: union sweeps over all internal nodes at once,
    # until nothing changes (at most the tree's height + 1 sweeps)
    big = torch.full((f - 1, 3), REAL_MAX, device=dev)
    bmin = torch.cat([big, fb_min[order]])
    bmax = torch.cat([-big, fb_max[order]])
    for _ in range(2 * f):
        new_min = torch.minimum(bmin[left], bmin[right])
        new_max = torch.maximum(bmax[left], bmax[right])
        changed = bool((new_min != bmin[:f - 1]).any()
                       | (new_max != bmax[:f - 1]).any())
        bmin[:f - 1], bmax[:f - 1] = new_min, new_max
        if not changed:
            break
    return BVH(left=left.int(), right=right.int(), parent=parent.int(),
               leaf_fid=leaf_fid, bmin=bmin, bmax=bmax, tri_verts=tri_verts)
