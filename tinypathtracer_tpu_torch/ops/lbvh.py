"""Morton codes (port of `tinypathtracer_tpu/ops/lbvh.py:84-106`).

Only what the dense intersector's slot order needs is ported; the LBVH
build itself is a later port item.
"""

from __future__ import annotations

import torch


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
