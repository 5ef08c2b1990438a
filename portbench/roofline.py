"""Frozen copies of the roofline arithmetic the per-layer metrics use.

The peaks and the hit test's operation counts are copied from
`tinypathtracer_tpu_torch/tools/common.py` (FP32_PEAK, HBM_BYTES_PER_S,
OPS_ORIGIN, OPS_DIRECTION, `bound`), and `mega_work` from
`tinypathtracer_tpu_torch/tools/lab_mega.py` `mega_work`, both at commit
cfca82b. `mega_work` here takes path statistics (the lanes that go on
at each bounce, and those of them on a diffuse surface) instead of
kernel B's residuals, and counts real faces, not padding slots (padding
needs no work): the work the inputs need, whatever implements it.
"""

from __future__ import annotations

# H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
# fp32 operations of the Woop hit test, a fused multiply-add counted as
# 2 and the divide as 1: o' = W o + c once per distinct (origin,
# triangle), 18; a direction against it, 21 per (ray, triangle)
OPS_ORIGIN = 18
OPS_DIRECTION = 21


def bound(ops: float, nbytes: float) -> float:
    """The least time in seconds: the larger of operations over the fp32
    peak and bytes over the memory bandwidth."""
    return max(ops / FP32_PEAK, nbytes / HBM_BYTES_PER_S)


def mega_work(lanes: int, live, diffuse, depth: int, faces: int,
              origins: int = 1, n_lights: int = 0):
    """(operations, bytes) of reference-mode path tracing on `lanes`
    paths against `faces` triangles: the camera query of every lane (one
    origin transform per face for each of `origins` distinct camera
    origins), then per bounce on each live lane (live[d]: hit, not
    emissive) one origin transform per face, the next-direction query
    (not on the last bounce) and the extra emitter query on diffuse
    lanes (diffuse[d]); no delta lights (the configurations have none).
    Bytes: the camera rays and per-bounce uniforms read and the [16, N]
    output written per lane, the planes and shading rows of each face
    read once."""
    if n_lights:
        raise ValueError("mega_work counts no delta lights")
    n_origin = origins * faces
    n_dir = lanes * faces
    for d in range(depth):
        n_origin += live[d] * faces
        n_dir += (live[d] * (d + 1 < depth) + diffuse[d]) * faces
    nbytes = lanes * (32 + 32 * depth + 64) + faces * (48 + 128)
    return n_origin * OPS_ORIGIN + n_dir * OPS_DIRECTION, nbytes


def frame_work(stats: dict, width: int, height: int, spp: int, depth: int,
               faces: int, lanes_per_launch: int):
    """(operations, bytes) of one frame's path tracing, from the path
    statistics a sample of its lanes gave (the reference's `stats`),
    scaled to the frame's width * height * spp lanes, in launches of at
    most lanes_per_launch lanes (the faces' bytes are read by each)."""
    n = width * height * spp
    scale = n / stats["lanes"]
    ops, nbytes = 0.0, 0.0
    for start in range(0, n, lanes_per_launch):
        m = min(lanes_per_launch, n - start)
        f = m / n
        o, b = mega_work(m, [x * scale * f for x in stats["live"]],
                         [x * scale * f for x in stats["diffuse"]], depth,
                         faces)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
