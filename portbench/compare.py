"""The comparison that decides `correct`: the program's outputs against
the plain reference (reference/), each number beside its limit.

Frame cells compare pixels of the timed frames, the same number drawn
from every chunk of the frame. The limits of a cell live in
limits/<cell>.json and were set from readings of sound runs, of the
control and of planted faults (readings.py, PERF.md).
"""

from __future__ import annotations

import math

import torch

# A pixel is off when a channel of its mean radiance differs from the
# reference's by more than PIXEL_TOL * (1 + |reference|): rounding moves
# a path's radiance by ~1e-6 of itself, a path that parts from the
# reference's moves its pixel by ~1/spp of the pixel.
PIXEL_TOL = 1e-4


def off_pixels(port, ref):
    """[P] bool: the pixels ([P, 3] means) off the reference (NaN is
    off)."""
    ok = (port - ref).abs() <= PIXEL_TOL * (1.0 + ref.abs())
    return ~ok.all(dim=1)


def frame_numbers(port, ref, chunk) -> dict:
    """pixels_off: the share of sampled pixels off the reference;
    chunk_off_max: the largest such share among the chunks (chunk [P]
    is each pixel's), which a fault confined to one chunk raises."""
    off = off_pixels(port, ref).double()
    n = int(chunk.max()) + 1
    count = torch.zeros(n, dtype=torch.float64).index_add_(0, chunk, off)
    size = torch.zeros(n, dtype=torch.float64).index_add_(
        0, chunk, torch.ones_like(off))
    return {"pixels_off": float(off.mean()),
            "chunk_off_max": float((count / size.clamp_min(1)).max())}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit; a number without a limit, or a limit without a
    number, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    ok = set(numbers) == set(limits) and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
