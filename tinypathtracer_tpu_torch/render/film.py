"""Film: radiance sum -> image (port of `tinypathtracer_tpu/render/film.py`)."""

from __future__ import annotations


def to_image(radiance_sum, spp: int):
    """Mean radiance [H, W, 3], flipped to top-down rows."""
    return (radiance_sum / spp).flip(0)
