"""Film: radiance sum -> image (port of `tinypathtracer_tpu/render/film.py`).

The reference divides the accumulated radiance by spp, clamps it to
[0, 255] uchar and flips it vertically into its framebuffer
(path_tracer.cu:451-471); here the film returns the flipped mean image
and writes PNG files.
"""

from __future__ import annotations

import torch


def to_image(radiance_sum, spp: int):
    """Mean radiance [H, W, 3], flipped to top-down rows."""
    return (radiance_sum / spp).flip(0)


def tonemap_uint8(img):
    """Clamp to [0, 1] and quantize like Spectrum::toUChar
    (material.h:74-81): uint8 [H, W, 3] tensor on img's device."""
    return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)


def write_png(path: str, img) -> None:
    """Write a float [H, W, 3] image (top-down rows) as PNG."""
    from PIL import Image

    arr = tonemap_uint8(torch.as_tensor(img)).cpu().numpy()
    Image.fromarray(arr).save(path)
