"""Environment (dome) light (port of `tinypathtracer_tpu/models/envlight.py`).

Only the procedural sky is ported; the miss lookup lives in
`ops/shading_c.env_texel_c`. Image loading and the importance-sampling
tables (physical mode) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def gradient_sky(height: int = 64, width: int = 128,
                 horizon=(0.8, 0.75, 0.7), zenith=(0.25, 0.45, 0.85),
                 device="cpu") -> torch.Tensor:
    """Procedural sky dome [H, W, 3] float32, row 0 = zenith. Built with
    numpy in float64 exactly as the JAX package builds it."""
    t = np.linspace(1.0, 0.0, height)[:, None, None]
    sky = t * np.asarray(zenith)[None, None, :] \
        + (1 - t) * np.asarray(horizon)[None, None, :]
    sky = np.broadcast_to(sky, (height, width, 3)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(sky)).to(device)
