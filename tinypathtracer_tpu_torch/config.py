"""Render configuration (port of `tinypathtracer_tpu/config.py`).

Only the knobs of the ported slices exist here. The TPU tuning fields
of the JAX config (megakernel block width and chunk size, slab gates,
the packet traversal's `packet_*` knobs, pixel tiling) and its `TPT_*`
environment reads have no counterpart: the CUDA kernels take no tuning
knobs yet.
"""

from __future__ import annotations

import dataclasses

_INTERSECTORS = ("dense", "packet", "bvh", "bruteforce")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render pipeline instance."""

    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 8
    # "reference" reproduces the CUDA reference estimator with its quirks
    # (render/integrator.py). "physical" is not ported yet.
    mode: str = "reference"
    # "dense" tests every ray against every triangle (ops/dense.py) and
    # resolves to "packet" above 8192 padded faces
    # (render/renderer.resolve_intersector); "packet" forces the
    # near-to-far chunk walk (ops/packet.py). The LBVH and brute-force
    # intersectors are not ported yet.
    intersector: str = "dense"
    # (pixel, sample) lanes are processed in chunks of up to this many
    # rays; the cap bounds live ray-state memory. Images do not depend
    # on it (per-lane keys).
    rays_per_dispatch: int = 1 << 20
    # Environment light intensity scale applied on miss.
    env_scale: float = 1.0
    # Trace the whole reference-mode bounce loop in one kernel launch
    # per chunk (ops/mega.py) when the scene qualifies (<= 8192 padded
    # faces, <= 6 delta lights). False forces the modular per-bounce
    # path on the dense closest-hit kernel.
    megakernel: bool = True

    def __post_init__(self):
        for name in ("width", "height", "spp", "max_depth",
                     "rays_per_dispatch"):
            value = getattr(self, name)
            if not isinstance(value, int) or value < 1:
                raise ValueError(f"{name} must be a positive int: {value!r}")
        if self.mode == "physical":
            raise NotImplementedError(
                "mode='physical' is not ported yet (ROADMAP.md, port item "
                "'Physical mode')")
        if self.mode != "reference":
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.intersector not in _INTERSECTORS:
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.intersector not in ("dense", "packet"):
            raise NotImplementedError(
                f"intersector={self.intersector!r} is not ported yet "
                "(ROADMAP.md, port item 1.6 'LBVH and oracles')")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
