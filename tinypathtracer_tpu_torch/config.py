"""Render configuration (port of `tinypathtracer_tpu/config.py`).

The TPU tuning fields of the JAX config (megakernel block width and
chunk size, slab gates, the packet traversal's `packet_*` knobs, the
deprecated pixel tiling, `mega_bwd`, `remat_chunks`) and its `TPT_*`
environment reads have no counterpart: the CUDA kernels take no tuning
knobs.
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
    # (render/integrator.py); "physical" is the physically correct one
    # (emissive-hit MIS, delta-light NEE with the cosine, environment
    # importance sampling, emissive-face NEE). The megakernel runs
    # reference mode only; physical mode runs the modular loop.
    mode: str = "reference"
    # "dense" tests every ray against every triangle (ops/dense.py) and
    # resolves to "packet" above 8192 padded faces
    # (render/renderer.resolve_intersector); "packet" forces the
    # near-to-far chunk walk (ops/packet.py); "bruteforce" is the plain
    # Moller-Trumbore oracle (ops/intersect.py); "bvh" the LBVH lockstep
    # walk (ops/traverse.py), an oracle of the LBVH build. The last two
    # run the modular loop, never the megakernel.
    intersector: str = "dense"
    # Stack slots per ray of the "bvh" walk: holds a tree of depth
    # stack_depth - 1 (the Renderer refuses a deeper tree).
    stack_depth: int = 32
    # Where the "bvh" intersector's tree is built: "device" in PyTorch
    # with the frame (ops/lbvh.py), "host" once per scene by the C++
    # builder (utils/native.py), its boxes padded by 1e-5 relative.
    bvh_source: str = "device"
    # (pixel, sample) lanes are processed in chunks of up to this many
    # rays; the cap bounds live ray-state memory. Images do not depend
    # on it (per-lane keys).
    rays_per_dispatch: int = 1 << 20
    # Environment light intensity scale applied on miss.
    env_scale: float = 1.0
    # Russian roulette is NOT part of the reference estimator; keep off
    # for parity. Physical mode only: from the fourth bounce a path
    # survives with probability max(throughput) clamped to [0.05, 1].
    russian_roulette: bool = False
    # Physical mode only: emissive-triangle next-event estimation with
    # MIS against BSDF sampling (power-weighted face sampling), the
    # correct version of the reference's extra BSDF-sampled direct ray
    # (path_tracer.cu:387-401). Off = BSDF sampling finds emitters by
    # luck.
    area_nee: bool = True
    # Base-color texture filtering: "point" fetches the nearest level-0
    # texel (the reference's cudaFilterModePoint, the parity default);
    # "bilinear" picks a mip level per lane from the hit distance and
    # the pixel's ray spread and filters bilinearly in the atlas mip
    # chain. Texel gradients flow through either.
    tex_filter: str = "point"
    # Trace the whole reference-mode bounce loop in one kernel launch
    # per chunk (ops/mega.py) when the scene qualifies (<= 8192 padded
    # faces, <= 6 delta lights; on a textured scene the kernel records
    # the hits and the shading replays on them). False forces the
    # modular per-bounce path on the dense closest-hit kernel.
    megakernel: bool = True

    def __post_init__(self):
        for name in ("width", "height", "spp", "max_depth",
                     "rays_per_dispatch", "stack_depth"):
            value = getattr(self, name)
            if not isinstance(value, int) or value < 1:
                raise ValueError(f"{name} must be a positive int: {value!r}")
        if self.mode not in ("reference", "physical"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.intersector not in _INTERSECTORS:
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.bvh_source not in ("device", "host"):
            raise ValueError(f"unknown bvh_source {self.bvh_source!r}")
        if self.tex_filter not in ("point", "bilinear"):
            raise ValueError(f"unknown tex_filter {self.tex_filter!r}")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
