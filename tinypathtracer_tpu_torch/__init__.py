"""tinypathtracer_tpu_torch: the PyTorch + CUDA port of tinypathtracer_tpu.

The reference-mode forward render path, with hand-written Hopper
kernels for the two hot loops: the dense closest hit (`csrc/dense.cu`)
and the path-tracing megakernel (`csrc/mega.cu`). The JAX package
`tinypathtracer_tpu` is the reference this port is tested against; this
package never imports jax.

Public API:
    RenderConfig(...)                 -> resolution / spp / depth config
    FlatScene.from_numpy(arrays, dev) -> scene tensors on a device
    sphere_grid_scene(...)            -> procedural room scene
    prng_key(seed)                    -> frame key (== jax.random.PRNGKey)
    Renderer(cfg, device).render(scene, key) -> image [H, W, 3]
"""

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.ops.sampling import prng_key
from tinypathtracer_tpu_torch.render.renderer import Renderer, render_frame

__all__ = ["RenderConfig", "FlatScene", "sphere_grid_scene", "prng_key",
           "Renderer", "render_frame"]
