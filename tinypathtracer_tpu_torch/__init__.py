"""tinypathtracer_tpu_torch: the PyTorch + CUDA port of tinypathtracer_tpu.

A differentiable path tracer with hand-written Hopper kernels for its
hot loops: the dense closest hit (`csrc/dense.cu`), the path-tracing
megakernel (`csrc/mega.cu`) and the packet traversal (`csrc/packet.cu`).
The JAX package `tinypathtracer_tpu` is the reference this port is
tested against; this package never imports jax. Entry points run on the
card unless the caller passes device="cpu".

Public API:
    load_scene(path)                  -> Scene (host-side, numpy)
    Scene.flatten(env, device)        -> FlatScene (scene tensors on a device)
    RenderConfig(...)                 -> resolution / spp / depth / mode
    render(scene, cfg, key, env, device) -> image [H, W, 3]
    Camera(...)                       -> perspective camera
    FlatScene.from_numpy(arrays, dev) -> scene tensors on a device
    sphere_grid_scene(...)            -> procedural room scene
    prng_key(seed)                    -> frame key (== jax.random.PRNGKey)
    Renderer(cfg, device).render(scene, key) -> image [H, W, 3]
    Renderer(cfg, device).progressive()   -> resumable ProgressiveRender
    render_aov(scene, cfg, key, kind, device="cuda") -> an AOV
    save_pytree / load_pytree         -> Params / optimiser state checkpoints
    diff.make_train_step(cfg, diff.adam(lr)) -> train step (diff.sgd too)
    python -m tinypathtracer_tpu_torch.entry [multichip N] -> entry points
    StageTimer, RenderStats, timed_render, trace_profile -> metrics
    python -m tinypathtracer_tpu_torch.tools.render_cli -> the CLI
"""

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.camera import Camera
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.models.scene import FlatScene, Scene, load_scene
from tinypathtracer_tpu_torch.ops.sampling import prng_key
from tinypathtracer_tpu_torch.render.aov import AOV_KINDS, render_aov
from tinypathtracer_tpu_torch.render.renderer import (Renderer, render,
                                                      render_frame)
from tinypathtracer_tpu_torch.utils.checkpoint import (ProgressiveRender,
                                                       load_pytree,
                                                       save_pytree)
from tinypathtracer_tpu_torch.utils.metrics import (RenderStats, StageTimer,
                                                    timed_render,
                                                    trace_profile)

__all__ = ["RenderConfig", "Scene", "FlatScene", "load_scene", "Camera",
           "sphere_grid_scene", "prng_key", "Renderer", "render",
           "render_frame", "AOV_KINDS", "render_aov", "ProgressiveRender",
           "save_pytree", "load_pytree", "RenderStats", "StageTimer",
           "timed_render", "trace_profile"]
