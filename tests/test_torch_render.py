"""The slice end to end: the port's Renderer on the CPU against the JAX
package's render_frame, same scene, same key.

JAX renders on the CPU through its modular path (`megakernel=False`)
and through its Pallas megakernel in interpret mode
(`mega_impl="interpret"`); the port renders through its modular path
and its megakernel twin. The target is atol 1e-5 on every pixel. The
hits are bit-equal by construction, but XLA:CPU fuses the shading
math's multiply-adds and approximates rsqrt, sin, cos, tan and atan2
differently from the port: paths agree to ulps, and one that grazes an
edge could in principle take another branch. The check therefore bounds
the share of pixels beyond 1e-5 (<= 0.5 %) and the mean abs difference
(< 1e-5); on these scenes every pixel is within 1e-5 (measured).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.render import film as jfilm
from tinypathtracer_tpu.render.renderer import render_frame as jax_render
from tinypathtracer_tpu_torch import RenderConfig, Renderer, prng_key
from tinypathtracer_tpu_torch.ops.dense import dense_hit
from tinypathtracer_tpu_torch.ops.mega import mega_trace

from _torch_scenes import jax_scene, port_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(width=16, height=16, spp=2, max_depth=4)


def _assert_close_images(got, want):
    diff = np.abs(got - want).max(axis=-1)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert (diff > 1e-5).mean() <= 0.005, f"max diff {diff.max()}"
    assert diff.mean() < 1e-5


@pytest.mark.parametrize("lights", [False, True])
@pytest.mark.parametrize("jax_path", ["modular", "mega_interpret"])
def test_render_matches_jax(jax_path, lights):
    flat = jax_scene(lights=lights)
    jcfg = JaxConfig(**SIZE, megakernel=jax_path != "modular",
                     mega_impl="interpret" if jax_path != "modular" else "off")
    want = np.asarray(jfilm.to_image(
        jax.jit(lambda s, k: jax_render(s, jcfg, k))(
            flat, jax.random.PRNGKey(3)), SIZE["spp"]))
    scene = port_scene(flat)
    for megakernel in (True, False):
        got = Renderer(RenderConfig(**SIZE, megakernel=megakernel),
                       device="cpu").render(scene, prng_key(3)).numpy()
        _assert_close_images(got, want)
    assert want.mean() > 0.05


def test_megakernel_and_modular_paths_agree():
    """The port's two paths share the hit arithmetic and the draws: on a
    scene without delta lights they give the same image bit for bit."""
    scene = port_scene(jax_scene())
    cfg = RenderConfig(width=12, height=10, spp=3, max_depth=5)
    a = Renderer(cfg, device="cpu").render(scene, prng_key(11))
    b = Renderer(dataclasses.replace(cfg, megakernel=False),
                 device="cpu").render(scene, prng_key(11))
    assert torch.equal(a, b)


def test_megakernel_and_modular_paths_agree_with_lights():
    """Both paths shade a bounce with the same helpers (integrator
    `scatter` and `end_bounce`), so with delta lights too the images are
    bit-equal: any-hit occlusion in one pass equals one closest-hit query
    per light."""
    scene = port_scene(jax_scene(lights=True))
    cfg = RenderConfig(width=12, height=10, spp=3, max_depth=5)
    a = Renderer(cfg, device="cpu").render(scene, prng_key(11))
    b = Renderer(dataclasses.replace(cfg, megakernel=False),
                 device="cpu").render(scene, prng_key(11))
    assert float(a.mean()) > 0.05
    assert torch.equal(a, b)


@pytest.mark.parametrize("megakernel", [True, False])
def test_image_independent_of_chunking(megakernel):
    scene = port_scene(jax_scene(lights=True))
    cfg = RenderConfig(width=9, height=7, spp=3, max_depth=3,
                       megakernel=megakernel)
    a = Renderer(cfg, device="cpu").render(scene, prng_key(5))
    b = Renderer(dataclasses.replace(cfg, rays_per_dispatch=20),
                 device="cpu").render(scene, prng_key(5))
    assert torch.equal(a, b)


def test_cpu_render_launches_no_kernel():
    """On CPU tensors the wrappers take the plain twins: no launch."""
    before = (dense_hit.launches, mega_trace.launches)
    Renderer(RenderConfig(width=4, height=4, spp=1, max_depth=2),
             device="cpu").render(port_scene(jax_scene()), prng_key(0))
    assert (dense_hit.launches, mega_trace.launches) == before


def test_port_imports_no_jax():
    """The port imports, renders and takes a train step with jax made
    unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tinypathtracer_tpu_torch as T\n"
        "img = T.Renderer(T.RenderConfig(width=4, height=4, spp=1, "
        "max_depth=2), device='cpu').render(T.sphere_grid_scene(1, 4, 8), "
        "T.prng_key(0))\n"
        "assert tuple(img.shape) == (4, 4, 3)\n"
        "import torch\n"
        "from tinypathtracer_tpu_torch.diff import (AdamState, Params, adam, "
        "make_train_step)\n"
        "scene = T.sphere_grid_scene(1, 4, 8)\n"
        "p = Params.from_scene(scene)\n"
        "_, _, loss = make_train_step(T.RenderConfig(width=4, height=4, "
        "spp=1, max_depth=2), adam(1e-2), device='cpu')(p, "
        "AdamState.init(p), scene, torch.zeros(4, 4, 3), T.prng_key(0))\n"
        "assert bool(torch.isfinite(loss))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_request_without_cuda_raises():
    """No hidden fallback: asking for a card that is not there raises
    instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(RenderConfig(), device="cuda")


def test_missing_toolkit_raises(monkeypatch, tmp_path):
    """Building a kernel without nvcc raises a clear error."""
    from tinypathtracer_tpu_torch.utils import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()
