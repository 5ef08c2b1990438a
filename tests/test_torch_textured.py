"""Textured scenes: the port against the JAX package on the same scenes,
keys and parameters, on the CPU.

Two scenes: a textured quad glTF written here (tests/_torch_scenes.py
`write_textured_quad`, flattened by both packages' `load_scene`) and
`sphere_grid_scene(2, 4, 8, textured=True)` (396 faces; the 64x64
checker atlas on the diffuse materials, texcoords on the quads and
spheres). `flatten`, the procedural arrays and the texture fields of
`TraceData` equal JAX's exactly; frames match JAX's modular path within
1e-5 at 16x16 @4 spp d3 with both filters in both modes (the shading
is unfused here and FMA-fused by XLA); the megakernel twin route (the
save_hits twin run hits-only, then the shading replay on its hits)
equals the port's modular route bit for bit; texel, albedo and env
gradients match JAX to rtol 1e-4 and central differences; one Adam step
with `tex_atlas` matches optax's.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu import load_scene as jax_load_scene
from tinypathtracer_tpu.diff import invrender as jinv
from tinypathtracer_tpu.models.envlight import gradient_sky as jax_sky
from tinypathtracer_tpu.models.procedural import sphere_grid_scene as jax_grid
from tinypathtracer_tpu.render import integrator as jintegrator
from tinypathtracer_tpu.render.renderer import Renderer as JaxRenderer
from tinypathtracer_tpu_torch import (RenderConfig, Renderer, load_scene,
                                      prng_key, sphere_grid_scene)
from tinypathtracer_tpu_torch.diff import invrender as inv
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.render import renderer as rend
from tinypathtracer_tpu_torch.render.integrator import TraceData

from _torch_scenes import (LR, port_scene, to_numpy, train_setup,
                           write_textured_quad)

torch.set_num_threads(2)

SKY = (16, 32)
FRAME = dict(width=16, height=16, spp=4, max_depth=3)
SIZE = dict(width=12, height=12, spp=2, max_depth=3)
TEX_FIELDS = ("face_tex", "tex_atlas", "atlas_r", "atlas_g", "atlas_b",
              "atlas_mips_r", "atlas_mips_g", "atlas_mips_b", "face_duv",
              "cam_spread", "tri_verts", "face_emission")
FIELDS = [f.name for f in dataclasses.fields(inv.Params)]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{name: JAX FlatScene}: the written quad and the textured grid."""
    path = write_textured_quad(tmp_path_factory.mktemp("quad"))
    return {"quad": jax_load_scene(path).flatten(
                env_radiance=jax_sky(*SKY)),
            "quad_path": path,
            "grid": jax_grid(2, 4, 8, env_radiance=jax_sky(*SKY),
                             textured=True)}


def test_flatten_matches_jax(scenes):
    got = load_scene(scenes["quad_path"]).flatten(gradient_sky(*SKY),
                                                  device="cpu")
    want = scenes["quad"]
    assert got.has_textures and tuple(got.tex_atlas.shape) == (1, 8, 8, 3)
    for f in dataclasses.fields(got):
        assert np.array_equal(getattr(got, f.name).numpy(),
                              np.asarray(getattr(want, f.name))), f.name


def test_procedural_textured_matches_jax(scenes):
    """sphere_grid_scene(textured=True) builds JAX's arrays exactly."""
    got = sphere_grid_scene(2, 4, 8, env_radiance=gradient_sky(*SKY),
                            textured=True)
    want = to_numpy(scenes["grid"])
    for f in dataclasses.fields(got):
        assert np.array_equal(getattr(got, f.name).numpy(), want[f.name]), \
            f.name
    assert got.has_textures and got.mtl_tex_id.tolist() == [0, 0, 0, -1, -1]


@pytest.mark.parametrize("name", ["quad", "grid"])
def test_trace_data_matches_jax(scenes, name):
    """The texture fields of TraceData (and the texcoord rows 15-20 of
    shade_packT) equal JAX's jitted ones exactly; the corner normals
    rows within 2 ulp (XLA's rsqrt, tests/test_torch_scene.py)."""
    flat = scenes[name]
    want = jax.jit(jintegrator.TraceData.from_scene)(flat)
    got = TraceData.from_scene(port_scene(flat))
    assert got.textured
    for f in TEX_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    g, w = got.shade_packT.numpy(), np.asarray(want.shade_packT)
    assert g.shape == w.shape == (21, flat.indices.shape[0])
    np.testing.assert_array_equal(g[9:], w[9:])
    np.testing.assert_allclose(g[:9], w[:9], rtol=2.5e-7, atol=0)


def test_textured_scene_builds_without_textures_rows():
    """An untextured scene keeps its 15-row table and no texture work."""
    data = TraceData.from_scene(sphere_grid_scene(1, 6, 12))
    assert not data.textured and data.shade_packT.shape[0] == 15


def _jax_frame(flat, cfg, seed):
    jcfg = JaxConfig(**cfg, megakernel=False, mega_impl="off")
    return np.asarray(JaxRenderer(jcfg).render(flat, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("tex_filter", ["point", "bilinear"])
@pytest.mark.parametrize("mode", ["reference", "physical"])
@pytest.mark.parametrize("name", ["quad", "grid"])
def test_frames_match_jax(scenes, name, mode, tex_filter):
    flat = scenes[name]
    cfg = dict(FRAME, mode=mode, tex_filter=tex_filter)
    want = _jax_frame(flat, cfg, 3)
    got = Renderer(RenderConfig(**cfg), device="cpu").render(
        port_scene(flat), prng_key(3))
    assert torch.isfinite(got).all() and want.mean() > 0.02
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_filters_differ_and_texture_shows(scenes):
    """The texture reaches the image: the quad frame differs from the
    untextured one, and bilinear from point."""
    flat = port_scene(scenes["quad"])
    r = Renderer(RenderConfig(**FRAME), device="cpu")
    point = r.render(flat, prng_key(1))
    white = r.render(dataclasses.replace(flat,
                                         tex_atlas=torch.ones((1, 1, 1, 3))),
                     prng_key(1))
    bil = Renderer(RenderConfig(**FRAME, tex_filter="bilinear"),
                   device="cpu").render(flat, prng_key(1))
    assert float((point - white).abs().max()) > 0.05
    assert float((point - bil).abs().max()) > 1e-3


@pytest.mark.parametrize("tex_filter", ["point", "bilinear"])
@pytest.mark.parametrize("name", ["quad", "grid"])
def test_megakernel_route_equals_modular(scenes, name, tex_filter):
    """The megakernel twin route (hits-only save_hits, then the shading
    replay) equals the modular loop bit for bit."""
    flat = port_scene(scenes[name])
    cfg = RenderConfig(**FRAME, tex_filter=tex_filter)
    state = rend.prepare_state(flat, cfg)
    assert state.woop is not None and state.packet is None
    mega = Renderer(cfg, device="cpu").render(flat, prng_key(4))
    modular = Renderer(dataclasses.replace(cfg, megakernel=False),
                       device="cpu").render(flat, prng_key(4))
    assert torch.equal(mega, modular)


def test_megakernel_route_runs_save_hits(scenes, monkeypatch):
    """On a textured scene the route calls the megakernel with save_hits
    (and no forward instance) once per chunk."""
    from tinypathtracer_tpu_torch.ops import mega

    calls = []
    real = mega.mega_trace

    def spy(*args, **kw):
        calls.append(kw.get("save_hits", False))
        return real(*args, **kw)

    monkeypatch.setattr(mega, "mega_trace", spy)
    cfg = RenderConfig(**FRAME, rays_per_dispatch=512)
    Renderer(cfg, device="cpu").render(port_scene(scenes["grid"]),
                                       prng_key(2))
    assert calls == [True] * (FRAME["width"] * FRAME["height"]
                              * FRAME["spp"] // 512)


def _target(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((SIZE["height"], SIZE["width"], 3)).astype(np.float32)


@pytest.mark.parametrize("tex_filter", ["point", "bilinear"])
@pytest.mark.parametrize("megakernel", [True, False])
def test_grads_match_jax(scenes, megakernel, tex_filter):
    """Every Params leaf's gradient (texels, albedo, env among them)
    against JAX's modular path: rtol 1e-4, atol 1e-6 of the leaf's
    largest gradient; the loss within 1e-6 relative."""
    flat = scenes["grid"]
    cfg = dict(SIZE, tex_filter=tex_filter)
    jparams, _, params, _ = train_setup(flat)
    target = _target()
    fn = jax.jit(lambda p, s, t, k: jax.value_and_grad(jinv.mse_loss)(
        p, s, JaxConfig(**cfg, megakernel=False, mega_impl="off"), t, k))
    want_loss, want = fn(jparams, flat, jnp.asarray(target),
                         jax.random.PRNGKey(3))
    loss, got = inv.loss_and_grads(
        params, port_scene(flat), RenderConfig(**cfg, megakernel=megakernel),
        torch.from_numpy(target), prng_key(3))
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.isfinite(g).all(), f
        if f in ("tex_atlas", "mtl_base_color", "env_radiance"):
            assert np.abs(w).max() > 0, f
        if f == "cam_to_world":
            continue        # zero analytically without lights (train tests)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(initial=0.0),
                                   err_msg=f)


@pytest.mark.parametrize("tex_filter", ["point", "bilinear"])
def test_texel_grad_matches_central_differences(scenes, tex_filter):
    """The texel with the largest gradient against central differences
    of the port's own loss. A texel scales the base color of the hits
    that fetch it, so the loss is a low-order polynomial in it (nearly
    quadratic: few paths fetch one texel twice): with h = 0.25 the
    difference is within rtol 1e-4 of the gradient (measured within
    9e-7 relative)."""
    scene = port_scene(scenes["grid"])
    cfg = RenderConfig(**SIZE, tex_filter=tex_filter)
    params = inv.Params.from_scene(scene)
    target, key = torch.from_numpy(_target(4)), prng_key(6)
    _, grads = inv.loss_and_grads(params, scene, cfg, target, key)
    g = grads.tex_atlas.reshape(-1)
    i = int(g.abs().argmax())
    assert float(g[i]) != 0.0

    def loss_at(delta):
        x = params.tex_atlas.clone()
        x.view(-1)[i] += delta
        with torch.no_grad():
            return float(inv.mse_loss(
                dataclasses.replace(params, tex_atlas=x), scene, cfg, target,
                key))

    h = 0.25
    fd = (loss_at(h) - loss_at(-h)) / (2 * h)
    assert abs(fd - float(g[i])) <= 1e-4 * abs(float(g[i])), (fd, g[i])


def test_adam_step_matches_jax(scenes):
    """One train step from the same mid-training state: JAX's
    make_train_step with optax.adam against the port's make_train_step,
    the weights (tex_atlas among them) carried across by
    Params.from_numpy. rtol 1e-6 plus atol 1e-4 * lr on the new params
    (optax rounds Adam's bias corrections to float32, torch does not;
    tests/test_torch_train.py), the loss within 1e-6 relative."""
    flat = scenes["grid"]
    jparams, jstate, params, state = train_setup(flat, seed=5, steps=2)
    target = _target(7)
    jstep = jinv.make_train_step(
        JaxConfig(**SIZE, megakernel=False, mega_impl="off"), optax.adam(LR))
    want, _, want_loss = jstep(jparams, jstate, flat, jnp.asarray(target),
                               jax.random.PRNGKey(8))
    step = inv.make_train_step(RenderConfig(**SIZE), inv.adam(LR),
                               device="cpu")
    got, state2, loss = step(params, state, port_scene(flat),
                             torch.from_numpy(target), prng_key(8))
    assert state2.step == state.step + 1
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    moved = float((got.tex_atlas - params.tex_atlas).abs().max())
    assert moved > 0.5 * LR
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-4 * LR, err_msg=f)
