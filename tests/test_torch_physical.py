"""The physical estimator: the port's samplers, BSDF, environment
sampling, emissive-face tables, physical frames and gradients on the
CPU against the JAX package's `mode="physical"`, same scenes, keys and
arrays.

Keyed draws match bit for bit (the port's threefry is jax's). The
environment's sampling tables and the emissive-face cdf are the JAX
package's bit for bit on power-of-two maps (the port sums in XLA:CPU's
order, `utils/math3d.xla_sum` / `xla_cumsum`), so every lane samples
the same texel and face; the frames use the 64x128 sky for that. JAX's
shading is FMA-fused by XLA and the port's is not, so frames agree
within 1e-5 (measured max 2.1e-6) and gradients within rtol 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.diff import invrender as jinv
from tinypathtracer_tpu.models import envlight as jenv
from tinypathtracer_tpu.ops import bsdf as jbsdf
from tinypathtracer_tpu.ops import sampling as jsamp
from tinypathtracer_tpu.render import film as jfilm
from tinypathtracer_tpu.render import integrator as jintegrator
from tinypathtracer_tpu.render import raygen as jraygen
from tinypathtracer_tpu.render.renderer import render_frame as jax_render
from tinypathtracer_tpu_torch import RenderConfig, Renderer, prng_key
from tinypathtracer_tpu_torch.diff import invrender as inv
from tinypathtracer_tpu_torch.models import envlight as env
from tinypathtracer_tpu_torch.ops import bsdf, sampling
from tinypathtracer_tpu_torch.render import raygen, renderer
from tinypathtracer_tpu_torch.render.integrator import TraceData
from tinypathtracer_tpu_torch.utils.math3d import xla_cumsum, xla_sum

from _torch_scenes import jax_scene, port_scene, train_setup

torch.set_num_threads(2)

SIZE = dict(width=16, height=16, spp=4, max_depth=4)
GRAD_SIZE = dict(width=12, height=12, spp=2, max_depth=3)
FIELDS = [f.name for f in dataclasses.fields(inv.Params)]


def _scene(lights=False, sky=(64, 128), grid=(1, 6, 12)):
    """The JAX room (optionally with the three delta lights) under a
    gradient sky of the given size."""
    return dataclasses.replace(jax_scene(*grid, lights=lights),
                               env_radiance=jnp.asarray(jenv.gradient_sky(*sky)))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- samplers and BSDF -------------------------------------------------------

@pytest.mark.parametrize("draw", ["uniform2", "hemisphere_cosine",
                                  "hemisphere_uniform", "coin_flip",
                                  "triangle_uniform", "split",
                                  "camera_rays", "bounce_uniforms"])
def test_keyed_draws_match_jax(draw):
    """Each keyed sampler from the same key: the uniforms bit for bit,
    the directions and points they map to within 1e-6 (XLA fuses the
    frame's multiply-adds and approximates rsqrt)."""
    key = jax.random.PRNGKey(17)
    pkey = prng_key(17)
    rng = np.random.default_rng(1)
    n = rng.normal(size=(300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:2, 2] = 0.0
    v = rng.normal(size=(3, 300, 3)).astype(np.float32)
    if draw == "bounce_uniforms":
        # the physical bounce's 9 uniform rows, lane keys folded with the
        # depth as the integrator folds them
        keys = jax.random.split(key, 257)
        want = jax.jit(lambda k: jsamp.lane_uniform(jsamp.fold_all(k, 3), 9))(
            keys)
        got = sampling.lane_uniform(sampling.fold_all(
            torch.from_numpy(np.asarray(keys).astype(np.int64)), 3), 9)
        assert np.array_equal(got.numpy(), np.asarray(want))
        return
    if draw == "split":
        assert np.array_equal(sampling.split(pkey, 5).numpy(), np.asarray(
            jax.random.split(key, 5)).astype(np.int64))
        return
    if draw == "uniform2":
        want = jax.jit(jsamp.uniform2, static_argnums=1)(key, (7, 9))
        got = sampling.uniform2(pkey, (7, 9))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        return
    if draw == "coin_flip":
        p = rng.random(300).astype(np.float32)
        assert np.array_equal(
            sampling.coin_flip(pkey, _t(p)).numpy(),
            np.asarray(jax.jit(jsamp.coin_flip)(key, jnp.asarray(p))))
        return
    if draw == "camera_rays":
        px = np.arange(300) % 20
        py = np.arange(300) // 20
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.0, 1.0, -4.0]
        args = (c2w, np.float32(1.1), np.float32(1.25), px, py, 20, 15)
        want = jax.jit(jraygen.camera_rays, static_argnums=(6, 7))(
            key, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args))
        got = raygen.camera_rays(pkey, _t(c2w), _t(args[1]), _t(args[2]),
                                 _t(px), _t(py), 20, 15)
    elif draw == "triangle_uniform":
        want = (jax.jit(jsamp.triangle_uniform)(key, *map(jnp.asarray, v)),)
        got = (sampling.triangle_uniform(pkey, *map(_t, v)),)
    else:
        want = jax.jit(getattr(jsamp, draw))(key, jnp.asarray(n))
        got = getattr(sampling, draw)(pkey, _t(n))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_bsdf_matches_jax():
    """refract_reference, schlick_fresnel and sample_bsdf (keyed) on
    dielectric, mirror and diffuse lanes: directions and weights within
    1e-6, the specular flags exactly."""
    rng = np.random.default_rng(2)
    m = 400
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    eta = np.where(rng.random(m) < 0.4, rng.uniform(1.1, 2.4, m),
                   0.0).astype(np.float32)
    metal = (rng.random(m) < 0.3).astype(np.float32)
    base = rng.random((m, 3)).astype(np.float32)
    want = jax.jit(jbsdf.refract_reference)(*map(jnp.asarray, (d, nrm, eta)))
    got = bsdf.refract_reference(*map(_t, (d, nrm, eta)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    ci, er = rng.random(m).astype(np.float32), rng.uniform(
        0.3, 2.5, m).astype(np.float32)
    np.testing.assert_allclose(
        bsdf.schlick_fresnel(_t(ci), _t(er)).numpy(),
        np.asarray(jax.jit(jbsdf.schlick_fresnel)(ci, er)), rtol=0, atol=1e-6)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jbsdf.sample_bsdf)(key, *map(jnp.asarray,
                                                (d, nrm, eta, metal, base)))
    got = bsdf.sample_bsdf(prng_key(4), *map(_t, (d, nrm, eta, metal, base)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and (~got[2]).any()


# ---- environment sampling ----------------------------------------------------

def _jax_tables(sky):
    fn = jax.jit(lambda a: (lambda t: (t.marginal_cdf, t.conditional_cdf,
                                       t.pdf))(jenv.build_env_tables(a)))
    return [np.asarray(x) for x in fn(jnp.asarray(sky))]


@pytest.mark.parametrize("sky", ["gradient_64x128", "random_32x64",
                                 "random_16x32", "random_50x100"])
def test_env_tables_match_jax(sky):
    """build_env_tables against the JAX package's, jitted. Power-of-two
    maps: every entry bit for bit. Other widths: XLA's row sum pads its
    windows in an order not reproduced (ROADMAP section 3), so the
    marginal cdf may differ by ulps, and the pdf through its total; the
    conditional cdf stays exact; bound 2.4e-7 relative (2 ulps)."""
    rng = np.random.default_rng(3)
    arr = {"gradient_64x128": jenv.gradient_sky(64, 128),
           "random_32x64": (rng.random((32, 64, 3)) ** 3).astype(np.float32),
           "random_16x32": rng.random((16, 32, 3)).astype(np.float32),
           "random_50x100": rng.random((50, 100, 3)).astype(np.float32)}[sky]
    want = _jax_tables(arr)
    t = env.build_env_tables(_t(arr))
    got = [x.detach().numpy() for x in (t.marginal_cdf, t.conditional_cdf,
                                       t.pdf)]
    assert np.array_equal(got[1], want[1])
    for g, w in (got[0], want[0]), (got[2], want[2]):
        if sky == "random_50x100":
            np.testing.assert_allclose(g, w, rtol=2.4e-7, atol=0)
        else:
            assert np.array_equal(g, w)


def test_sample_env_u_on_jax_tables():
    """sample_env_u on the JAX package's own tables: the texel picked
    (row, col) exactly, the pdf exactly (a gather), the directions within
    1e-6 (the port's texel-centre sines and cosines are glibc's, as
    XLA:CPU's: measured exact)."""
    sky = jenv.gradient_sky(64, 128)
    sky = sky * np.random.default_rng(5).uniform(0.2, 1.0, sky.shape[:2]
                                                 )[..., None]
    sky = sky.astype(np.float32)
    m, c, p = _jax_tables(sky)
    u = np.random.default_rng(6).random((5000, 2)).astype(np.float32)
    wd, wp = jax.jit(lambda u_, *t: jenv.sample_env_u(
        u_, jenv.EnvSamplingTables(*t)))(*map(jnp.asarray, (u, m, c, p)))
    tables = env.EnvSamplingTables(_t(m), _t(c), _t(p))
    gd, gp = env.sample_env_u(_t(u), tables)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-6)
    # the texel each direction falls in is the one each package picked
    uv_g = [x.numpy() for x in env.dir_to_uv(gd)]
    uv_w = [np.asarray(x) for x in jenv.dir_to_uv(wd)]
    for a, b, size in zip(uv_g, uv_w, (128, 64)):
        assert np.array_equal(np.floor(a * size), np.floor(b * size))


def test_env_lookup_and_sample_env_keyed():
    sky = jenv.gradient_sky(16, 32)
    sky = (sky * np.linspace(0.1, 1.0, 32)[None, :, None]).astype(np.float32)
    dirs = np.random.default_rng(7).normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jax.jit(jenv.env_lookup)(jnp.asarray(sky),
                                               jnp.asarray(dirs)))
    assert np.array_equal(env.env_lookup(_t(sky), _t(dirs)).numpy(), want)
    tables = _jax_tables(sky)
    wd, wp = jax.jit(lambda k, *t: jenv.sample_env(
        k, jenv.EnvSamplingTables(*t), 700))(jax.random.PRNGKey(8),
                                            *map(jnp.asarray, tables))
    gd, gp = env.sample_env(prng_key(8),
                            env.EnvSamplingTables(*map(_t, tables)), 700)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


def test_own_tables_pick_the_same_texels():
    """The prefix sums' rounding: sample_env_u on the port's own tables
    against JAX's tables, same uniforms. Power-of-two maps: the tables
    are equal, so no lane's pick differs. The 50x100 map (marginal cdf
    off by ulps, see test_env_tables_match_jax): the lanes whose pick
    differs are counted, 0 of 2**16 here (measured), at most 0.1 %."""
    u = np.random.default_rng(9).random((1 << 16, 2)).astype(np.float32)
    for shape, limit in (((64, 128), 0), ((16, 32), 0), ((50, 100), 66)):
        sky = (np.random.default_rng(10).random(shape + (3,)) ** 2).astype(
            np.float32)
        d_j, _ = env.sample_env_u(_t(u), env.EnvSamplingTables(
            *map(_t, _jax_tables(sky))))
        d_p, _ = env.sample_env_u(_t(u), env.build_env_tables(_t(sky)))
        differ = int((d_j != d_p).any(dim=1).sum())
        assert differ <= limit, (shape, differ)


# ---- emissive-face tables ----------------------------------------------------

@pytest.mark.parametrize("grid", [(1, 6, 12), (2, 8, 16)])
def test_trace_data_tables_match_jax(grid):
    """face_area, em_cdf, em_power and the 16x32 sky's sampling tables
    against the JAX TraceData: exact (the cross product and norm fused as
    XLA fuses them, the sums in XLA's order); the emission spread over
    every face by a seeded material table, so the cdf has many nonzero
    steps."""
    flat = jax_scene(*grid)
    rng = np.random.default_rng(11)
    flat = dataclasses.replace(flat, mtl_emission=jnp.asarray(
        rng.random(flat.mtl_emission.shape).astype(np.float32)))
    want = jax.jit(jintegrator.TraceData.from_scene)(flat)
    got = TraceData.from_scene(port_scene(flat))
    for name in ("face_area", "em_cdf", "em_power"):
        assert np.array_equal(getattr(got, name).detach().numpy(),
                              np.asarray(getattr(want, name))), name
    for name, jname in (("marginal_cdf", "env_marginal_cdf"),
                        ("conditional_cdf", "env_conditional_cdf"),
                        ("pdf", "env_pdf")):
        assert np.array_equal(getattr(got.env_tables, name).detach().numpy(),
                              np.asarray(getattr(want, jname))), name


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 1804, 61452])
def test_xla_sums_match_jax(n):
    """xla_cumsum and xla_sum against jitted jnp.cumsum / jnp.sum on
    seeded sparse weights (the em_cdf case), bit for bit."""
    rng = np.random.default_rng(n)
    x = (rng.random(n) * (rng.random(n) < 0.3)).astype(np.float32)
    assert np.array_equal(xla_cumsum(_t(x)).numpy(),
                          np.asarray(jax.jit(jnp.cumsum)(x)))
    rows = rng.random((3, 1 << (n % 5 + 6))).astype(np.float32)
    assert np.array_equal(xla_sum(_t(rows)).numpy(), np.asarray(
        jax.jit(lambda a: jnp.sum(a, axis=1))(rows)))


# ---- frames ------------------------------------------------------------------

FRAME_CASES = {
    "room": dict(),
    "room-no-area-nee": dict(area_nee=False),
    "room-roulette": dict(russian_roulette=True, max_depth=6),
    "room-packet": dict(intersector="packet"),
    "room-bvh": dict(intersector="bvh"),
    "lights": dict(lights=True),
    "lights-no-area-nee": dict(lights=True, area_nee=False),
    "lights-roulette-bvh": dict(lights=True, russian_roulette=True,
                                max_depth=6, intersector="bvh"),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_physical_frame_matches_jax(case):
    """The port's physical frame against JAX `mode="physical"` (its
    modular path) on the room and the 3-light room: every pixel within
    1e-5."""
    kw = dict(FRAME_CASES[case])
    flat = _scene(lights=kw.pop("lights", False))
    size = dict(SIZE, max_depth=kw.pop("max_depth", SIZE["max_depth"]))
    jcfg = JaxConfig(**size, mode="physical", megakernel=False,
                     mega_impl="off", **kw)
    want = np.asarray(jfilm.to_image(jax.jit(
        lambda s, k: jax_render(s, jcfg, k))(flat, jax.random.PRNGKey(3)),
        size["spp"]))
    got = Renderer(RenderConfig(**size, mode="physical", **kw),
                   device="cpu").render(port_scene(flat), prng_key(3))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want.mean() > 0.05


def test_physical_frame_runs_the_modular_loop(monkeypatch):
    """mega_available refuses physical mode: the frame never reaches the
    megakernel (twin or kernel B), and each bounce makes 3 + L closest-hit
    queries (main ray, the L delta lights, environment NEE, area NEE),
    the NEE queries masked to the diffuse lanes."""
    def no_mega(*args, **kwargs):
        raise AssertionError("the megakernel ran in physical mode")

    monkeypatch.setattr(renderer, "trace_paths_mega", no_mega)
    calls = []
    hit = renderer.hit_fn

    def counting_hit_fn(state, cfg):
        fn = hit(state, cfg)

        def counted(o, d, mask=None):
            calls.append(None if mask is None else int(mask.sum()))
            return fn(o, d, mask=mask)
        return counted

    monkeypatch.setattr(renderer, "hit_fn", counting_hit_fn)
    flat = port_scene(_scene(lights=True))
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3,
                       mode="physical")
    Renderer(cfg, device="cpu").render(flat, prng_key(1))
    per_bounce = 3 + flat.light_kind.shape[0]
    assert len(calls) == cfg.max_depth * per_bounce
    for b in range(cfg.max_depth):
        main, *nee = calls[b * per_bounce:(b + 1) * per_bounce]
        assert all(q <= main for q in nee)
    # the reference mode on the same scene goes through the megakernel
    with pytest.raises(AssertionError, match="megakernel ran"):
        Renderer(dataclasses.replace(cfg, mode="reference"),
                 device="cpu").render(flat, prng_key(1))


def test_dense_and_bruteforce_differ_only_on_self_hits():
    """chip_smoke's phase 21 check on the CPU: every query of a physical
    trace on the dense route answered by the brute force too. The two
    round a ray-triangle test differently; where their faces differ one
    of the hits lies within SELF_HIT_T of the ray's origin (a ray grazing
    the surface it leaves or a neighbouring facet; 16 such pairs here,
    measured, and none other)."""
    from chip_smoke import SELF_HIT_T, oracle_disagreements

    room = port_scene(_scene())
    cfg = RenderConfig(width=24, height=24, spp=4, max_depth=5,
                       mode="physical")
    pairs, unexplained = oracle_disagreements(room, cfg, prng_key(3),
                                              torch.device("cpu"))
    assert unexplained == 0, (pairs, unexplained, SELF_HIT_T)
    assert pairs > 0


def test_reference_branch_unchanged_by_physical_tables():
    """The reference branch ignores the physical tables: the megakernel
    twin and the modular loop still give bit-equal frames."""
    flat = port_scene(_scene(lights=True))
    cfg = RenderConfig(width=10, height=8, spp=2, max_depth=4)
    a = Renderer(cfg, device="cpu").render(flat, prng_key(2))
    b = Renderer(dataclasses.replace(cfg, megakernel=False),
                 device="cpu").render(flat, prng_key(2))
    assert torch.equal(a, b)


# ---- gradients ---------------------------------------------------------------

@pytest.mark.parametrize("lights", [False, True])
def test_physical_grads_match_jax(lights):
    """mse_loss's gradient in physical mode against jax.grad of the JAX
    package's (modular path): per leaf rtol 1e-4 with atol 1e-6 * max|g|,
    the loss within 1e-6 relative. env_radiance's gradient reaches the
    map through the environment-NEE pdf as well (not detached). Every
    leaf carries gradient but tex_atlas: this scene is untextured, its
    [1, 1, 1, 3] sentinel atlas is never read (zero in both packages)."""
    flat = _scene(lights=lights)
    jparams, _, params, _ = train_setup(flat)
    target = np.random.default_rng(12).random(
        (GRAD_SIZE["height"], GRAD_SIZE["width"], 3)).astype(np.float32)
    jcfg = JaxConfig(**GRAD_SIZE, mode="physical", megakernel=False,
                     mega_impl="off")
    fn = jax.jit(lambda p, s, t, k: jax.value_and_grad(jinv.mse_loss)(
        p, s, jcfg, t, k))
    want_loss, want = fn(jparams, flat, jnp.asarray(target),
                         jax.random.PRNGKey(3))
    loss, got = inv.loss_and_grads(
        params, port_scene(flat), RenderConfig(**GRAD_SIZE, mode="physical"),
        torch.from_numpy(target), prng_key(3))
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), f
        if w.size:
            assert (np.abs(w).max() > 0) == (f != "tex_atlas"), f
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f)


def test_env_pdf_keeps_its_gradient():
    """Only the picks are detached in environment sampling: the pdf of a
    drawn texel has a gradient to the map (JAX does not stop it)."""
    sky = env.gradient_sky(16, 32).requires_grad_()
    u = torch.from_numpy(np.random.default_rng(13).random(
        (64, 2)).astype(np.float32))
    _, pdf = env.sample_env_u(u, env.build_env_tables(sky))
    (g,) = torch.autograd.grad(pdf.sum(), sky)
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("leaf", ["mtl_emission", "env_radiance"])
def test_physical_grads_match_finite_differences(leaf):
    """The port's own physical gradient against central differences of
    its loss on the 3-light room. The emissive panel's emission scales
    every emissive term linearly (its own sampling pdf and MIS weights do
    not depend on it): the loss is quadratic, so at h = 1 the central
    difference is exact up to the float32 rounding of the two losses
    (measured 6e-6 relative): rtol 1e-4. An env texel also moves the
    environment-NEE pdf, smoothly while no lane's pick moves: at h = 1e-2
    the second-order term and the rounding stay within 3.1e-4 relative
    (measured): rtol 1e-3."""
    scene = port_scene(_scene(lights=True))
    cfg = RenderConfig(**GRAD_SIZE, mode="physical")
    params = inv.Params.from_scene(scene)
    target = torch.from_numpy(np.random.default_rng(4).random(
        (GRAD_SIZE["height"], GRAD_SIZE["width"], 3)).astype(np.float32))
    key = prng_key(6)
    _, grads = inv.loss_and_grads(params, scene, cfg, target, key)
    g = getattr(grads, leaf).reshape(-1)
    i = 4 if leaf == "mtl_emission" else int(g.abs().argmax())
    h, rtol = (1.0, 1e-4) if leaf == "mtl_emission" else (1e-2, 1e-3)

    def loss_at(delta):
        x = getattr(params, leaf).clone()
        x.view(-1)[i] += delta
        with torch.no_grad():
            return float(inv.mse_loss(dataclasses.replace(params, **{leaf: x}),
                                      scene, cfg, target, key))

    fd = (loss_at(h) - loss_at(-h)) / (2 * h)
    assert float(g[i]) != 0.0
    assert abs(fd - float(g[i])) <= rtol * abs(float(g[i])), (fd, g[i])


def test_physical_train_step_on_cpu():
    """make_train_step runs unchanged in physical mode: a finite loss,
    finite parameters that moved, and the step counted."""
    scene = port_scene(_scene(lights=True))
    params = inv.Params.from_scene(scene)
    step = inv.make_train_step(RenderConfig(**GRAD_SIZE, mode="physical"),
                               inv.adam(1e-2), device="cpu")
    new, state, loss = step(params, inv.AdamState.init(params), scene,
                            torch.zeros(GRAD_SIZE["height"],
                                        GRAD_SIZE["width"], 3), prng_key(1))
    assert np.isfinite(float(loss)) and state.step == 1
    assert all(torch.isfinite(x).all() for x in new.leaves())
    assert not torch.equal(new.mtl_base_color, params.mtl_base_color)
