"""The training slice: the port's loss, gradients and Adam step on the
CPU against the JAX package's `diff/invrender`, same scene, key and
parameters.

JAX differentiates its modular path (`megakernel=False`) and its Pallas
megakernel in interpret mode (`mega_impl="interpret"`, the stored-hit
backward); the port differentiates its megakernel twin (the save_hits
forward and the shading-only replay). Shading is unfused in the port
and FMA-fused by XLA, so gradients agree to rounding, not bit for bit:
rtol 1e-4 with atol 1e-6 * max|g| per leaf, the loss within 1e-6
relative. Inside the port the two paths run the same replay on
bit-equal hits, so their gradients are equal exactly.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.diff import invrender as jinv
from tinypathtracer_tpu.ops import dense as jdense
from tinypathtracer_tpu.render import integrator as jintegrator
from tinypathtracer_tpu_torch import RenderConfig, Renderer, prng_key
from tinypathtracer_tpu_torch.diff import invrender as inv
from tinypathtracer_tpu_torch.ops.dense import closest_hit_dense, dense_hit
from tinypathtracer_tpu_torch.ops.mega import mega_trace
from tinypathtracer_tpu_torch.render.integrator import _HitSurface

from _torch_scenes import (LR, jax_scene, port_scene, to_numpy,
                           train_setup)

torch.set_num_threads(2)

SIZE = dict(width=12, height=12, spp=2, max_depth=3)
FIELDS = [f.name for f in dataclasses.fields(inv.Params)]


def _target(seed=0):
    """A non-symmetric target image (raw, bottom-up rows)."""
    rng = np.random.default_rng(seed)
    return rng.random((SIZE["height"], SIZE["width"], 3)).astype(np.float32)


def _jax_value_and_grad(flat, jparams, jcfg, target, seed):
    fn = jax.jit(lambda p, s, t, k: jax.value_and_grad(jinv.mse_loss)(
        p, s, jcfg, t, k))
    loss, grads = fn(jparams, flat, jnp.asarray(target),
                     jax.random.PRNGKey(seed))
    return float(loss), {f: np.asarray(getattr(grads, f)) for f in FIELDS}


def _port_value_and_grad(flat, params, cfg, target, seed):
    loss, grads = inv.loss_and_grads(params, port_scene(flat), cfg,
                                     torch.from_numpy(target), prng_key(seed))
    return float(loss), {f: getattr(grads, f) for f in FIELDS}


def _assert_grads_close(got, want, lights):
    """Per leaf: finite, allclose rtol 1e-4, atol 1e-6 * max|g|.

    Without delta lights the camera gradient is zero analytically: the
    radiance depends on the hit point only through the diffuse ratio
    |cos_o| / cos_t = 1, so both packages return rounding residue (~5e-8
    against ~0.2 for the materials, measured). There it is held to
    1e-6 of the largest gradient of any leaf."""
    g_all = max(np.abs(w).max() for w in want.values() if w.size)
    for f in FIELDS:
        g, w = got[f].numpy(), want[f]
        assert g.shape == w.shape, f
        assert np.isfinite(g).all(), f
        if not w.size:
            continue
        scale = np.abs(w).max()
        if f == "cam_to_world" and not lights:
            assert scale < 1e-6 * g_all
            scale = g_all
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f)


@pytest.mark.parametrize("lights", [False, True])
@pytest.mark.parametrize("jax_path", ["modular", "mega_interpret"])
def test_grads_match_jax(jax_path, lights):
    flat = jax_scene(lights=lights)
    jcfg = JaxConfig(**SIZE, megakernel=jax_path != "modular",
                     mega_impl="interpret" if jax_path != "modular" else "off")
    jparams, _, params, _ = train_setup(flat)
    target = _target()
    want_loss, want = _jax_value_and_grad(flat, jparams, jcfg, target, 3)
    loss, got = _port_value_and_grad(flat, params, RenderConfig(**SIZE),
                                     target, 3)
    assert abs(loss - want_loss) <= 1e-6 * want_loss
    _assert_grads_close(got, want, lights)
    # the leaves the scene exercises carry gradient
    for f in ["mtl_base_color", "mtl_emission", "env_radiance"] + (
            ["light_intensity", "cam_to_world"] if lights else []):
        assert np.abs(want[f]).max() > 0, f


@pytest.mark.parametrize("lights", [False, True])
def test_megakernel_and_modular_grads_equal(lights):
    """The stored-hit replay and the modular path differentiate the same
    shading on bit-equal hits: loss and gradients are equal exactly."""
    flat = jax_scene(lights=lights)
    _, _, params, _ = train_setup(flat)
    target = _target(1)
    cfg = RenderConfig(width=10, height=9, spp=3, max_depth=4)
    a_loss, a = _port_value_and_grad(flat, params, cfg, target[:9, :10], 7)
    b_loss, b = _port_value_and_grad(
        flat, params, dataclasses.replace(cfg, megakernel=False),
        target[:9, :10], 7)
    assert a_loss == b_loss
    for f in FIELDS:
        assert torch.equal(a[f], b[f]), f


@pytest.mark.parametrize("megakernel", [True, False])
def test_grads_independent_of_chunking(megakernel):
    """Chunks of 20 rays give the one-chunk loss and gradients: the loss
    bit for bit; the gradients up to the order in which the chunks'
    contributions are summed (float addition is not associative; measured
    up to 8e-6 relative on small env texels, 2e-7 elsewhere), within
    rtol 1e-6 plus 1e-6 of the leaf's largest gradient."""
    flat = jax_scene(lights=True)
    _, _, params, _ = train_setup(flat)
    target = _target(2)
    cfg = RenderConfig(**SIZE, megakernel=megakernel)
    a_loss, a = _port_value_and_grad(flat, params, cfg, target, 5)
    b_loss, b = _port_value_and_grad(
        flat, params, dataclasses.replace(cfg, rays_per_dispatch=20), target,
        5)
    assert a_loss == b_loss
    for f in FIELDS:
        want = a[f].numpy()
        np.testing.assert_allclose(
            b[f].numpy(), want, rtol=1e-6,
            atol=1e-6 * np.abs(want).max(initial=0.0), err_msg=f)


@pytest.mark.parametrize("leaf", ["mtl_emission", "env_radiance"])
@pytest.mark.parametrize("grid", [(1, 6, 12), (4, 8, 16)],
                         ids=["room", "large"])
def test_grads_match_finite_differences(grid, leaf):
    """The port's own gradient against central differences of its own
    loss, on the CPU: the room (132 faces) through the megakernel twin's
    stored-hit replay, and the 14,348-face scene through the modular
    loop on the packet traversal. The loss is quadratic in the emissive
    material's emission (while it stays > 0: emission > 0 decides
    termination) and in an env texel (both only add radiance on fixed
    paths), so the central difference is exact up to the float32
    rounding of the two losses (~1e-7 relative, over 2h = 2; measured
    within 1.9e-6 of the gradient): rtol 1e-4 plus atol 1e-8."""
    from tinypathtracer_tpu_torch.render import renderer

    scene = port_scene(jax_scene(*grid))
    cfg = RenderConfig(**SIZE)
    state = renderer.prepare_state(scene, cfg)
    assert (state.packet is not None) == (grid != (1, 6, 12))
    params = inv.Params.from_scene(scene)
    target, key = torch.from_numpy(_target(4)), prng_key(6)
    _, grads = inv.loss_and_grads(params, scene, cfg, target, key)
    g = getattr(grads, leaf).reshape(-1)
    # the emissive panel's material; the env texel with the most gradient
    i = 4 if leaf == "mtl_emission" else int(g.abs().argmax())
    assert float(scene.mtl_emission[4]) > 1.0 and float(g[i]) != 0.0

    def loss_at(delta):
        x = getattr(params, leaf).clone()
        x.view(-1)[i] += delta
        with torch.no_grad():
            return float(inv.mse_loss(dataclasses.replace(params, **{leaf: x}),
                                      scene, cfg, target, key))

    h = 1.0
    fd = (loss_at(h) - loss_at(-h)) / (2 * h)
    assert abs(fd - float(g[i])) <= 1e-4 * abs(float(g[i])) + 1e-8, (fd, g[i])


def test_adam_matches_optax():
    """One update from the same mid-training state and the same gradient:
    torch.optim.Adam (through adam_step) against optax.adam. optax rounds
    the bias corrections 1 - beta**t to float32, torch keeps them in
    float64: at t = 4 that moves an update by up to 1.5e-5 * lr
    (measured), so params agree to rtol 1e-6 plus atol 1e-4 * lr, and the
    moments (torch blends the first with lerp) to rtol 1e-6 plus 1e-6 of
    their largest value."""
    flat = jax_scene(lights=True)
    jparams, jstate, params, state = train_setup(flat, seed=4, steps=3)
    rng = np.random.default_rng(5)
    jgrads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)),
        jparams)
    opt = optax.adam(LR)
    updates, jstate2 = opt.update(jgrads, jstate, jparams)
    want = optax.apply_updates(jparams, updates)
    grads = inv.Params.from_numpy(to_numpy(jgrads), "cpu")
    got, state2 = inv.adam_step(params, grads, state, LR)
    assert state2.step == int(jstate2[0].count) == state.step + 1
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-4 * LR, err_msg=f)
        for mine, theirs in ((state2.exp_avg, jstate2[0].mu),
                             (state2.exp_avg_sq, jstate2[0].nu)):
            theirs = np.asarray(getattr(theirs, f))
            np.testing.assert_allclose(
                getattr(mine, f).numpy(), theirs, rtol=1e-6,
                atol=1e-6 * np.abs(theirs).max(initial=0.0), err_msg=f)
    # the inputs were not modified in place
    assert torch.equal(params.mtl_base_color,
                       torch.from_numpy(np.array(jparams.mtl_base_color)))


def test_params_from_numpy_reproduce_jax_loss():
    """Params moved across after a JAX train step give JAX's loss there."""
    flat = jax_scene()
    jcfg = JaxConfig(**SIZE, megakernel=False)
    jparams, jstate, _, _ = train_setup(flat)
    target = _target(3)
    step = jinv.make_train_step(jcfg, optax.adam(LR))
    jparams, _, _ = step(jparams, jstate, flat, jnp.asarray(target),
                         jax.random.PRNGKey(1))
    want = float(jax.jit(lambda p, k: jinv.mse_loss(
        p, flat, jcfg, jnp.asarray(target), k))(jparams,
                                                jax.random.PRNGKey(2)))
    params = inv.Params.from_numpy(to_numpy(jparams), "cpu")
    got = float(inv.mse_loss(params, port_scene(flat), RenderConfig(**SIZE),
                             torch.from_numpy(target), prng_key(2)))
    assert abs(got - want) <= 1e-6 * want


def test_render_mean_rows_are_raw_order():
    """render_mean keeps render_frame's bottom-up rows, as JAX's does;
    Renderer.render's image is the flipped one."""
    flat = jax_scene()
    want = np.asarray(jax.jit(lambda s, k: jinv.render_mean(
        s, JaxConfig(**SIZE, megakernel=False), k))(flat,
                                                   jax.random.PRNGKey(4)))
    scene = port_scene(flat)
    with torch.no_grad():
        got = inv.render_mean(scene, RenderConfig(**SIZE), prng_key(4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    img = Renderer(RenderConfig(**SIZE), device="cpu").render(scene,
                                                              prng_key(4))
    assert torch.equal(img.flip(0), got)
    assert not np.allclose(img.numpy(), want, atol=1e-3)


def test_hit_surface_backward_matches_jax():
    """_HitSurface's Moller-Trumbore backward against jax.vjp of JAX
    `_hit_surface` on hits from inside the room; miss lanes get exactly
    zero gradient and nothing is NaN."""
    flat = jax_scene()
    jdata = jax.jit(jintegrator.TraceData.from_scene)(flat)
    jwoop = jax.jit(jdense.precompute_woop)(jdata.tri_verts)
    rng = np.random.default_rng(6)
    n = 512
    o = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = [0.0, 0.0, 1.0]                        # some rays leave the room
    o[:8] = [0.0, 0.0, 4.99]
    fid, t_k, uv = jdense.closest_hit_dense(jnp.asarray(o), jnp.asarray(d),
                                            woop=jwoop)
    miss = np.asarray(fid) < 0
    assert 0 < miss.sum() < n
    t_k = jnp.where(miss, 1.0, t_k)
    cts = tuple(jnp.asarray(rng.standard_normal(n).astype(np.float32))
                for _ in range(3))
    _, vjp = jax.vjp(lambda o_, d_, tv_: jintegrator._hit_surface(
        o_, d_, tv_, fid, t_k, uv[:, 0], uv[:, 1]),
        jnp.asarray(o), jnp.asarray(d), jdata.tri_verts)
    want = [np.asarray(g) for g in vjp(cts)]

    t = lambda a: torch.from_numpy(np.array(a))       # noqa: E731
    leaves = [t(o).requires_grad_(), t(d).requires_grad_(),
              t(jdata.tri_verts).requires_grad_()]
    out = _HitSurface.apply(*leaves, t(fid).long(), t(t_k), t(uv[:, 0]),
                            t(uv[:, 1]))
    assert all(torch.equal(a, t(b)) for a, b in zip(
        out, (t_k, uv[:, 0], uv[:, 1])))                  # primal unchanged
    got = torch.autograd.grad(out, leaves, [t(c) for c in cts])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert (got[0][torch.from_numpy(miss)] == 0).all()
    assert (got[1][torch.from_numpy(miss)] == 0).all()


def test_train_step_on_cpu():
    """The step on device="cpu": the loss and update of its parts, and no
    kernel launch."""
    flat = jax_scene(lights=True)
    _, _, params, state = train_setup(flat)
    scene, target = port_scene(flat), torch.from_numpy(_target())
    cfg = RenderConfig(**SIZE)
    before = (dense_hit.launches, mega_trace.launches,
              mega_trace.launches_save_hits)
    step = inv.make_train_step(cfg, inv.adam(LR),
                               project_fn=inv.project_physical,
                               device="cpu")
    new, new_state, loss = step(params, state, scene, target, prng_key(8))
    want_loss, grads = inv.loss_and_grads(params, scene, cfg, target,
                                          prng_key(8))
    want, _ = inv.adam_step(params, grads, state, LR)
    want = inv.project_physical(want)
    assert (dense_hit.launches, mega_trace.launches,
            mega_trace.launches_save_hits) == before
    assert float(loss) == float(want_loss) and np.isfinite(float(loss))
    assert new_state.step == state.step + 1
    for f in FIELDS:
        assert torch.equal(getattr(new, f), getattr(want, f)), f
    assert float((new.mtl_base_color - params.mtl_base_color).abs().max()) > 0


def test_entry_points_default_to_the_card():
    """Renderer(cfg) and make_train_step(cfg) take the card unless given
    device="cpu": without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(RenderConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inv.make_train_step(RenderConfig(), inv.adam(LR))


def test_modular_hit_queries_are_detached():
    """The modular path calls its intersector on detached rays (hit ids
    carry no gradient), while the radiance stays differentiable."""
    flat = jax_scene()
    scene = port_scene(flat)
    seen = []

    def spy(o, d, mask=None, woop=None):
        seen.append(o.requires_grad or d.requires_grad)
        return closest_hit_dense(o, d, woop, mask)

    from tinypathtracer_tpu_torch.render import integrator, renderer
    state = renderer.prepare_state(scene, RenderConfig(**SIZE))
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.nn.functional.normalize(torch.randn((4, 3)), dim=1)
    rad = integrator.trace_paths(
        state.data, RenderConfig(**SIZE, megakernel=False),
        lambda o_, d_, mask=None: spy(o_, d_, mask, state.woop), o, d,
        prng_key(0)[None].expand(4, 2).contiguous())
    assert seen and not any(seen)
    assert rad.requires_grad
