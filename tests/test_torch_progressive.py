"""Progressive rendering and checkpoints: the port's `sample_offset`,
`Renderer.progressive` and `utils/checkpoint.py` on the CPU, against
themselves and against the JAX package's on the same scenes and keys.

Samples are indexed (a lane's key folds in its absolute sample index),
so passes over disjoint sample ranges add up to one pass over their
union (within 1e-6: only the float32 sum order differs) and a resumed
progressive render equals an uninterrupted one bit for bit. JAX's
progressive image is matched within 1e-5 (its shading is FMA-fused by
XLA). Checkpoints written by the JAX package (a `Params` pytree, a
`ProgressiveRender`) load here.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.diff.invrender import Params as JaxParams
from tinypathtracer_tpu.render.renderer import Renderer as JaxRenderer
from tinypathtracer_tpu.utils import checkpoint as jckpt
from tinypathtracer_tpu_torch import (RenderConfig, Renderer, load_pytree,
                                      prng_key, save_pytree)
from tinypathtracer_tpu_torch.diff import (AdamState, Params, SgdState, sgd,
                                           sgd_state_from_optax)
from tinypathtracer_tpu_torch.render import film
from tinypathtracer_tpu_torch.render.renderer import (prepare_state,
                                                      render_pixel_ids)

from _torch_scenes import jax_scene, port_scene, train_setup

torch.set_num_threads(2)

SIZE = dict(width=12, height=10, max_depth=3)
JAX_CFG = dict(megakernel=False, mega_impl="off")


def _textured():
    from tinypathtracer_tpu.models.envlight import gradient_sky
    from tinypathtracer_tpu.models.procedural import sphere_grid_scene

    return sphere_grid_scene(1, 6, 12, env_radiance=gradient_sky(16, 32),
                             textured=True)


@pytest.fixture(scope="module", params=["room", "textured"])
def flat(request):
    return jax_scene() if request.param == "room" else _textured()


@pytest.mark.parametrize("megakernel", [True, False])
def test_sample_offset_splits_the_sum(flat, megakernel):
    """render_pixel_ids over samples 0-1 plus samples 2-3 equals one pass
    over 0-3 within 1e-6; the second pass alone differs from the first."""
    cfg = RenderConfig(**SIZE, spp=4, megakernel=megakernel)
    scene = port_scene(flat)
    with torch.no_grad():
        st = prepare_state(scene, cfg)
        pix = torch.arange(cfg.n_pixels)
        whole = render_pixel_ids(st, cfg, pix, prng_key(1))
        a = render_pixel_ids(st, cfg, pix, prng_key(1), spp=2)
        b = render_pixel_ids(st, cfg, pix, prng_key(1), spp=2,
                             sample_offset=2)
    np.testing.assert_allclose((a + b).numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    assert not torch.equal(a, b)


def test_progressive_resume_is_bit_equal(flat, tmp_path):
    """2 steps of 2 samples straight through, and 2 samples, save, load
    into a new accumulator, 2 more: the same radiance sum bit for bit;
    the image within 1e-5 of Renderer.render's (flipped) frame."""
    cfg = RenderConfig(**SIZE, spp=4)
    scene = port_scene(flat)
    r = Renderer(cfg, device="cpu")
    straight = r.progressive()
    for _ in range(2):
        straight.step(scene, prng_key(0), 2)
    part = r.progressive()
    part.step(scene, prng_key(0), 2)
    path = str(tmp_path / "prog.npz")
    part.save(path)
    resumed = r.progressive()
    resumed.load(path)
    assert resumed.samples_done == 2
    img = resumed.step(scene, prng_key(0), 2)
    assert resumed.samples_done == 4
    assert torch.equal(resumed.radiance_sum, straight.radiance_sum)
    assert torch.equal(img, straight.image())
    oneshot = r.render(scene, prng_key(0))
    np.testing.assert_allclose(film.to_image(resumed.radiance_sum, 4).numpy(),
                               oneshot.numpy(), rtol=0, atol=1e-5)


def test_progressive_matches_jax(flat):
    """The port's progressive image after 2 + 1 samples against JAX's
    Renderer.progressive on its modular path, within 1e-5."""
    want = JaxRenderer(JaxConfig(**SIZE, spp=3, **JAX_CFG)).progressive()
    got = Renderer(RenderConfig(**SIZE, spp=3), device="cpu").progressive()
    scene = port_scene(flat)
    for n in (2, 1):
        want.step(flat, jax.random.PRNGKey(4), n)
        got.step(scene, prng_key(4), n)
    assert got.samples_done == want.samples_done == 3
    np.testing.assert_allclose(got.image().numpy(), np.asarray(want.image()),
                               rtol=0, atol=1e-5)


def test_jax_progressive_checkpoint_resumes(flat, tmp_path):
    """A ProgressiveRender that JAX saved after 2 samples resumes in the
    port; 2 more samples match JAX's own continuation within 1e-5."""
    jr = JaxRenderer(JaxConfig(**SIZE, spp=4, **JAX_CFG)).progressive()
    jr.step(flat, jax.random.PRNGKey(6), 2)
    path = str(tmp_path / "jax_prog.npz")
    jr.save(path)
    port = Renderer(RenderConfig(**SIZE, spp=4), device="cpu").progressive()
    port.load(path)
    assert port.samples_done == 2
    assert np.array_equal(port.radiance_sum.numpy(), jr.radiance_sum)
    port.step(port_scene(flat), prng_key(6), 2)
    jr.step(flat, jax.random.PRNGKey(6), 2)
    np.testing.assert_allclose(port.image().numpy(), np.asarray(jr.image()),
                               rtol=0, atol=1e-5)


def _params(seed=0):
    _, _, params, state = train_setup(jax_scene(lights=True), seed=seed)
    return params, state


def test_pytree_round_trip(tmp_path):
    """Params and AdamState survive save_pytree / load_pytree exactly,
    with their metadata; the loaded tensors are new ones."""
    from tinypathtracer_tpu_torch.utils.checkpoint import _flatten

    params, state = _params()
    for tree in (params, state, {"params": params, "step": [3, 4.5]}):
        path = str(tmp_path / "t.npz")
        save_pytree(path, tree, meta={"step": 7})
        got, meta = load_pytree(path, tree)
        assert meta == {"step": 7} and type(got) is type(tree)
        leaves_a, leaves_b = [], []
        assert _flatten(got, leaves_a) == _flatten(tree, leaves_b)
        for a, b in zip(leaves_a, leaves_b):
            if torch.is_tensor(b):
                assert a is not b and a.dtype == b.dtype
                assert torch.equal(a, b)
            else:
                assert a == b and type(a) is type(b)


def test_pytree_structure_mismatch(tmp_path):
    """A file of another structure raises: a dict against a dict of
    other keys, Params against AdamState."""
    path = str(tmp_path / "p.npz")
    save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        load_pytree(path, {"b": torch.zeros(3), "c": torch.zeros(2)})
    params, state = _params()
    save_pytree(path, params)
    with pytest.raises(ValueError, match="structure"):
        load_pytree(path, state)


def test_jax_params_checkpoint_loads(tmp_path):
    """A Params pytree saved by the JAX package (leaf_0..5 in field order)
    loads into the port's Params: every leaf equal; a Params of other
    shapes is refused."""
    flat = jax_scene(lights=True)
    jparams = JaxParams.from_scene(flat)
    path = str(tmp_path / "jax_params.npz")
    jckpt.save_pytree(path, jparams, meta={"step": 5})
    like = Params.from_scene(port_scene(flat))
    got, meta = load_pytree(path, like)
    assert meta == {"step": 5}
    for f in dataclasses.fields(Params):
        assert np.array_equal(getattr(got, f.name).numpy(),
                              np.asarray(getattr(jparams, f.name))), f.name
    other = Params.from_scene(port_scene(jax_scene(lights=False)))
    with pytest.raises(ValueError, match="shapes"):
        load_pytree(path, other)


def test_jax_adam_state_checkpoint_loads(tmp_path):
    """optax.adam's state saved by the JAX package (count, then mu's and
    nu's leaves) loads into an AdamState: the same step and moments as
    adam_state_from_optax gives."""
    flat = jax_scene(lights=True)
    _, jstate, params, state = train_setup(flat, seed=2, steps=3)
    path = str(tmp_path / "jax_opt.npz")
    jckpt.save_pytree(path, jstate)
    got, _ = load_pytree(path, AdamState.init(params))
    assert got.step == state.step == 3
    for a, b in zip(got.exp_avg.leaves() + got.exp_avg_sq.leaves(),
                    state.exp_avg.leaves() + state.exp_avg_sq.leaves()):
        assert torch.equal(a, b)


def _sgd_state(seed):
    """(JAX Params of the lit room, an optax.sgd(lr, momentum=0.9) state
    after two updates of numpy gradients, the port's Params)."""
    flat = jax_scene(lights=True)
    jparams = JaxParams.from_scene(flat)
    opt = optax.sgd(1e-2, momentum=0.9)
    state = opt.init(jparams)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), jparams)
        _, state = opt.update(grads, state, jparams)
    return jparams, state, Params.from_scene(port_scene(flat))


def test_sgd_state_round_trip(tmp_path):
    """SGD's momentum state survives save_pytree / load_pytree exactly; a
    Params file is refused for it."""
    _, jstate, params = _sgd_state(3)
    state = sgd_state_from_optax(jstate, params)
    path = str(tmp_path / "sgd.npz")
    save_pytree(path, state, meta={"step": 2})
    got, meta = load_pytree(path, sgd(1e-2, momentum=0.9).init(params))
    assert meta == {"step": 2} and isinstance(got, SgdState)
    for a, b in zip(got.trace.leaves(), state.trace.leaves()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    save_pytree(path, params)
    with pytest.raises(ValueError, match="structure"):
        load_pytree(path, state)


def test_jax_sgd_state_checkpoint_loads(tmp_path):
    """optax.sgd(lr, momentum=0.9)'s state saved by the JAX package (its
    TraceState's leaves) loads into an SgdState: the traces
    sgd_state_from_optax gives, bit for bit."""
    _, jstate, params = _sgd_state(4)
    path = str(tmp_path / "jax_sgd.npz")
    jckpt.save_pytree(path, jstate)
    got, _ = load_pytree(path, sgd(1e-2, momentum=0.9).init(params))
    want = sgd_state_from_optax(jstate, params)
    assert any(bool((t != 0).any()) for t in want.trace.leaves())
    for a, b in zip(got.trace.leaves(), want.trace.leaves()):
        assert torch.equal(a, b)
