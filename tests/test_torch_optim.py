"""The train steps' optimiser and loss arguments on the CPU: the port's
functional optimisers (`diff.adam`, `diff.sgd`) against a stateful
torch.optim.Adam and against optax.sgd, and `make_train_step(cfg,
optimizer, loss_fn)` / `make_sharded_train_step(cfg, mesh, optimizer)`
against the JAX package's `make_train_step(cfg, optax..., loss_fn)` and
the one-device step, on numpy-seeded inputs and the small lit room.

Tolerances: adam(lr) bit for bit with torch.optim.Adam; sgd within
1e-6 relative of optax.sgd (torch may fuse p - lr * g into one
multiply-add, optax rounds the product first); against JAX's steps the
loss within 1e-6 relative and the parameters rtol 1e-4 with atol 1e-6 *
max|g| (tests/test_torch_train.py's: the gradients differ by the
rounding of the unfused shading); the sharded step rtol 1e-5 of the
one-device step (tests/test_torch_shard.py's).
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
from tinypathtracer_tpu_torch import RenderConfig, prng_key
from tinypathtracer_tpu_torch.diff import invrender as inv

from _torch_dist import FRAME, collect, sgd_rank, start
from _torch_scenes import LR, jax_scene, port_scene, to_numpy, train_setup

torch.set_num_threads(2)

SIZE = dict(width=12, height=12, spp=2, max_depth=3)
FIELDS = [f.name for f in dataclasses.fields(inv.Params)]
SGD_CASES = [(None, False), (0.9, False), (0.9, True), (0.0, True)]


def _grads(params, seed):
    """Gradients as Params drawn from numpy (standard normal)."""
    rng = np.random.default_rng(seed)
    return inv.Params(*(torch.from_numpy(
        rng.standard_normal(tuple(x.shape)).astype(np.float32))
        for x in params.leaves()))


def _jax_tree(params):
    return jinv.Params(**{f: jnp.asarray(getattr(params, f).numpy())
                          for f in FIELDS})


def _target(seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    return rng.random((size["height"], size["width"], 3)).astype(np.float32)


def test_adam_is_torch_adam_bit_for_bit():
    """Three adam(LR) steps from a mid-training AdamState equal, bit for
    bit, three adam_step calls and three steps of one stateful
    torch.optim.Adam (optax.adam's defaults) on the same gradients; the
    inputs are not modified."""
    _, _, params, state = train_setup(jax_scene(lights=True), seed=1)
    opt = inv.adam(LR)
    leaves = [x.clone() for x in params.leaves()]
    ref = torch.optim.Adam(leaves, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for p, m, v in zip(leaves, state.exp_avg.leaves(),
                       state.exp_avg_sq.leaves()):
        ref.state[p] = {"step": torch.tensor(float(state.step)),
                        "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    got, got_state = params, state
    old, old_state = params, state
    before = [x.clone() for x in params.leaves() + state.exp_avg.leaves()]
    for k in range(3):
        grads = _grads(params, 10 + k)
        got, got_state = opt.step(got, grads, got_state)
        old, old_state = inv.adam_step(old, grads, old_state, LR)
        for p, g in zip(leaves, grads.leaves()):
            p.grad = g
        ref.step()
        assert got_state.step == old_state.step == state.step + k + 1
        for a, b, c in zip(got.leaves(), old.leaves(), leaves):
            assert torch.equal(a, b) and torch.equal(a, c)
        for a, b, p in zip(got_state.exp_avg.leaves() +
                           got_state.exp_avg_sq.leaves(),
                           old_state.exp_avg.leaves() +
                           old_state.exp_avg_sq.leaves(),
                           leaves + leaves):
            assert torch.equal(a, b)
        for p, m, v in zip(leaves, got_state.exp_avg.leaves(),
                           got_state.exp_avg_sq.leaves()):
            assert torch.equal(ref.state[p]["exp_avg"], m)
            assert torch.equal(ref.state[p]["exp_avg_sq"], v)
    assert all(torch.equal(a, b) for a, b in zip(
        before, params.leaves() + state.exp_avg.leaves()))
    assert isinstance(opt.init(params), inv.AdamState)


@pytest.mark.parametrize("momentum,nesterov", SGD_CASES)
def test_sgd_matches_optax(momentum, nesterov):
    """Three sgd(LR, momentum, nesterov) steps against optax.sgd with the
    same arguments on the same gradients: parameters and the momentum
    trace within 1e-6 relative (no state without momentum)."""
    _, _, params, _ = train_setup(jax_scene(lights=True))
    opt = inv.sgd(LR, momentum=momentum, nesterov=nesterov)
    jopt = optax.sgd(LR, momentum=momentum, nesterov=nesterov)
    jparams = _jax_tree(params)
    state, jstate = opt.init(params), jopt.init(jparams)
    assert (state is None) == (momentum is None)
    got = params
    for k in range(3):
        grads = _grads(params, 20 + k)
        got, state = opt.step(got, grads, state)
        updates, jstate = jopt.update(_jax_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for f in FIELDS:
            want = np.asarray(getattr(jparams, f))
            np.testing.assert_allclose(getattr(got, f).numpy(), want,
                                       rtol=1e-6, atol=1e-6 * LR, err_msg=f)
        if momentum is None:
            assert state is None
            assert inv.sgd_state_from_optax(jstate, params) is None
            continue
        want = inv.sgd_state_from_optax(jstate, params)
        for a, b in zip(state.trace.leaves(), want.trace.leaves()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


def _jax_step(flat, opt, jstate, target, loss_fn=jinv.mse_loss):
    jstep = jinv.make_train_step(JaxConfig(**SIZE, megakernel=False), opt,
                                 loss_fn=loss_fn)
    jparams = jinv.Params.from_scene(flat)
    return jstep(jparams, jstate, flat, jnp.asarray(target),
                 jax.random.PRNGKey(8))


def _assert_step_close(got, loss, want, want_loss, g_max):
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-6 * g_max, err_msg=f)


def test_sgd_train_step_matches_jax():
    """One make_train_step(cfg, sgd(LR, momentum=0.9)) step from a
    mid-training trace (two optax updates of numpy gradients, carried
    across by sgd_state_from_optax) against JAX's make_train_step(jcfg,
    optax.sgd(LR, momentum=0.9)): the loss, the parameters and the new
    trace."""
    flat = jax_scene(lights=True)
    jparams = jinv.Params.from_scene(flat)
    jopt = optax.sgd(LR, momentum=0.9)
    jstate = jopt.init(jparams)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), jparams)
        _, jstate = jopt.update(grads, jstate, jparams)
    params = inv.Params.from_numpy(to_numpy(jparams), "cpu")
    state = inv.sgd_state_from_optax(jstate, params)
    target = _target(5)
    want, want_state, want_loss = _jax_step(flat, jopt, jstate, target)
    step = inv.make_train_step(RenderConfig(**SIZE),
                               inv.sgd(LR, momentum=0.9), device="cpu")
    got, got_state, loss = step(params, state, port_scene(flat),
                                torch.from_numpy(target), prng_key(8))
    old = inv.sgd_state_from_optax(jstate, params).trace.leaves()
    new = inv.sgd_state_from_optax(want_state, params).trace.leaves()
    g_max = max(float((b - 0.9 * a).abs().max()) for a, b in zip(old, new))
    _assert_step_close(got, loss, want, want_loss, g_max)
    for a, b in zip(got_state.trace.leaves(), new):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * g_max)


def _jax_mae(params, scene, cfg, target, key):
    img = jinv.render_mean(jinv.apply_params(scene, params), cfg, key)
    return jnp.mean(jnp.abs(img - target))


def _port_mae(params, scene, cfg, target, key):
    img = inv.render_mean(inv.apply_params(scene, params), cfg, key)
    return torch.mean(torch.abs(img - target))


def test_custom_loss_matches_jax():
    """A loss of the caller's own, the mean absolute error written in
    each package: make_train_step(cfg, sgd(LR), loss_fn=...) against
    JAX's make_train_step(jcfg, optax.sgd(LR), loss_fn=...). The loss
    differs from the MSE, and so do the moved parameters."""
    flat = jax_scene(lights=True)
    jopt = optax.sgd(LR)
    target = _target(6)
    want, _, want_loss = _jax_step(flat, jopt, jopt.init(
        jinv.Params.from_scene(flat)), target, loss_fn=_jax_mae)
    scene = port_scene(flat)
    params = inv.Params.from_scene(scene)
    step = inv.make_train_step(RenderConfig(**SIZE), inv.sgd(LR),
                               loss_fn=_port_mae, device="cpu")
    got, state, loss = step(params, None, scene, torch.from_numpy(target),
                            prng_key(8))
    assert state is None
    g_max = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(jinv.Params.from_scene(flat)),
        jax.tree_util.tree_leaves(want))) / LR
    _assert_step_close(got, loss, want, want_loss, g_max)
    mse = inv.make_train_step(RenderConfig(**SIZE), inv.sgd(LR),
                              device="cpu")
    got_mse, _, loss_mse = mse(params, None, scene, torch.from_numpy(target),
                               prng_key(8))
    assert abs(float(loss_mse) - float(loss)) > 1e-3
    assert not torch.equal(got_mse.mtl_base_color, got.mtl_base_color)


def test_sharded_sgd_matches_one_device(tmp_path):
    """Two gloo ranks, mesh (2, 1): make_sharded_train_step(cfg, mesh,
    sgd(LR, momentum=0.9)) against make_train_step with the same
    optimiser on one device: the loss within 1e-6, the trace (the
    gradient, from a zero trace) rtol 1e-5 with atol 1e-6 of each leaf's
    largest, the parameters to match; equal on both ranks."""
    lit = jax_scene(lights=True)
    target = _target(0, FRAME)
    ctx = start(sgd_rank, 2, tmp_path, to_numpy(lit), target, LR, 0.9)
    scene, cfg = port_scene(lit), RenderConfig(**FRAME)
    params, opt = inv.Params.from_scene(scene), inv.sgd(LR, momentum=0.9)
    want, want_state, want_loss = inv.make_train_step(cfg, opt, device="cpu")(
        params, opt.init(params), scene, torch.from_numpy(target),
        prng_key(5))
    ranks = collect(ctx, tmp_path)
    first = ranks[0]
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["params"],
                                                     first["params"]))
    assert abs(float(first["loss"]) - float(want_loss)) <= \
        1e-6 * float(want_loss)
    for f, g, w, p, q in zip(FIELDS, first["trace"],
                             want_state.trace.leaves(), first["params"],
                             want.leaves()):
        scale = float(w.abs().max()) if w.numel() else 0.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=f)
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5,
                                   atol=LR * 1e-6 * scale, err_msg=f)
