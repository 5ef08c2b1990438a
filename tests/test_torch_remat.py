"""Per-bounce rematerialisation of the port's bounce loop
(`render/integrator.trace_paths`), the JAX integrator's
`lax.scan(jax.checkpoint(bounce))`.

Under autograd each bounce runs under `torch.utils.checkpoint`, so a
train step's forward keeps only the carries between bounces: o, d,
throughput and radiance (three f32 each), alive and prev_spec (bool),
prev_pdf (f32), CARRY_BYTES bytes a lane a bounce. The tests count the
bytes autograd saves during the forward of `mse_loss` with
`torch.autograd.graph.saved_tensors_hooks` on the modular dense route,
the packet route, physical mode and the textured megakernel route (the
replay on kernel B's stored hits): from depth 2 to depth 4 they grow by
at most CARRY_BYTES a lane a bounce, and they stay far below the bytes
saved with the checkpoint patched to a plain call (this file only).
The gradients with and without rematerialisation are equal bit for bit:
the recomputed bounce equals the forward's. The untextured megakernel
route (the stored-hit backward, differentiated at once) is not
rematerialised and keeps its one save_hits launch a chunk.
"""

import dataclasses

import pytest
import torch

from tinypathtracer_tpu_torch import (RenderConfig, prng_key,
                                      sphere_grid_scene)
from tinypathtracer_tpu_torch.diff import invrender as inv
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.ops import dense, mega, packet
from tinypathtracer_tpu_torch.render import integrator

torch.set_num_threads(2)

CARRY_BYTES = 13 * 4 + 2 * 1
SIZE = dict(width=8, height=8, spp=2)
# route: (sphere_grid_scene args, RenderConfig fields)
ROUTES = {
    "dense": ((1, 6, 12), dict(megakernel=False)),
    "packet": ((4, 8, 16), dict()),
    "physical": ((1, 6, 12), dict(mode="physical")),
    "textured_megakernel": ((1, 6, 12, True), dict()),
}


def _scene(args):
    grid, n_lat, n_lon, *textured = args
    return sphere_grid_scene(grid, n_lat, n_lon,
                             env_radiance=gradient_sky(16, 32),
                             textured=bool(textured), device="cpu")


def _forward_backward(scene, cfg, remat: bool, monkeypatch):
    """(bytes autograd saved in mse_loss's forward, the gradients)."""
    if not remat:
        monkeypatch.setattr(integrator, "checkpoint",
                            lambda fn, *args, **kw: fn(*args))
    saved = [0]

    def pack(x):
        saved[0] += x.numel() * x.element_size()
        return x

    params = inv.Params.from_scene(scene)
    leaves = inv.Params(*(x.detach().requires_grad_()
                          for x in params.leaves()))
    target = torch.zeros((cfg.height, cfg.width, 3))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = inv.mse_loss(leaves, scene, cfg, target, prng_key(4))
    loss.backward()
    monkeypatch.undo()
    return saved[0], leaves.grads().leaves()


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(args) for name, (args, _) in ROUTES.items()}


@pytest.mark.parametrize("route", list(ROUTES))
def test_saved_bytes_grow_only_by_the_carries(route, scenes, monkeypatch):
    scene, fields = scenes[route], ROUTES[route][1]
    lanes = SIZE["width"] * SIZE["height"] * SIZE["spp"]
    got = {}
    for depth in (2, 4):
        cfg = RenderConfig(**SIZE, max_depth=depth, **fields)
        got[depth] = {remat: _forward_backward(scene, cfg, remat,
                                               monkeypatch)[0]
                      for remat in (True, False)}
    growth = (got[4][True] - got[2][True]) / (2 * lanes)
    assert 0 < growth <= CARRY_BYTES, growth
    plain = (got[4][False] - got[2][False]) / (2 * lanes)
    assert plain > 5 * CARRY_BYTES, plain
    assert got[4][False] > 3 * got[4][True]


@pytest.mark.parametrize("route", list(ROUTES))
def test_gradients_equal_without_rematerialisation(route, scenes,
                                                   monkeypatch):
    cfg = RenderConfig(**SIZE, max_depth=4, **ROUTES[route][1])
    _, a = _forward_backward(scenes[route], cfg, True, monkeypatch)
    _, b = _forward_backward(scenes[route], cfg, False, monkeypatch)
    assert any(bool((g != 0).any()) for g in a)
    for f, ga, gb in zip([f.name for f in dataclasses.fields(inv.Params)],
                         a, b):
        assert torch.equal(ga, gb), f


def _counted(monkeypatch, module, name):
    """Patch module.name with a wrapper that logs each call's arguments."""
    calls, real = [], getattr(module, name)

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("route", ["dense", "packet", "physical"])
def test_backward_recomputes_the_queries(route, scenes, monkeypatch):
    """The modular routes' backward reruns every bounce's closest-hit
    queries: a train step runs each query of its forward twice (the
    twins stand in for kernels A and C here)."""
    scene, fields = scenes[route], ROUTES[route][1]
    cfg = RenderConfig(**SIZE, max_depth=3, **fields)
    calls = (_counted(monkeypatch, packet, "_packet_torch")
             if route == "packet"
             else _counted(monkeypatch, dense, "_dense_torch"))
    params = inv.Params.from_scene(scene)
    target = torch.zeros((cfg.height, cfg.width, 3))
    with torch.no_grad():
        inv.mse_loss(params, scene, cfg, target, prng_key(4))
    forward = len(calls)
    inv.loss_and_grads(params, scene, cfg, target, prng_key(4))
    assert forward > 0
    assert len(calls) - forward == 2 * forward


def test_megakernel_stored_backward_is_not_rematerialised(scenes,
                                                          monkeypatch):
    """The untextured megakernel step: one save_hits run a chunk, no
    other, and no checkpoint (its replay is differentiated at once); the
    textured step: one save_hits run a chunk and a checkpoint a
    bounce."""
    calls = _counted(monkeypatch, integrator, "checkpoint")
    runs = _counted(monkeypatch, mega, "_mega_torch")
    hits = _counted(monkeypatch, dense, "_dense_torch")
    cfg = RenderConfig(**SIZE, max_depth=3)
    for name, n_checkpoints in (("dense", 0), ("textured_megakernel", 3)):
        del calls[:], runs[:]
        scene = scenes[name]
        inv.loss_and_grads(inv.Params.from_scene(scene), scene, cfg,
                           torch.zeros((cfg.height, cfg.width, 3)),
                           prng_key(4))
        assert len(runs) == 1 and runs[0][7] is True        # save_hits
        assert len(calls) == n_checkpoints
    assert not hits
