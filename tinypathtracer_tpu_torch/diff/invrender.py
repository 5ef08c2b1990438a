"""Differentiable / inverse rendering (port of
`tinypathtracer_tpu/diff/invrender.py`).

The integrator is differentiable end to end by construction: hit ids
are detached, every shading quantity is recomputed with differentiable
ops, and every draw comes from a counter-based key. So the gradient of
a render is path-replay backprop: the backward pass replays the same
paths. On the megakernel path it replays the shading alone, on the hit
residuals the forward kernel recorded (ops/mega.py).

`Params` picks out the differentiable leaves (material colors, scalar
emissions, light intensities, env map, camera pose). `make_train_step`
is one optimiser step on a loss (`mse_loss` by default). The optimiser
is an `Optimizer`, the counterpart of an optax GradientTransformation:
`adam(lr)` (`torch.optim.Adam`, state `AdamState`, optax's
ScaleByAdamState) or `sgd(lr, momentum, nesterov)` (`torch.optim.SGD`,
state `SgdState` or none, optax's TraceState). The JAX package's
functional signature is kept: the step takes and returns (params,
opt_state). `make_sharded_train_step` is the same step on the MSE loss
over a ("data", "sample") device mesh (parallel/mesh.py): pixels and
samples shard over the ranks, the gradient is all-reduced, the
optimiser runs on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene
from tinypathtracer_tpu_torch.parallel.mesh import SAMPLE_AXIS, axis
from tinypathtracer_tpu_torch.parallel.shard import (mesh_device, pixel_shard,
                                                     sample_split)
from tinypathtracer_tpu_torch.render import renderer as rend

ADAM_BETAS = (0.9, 0.999)   # optax.adam's defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass
class Params:
    """Differentiable scene parameters (gradient leaves), in the JAX
    package's field order (a checkpoint's leaf_0..5)."""

    mtl_base_color: torch.Tensor   # [M, 3]
    mtl_emission: torch.Tensor     # [M]
    light_intensity: torch.Tensor  # [L]
    env_radiance: torch.Tensor     # [He, We, 3]
    cam_to_world: torch.Tensor     # [4, 4]
    tex_atlas: torch.Tensor        # [T, Ht, Wt, 3] base-color texels

    @staticmethod
    def from_scene(scene: FlatScene) -> "Params":
        return Params(**{f.name: getattr(scene, f.name).detach().clone()
                         for f in dataclasses.fields(Params)})

    @staticmethod
    def from_numpy(arrays, device) -> "Params":
        """From a JAX Params (or its optimizer moments), given as a dict
        of numpy arrays by field name."""
        return Params(**{
            f.name: torch.from_numpy(np.array(arrays[f.name], np.float32,
                                              order="C")).to(device)
            for f in dataclasses.fields(Params)})

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def to(self, device) -> "Params":
        return Params(*(x.to(device) for x in self.leaves()))

    def grads(self) -> "Params":
        """Each leaf's .grad after backward(), zeros where it got none."""
        return Params(*(x.grad if x.grad is not None else torch.zeros_like(x)
                        for x in self.leaves()))


def apply_params(scene: FlatScene, params: Params) -> FlatScene:
    """Return a scene with the differentiable leaves swapped in."""
    # not dataclasses.asdict: it deep-copies, which cuts the graph
    return dataclasses.replace(scene, **{
        f.name: getattr(params, f.name) for f in dataclasses.fields(params)})


def render_mean(scene: FlatScene, cfg: RenderConfig, key):
    """Differentiable mean-radiance image [H, W, 3] (bottom-up rows, the
    raw pixel order; `film.to_image` flips for display)."""
    return rend.render_frame(scene, cfg, key) / cfg.spp


def mse_loss(params: Params, scene: FlatScene, cfg: RenderConfig, target,
             key):
    """Mean squared error against a target radiance image."""
    img = render_mean(apply_params(scene, params), cfg, key)
    return torch.mean(torch.square(img - target))


def project_physical(params: Params) -> Params:
    """Default feasibility projection: albedo in [0, 1], emission, light
    intensity and env radiance non-negative."""
    return dataclasses.replace(
        params,
        mtl_base_color=torch.clamp(params.mtl_base_color, 0.0, 1.0),
        mtl_emission=torch.clamp_min(params.mtl_emission, 0.0),
        light_intensity=torch.clamp_min(params.light_intensity, 0.0),
        env_radiance=torch.clamp_min(params.env_radiance, 0.0))


@dataclasses.dataclass
class AdamState:
    """Adam's state, as optax's ScaleByAdamState(count, mu, nu): the
    step count and the first and second moments per leaf."""

    step: int
    exp_avg: Params
    exp_avg_sq: Params

    @staticmethod
    def init(params: Params) -> "AdamState":
        zeros = Params(*(torch.zeros_like(x) for x in params.leaves()))
        return AdamState(0, zeros, dataclasses.replace(zeros))

    def to(self, device) -> "AdamState":
        return AdamState(self.step, self.exp_avg.to(device),
                         self.exp_avg_sq.to(device))


def adam_state_from_optax(state, params: Params) -> AdamState:
    """optax.adam's state (the ScaleByAdamState(count, mu, nu), or the
    chain's tuple holding it) as an AdamState on params' device."""
    if not hasattr(state, "mu"):
        state = next(s for s in state if hasattr(s, "mu"))
    dev = params.mtl_base_color.device

    def moments(tree):
        return Params.from_numpy(
            {f.name: np.asarray(getattr(tree, f.name))
             for f in dataclasses.fields(Params)}, dev)

    return AdamState(int(np.asarray(state.count)), moments(state.mu),
                     moments(state.nu))


def adam_step(params: Params, grads: Params, state: AdamState, lr: float,
              b1: float = ADAM_BETAS[0], b2: float = ADAM_BETAS[1],
              eps: float = ADAM_EPS):
    """One torch.optim.Adam update of params with grads from state
    (optax.adam's defaults). Returns (new params, new AdamState); the
    inputs are not modified."""
    leaves = [x.detach().clone() for x in params.leaves()]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(b1, b2), eps=eps)
    for p, g, m, v in zip(leaves, grads.leaves(), state.exp_avg.leaves(),
                          state.exp_avg_sq.leaves()):
        p.grad = g.detach()
        opt.state[p] = {"step": torch.tensor(float(state.step)),
                        "exp_avg": m.detach().clone(),
                        "exp_avg_sq": v.detach().clone()}
    opt.step()
    new = [opt.state[p] for p in leaves]
    return Params(*leaves), AdamState(
        state.step + 1, Params(*(s["exp_avg"] for s in new)),
        Params(*(s["exp_avg_sq"] for s in new)))


@dataclasses.dataclass
class SgdState:
    """SGD's momentum state, as optax's TraceState(trace): one trace per
    leaf."""

    trace: Params

    def to(self, device) -> "SgdState":
        return SgdState(self.trace.to(device))


def sgd_state_from_optax(state, params: Params) -> Optional[SgdState]:
    """optax.sgd's state (the chain's tuple, or its TraceState) as an
    SgdState on params' device; None for optax.sgd without momentum,
    whose state holds nothing."""
    if not hasattr(state, "trace"):
        state = next((s for s in state if hasattr(s, "trace")), None)
        if state is None:
            return None
    return SgdState(Params.from_numpy(
        {f.name: np.asarray(getattr(state.trace, f.name))
         for f in dataclasses.fields(Params)}, params.mtl_base_color.device))


def _sgd_step(params: Params, grads: Params, state: Optional[SgdState],
              lr: float, momentum: Optional[float], nesterov: bool):
    """One torch.optim.SGD update (optax.sgd's semantics: the trace is
    g + momentum * trace, Nesterov adds momentum * trace to g). Returns
    (new params, new state); the inputs are not modified."""
    leaves = [x.detach().clone() for x in params.leaves()]
    # torch keeps no buffer at momentum 0, where optax's trace is g and
    # its update g with or without Nesterov
    opt = torch.optim.SGD(leaves, lr=lr, momentum=momentum or 0.0,
                          nesterov=nesterov and bool(momentum))
    for p, g in zip(leaves, grads.leaves()):
        p.grad = g.detach()
    if momentum:
        for p, t in zip(leaves, state.trace.leaves()):
            opt.state[p] = {"momentum_buffer": t.detach().clone()}
    opt.step()
    if momentum is None:
        return Params(*leaves), None
    trace = ([opt.state[p]["momentum_buffer"] for p in leaves] if momentum
             else [g.detach().clone() for g in grads.leaves()])
    return Params(*leaves), SgdState(Params(*trace))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A functional optimiser, the counterpart of an optax
    GradientTransformation: `init(params) -> state` and `step(params,
    grads, state) -> (params, state)`; neither changes its inputs. A
    state is None or has `.to(device)`, which the train steps use to
    move it to their device."""

    init: Callable[[Params], Any]
    step: Callable[[Params, Params, Any], tuple]


def adam(lr: float, b1: float = ADAM_BETAS[0], b2: float = ADAM_BETAS[1],
         eps: float = ADAM_EPS) -> Optimizer:
    """optax.adam(lr, b1, b2, eps) through torch.optim.Adam; its state is
    an AdamState."""
    return Optimizer(AdamState.init, functools.partial(
        adam_step, lr=lr, b1=b1, b2=b2, eps=eps))


def sgd(lr: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Optimizer:
    """optax.sgd(lr, momentum, nesterov) through torch.optim.SGD. Without
    momentum the state is None; with it an SgdState of zero traces to
    start."""

    def init(params: Params) -> Optional[SgdState]:
        if momentum is None:
            return None
        return SgdState(Params(*(torch.zeros_like(x)
                                 for x in params.leaves())))

    return Optimizer(init, functools.partial(
        _sgd_step, lr=lr, momentum=momentum, nesterov=nesterov))


def _state_to(state, device):
    return None if state is None else state.to(device)


def loss_and_grads(params: Params, scene: FlatScene, cfg: RenderConfig,
                   target, key, loss_fn: Callable = mse_loss):
    """(loss, grads as Params) of loss_fn at params."""
    leaves = Params(*(x.detach().requires_grad_() for x in params.leaves()))
    loss = loss_fn(leaves, scene, cfg, target, key)
    loss.backward()
    return loss.detach(), leaves.grads()


def make_train_step(cfg: RenderConfig, optimizer: Optimizer,
                    loss_fn: Callable = mse_loss,
                    project_fn: Optional[Callable] = None, device="cuda"):
    """Single-device train step, on the card unless device="cpu":
    (params, opt_state, scene, target, key) -> (params, opt_state, loss).
    loss_fn(params, scene, cfg, target, key) -> scalar, as the JAX
    package's; opt_state: `optimizer.init(params)` to start. The inputs
    move to the device; the outputs live there."""
    dev = rend.resolve_device(device, "make_train_step")

    def step(params, opt_state, scene, target, key):
        params = params.to(dev)
        loss, grads = loss_and_grads(params, scene.to(dev), cfg,
                                     target.to(dev), key.to(dev), loss_fn)
        params, opt_state = optimizer.step(params, grads,
                                           _state_to(opt_state, dev))
        if project_fn is not None:
            params = project_fn(params)
        return params, opt_state, loss

    return step


def sharded_loss_and_grads(params: Params, scene: FlatScene,
                           cfg: RenderConfig, target, key, mesh):
    """(loss, grads as Params) of mse_loss over a ("data", "sample") mesh
    (parallel/mesh.py), equal on every rank. Call on every rank with the
    same arguments on the mesh's device; target is the full [H, W, 3]
    image (raw bottom-up rows).

    Each rank renders its pixel shard for its sample range, as
    parallel/shard.py does, and keeps its partial radiance sum r under
    autograd. A detached copy, all-reduced over "sample", is the pixels'
    image; the residual against the target (padding lanes masked out)
    gives the cotangent c of the squared error with respect to r, and
    (c * r).sum() is back-propagated. The gradients and the loss sum
    (counted once, on the first rank of each sample group) are
    all-reduced over the whole mesh in one buffer and divided by
    n_pixels * 3: the gradient of the global mean loss, the one-device
    gradient up to rounding.
    """
    spp_local, offset = sample_split(cfg, mesh)
    n_sample, s_rank, sample_group = axis(mesh, SAMPLE_AXIS)
    pix, valid = pixel_shard(cfg, mesh, scene.device)
    leaves = Params(*(x.detach().requires_grad_() for x in params.leaves()))
    state = rend.prepare_state(apply_params(scene, leaves), cfg)
    rad = rend.render_pixel_ids(state, cfg, pix, key, spp=spp_local,
                                sample_offset=offset)
    img = rad.detach().clone()
    if n_sample > 1:
        dist.all_reduce(img, group=sample_group)
    tgt = target.reshape(-1, 3)[pix]
    resid = torch.where(valid[:, None], img / cfg.spp - tgt, 0.0)
    # d(sum of squared residuals) / d(this rank's sample sum)
    (rad * (2.0 * resid / cfg.spp)).sum().backward()
    loss_sum = resid.square().sum() if s_rank == 0 else resid.new_zeros(())
    grads = leaves.grads().leaves()
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss_sum.reshape(1)])
    dist.all_reduce(flat)              # the mesh covers the whole group
    flat = flat / (cfg.n_pixels * 3)
    parts = flat[:-1].split([g.numel() for g in grads])
    return flat[-1], Params(*(p.reshape(g.shape)
                              for p, g in zip(parts, grads)))


def make_sharded_train_step(cfg: RenderConfig, mesh, optimizer: Optimizer,
                            project_fn: Optional[Callable] = None):
    """Distributed train step over a ("data", "sample") mesh, on the
    mesh's device: (params, opt_state, scene, target, key) -> (params,
    opt_state, loss), as `make_train_step` on the MSE loss. Call on
    every rank with the same arguments; `target` is the full [H, W, 3]
    image. The gradient is `sharded_loss_and_grads`'s, equal on every
    rank, so the optimiser runs on every rank on equal inputs and the
    parameters stay equal on every rank. The inputs move to this rank's
    device."""
    sample_split(cfg, mesh)            # spp must split over "sample"
    dev = mesh_device(mesh)

    def step(params, opt_state, scene, target, key):
        params = params.to(dev)
        loss, grads = sharded_loss_and_grads(params, scene.to(dev), cfg,
                                             target.to(dev), key.to(dev),
                                             mesh)
        params, opt_state = optimizer.step(params, grads,
                                           _state_to(opt_state, dev))
        if project_fn is not None:
            params = project_fn(params)
        return params, opt_state, loss

    return step
