"""Differentiable / inverse rendering (port of
`tinypathtracer_tpu/diff/invrender.py`).

The integrator is differentiable end to end by construction: hit ids
are detached, every shading quantity is recomputed with differentiable
ops, and every draw comes from a counter-based key. So the gradient of
a render is path-replay backprop: the backward pass replays the same
paths. On the megakernel path it replays the shading alone, on the hit
residuals the forward kernel recorded (ops/mega.py).

`Params` picks out the differentiable leaves (material colors, scalar
emissions, light intensities, env map, camera pose); `make_train_step`
is one Adam step (`torch.optim.Adam`, optax.adam's defaults) on the MSE
loss. The JAX package's functional signature is kept: the step takes
and returns (params, opt_state), with the optimizer state held as
`AdamState`, the counterpart of optax's ScaleByAdamState.
`make_sharded_train_step` is the same step over a ("data", "sample")
device mesh (parallel/mesh.py): pixels and samples shard over the
ranks, the gradient is all-reduced, Adam runs on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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


def adam_step(params: Params, grads: Params, state: AdamState, lr: float):
    """One torch.optim.Adam update of params with grads from state.
    Returns (new params, new AdamState); the inputs are not modified."""
    leaves = [x.detach().clone() for x in params.leaves()]
    opt = torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
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


def loss_and_grads(params: Params, scene: FlatScene, cfg: RenderConfig,
                   target, key):
    """(loss, grads as Params) of mse_loss at params."""
    leaves = Params(*(x.detach().requires_grad_() for x in params.leaves()))
    loss = mse_loss(leaves, scene, cfg, target, key)
    loss.backward()
    return loss.detach(), leaves.grads()


def make_train_step(cfg: RenderConfig, lr: float = 1e-2,
                    project_fn: Optional[Callable] = None, device="cuda"):
    """Single-device train step, on the card unless device="cpu":
    (params, opt_state, scene, target, key) -> (params, opt_state, loss).
    opt_state: an AdamState (`AdamState.init(params)` to start). The
    inputs move to the device; the outputs live there."""
    dev = rend.resolve_device(device, "make_train_step")

    def step(params, opt_state, scene, target, key):
        params = params.to(dev)
        loss, grads = loss_and_grads(params, scene.to(dev), cfg,
                                     target.to(dev), key.to(dev))
        params, opt_state = adam_step(params, grads, opt_state.to(dev), lr)
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


def make_sharded_train_step(cfg: RenderConfig, mesh, lr: float = 1e-2,
                            project_fn: Optional[Callable] = None):
    """Distributed train step over a ("data", "sample") mesh, on the
    mesh's device: (params, opt_state, scene, target, key) -> (params,
    opt_state, loss), as `make_train_step`. Call on every rank with the
    same arguments; `target` is the full [H, W, 3] image. The gradient
    is `sharded_loss_and_grads`'s, equal on every rank, so Adam runs on
    every rank on equal inputs and the parameters stay equal on every
    rank. The inputs move to this rank's device."""
    sample_split(cfg, mesh)            # spp must split over "sample"
    dev = mesh_device(mesh)

    def step(params, opt_state, scene, target, key):
        params = params.to(dev)
        loss, grads = sharded_loss_and_grads(params, scene.to(dev), cfg,
                                             target.to(dev), key.to(dev),
                                             mesh)
        params, opt_state = adam_step(params, grads, opt_state.to(dev), lr)
        if project_fn is not None:
            params = project_fn(params)
        return params, opt_state, loss

    return step
