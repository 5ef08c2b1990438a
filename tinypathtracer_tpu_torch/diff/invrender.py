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

Not ported yet: `make_sharded_train_step` (ROADMAP item 1.6,
torch.distributed sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tinypathtracer_tpu_torch.config import RenderConfig
from tinypathtracer_tpu_torch.models.scene import FlatScene
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
