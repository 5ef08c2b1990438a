"""Rank programs of tests/test_torch_shard.py: each runs in a process
started by `start` (the port's `parallel.spawn.start_ranks`), joins
a gloo group through a file:// store in the test's temporary directory
(so parallel test workers never race for a port), runs the port's
sharded paths on the CPU with one thread and saves what it got to
`rank<r>.pt` there. Imports torch and the port only (no JAX).
"""

import dataclasses
import os

import torch
import torch.distributed as dist

from tinypathtracer_tpu_torch.parallel.spawn import (collect_ranks, rank_file,
                                                     start_ranks as start)

# 255 pixels: the data shards of 2 and 4 ranks each hold a padding lane
FRAME = dict(width=17, height=15, spp=4, max_depth=2)
LR = 0.05
DESCENT_STEPS = 12


def collect(context, tmp) -> list:
    """What each rank of a context from `start` saved, in rank order,
    once all have exited, with no deadline. A rank that raised fails
    the call."""
    return collect_ranks(context, tmp, timeout=None)


def _scene(arrays):
    from tinypathtracer_tpu_torch import FlatScene

    return FlatScene.from_numpy(arrays, "cpu")


def _frames(scenes, mesh):
    """{scene name: the sharded radiance sum image} on mesh."""
    from tinypathtracer_tpu_torch import RenderConfig, prng_key
    from tinypathtracer_tpu_torch.parallel import render_frame_sharded

    cfg = RenderConfig(**FRAME)
    with torch.inference_mode():
        return {name: render_frame_sharded(_scene(a), cfg, prng_key(3), mesh)
                for name, a in scenes.items()}


def _train(arrays, target, mesh):
    """The sharded loss and gradients, and the parameters after one
    sharded Adam step (lr 1e-2), of the lit room against target."""
    from tinypathtracer_tpu_torch import RenderConfig, prng_key
    from tinypathtracer_tpu_torch.diff import (AdamState, Params, adam,
                                               make_sharded_train_step)
    from tinypathtracer_tpu_torch.diff.invrender import \
        sharded_loss_and_grads

    scene, cfg = _scene(arrays), RenderConfig(**FRAME)
    target = torch.from_numpy(target)
    params = Params.from_scene(scene)
    loss, grads = sharded_loss_and_grads(params, scene, cfg, target,
                                         prng_key(5), mesh)
    step = make_sharded_train_step(cfg, mesh, adam(1e-2))
    stepped, state, step_loss = step(params, AdamState.init(params), scene,
                                     target, prng_key(5))
    return {"loss": loss, "grads": grads.leaves(), "step_loss": step_loss,
            "params": stepped.leaves(), "adam_step": state.step}


def _descent(arrays, mesh):
    """Losses of DESCENT_STEPS sharded Adam steps (lr LR) on the room
    with base color 0 perturbed, against the sharded frame of the true
    room; the projection keeps every other leaf at its true value."""
    from tinypathtracer_tpu_torch import RenderConfig, prng_key
    from tinypathtracer_tpu_torch.diff import (AdamState, Params, adam,
                                               make_sharded_train_step)
    from tinypathtracer_tpu_torch.parallel import render_frame_sharded

    scene, cfg = _scene(arrays), RenderConfig(**FRAME)
    key = prng_key(2)
    with torch.inference_mode():
        target = render_frame_sharded(scene, cfg, key, mesh) / cfg.spp
    true = Params.from_scene(scene)
    params = dataclasses.replace(
        true, mtl_base_color=true.mtl_base_color.index_put(
            (torch.tensor([0]),), torch.tensor([[0.1, 0.9, 0.1]])))

    def only_albedo(p):
        return dataclasses.replace(
            true, mtl_base_color=torch.clamp(p.mtl_base_color, 0.0, 1.0))

    step = make_sharded_train_step(cfg, mesh, adam(LR),
                                   project_fn=only_albedo)
    state, losses = AdamState.init(params), []
    for _ in range(DESCENT_STEPS):
        params, state, loss = step(params, state, scene, target, key)
        losses.append(float(loss))
    return losses


def pair_rank(rank, world, tmp, scenes, lit_room, target):
    """Two ranks started from the JAX package's environment variables:
    initialize() and global_mesh() at (2, 1) and (1, 2), frames of both
    scenes on each, the sharded renderer at (2, 1), the sharded train
    step on each, the descent at (2, 1), an spp that does not split."""
    torch.set_num_threads(1)
    os.environ.update(COORDINATOR_ADDRESS=f"file://{tmp}/store",
                      NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    from tinypathtracer_tpu_torch import RenderConfig, prng_key
    from tinypathtracer_tpu_torch.parallel import (global_mesh, initialize,
                                                   make_sharded_renderer)

    initialize(device="cpu")
    out = {"world": dist.get_world_size(), "rank": dist.get_rank(),
           "backend": dist.get_backend()}
    meshes = {(2, 1): global_mesh(device="cpu"),
              (1, 2): global_mesh(n_sample=2, device="cpu")}
    out["meshes"] = {k: (m.mesh_dim_names, tuple(m.shape))
                     for k, m in meshes.items()}
    try:
        global_mesh(n_sample=3, device="cpu")
    except ValueError as e:
        out["global_mesh_error"] = str(e)
    out["frames"] = {k: _frames(scenes, m) for k, m in meshes.items()}
    out["renderer"] = make_sharded_renderer(
        RenderConfig(**FRAME), meshes[(2, 1)])(_scene(scenes["room"]),
                                               prng_key(3))
    out["train"] = {k: _train(lit_room, target, m) for k, m in meshes.items()}
    out["descent"] = _descent(scenes["room"], meshes[(2, 1)])
    try:
        from tinypathtracer_tpu_torch.diff import (adam,
                                                   make_sharded_train_step)

        make_sharded_train_step(RenderConfig(**dict(FRAME, spp=3)),
                                meshes[(1, 2)], adam(1e-2))
    except ValueError as e:
        out["spp_error"] = str(e)
    torch.save(out, rank_file(tmp, rank))
    dist.destroy_process_group()


def quad_rank(rank, world, tmp, scenes, lit_room, target):
    """Four ranks started with explicit arguments: make_mesh's shapes
    and errors, frames of both scenes at (4, 1) and (2, 2), the sharded
    train step at (2, 2)."""
    torch.set_num_threads(1)
    from tinypathtracer_tpu_torch.parallel import initialize, make_mesh

    initialize(f"file://{tmp}/store", world, rank, device="cpu")
    meshes = {(4, 1): make_mesh(device="cpu"),
              (2, 2): make_mesh(2, 2, device="cpu")}
    out = {"meshes": {k: (m.mesh_dim_names, tuple(m.shape))
                      for k, m in meshes.items()},
           "mesh_errors": []}
    for shape in ((4, 2), (2, 1)):
        try:
            make_mesh(*shape, device="cpu")
        except ValueError as e:
            out["mesh_errors"].append(str(e))
    out["frames"] = {k: _frames(scenes, m) for k, m in meshes.items()}
    out["train"] = {(2, 2): _train(lit_room, target, meshes[(2, 2)])}
    torch.save(out, rank_file(tmp, rank))
    dist.destroy_process_group()



def sgd_rank(rank, world, tmp, lit_room, target, lr, momentum):
    """Two ranks on a (2, 1) mesh: one make_sharded_train_step step with
    sgd(lr, momentum) on the lit room against target (key 5), from the
    optimiser's initial state; saves the loss, new parameters and
    trace."""
    torch.set_num_threads(1)
    from tinypathtracer_tpu_torch import RenderConfig, prng_key
    from tinypathtracer_tpu_torch.diff import (Params,
                                               make_sharded_train_step, sgd)
    from tinypathtracer_tpu_torch.parallel import initialize, make_mesh

    initialize(f"file://{tmp}/store", world, rank, device="cpu")
    scene, cfg = _scene(lit_room), RenderConfig(**FRAME)
    params, opt = Params.from_scene(scene), sgd(lr, momentum=momentum)
    step = make_sharded_train_step(cfg, make_mesh(device="cpu"), opt)
    new, state, loss = step(params, opt.init(params), scene,
                            torch.from_numpy(target), prng_key(5))
    torch.save({"loss": loss, "params": new.leaves(),
                "trace": state.trace.leaves()},
               rank_file(tmp, rank))
    dist.destroy_process_group()
