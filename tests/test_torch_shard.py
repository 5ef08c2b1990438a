"""The port's torch.distributed slice (`parallel/`,
`diff.make_sharded_train_step`, the CLI's --shard) on the CPU: gloo
ranks in processes started with torch.multiprocessing ("spawn"), each
joined through a file:// store under the test's temporary directory and
run on one thread (tests/_torch_dist.py), against the port on one
device and the JAX package's sharded paths on the same mesh shapes (8
virtual CPU devices, tests/conftest.py).

Scenes: the room `sphere_grid_scene(1, 6, 12)` (the megakernel twin),
the same room with three delta lights for the gradients, and
`sphere_grid_scene(4, 8, 16)`, above 8,192 faces (the packet twin). A
17x15 frame @4 spp d2: 255 pixels, so the data shards of 2 and 4 ranks
hold padding lanes. Tolerances:

  * data-sharded frames ((2, 1), (4, 1)) equal the one-device frame bit
    for bit; sample-sharded ones ((1, 2), (2, 2)) within 1e-5 (only the
    order of the sample sum differs);
  * every frame within 1e-5 of JAX `render_frame_sharded`;
  * the sharded loss within 1e-6 relative, and the gradients rtol 1e-5,
    of the port's one-device `loss_and_grads` (each leaf with atol 1e-6
    of its largest gradient: the camera's gradient sums terms of both
    signs, whose order the shards change);
  * gradients rtol 1e-4 of JAX `make_sharded_train_step` with
    optax.sgd(1.0), recovered as params - new params, with atol 1e-6 of
    the leaf's largest gradient plus the recovery's own rounding (2 ulp
    of each parameter);
  * the parameters after one sharded Adam step equal on every rank.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.diff import invrender as jinv
from tinypathtracer_tpu.parallel import mesh as jmesh
from tinypathtracer_tpu.parallel.shard import \
    render_frame_sharded as jax_render_frame_sharded
from tinypathtracer_tpu_torch import RenderConfig, Renderer, prng_key
from tinypathtracer_tpu_torch.diff import Params
from tinypathtracer_tpu_torch.diff.invrender import loss_and_grads
from tinypathtracer_tpu_torch.parallel import make_mesh
from tinypathtracer_tpu_torch.parallel.shard import _padded_pixels
from tinypathtracer_tpu_torch.render.renderer import render_frame
from tinypathtracer_tpu_torch.tools import render_cli

from _torch_dist import FRAME, collect, pair_rank, quad_rank, start
from _torch_scenes import jax_scene, port_scene, to_numpy, write_room

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {"room": (1, 6, 12), "large": (4, 8, 16)}
DATA_MESHES = [(2, 1), (4, 1)]
SAMPLE_MESHES = [(1, 2), (2, 2)]
TRAIN_MESHES = [(2, 1), (1, 2), (2, 2)]
FIELDS = [f.name for f in dataclasses.fields(Params)]


def _target():
    rng = np.random.default_rng(0)
    return rng.random((FRAME["height"], FRAME["width"], 3)).astype(np.float32)


def _jax_cfg():
    return JaxConfig(**FRAME, megakernel=False, mega_impl="off")


def _jax_frame(flat, shape):
    """JAX render_frame_sharded on a mesh of shape (jitted: compiling
    the whole frame once is quicker than running it op by op)."""
    mesh = jmesh.make_mesh(*shape)
    return jax.jit(lambda s, k: jax_render_frame_sharded(
        s, _jax_cfg(), k, mesh))(flat, jax.random.PRNGKey(3))


def _jax_sharded_grads(flat, shape):
    """JAX make_sharded_train_step's gradient on a mesh of shape, from
    one optax.sgd(1.0) step: (grads, params) as numpy dicts."""
    jparams = jinv.Params.from_scene(flat)
    opt = optax.sgd(1.0)
    step = jinv.make_sharded_train_step(_jax_cfg(), jmesh.make_mesh(*shape),
                                        opt)
    new, _, _ = step(jparams, opt.init(jparams), flat,
                     jnp.asarray(_target()), jax.random.PRNGKey(5))
    p = {f: np.asarray(getattr(jparams, f)) for f in FIELDS}
    return {f: p[f] - np.asarray(getattr(new, f)) for f in FIELDS}, p


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The rank programs' results (started first, so that they run while
    the references are computed here) and the references: the port's
    one-device frames, renderer, loss and gradients, JAX's sharded
    frames and gradients."""
    flats = {name: jax_scene(*grid) for name, grid in SCENES.items()}
    lit = jax_scene(lights=True)
    scenes = {name: to_numpy(f) for name, f in flats.items()}
    args = (scenes, to_numpy(lit), _target())
    dirs = [tmp_path_factory.mktemp(n) for n in ("pair", "quad")]
    contexts = [start(pair_rank, 2, dirs[0], *args),
                start(quad_rank, 4, dirs[1], *args)]
    cfg = RenderConfig(**FRAME)
    ref = {}
    with torch.inference_mode():
        ref["frames"] = {name: render_frame(port_scene(f), cfg, prng_key(3))
                         for name, f in flats.items()}
        ref["renderer"] = Renderer(cfg, device="cpu").render(
            port_scene(flats["room"]), prng_key(3))
    loss, grads = loss_and_grads(Params.from_scene(port_scene(lit)),
                                 port_scene(lit), cfg,
                                 torch.from_numpy(_target()), prng_key(5))
    ref["loss"], ref["grads"] = float(loss), grads.leaves()
    ref["jax_frames"] = {
        (name, shape): np.asarray(_jax_frame(f, shape))
        for name, f in flats.items()
        for shape in DATA_MESHES + SAMPLE_MESHES}
    ref["jax_grads"] = {shape: _jax_sharded_grads(lit, shape)
                        for shape in TRAIN_MESHES}
    pair, quad = (collect(c, d) for c, d in zip(contexts, dirs))
    ranks = {shape: pair for shape in ((2, 1), (1, 2))}
    ranks.update({shape: quad for shape in ((4, 1), (2, 2))})
    return ranks, ref


def _images(ranks, shape, name):
    return [r["frames"][shape][name] for r in ranks[shape]]


def test_padded_pixels():
    cfg = RenderConfig(**FRAME)
    for n_data, total in ((1, 255), (2, 256), (4, 256), (3, 255)):
        pix, got = _padded_pixels(cfg, n_data)
        assert got == total and pix.shape == (total,)
        assert torch.equal(pix[:255], torch.arange(255))
        assert not pix[255:].any()          # padding re-renders pixel 0


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_make_mesh_shapes_and_errors(run):
    ranks, _ = run
    for r in ranks[(4, 1)]:
        assert r["meshes"] == {(4, 1): (("data", "sample"), (4, 1)),
                               (2, 2): (("data", "sample"), (2, 2))}
        assert r["mesh_errors"][0] == "mesh 4x2 needs 8 devices, have 4"
        assert "must cover every rank" in r["mesh_errors"][1]


def test_initialize_and_global_mesh_from_environment(run):
    ranks, _ = run
    for rank, r in enumerate(ranks[(2, 1)]):
        assert (r["world"], r["rank"], r["backend"]) == (2, rank, "gloo")
        assert r["meshes"] == {(2, 1): (("data", "sample"), (2, 1)),
                               (1, 2): (("data", "sample"), (1, 2))}
        assert r["global_mesh_error"] == ("2 global devices not divisible "
                                          "by n_sample=3")
        assert "not divisible by sample axis 2" in r["spp_error"]


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("shape", DATA_MESHES)
def test_data_sharded_frame_equals_one_device(run, shape, name):
    ranks, ref = run
    for img in _images(ranks, shape, name):
        assert torch.equal(img, ref["frames"][name])
    assert float(ref["frames"][name].mean()) > 0.05


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("shape", SAMPLE_MESHES)
def test_sample_sharded_frame_within_1e5(run, shape, name):
    ranks, ref = run
    imgs = _images(ranks, shape, name)
    for img in imgs:
        assert torch.equal(img, imgs[0])
    assert float((imgs[0] - ref["frames"][name]).abs().max()) <= 1e-5


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("shape", DATA_MESHES + SAMPLE_MESHES)
def test_frame_matches_jax_sharded(run, shape, name):
    ranks, ref = run
    got = _images(ranks, shape, name)[0].numpy()
    np.testing.assert_allclose(got, ref["jax_frames"][(name, shape)],
                               rtol=0, atol=1e-5)


def test_sharded_renderer_equals_renderer(run):
    ranks, ref = run
    for r in ranks[(2, 1)]:
        assert torch.equal(r["renderer"], ref["renderer"])


def _assert_grads(got, want, rtol, slack=None):
    """Per leaf: finite, |got - want| <= rtol |want| + 1e-6 max|want|
    (+ slack[leaf], elementwise, where given)."""
    for f, g, w in zip(FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), f
        if not w.size:
            continue
        tol = rtol * np.abs(w) + 1e-6 * np.abs(w).max()
        if slack is not None:
            tol = tol + slack[f]
        assert (np.abs(g - w) <= tol).all(), (f, np.abs(g - w).max())


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_sharded_grads_match_one_device(run, shape):
    ranks, ref = run
    for r in ranks[shape]:
        t = r["train"][shape]
        assert abs(float(t["loss"]) - ref["loss"]) <= 1e-6 * ref["loss"]
        assert float(t["step_loss"]) == float(t["loss"])
        _assert_grads(t["grads"], ref["grads"], 1e-5)
    assert max(float(g.abs().max()) for g in ref["grads"]) > 0


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_sharded_grads_match_jax(run, shape):
    ranks, ref = run
    want, params = ref["jax_grads"][shape]
    slack = {f: 2 * np.finfo(np.float32).eps * np.abs(params[f])
             for f in FIELDS}
    _assert_grads(ranks[shape][0]["train"][shape]["grads"],
                  [want[f] for f in FIELDS], 1e-4, slack)


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_adam_step_params_equal_on_every_rank(run, shape):
    ranks, _ = run
    first = ranks[shape][0]["train"][shape]
    assert first["adam_step"] == 1
    for r in ranks[shape][1:]:
        t = r["train"][shape]
        assert all(torch.equal(a, b)
                   for a, b in zip(t["params"], first["params"]))
        assert all(torch.equal(a, b)
                   for a, b in zip(t["grads"], first["grads"]))


def test_sharded_step_descends(run):
    ranks, _ = run
    for r in ranks[(2, 1)]:
        losses = r["descent"]
        assert r["descent"] == ranks[(2, 1)][0]["descent"]
        assert np.isfinite(losses[0]) and losses[0] > 0
        assert min(losses) < 0.5 * losses[0], losses


def test_cli_shard_two_processes(tmp_path):
    """render_cli --shard --device cpu as two processes started from
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID: rank 0's PNG equals
    the unsharded CLI's byte for byte; rank 1 writes none."""
    scene = write_room(tmp_path)
    args = ["--scene", scene, "--width", "17", "--height", "15", "--spp",
            "4", "--depth", "2", "--seed", "3", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               COORDINATOR_ADDRESS=f"file://{tmp_path}/store",
               NUM_PROCESSES="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tinypathtracer_tpu_torch.tools.render_cli",
         "--shard", "--out", str(tmp_path / f"shard{rank}.png")] + args,
        cwd=REPO, env=dict(env, PROCESS_ID=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    render_cli.main(["--out", str(tmp_path / "one.png")] + args)
    with open(tmp_path / "shard0.png", "rb") as a, \
            open(tmp_path / "one.png", "rb") as b:
        assert a.read() == b.read()
    assert not (tmp_path / "shard1.png").exists()
