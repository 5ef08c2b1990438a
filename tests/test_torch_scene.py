"""The port's scene tables against the JAX package's, on the CPU.

Procedural arrays, world vertices, morton codes, the slot permutation
and the Woop planes are exactly equal. World normals (and the corner
normals of the shading table built from them) are within 2 ulp: XLA:CPU
computes `lax.rsqrt` as an approximation refined by Newton steps, while
the port computes 1 / sqrt correctly rounded; the two differ by up to
1 ulp, and the product with the normal rounds once more (measured:
<= 2 ulp).
The JAX tables are built under `jax.jit`, as the renderer builds them:
XLA fuses their multiply-adds only inside a compiled computation.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu.models.envlight import gradient_sky as jax_sky
from tinypathtracer_tpu.models.procedural import sphere_grid_scene as jax_grid
from tinypathtracer_tpu.ops.dense import precompute_woop as jax_woop
from tinypathtracer_tpu.ops.lbvh import morton30 as jax_morton30
from tinypathtracer_tpu.render.integrator import TraceData as JaxTraceData
from tinypathtracer_tpu_torch import RenderConfig
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene
from tinypathtracer_tpu_torch.ops.dense import precompute_woop
from tinypathtracer_tpu_torch.ops.lbvh import morton30
from tinypathtracer_tpu_torch.render.integrator import TraceData

from _torch_scenes import jax_planes, jax_scene, port_scene, to_numpy

torch.set_num_threads(2)

GRIDS = [(1, 6, 12), (2, 8, 16)]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


@pytest.mark.parametrize("grid", GRIDS)
def test_procedural_arrays_identical(grid):
    jax_flat = to_numpy(jax_grid(*grid, env_radiance=jax_sky(64, 128)))
    port = sphere_grid_scene(*grid, env_radiance=gradient_sky(64, 128))
    for name, want in jax_flat.items():
        got = getattr(port, name).numpy()
        assert got.shape == want.shape and np.array_equal(got, want), name


@pytest.mark.parametrize("grid", GRIDS)
def test_world_geometry(grid):
    flat = jax_scene(*grid)
    wv, wn = jax.jit(lambda s: s.world_geometry())(flat)
    pv, pn = port_scene(flat).world_geometry()
    assert np.array_equal(np.asarray(wv), pv.numpy())
    assert _ulps(wn, pn.numpy()) <= 2


@pytest.mark.parametrize("lights", [False, True])
def test_trace_data_fields(lights):
    flat = jax_scene(2, 8, 16, lights=lights)
    want = jax.jit(JaxTraceData.from_scene)(flat)
    got = TraceData.from_scene(port_scene(flat))
    for f in dataclasses.fields(got):
        a, b = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert a.shape == b.shape, f.name
        if f.name in ("world_normals", "shade_packT"):
            assert _ulps(a, b) <= 2, f.name
        else:
            assert np.array_equal(a, b), f.name


def test_morton30_exact():
    rng = np.random.default_rng(3)
    cent = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    cent[:8] = cent[8:16]                            # duplicate codes
    lo, hi = cent.min(0), cent.max(0)
    want = np.asarray(jax_morton30(jnp.asarray(cent), jnp.asarray(lo),
                                   jnp.asarray(hi)))
    got = morton30(torch.from_numpy(cent), torch.from_numpy(lo),
                   torch.from_numpy(hi)).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("grid", GRIDS + [(2, 16, 32)])
def test_woop_planes_and_perm(grid):
    """Stable morton order (ties keep file order), padding to 128 up to
    4096 faces / 4096 above, all-zero padding planes: exactly JAX's."""
    data = jax.jit(JaxTraceData.from_scene)(jax_scene(*grid))
    want = jax.jit(jax_woop)(data.tri_verts)
    got = precompute_woop(torch.from_numpy(np.array(data.tri_verts)))
    assert got.n_faces == want.n_faces and got.n_padded == want.n_padded
    assert np.array_equal(np.asarray(want.perm), got.perm.numpy())
    assert np.array_equal(jax_planes(want), got.planes.numpy())
    assert not got.planes[got.n_faces:].any()


def test_big_room_pads_to_megakernel_limit():
    """The 7,692-face room pads to 8,192 slots: still megakernel scope."""
    scene = sphere_grid_scene(2, 16, 32)
    woop = precompute_woop(TraceData.from_scene(scene).tri_verts)
    assert (woop.n_faces, woop.n_padded) == (7692, 8192)


def test_config_validation():
    cfg = RenderConfig(mode="physical")
    assert (cfg.mode, cfg.russian_roulette, cfg.area_nee) == (
        "physical", False, True)
    with pytest.raises(ValueError):
        RenderConfig(mode="biased")
    for isect in ("bvh", "bruteforce", "packet"):
        assert RenderConfig(intersector=isect).intersector == isect
    with pytest.raises(ValueError):
        RenderConfig(intersector="octree")
    with pytest.raises(ValueError):
        RenderConfig(spp=0)
    with pytest.raises(ValueError):
        RenderConfig(bvh_source="disk")
    with pytest.raises(ValueError):
        RenderConfig(stack_depth=0)


def test_textured_scene_not_ported():
    """Textured scenes are ported now: TraceData no longer raises on an
    atlas, it adds the six texcoord rows and the atlas tables (their
    values are held to JAX's in tests/test_torch_textured.py)."""
    scene = dataclasses.replace(port_scene(jax_scene()),
                                tex_atlas=torch.ones((1, 4, 4, 3)))
    data = TraceData.from_scene(scene)
    assert data.textured
    assert data.shade_packT.shape == (21, scene.indices.shape[0])
    assert data.atlas_r.shape == (16,) and data.atlas_mips_r.shape == (21,)
