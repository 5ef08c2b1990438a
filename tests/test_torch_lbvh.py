"""The LBVH, its traversal and the brute-force oracles: the port's plain
PyTorch versions against the JAX package's on the same triangles and
rays (ops/lbvh.py, ops/traverse.py, ops/intersect.py), the host builder
against the device build, the stack guard, and the "bvh" and
"bruteforce" routes of the Renderer against the JAX Renderer's frames.

The builds are integer arithmetic and min / max: trees equal exactly.
The hit tests round as XLA:CPU fuses the JAX versions, so hits (fid, t,
uv) equal exactly too. Frames agree within 1e-5 (the shading is unfused
in the port and FMA-fused by XLA).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu import Renderer as JaxRenderer
from tinypathtracer_tpu.ops import intersect as jintersect
from tinypathtracer_tpu.ops import lbvh as jlbvh
from tinypathtracer_tpu.ops import traverse as jtraverse
from tinypathtracer_tpu_torch import RenderConfig, Renderer, prng_key
from tinypathtracer_tpu_torch.ops import dense, intersect, lbvh, traverse
from tinypathtracer_tpu_torch.ops.mega import mega_trace
from tinypathtracer_tpu_torch.render import renderer
from tinypathtracer_tpu_torch.utils import native

from _torch_scenes import jax_scene, port_scene

torch.set_num_threads(2)

FIELDS = ("left", "right", "parent", "leaf_fid", "bmin", "bmax")


def random_tris(n, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n, 1, 3))
    return (centers + rng.normal(scale=0.3, size=(n, 3, 3))).astype(
        np.float32)


def random_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def comb_tris(extra=0):
    """tests/test_stack_guard.py's adversarial input: centroids whose
    morton codes are 2^0 .. 2^29 build a ~30-deep comb; `extra` appends
    equal-code duplicates at distinct depths."""
    pos = []
    for i in range(30):
        p = [0.0, 0.0, 0.0]
        p[i % 3] = float(2 ** (i // 3)) + 0.5
        pos.append(p)
    pos += [[0.25, 0.25, 0.25], [1023.5, 1023.5, 1023.5]]
    pos += [[0.25, 0.25, 0.25 - 0.001 * (k + 1)] for k in range(extra)]
    tris = np.zeros((len(pos), 3, 3), np.float32)
    for i, (x, y, z) in enumerate(pos):
        tris[i] = [[x - 0.2, y - 0.2, z], [x + 0.2, y - 0.2, z],
                   [x, y + 0.2, z]]
    return tris


def jax_tree(tris):
    bvh = jax.jit(jlbvh.build_lbvh)(jnp.asarray(tris))
    return {f: np.asarray(getattr(bvh, f)) for f in FIELDS + ("tri_verts",)}


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 500])
def test_build_equals_jax_and_invariants(n):
    """Topology and boxes equal the JAX build's; every node but the root
    is one parent's child, parent links agree, leaves are a permutation,
    and every box holds its children's."""
    tris = random_tris(n)
    bvh = lbvh.build_lbvh(torch.from_numpy(tris))
    want = jax_tree(tris)
    for f in FIELDS:
        got = getattr(bvh, f)
        assert got.dtype == (torch.float32 if f in ("bmin", "bmax")
                             else torch.int32), f
        assert np.array_equal(got.numpy(), want[f]), f
    if n == 1:
        assert int(bvh.parent[0]) == -1
        return
    left, right = bvh.left.numpy(), bvh.right.numpy()
    parent = bvh.parent.numpy()
    refs = np.zeros(2 * n - 1, dtype=int)
    np.add.at(refs, left, 1)
    np.add.at(refs, right, 1)
    assert refs[0] == 0 and (refs[1:] == 1).all() and parent[0] == -1
    assert (parent[left] == np.arange(n - 1)).all()
    assert (parent[right] == np.arange(n - 1)).all()
    assert sorted(bvh.leaf_fid.tolist()) == list(range(n))
    bmin, bmax = bvh.bmin.numpy(), bvh.bmax.numpy()
    for c in (left, right):
        assert (bmin[:n - 1] <= bmin[c]).all() and (bmax[:n - 1] >= bmax[c]).all()


def test_duplicate_centroids_build_a_valid_tree():
    tri = np.broadcast_to(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                   np.float32), (33, 3, 3)).copy()
    bvh = lbvh.build_lbvh(torch.from_numpy(tri))
    refs = np.zeros(65, dtype=int)
    np.add.at(refs, bvh.left.numpy(), 1)
    np.add.at(refs, bvh.right.numpy(), 1)
    assert (refs[1:] == 1).all()
    assert np.array_equal(bvh.left.numpy(), jax_tree(tri)["left"])


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (17, 2), (200, 3),
                                    (1000, 4)])
def test_bvh_walk_equals_jax_and_bruteforce(n, seed):
    """On a JAX-built tree carried across (BVH.from_numpy), the port's
    closest_hit_bvh equals JAX closest_hit_bvh exactly, and the port's
    brute force equals JAX's; the walk's faces and t are the brute
    force's (uv too, away from measure-zero ties)."""
    tris = random_tris(n, seed=seed)
    o, d = random_rays(256, seed=seed + 10)
    bvh = lbvh.BVH.from_numpy(jax_tree(tris), "cpu")
    got = traverse.closest_hit_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                   bvh)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    want = jtraverse.closest_hit_bvh(jo, jd, jax.jit(jlbvh.build_lbvh)(
        jnp.asarray(tris)))
    for g, w, name in zip(got, want, ("fid", "t", "uv")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    bf = intersect.closest_hit_bruteforce(torch.from_numpy(o),
                                          torch.from_numpy(d),
                                          torch.from_numpy(tris))
    want_bf = jintersect.closest_hit_bruteforce(jo, jd, jnp.asarray(tris))
    for g, w, name in zip(bf, want_bf, ("fid", "t", "uv")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    hit = bf[0] >= 0
    assert torch.equal(got[0] >= 0, hit)
    assert torch.equal(got[1][hit], bf[1][hit])
    same = (got[0] == bf[0]) & hit
    assert float((~same & hit).float().mean()) < 0.01
    assert torch.equal(got[2][same], bf[2][same])


def test_mask_and_any_hit():
    """Masked lanes traverse nothing and miss; any_hit_bruteforce is the
    closest hit's hit flag; ray_aabb agrees with JAX's."""
    tris = random_tris(64, seed=5)
    o, d = random_rays(128, seed=6)
    mask = torch.from_numpy(np.arange(128) % 3 != 0)
    bvh = lbvh.build_lbvh(torch.from_numpy(tris))
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, tris))
    fid, t, uv = traverse.closest_hit_bvh(ot, dt, bvh, mask=mask)
    full = traverse.closest_hit_bvh(ot, dt, bvh)
    assert (fid[~mask] == -1).all() and (t[~mask] == dense.REAL_MAX).all()
    assert torch.equal(fid[mask], full[0][mask])
    assert torch.equal(intersect.any_hit_bruteforce(ot, dt, tt),
                       intersect.closest_hit_bruteforce(ot, dt, tt)[0] >= 0)
    inv = 1.0 / dt
    want = jintersect.ray_aabb(jnp.asarray(o), jnp.asarray(inv.numpy()),
                               jnp.asarray(tris.min(1)),
                               jnp.asarray(tris.max(1)))
    got = intersect.ray_aabb(ot, inv, tt.amin(1), tt.amax(1))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 500])
def test_host_build_equals_device_build(n):
    """The C++ host builder (utils/native.py) gives the device build's
    topology and boxes."""
    tris = random_tris(n, seed=7)
    host = native.build_lbvh_host(tris)
    dev = lbvh.build_lbvh(torch.from_numpy(tris))
    for f in FIELDS:
        if n == 1 and f in ("left", "right"):
            continue
        assert np.array_equal(host[f], getattr(dev, f).numpy()), f


def test_tree_depth_and_deep_stack_on_comb():
    """tree_depth equals JAX's on the comb; with a stack deep enough the
    walk equals the brute force on the degenerate tree."""
    tris = comb_tris(extra=30)
    bvh = lbvh.build_lbvh(torch.from_numpy(tris))
    depth = lbvh.tree_depth(bvh)
    assert depth > 20
    assert depth == int(jax.jit(jlbvh.tree_depth)(
        jax.jit(jlbvh.build_lbvh)(jnp.asarray(tris))))
    rng = np.random.default_rng(2)
    o = np.stack([rng.uniform(-1, 1025, 128), rng.uniform(-1, 1025, 128),
                  np.full(128, 1500.0)], -1).astype(np.float32)
    d = rng.normal(scale=0.05, size=(128, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    fv, tv, _ = traverse.closest_hit_bvh(ot, dt, bvh, stack_depth=64)
    fb, tb, _ = intersect.closest_hit_bruteforce(ot, dt, torch.from_numpy(tris))
    assert torch.equal(fv, fb) and torch.equal(tv, tb)


def _comb_flat():
    """The room with its geometry replaced by the comb (JAX FlatScene)."""
    flat = jax_scene()
    tris = comb_tris()
    f = tris.shape[0]
    return dataclasses.replace(
        flat, vertices=jnp.asarray(tris.reshape(-1, 3)),
        normals=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (3 * f, 1)),
        texcoords=jnp.zeros((3 * f, 2), jnp.float32),
        indices=jnp.arange(3 * f, dtype=jnp.int32).reshape(f, 3),
        face_mtl=jnp.zeros((f,), jnp.int32),
        vert_obj=jnp.zeros((3 * f,), jnp.int32),
        vert_mats=jnp.eye(4)[None], normal_mats=jnp.eye(4)[None],
        obj_face_begin=jnp.zeros((1,), jnp.int32),
        obj_mtl_idx=jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("source", ["device", "host"])
def test_renderer_refuses_overflowing_stack(source):
    """The stack guard: on the comb the Renderer raises with the JAX
    package's message, for both tree sources; a stack that holds the
    tree renders."""
    scene = port_scene(_comb_flat())
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=1,
                       intersector="bvh", stack_depth=16, bvh_source=source)
    with pytest.raises(ValueError, match="stack_depth=16 can overflow"):
        Renderer(cfg, device="cpu").render(scene, prng_key(0))
    img = Renderer(dataclasses.replace(cfg, stack_depth=64),
                   device="cpu").render(scene, prng_key(0))
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("isect,source", [("bvh", "device"), ("bvh", "host"),
                                          ("bruteforce", "device")])
def test_frames_match_jax(isect, source):
    """A tiny frame of the room through the port's "bvh" (both tree
    sources) and "bruteforce" routes against the JAX Renderer on the same
    scene and key, within 1e-5; neither route launches a kernel, and
    each equals the port's dense frame where no hit ties."""
    flat = jax_scene(lights=True)
    kw = dict(width=8, height=8, spp=2, max_depth=3, intersector=isect,
              bvh_source=source)
    want = np.asarray(JaxRenderer(JaxConfig(**kw)).render(
        flat, jax.random.PRNGKey(4)))
    scene = port_scene(flat)
    before = (dense.dense_hit.launches, mega_trace.launches)
    got = Renderer(RenderConfig(**kw), device="cpu").render(scene,
                                                            prng_key(4))
    assert (dense.dense_hit.launches, mega_trace.launches) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want.mean() > 0.05
    ref = Renderer(RenderConfig(width=8, height=8, spp=2, max_depth=3),
                   device="cpu").render(scene, prng_key(4))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_routes_and_states():
    """bvh and bruteforce resolve to themselves at any size and hold
    their own tables; hit_fn's bruteforce chunk is JAX's."""
    scene = port_scene(jax_scene())
    for isect in ("bvh", "bruteforce"):
        cfg = RenderConfig(intersector=isect)
        assert renderer.resolve_intersector(cfg, 61452) == isect
        st = renderer.prepare_state(scene, cfg)
        assert st.packet is None and st.woop is None
        assert (st.bvh is not None) == (isect == "bvh")
    st = renderer.prepare_state(scene, RenderConfig(intersector="bruteforce"))
    fn = renderer.hit_fn(st, RenderConfig(intersector="bruteforce"))
    assert fn.keywords["chunk"] == min(512, max(8, st.data.tri_verts.shape[0]))
