"""The port's `models/texture.py` against the JAX package's, on the same
seeded inputs: the mip shapes and pyramid, the flat atlas mip chain bit
for bit (the decimation keeps the even texel of each pair), point
sampling (exact texels, wrapping), bilinear sampling (the midpoint,
wrapping, random uvs within 1e-6), `sample_mip` at every level, and
the gradient of a weighted texel sum against `jax.grad` (rtol 1e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu.models import texture as jtex
from tinypathtracer_tpu_torch.models import texture as tex

torch.set_num_threads(2)

SHAPES = [(64, 32), (5, 7), (1, 1), (8, 8), (1, 6)]


def _uv(n, seed, span=(-1.5, 2.5)):
    rng = np.random.default_rng(seed)
    return rng.uniform(*span, size=(n, 2)).astype(np.float32)


def _img(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_mip_level_shapes_match_jax(shape):
    assert tex.mip_level_shapes(*shape) == jtex.mip_level_shapes(*shape)
    assert tex.mip_level_shapes(*shape, max_levels=3) == \
        jtex.mip_level_shapes(*shape, max_levels=3)


@pytest.mark.parametrize("shape", SHAPES)
def test_mip_pyramid_matches_jax(shape):
    img = _img(*shape)
    got = tex.build_mip_pyramid(img)
    want = jtex.build_mip_pyramid(img)
    assert len(got) == len(want)
    assert [tuple(g.shape[:2]) for g in got] == tex.mip_level_shapes(*shape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 5, 7), (1, 1, 6),
                                   (1, 8, 8)])
def test_atlas_mips_bit_for_bit(shape):
    """The flat chain equals JAX's exactly, and each level keeps the even
    texel of each pair: level l is atlas[:, ::2**l, ::2**l]."""
    atlas = np.random.default_rng(3).random(shape + (3,)).astype(np.float32)
    got = tex.build_atlas_mips(torch.from_numpy(atlas))
    want = jtex.build_atlas_mips(jnp.asarray(atlas))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    off = 0
    for lvl, (hl, wl) in enumerate(tex.mip_level_shapes(*shape[1:])):
        step = 2 ** lvl
        level = atlas[:, ::step, ::step]
        assert level.shape[1:3] == (hl, wl)
        for c in range(3):
            np.testing.assert_array_equal(
                got[c][off:off + level[..., c].size].numpy(),
                level[..., c].reshape(-1))
        off += shape[0] * hl * wl
    assert off == got[0].shape[0]


def test_point_sample_exact_texels():
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3) / 12.0
    uv = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75],
                   [1.25, -0.75], [-0.25, 2.25]], np.float32)
    got = tex.sample_point(torch.from_numpy(img), torch.from_numpy(uv))
    want = np.asarray(jtex.sample_point(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = [img[0, 0], img[0, 1], img[1, 0], img[1, 1], img[0, 0],
              img[0, 1]]
    np.testing.assert_array_equal(got.numpy(), np.stack(expect))


@pytest.mark.parametrize("shape", [(8, 8), (5, 7), (1, 6)])
def test_point_sample_matches_jax(shape):
    """Random uvs, negative and above 1 (wrapping), and uvs at texel
    edges: the same texels as JAX, exactly."""
    img = _img(*shape, seed=1)
    h, w = shape
    edges = np.stack(np.meshgrid(np.arange(w + 1) / w, np.arange(h + 1) / h),
                     -1).reshape(-1, 2).astype(np.float32)
    uv = np.concatenate([_uv(512, 2), edges, -edges])
    got = tex.sample_point(torch.from_numpy(img), torch.from_numpy(uv))
    want = np.asarray(jtex.sample_point(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bilinear_interpolates_midpoint():
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 1] = 1.0
    img[1, 0] = 1.0
    out = tex.sample_bilinear(torch.from_numpy(img),
                              torch.tensor([[0.5, 0.5]]))
    np.testing.assert_allclose(out[0].numpy(), [0.5, 0.5, 0.5], atol=1e-6)


def test_bilinear_wraps():
    """u = 0 lies halfway between the last texel (wrapped) and the
    first; u = 1 and u = -1 wrap to the same place."""
    img = np.zeros((1, 2, 3), np.float32)
    img[0, 1] = 1.0
    uv = torch.tensor([[0.0, 0.5], [1.0, 0.5], [-1.0, 0.5]])
    out = tex.sample_bilinear(torch.from_numpy(img), uv)
    np.testing.assert_allclose(out.numpy(), np.full((3, 3), 0.5), atol=1e-6)
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(img),
                                           jnp.asarray(uv.numpy())))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 8), (5, 7), (1, 6)])
def test_bilinear_matches_jax(shape):
    img = _img(*shape, seed=4)
    uv = _uv(1024, 5)
    got = tex.sample_bilinear(torch.from_numpy(img), torch.from_numpy(uv))
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(img),
                                           jnp.asarray(uv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_mip_every_level(bilinear):
    """Each level index (and the clamped ones past either end) against
    JAX's lax.switch; a per-lane level tensor equals the per-level
    fetches lane by lane."""
    levels_np = jtex.build_mip_pyramid(_img(8, 8, seed=6))
    levels = tex.build_mip_pyramid(_img(8, 8, seed=6))
    uv = _uv(256, 7)
    uv_t = torch.from_numpy(uv)
    per_level = []
    for li in range(-1, len(levels) + 1):
        got = tex.sample_mip(levels, uv_t, li, bilinear=bilinear)
        want = np.asarray(jtex.sample_mip(levels_np, jnp.asarray(uv),
                                          jnp.int32(li), bilinear=bilinear))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        if 0 <= li < len(levels):
            per_level.append(got)
    lane_level = torch.arange(uv.shape[0]) % len(levels)
    mixed = tex.sample_mip(levels, uv_t, lane_level, bilinear=bilinear)
    expect = torch.stack(per_level)[lane_level, torch.arange(uv.shape[0])]
    assert torch.equal(mixed, expect)


@pytest.mark.parametrize("fn", ["sample_point", "sample_bilinear"])
def test_texel_gradient_matches_jax(fn):
    """d/d level of sum(weights * fetch(level, uv)) against jax.grad."""
    img = _img(5, 7, seed=8)
    uv = _uv(300, 9)
    wts = np.random.default_rng(10).standard_normal((300, 3)).astype(
        np.float32)
    want = np.asarray(jax.grad(lambda lv: jnp.sum(
        jnp.asarray(wts) * getattr(jtex, fn)(lv, jnp.asarray(uv))))(
        jnp.asarray(img)))
    level = torch.from_numpy(img).requires_grad_()
    (torch.from_numpy(wts) * getattr(tex, fn)(level, torch.from_numpy(uv))
     ).sum().backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(level.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_load_image_matches_jax(tmp_path):
    from PIL import Image

    arr = (np.random.default_rng(12).random((6, 10, 3)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "t.png")
    Image.fromarray(arr).save(path)
    got = tex.load_image(path)
    assert got.dtype == np.float32 and got.shape == (6, 10, 3)
    np.testing.assert_array_equal(got, jtex.load_image(path))
