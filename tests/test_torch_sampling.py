"""The port's threefry key chain against `jax.random`: exactly equal.

Images are compared by key, and the determinism contract (same key,
same image under any chunking) rests on these bits, so every check here
is bit equality.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu.ops import sampling as jsampling
from tinypathtracer_tpu.render.renderer import _CAM_TAG as JAX_CAM_TAG
from tinypathtracer_tpu_torch.ops import sampling
from tinypathtracer_tpu_torch.render.renderer import _CAM_TAG

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 12345, 2**31 - 1]
IDS = np.array([0, 1, 2, 3, 127, 128, 65535, 1 << 20, 2**31 - 3, 2**31 - 2,
                2**31 - 1], np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          sampling.prng_key(seed).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits(seed):
    """Raw threefry2x32 words of jax.random.bits against the port's."""
    key = jax.random.PRNGKey(seed)
    for m in (1, 2, 6, 9):
        want = np.asarray(jax.random.bits(key, (m,), jnp.uint32))
        k = sampling.prng_key(seed)
        j = torch.arange(m)
        b0, b1 = sampling.threefry2x32(k[0], k[1], torch.zeros_like(j), j)
        assert np.array_equal(want.astype(np.int64), (b0 ^ b1).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    for d in IDS:
        want = np.asarray(jax.random.fold_in(key, int(d)))
        got = sampling.fold_in(sampling.prng_key(seed), int(d)).numpy()
        assert np.array_equal(want, got), d


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_key_chain(seed):
    """fold_lanes -> per-lane sample fold_in -> fold_all(_CAM_TAG and
    bounce tags) -> lane_uniform, as the renderer derives them."""
    assert _CAM_TAG == JAX_CAM_TAG
    key = jax.random.PRNGKey(seed)
    samples = np.arange(len(IDS), dtype=np.int32) * 7 + 3
    jk = jax.vmap(jax.random.fold_in)(
        jsampling.fold_lanes(key, jnp.asarray(IDS)), jnp.asarray(samples))
    tk = sampling.fold_in(
        sampling.fold_lanes(sampling.prng_key(seed), _t(IDS)), _t(samples))
    assert np.array_equal(np.asarray(jk), tk.numpy())
    for tag, m in [(_CAM_TAG, 2), (0, 6), (1, 6), (7, 6)]:
        jf = jsampling.fold_all(jk, tag)
        tf = sampling.fold_all(tk, tag)
        assert np.array_equal(np.asarray(jf), tf.numpy())
        ju = np.asarray(jsampling.lane_uniform(jf, m))
        tu = sampling.lane_uniform(tf, m).numpy()
        assert ju.dtype == tu.dtype == np.float32
        assert np.array_equal(ju, tu), tag


def test_uniform_range_and_shape():
    keys = sampling.fold_lanes(sampling.prng_key(3), torch.arange(4096))
    u = sampling.lane_uniform(keys, 6)
    assert u.shape == (4096, 6) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


# ---- the frame's entry points: lane_keys and lane_draws ----------------------

def _jax_lane_keys(seed, spp, sample_offset):
    """The JAX renderer's lane keys and camera draws of the pixels IDS
    (tinypathtracer_tpu/render/renderer.py `render_chunk`)."""
    lane_pix = jnp.repeat(jnp.asarray(IDS), spp)
    lane_s = sample_offset + jnp.tile(jnp.arange(spp, dtype=jnp.int32),
                                      len(IDS))
    keys = jax.vmap(jax.random.fold_in)(
        jsampling.fold_lanes(jax.random.PRNGKey(seed), lane_pix), lane_s)
    return keys, jsampling.lane_uniform(jsampling.fold_all(keys, JAX_CAM_TAG),
                                        2)


def _port_lane_keys(seed, spp):
    return sampling.lane_keys(sampling.prng_key(seed), _t(IDS), spp, 0,
                              _CAM_TAG)[0]


@pytest.mark.parametrize("spp,sample_offset", [(1, 0), (16, 0), (1, 5),
                                               (16, 37)])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_lane_keys(seed, spp, sample_offset):
    """lane_keys on the CPU: the chain lane_rays ran before it, and the
    JAX renderer's lane keys and camera draws, bit for bit."""
    keys, u_cam = sampling.lane_keys(sampling.prng_key(seed), _t(IDS), spp,
                                     sample_offset, _CAM_TAG)
    lane_pix = _t(IDS).repeat_interleave(spp)
    lane_s = sample_offset + torch.arange(spp).repeat(len(IDS))
    chain = sampling.fold_in(
        sampling.fold_lanes(sampling.prng_key(seed), lane_pix), lane_s)
    assert keys.dtype == torch.int64 and u_cam.dtype == torch.float32
    assert torch.equal(keys, chain)
    assert torch.equal(u_cam, sampling.lane_uniform(
        sampling.fold_all(chain, _CAM_TAG), 2))
    jk, ju = _jax_lane_keys(seed, spp, sample_offset)
    assert np.array_equal(keys.numpy(), np.asarray(jk))
    assert np.array_equal(u_cam.numpy(), np.asarray(ju))


@pytest.mark.parametrize("depth", [1, 8])
def test_bounce_draws(depth):
    """The megakernel's u8d [8 * depth, N] (`lane_draws(keys, 0, depth, 6,
    8)`, mega.bounce_uniforms): rows 8b..8b+5 the modular loop's draws of
    bounce b, rows 8b+6 and 8b+7 zero; the JAX package's bands."""
    from tinypathtracer_tpu_torch.ops.mega import bounce_uniforms

    keys = _port_lane_keys(12345, 16)
    jk = _jax_lane_keys(12345, 16, 0)[0]
    u8d = sampling.lane_draws(keys, 0, depth, 6, 8)
    assert u8d.shape == (8 * depth, keys.shape[0])
    assert u8d.dtype == torch.float32 and u8d.is_contiguous()
    assert torch.equal(u8d, bounce_uniforms(keys, depth))
    for b in range(depth):
        band = u8d[8 * b:8 * b + 8]
        assert torch.equal(band[:6], sampling.lane_uniform(
            sampling.fold_all(keys, b), 6).T)
        assert np.array_equal(band[:6].numpy(), np.asarray(
            jsampling.lane_uniform(jsampling.fold_all(jk, b), 6)).T)
        assert not band[6:].any()


@pytest.mark.parametrize("m", [6, 9])
@pytest.mark.parametrize("tag", [3, _CAM_TAG])
def test_modular_draw(m, tag):
    """The modular loop's draw of one bounce ([m, N], m = 6 reference,
    9 physical) against the chain and JAX."""
    keys = _port_lane_keys(7, 16)
    jk = _jax_lane_keys(7, 16, 0)[0]
    u = sampling.lane_draws(keys, tag, 1, m)
    assert u.shape == (m, keys.shape[0])
    assert torch.equal(u, sampling.lane_uniform(
        sampling.fold_all(keys, tag), m).T)
    assert np.array_equal(u.numpy(), np.asarray(
        jsampling.lane_uniform(jsampling.fold_all(jk, tag), m)).T)


_KEYS = sampling.fold_lanes(sampling.prng_key(1), torch.arange(8))


@pytest.mark.parametrize("call", [
    pytest.param(lambda: sampling.lane_draws(_KEYS.int(), 0, 1, 6),
                 id="draws-int32-keys"),
    pytest.param(lambda: sampling.lane_draws(_KEYS.T.contiguous().T, 0, 1, 6),
                 id="draws-non-contiguous-keys"),
    pytest.param(lambda: sampling.lane_draws(_KEYS.to("meta"), 0, 1, 6),
                 id="draws-meta-device"),
    pytest.param(lambda: sampling.lane_draws(_KEYS, 0, 1, 9, 8),
                 id="draws-m-above-rows"),
    pytest.param(lambda: sampling.lane_keys(sampling.prng_key(1),
                                            torch.arange(8.0), 2, 0, 1),
                 id="keys-float-pix"),
    pytest.param(lambda: sampling.lane_keys(sampling.prng_key(1),
                                            torch.arange(16)[::2], 2, 0, 1),
                 id="keys-non-contiguous-pix"),
    pytest.param(lambda: sampling.lane_keys(sampling.prng_key(1).to("meta"),
                                            torch.arange(8, device="meta"),
                                            2, 0, 1),
                 id="keys-meta-device"),
    pytest.param(lambda: sampling.lane_keys(sampling.prng_key(1).int(),
                                            torch.arange(8), 2, 0, 1),
                 id="keys-int32-key"),
])
def test_key_chain_wrappers_refuse(call):
    """Operands the kernel does not take raise, on any device: a wrong
    dtype, a non-contiguous tensor, a device with no kernel."""
    with pytest.raises(ValueError):
        call()
