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
