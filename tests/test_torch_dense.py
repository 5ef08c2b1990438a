"""Kernel A's boundary: the port's dense closest hit against the JAX
package's, on identical planes and rays.

The port's plain twin (the CPU side of `dense_hit`; the CUDA kernel is
checked against the same twin on the card by chip_smoke.py) must give
exactly JAX's (slot, t, u, v): against `_dense_xla` (the JAX CPU path)
and against the Pallas kernel itself in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu.ops import dense as jdense
from tinypathtracer_tpu.render.integrator import TraceData as JaxTraceData
from tinypathtracer_tpu_torch.ops import dense

from _torch_scenes import jax_planes, jax_scene

torch.set_num_threads(2)


def _tri_verts():
    """The 132-face room plus a duplicate of face 40 (a tie: the lower
    slot must win) and a degenerate face (zero planes, never hit)."""
    tv = np.array(jax.jit(JaxTraceData.from_scene)(jax_scene()).tri_verts)
    degenerate = np.repeat(tv[7:8, :1], 3, axis=1)
    return np.concatenate([tv, tv[40:41], degenerate]).astype(np.float32)


def _rays(tv, n, seed):
    """Rays from inside the room in random directions, a quarter of them
    aimed at the duplicated face's centroid."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.5, 4.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    aim = n // 4
    d[:aim] = tv[40].mean(axis=0) - o[:aim]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def woops():
    tv = _tri_verts()
    jw = jax.jit(jdense.precompute_woop)(jnp.asarray(tv))
    tw = dense.precompute_woop(torch.from_numpy(tv))
    return tv, jw, tw


def test_planes_match(woops):
    _, jw, tw = woops
    assert np.array_equal(jax_planes(jw), tw.planes.numpy())


@pytest.mark.parametrize("n", [1, 257, 1001])
def test_hits_exact_vs_jax(woops, n):
    """(slot, t, u, v) exactly equal, ragged N included."""
    tv, jw, tw = woops
    o, d = _rays(tv, n, seed=n)
    rays = np.concatenate([o, d, np.zeros((n, 2), np.float32)], axis=1)
    t, slot, uv = dense.dense_hit(torch.from_numpy(rays), tw.planes)
    refs = {
        "xla": jdense._dense_xla(jnp.asarray(rays), jw.wx, jw.wy, jw.wz),
        "pallas": jdense._dense_pallas(jnp.asarray(rays), jw.wx, jw.wy,
                                       jw.wz, jw.sp_boxes, with_uv=True,
                                       interpret=True),
    }
    for name, (jt, js, juv) in refs.items():
        assert np.array_equal(np.asarray(js), slot.numpy()), name
        assert np.array_equal(np.asarray(jt), t.numpy()), name
        assert np.array_equal(np.asarray(juv), uv.numpy()), name
    assert (slot.numpy() >= 0).mean() > 0.5


def test_tie_goes_to_lowest_slot_and_degenerate_never_hits(woops):
    tv, jw, tw = woops
    o, d = _rays(tv, 1024, seed=5)
    fid, t, _ = dense.closest_hit_dense(torch.from_numpy(o),
                                        torch.from_numpy(d), tw)
    fid = fid.numpy()
    dup_slots = [int(s) for s in np.nonzero(np.isin(tw.perm.numpy(),
                                                    [40, 132]))[0]]
    hit_dup = np.isin(fid, [40, 132])
    assert hit_dup.sum() > 20
    # the duplicate (face 132) sorts after face 40: it never wins a tie
    assert tw.perm[min(dup_slots)] == 40 and (fid[hit_dup] == 40).all()
    assert not (fid == 133).any()


def test_closest_hit_semantics_match_jax(woops):
    """closest_hit_dense: post-applied mask, miss -> (-1, REAL_MAX, 0),
    morton slots mapped back to original face ids."""
    tv, jw, tw = woops
    o, d = _rays(tv, 600, seed=9)
    mask = np.random.default_rng(1).random(600) < 0.7
    jf, jt, juv = jdense.closest_hit_dense(jnp.asarray(o), jnp.asarray(d),
                                           jw, mask=jnp.asarray(mask))
    f, t, uv = dense.closest_hit_dense(torch.from_numpy(o),
                                       torch.from_numpy(d), tw,
                                       mask=torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jf), f.numpy())
    assert np.array_equal(np.asarray(jt), t.numpy())
    assert np.array_equal(np.asarray(juv), uv.numpy())
    assert (f.numpy()[~mask] == -1).all()


def test_no_kernel_for_other_devices(woops):
    """The wrapper has no silent fallback: a tensor that is neither on
    the CPU nor on CUDA raises."""
    _, _, tw = woops
    with pytest.raises(ValueError, match="no kernel"):
        dense.dense_hit(torch.empty((4, 8), device="meta"),
                        tw.planes.to("meta"))
