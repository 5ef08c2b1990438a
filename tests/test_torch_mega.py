"""Kernel B's boundary: the port's megakernel against the JAX package's
Pallas megakernel (interpret mode), on identical rays, uniforms, tables
and lights.

The [16, N] rows (radiance, throughput at miss, final direction) must
agree within atol 1e-5, the JAX package's own mega-vs-modular bound
(tests/test_mega.py). They are not bit-equal: the hit arithmetic is
(ops/dense.py), but XLA:CPU fuses the shading math's multiply-adds and
computes rsqrt, sin and cos with its own approximations, where the port
rounds every operation on its own (ulp-level differences per bounce).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu.ops import dense as jdense
from tinypathtracer_tpu.ops import mega as jmega
from tinypathtracer_tpu.render.integrator import TraceData as JaxTraceData
from tinypathtracer_tpu_torch.ops import mega
from tinypathtracer_tpu_torch.ops.dense import precompute_woop
from tinypathtracer_tpu_torch.ops.lights import lights_block
from tinypathtracer_tpu_torch.render.integrator import TraceData

from _torch_scenes import jax_scene, port_scene

torch.set_num_threads(2)

N = 256          # a multiple of the JAX kernel's 128-ray block


def _inputs(depth, seed):
    """rays8 from the camera and from inside the room, and u8d uniforms
    (6 rows per bounce, 2 zero rows), from numpy."""
    rng = np.random.default_rng(seed)
    o = np.where(rng.random((N, 1)) < 0.5, [[0.0, 0.0, -4.6]],
                 rng.uniform(-4.0, 4.0, (N, 3))).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.zeros((1, N), np.float32)
    rays8 = np.concatenate([o.T, z, d.T, z], axis=0)
    u8d = rng.random((8 * depth, N)).astype(np.float32)
    u8d.reshape(depth, 8, N)[:, 6:] = 0.0
    return rays8, u8d


@pytest.mark.parametrize("lights", [False, True])
@pytest.mark.parametrize("depth", [3, 4])
def test_mega_rows_vs_jax_interpret(lights, depth):
    flat = jax_scene(lights=lights)
    jdata = jax.jit(JaxTraceData.from_scene)(flat)
    jwoop = jax.jit(jdense.precompute_woop)(jdata.tri_verts)
    planesT, shadeT, boxes = jmega._scene_blocks(jdata, jwoop)
    jlights = jmega._lights_block(jdata)
    n_lights = int(jdata.light_kind.shape[0])
    rays8, u8d = _inputs(depth, seed=depth + 10 * lights)
    want = np.asarray(jmega._mega_pallas(
        jnp.asarray(rays8), jnp.asarray(u8d), planesT, shadeT, boxes,
        jlights, depth=depth, n_lights=n_lights, interpret=True, w=128))

    # the port's own tables equal JAX's (shading rows within 2 ulp, see
    # tests/test_torch_scene.py); the kernel gets JAX's, like for like
    data = TraceData.from_scene(port_scene(flat))
    p_planes, p_shade = mega._scene_blocks(data, precompute_woop(
        data.tri_verts))
    assert np.array_equal(np.asarray(planesT), p_planes.numpy())
    assert np.allclose(np.asarray(shadeT), p_shade.numpy(), rtol=3e-7,
                       atol=0)
    assert np.array_equal(np.asarray(jlights), lights_block(data).numpy())

    t = lambda a: torch.from_numpy(np.array(a))          # noqa: E731
    got = mega.mega_trace(t(rays8), t(u8d), t(planesT), t(shadeT),
                          t(jlights), depth=depth, n_lights=n_lights).numpy()
    assert got.shape == want.shape == (16, N)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[0:3].mean() > 0.01                       # paths gathered light


def _jax_unpack(hits, perm, depth):
    """JAX `trace_paths_mega` primal's unpacking of the residual rows."""
    hr = hits.reshape(depth, 8, -1)
    slot = hr[:, 0].astype(jnp.int32)
    slot2 = hr[:, 4].astype(jnp.int32)
    fid = jnp.where(slot >= 0, perm[jnp.maximum(slot, 0)], -1)
    fid2 = jnp.where(slot2 >= 0, perm[jnp.maximum(slot2, 0)], -1)
    return [np.asarray(a) for a in (fid, hr[:, 1], hr[:, 2], hr[:, 3], fid2,
                                    hr[:, 5].astype(jnp.int32))]


@pytest.mark.parametrize("lights", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
def test_save_hits_rows_vs_jax_interpret(lights, depth):
    """The twin's hit residuals against JAX `_mega_pallas(save_hits=True)`.

    Where read, the rows are exactly JAX's: slot on every lane, slot2 and
    the occlusion bits on live lanes (alive, hit, not emissive; elsewhere
    the port defines them as -1 and 0, JAX leaves what its queries gave).
    t, u, v are exact at the first bounce and on dead lanes; from the
    second bounce on the rays themselves differ by ulps (XLA fuses the
    shading that makes them, see the module docstring), so there t, u, v
    are held to the [16, N] rows' atol 1e-5. The [16, N] rows equal the
    save_hits=False call's."""
    flat = jax_scene(lights=lights)
    jdata = jax.jit(JaxTraceData.from_scene)(flat)
    jwoop = jax.jit(jdense.precompute_woop)(jdata.tri_verts)
    planesT, shadeT, boxes = jmega._scene_blocks(jdata, jwoop)
    jlights = jmega._lights_block(jdata)
    n_lights = int(jdata.light_kind.shape[0])
    rays8, u8d = _inputs(depth, seed=depth + 10 * lights)
    _, jhits = jmega._mega_pallas(
        jnp.asarray(rays8), jnp.asarray(u8d), planesT, shadeT, boxes,
        jlights, depth=depth, n_lights=n_lights, interpret=True, w=128,
        save_hits=True)

    t = lambda a: torch.from_numpy(np.array(a))          # noqa: E731
    ops = (t(rays8), t(u8d), t(planesT), t(shadeT), t(jlights))
    out, hits = mega.mega_trace(*ops, depth=depth, n_lights=n_lights,
                                save_hits=True)
    assert torch.equal(out, mega.mega_trace(*ops, depth=depth,
                                            n_lights=n_lights))
    got_rows = hits.numpy().reshape(depth, 8, N)
    want_rows = np.asarray(jhits).reshape(depth, 8, N)
    assert (got_rows[:, 6:] == 0).all()
    emissive = np.asarray(shadeT)[24] > 0.0
    perm = jwoop.perm
    fid, t_, uv, fid2, occ = mega.unpack_hits(hits, t(perm).long(), depth)
    got = [a.numpy() for a in (fid, t_, uv[..., 0], uv[..., 1], fid2, occ)]
    want = _jax_unpack(jhits, perm, depth)
    for dep in range(depth):
        slot = want_rows[dep, 0]
        hit = slot >= 0
        live = hit & ~emissive[np.maximum(slot, 0).astype(np.int64)]
        np.testing.assert_array_equal(got_rows[dep, 0], slot)
        np.testing.assert_array_equal(got[0][dep], want[0][dep])    # fid
        for row in (1, 2, 3):                                   # t, u, v
            np.testing.assert_array_equal(got_rows[dep, row][~hit],
                                          want_rows[dep, row][~hit])
            np.testing.assert_allclose(got_rows[dep, row][hit],
                                       want_rows[dep, row][hit], rtol=0,
                                       atol=0 if dep == 0 else 1e-5)
        for row, k in ((4, 4), (5, 5)):                   # slot2 / fid2, occ
            np.testing.assert_array_equal(got_rows[dep, row][live],
                                          want_rows[dep, row][live])
            np.testing.assert_array_equal(got[k][dep][live],
                                          want[k][dep][live])
            assert (got_rows[dep, row][~live] == (-1 if row == 4 else 0)).all()
        assert live.any()
    if lights:
        assert (got[5] > 0).any()                # some light was occluded


def test_constant_quotients_match_xla():
    """`x / pi` and `x / (2 pi)` in the JAX shading math are `x * fl32(1 /
    c)` once XLA has compiled them; the port (twin and kernel B alike)
    multiplies by the constants INV_PI and INV_2PI, bit-equal to XLA."""
    from tinypathtracer_tpu.ops import shading_c as jshading
    from tinypathtracer_tpu_torch.ops import shading_c

    x = np.random.default_rng(4).random(4096, dtype=np.float32) * 4.0
    for c, inv in ((jshading.PI, shading_c.INV_PI),
                   (2.0 * jshading.PI, shading_c.INV_2PI)):
        want = np.asarray(jax.jit(lambda a: a / c)(x))   # noqa: B023
        assert np.array_equal((torch.from_numpy(x) * inv).numpy(), want)
        # the IEEE quotient differs on a share of lanes: the test can tell
        assert not np.array_equal(x / np.float32(c), want)


def test_mega_available_scope():
    data = TraceData.from_scene(port_scene(jax_scene()))
    woop = precompute_woop(data.tri_verts)

    class Cfg:
        mode = "reference"

    assert mega.mega_available(data, Cfg, woop)
    big = precompute_woop(torch.zeros((8193, 3, 3)))
    assert not mega.mega_available(data, Cfg, big)


def test_bad_operands_raise():
    rays8, u8d = _inputs(2, seed=0)
    with pytest.raises(ValueError, match="bad megakernel operands"):
        mega.mega_trace(torch.from_numpy(rays8), torch.from_numpy(u8d),
                        torch.zeros((128, 12)), torch.zeros((32, 128)),
                        torch.zeros((1, 16)), depth=3, n_lights=0)


# ---- kernel B's schedule: the plain model of its refilled lanes ----------

def _slow_schedule(lengths, blocks, threads):
    """The refill rule written lane by lane: each round, free lanes take
    the next paths of their block's pool (b, b + blocks, ...) in lane
    order, then every lane that holds a path sweeps once."""
    n = len(lengths)
    rounds, lane, start = [], [-1] * n, [-1] * n
    for b in range(blocks):
        pool, taken, r = list(range(b, n, blocks)), 0, 0
        left = [0] * threads
        while True:
            for ln in range(threads):
                if left[ln] == 0 and taken < len(pool):
                    p = pool[taken]
                    taken += 1
                    left[ln], lane[p], start[p] = lengths[p], b * threads + ln, r
            if not any(left):
                break
            left = [x - 1 if x else 0 for x in left]
            r += 1
        rounds.append(r)
    return rounds, lane, start


@pytest.fixture(scope="module")
def room_lengths():
    """Each path's sweeps (`path_lengths`) from the twin's residuals: 512
    paths at depth 8 in the lit room."""
    data = TraceData.from_scene(port_scene(jax_scene(lights=True)))
    planesT, shadeT = mega._scene_blocks(data, precompute_woop(
        data.tri_verts))
    rays8, u8d = _inputs(8, seed=5)
    rays8 = np.concatenate([rays8, rays8], axis=1)
    u8d = np.concatenate([u8d, u8d[:, ::-1]], axis=1)
    _, hits = mega.mega_trace(torch.from_numpy(rays8),
                              torch.from_numpy(np.ascontiguousarray(u8d)),
                              planesT, shadeT, lights_block(data), depth=8,
                              n_lights=data.n_lights, save_hits=True)
    lengths = mega.path_lengths(hits, shadeT, 8)
    rows = hits.view(8, 8, -1)
    slot = rows[:, 0].long()
    live = (slot >= 0) & (shadeT[24][slot.clamp_min(0)] <= 0)
    # a path's live bounces come first, then it ends
    assert (live[1:] <= live[:-1]).all()
    assert torch.equal(lengths, 1 + live.sum(dim=0))
    assert int(lengths.min()) >= 1 and int(lengths.max()) <= 9
    assert lengths.float().std() > 0.5           # short and long paths
    return lengths


@pytest.mark.parametrize("blocks,threads", [(1, 32), (3, 32), (5, 64),
                                            (16, 32)])
def test_schedule_serves_every_path_once_in_order(room_lengths, blocks,
                                                  threads):
    """Every path is served once, by one lane, for its sweeps in a row
    (its bounces in order); a lane's paths follow each other without a
    gap, in pool order; the model equals the lane-by-lane rule."""
    lengths = room_lengths
    rounds, lane, start = mega._mega_schedule(lengths, blocks, threads)
    want = _slow_schedule(lengths.tolist(), blocks, threads)
    assert rounds.tolist() == want[0]
    assert lane.tolist() == want[1] and start.tolist() == want[2]
    n = lengths.shape[0]
    assert (lane >= 0).all() and (start >= 0).all()
    assert torch.equal(lane // threads, torch.arange(n) % blocks)
    for ln in lane.unique():
        paths = (lane == ln).nonzero()[:, 0]
        order = start[paths].argsort()
        p, s = paths[order], start[paths][order]
        ends = s + lengths[p]
        assert torch.equal(s[1:], ends[:-1])     # no gap, no overlap
        assert s[0] == 0 and bool((p[1:] > p[:-1]).all())
        assert int(ends[-1]) <= int(rounds[ln // threads])


@pytest.mark.parametrize("blocks,threads", [(1, 32), (3, 32), (16, 32)])
def test_schedule_rounds_between_longest_path_and_sum(room_lengths, blocks,
                                                      threads):
    """A block sweeps at least as often as its longest path and at most
    as often as all its paths together; with one lane a path it sweeps as
    often as its longest."""
    lengths = room_lengths
    rounds = mega._mega_schedule(lengths, blocks, threads)[0]
    for b in range(blocks):
        own = lengths[b::blocks]
        assert int(own.max()) <= int(rounds[b]) <= int(own.sum())
        assert int(rounds[b]) >= -(-int(own.sum()) // threads)
    wide = mega._mega_schedule(lengths, blocks, lengths.shape[0])[0]
    assert wide.tolist() == [int(lengths[b::blocks].max())
                             for b in range(blocks)]


def test_schedule_is_deterministic_under_a_reshuffled_pool(room_lengths):
    """The model is a function of the pool's order alone: the same pool
    twice gives the same schedule, a reshuffled pool the lane-by-lane
    rule's schedule for that order, and every path is still served."""
    perm = torch.from_numpy(np.random.default_rng(3).permutation(
        room_lengths.shape[0]))
    shuffled = room_lengths[perm]
    first = mega._mega_schedule(shuffled, 3, 32)
    again = mega._mega_schedule(shuffled.clone(), 3, 32)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = _slow_schedule(shuffled.tolist(), 3, 32)
    assert first[0].tolist() == want[0] and first[1].tolist() == want[1]
    assert (first[1] >= 0).all()
    assert int(first[0].sum()) * 32 >= int(shuffled.sum())


def test_rounds_are_counted_on_the_card_only():
    rays8, u8d = _inputs(2, seed=0)
    data = TraceData.from_scene(port_scene(jax_scene()))
    planesT, shadeT = mega._scene_blocks(data, precompute_woop(
        data.tri_verts))
    with pytest.raises(ValueError, match="rounds"):
        mega.mega_trace(torch.from_numpy(rays8), torch.from_numpy(u8d),
                        planesT, shadeT, lights_block(data), depth=2,
                        n_lights=0, rounds=torch.zeros(1, dtype=torch.int32))
