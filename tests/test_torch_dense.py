"""Kernel A's boundary: the port's dense closest hit against the JAX
package's, on identical planes and rays.

The port's plain twin (the CPU side of `dense_hit`; the CUDA kernel is
checked against the same twin on the card by chip_smoke.py) must give
exactly JAX's (slot, t, u, v): against `_dense_xla` (the JAX CPU path)
and against the Pallas kernel itself in interpret mode.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu.ops import dense as jdense
from tinypathtracer_tpu.render.integrator import TraceData as JaxTraceData
from tinypathtracer_tpu_torch.ops import dense
from tinypathtracer_tpu_torch.tools import lab_dense

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
    t, slot, uv = dense.dense_hit(torch.from_numpy(rays), tw)
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
                        dataclasses.replace(tw, planes=tw.planes.to("meta")))


# ---- the SUPER gate ------------------------------------------------------

def _scene_tris(args):
    """World triangles of JAX sphere_grid_scene(*args): the room (2, 8,
    16), 1,804 faces, or the big room (2, 16, 32), 7,692."""
    flat = jax_scene(*args)
    return np.array(jax.jit(JaxTraceData.from_scene)(flat).tri_verts)


def _random_tris(f, seed):
    """tests/test_dense.py's random scene of f triangles."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, 3, (f, 1, 3))
            + rng.normal(scale=0.4, size=(f, 3, 3))).astype(np.float32)


def _ray_rows(o, d):
    n = o.shape[0]
    return torch.from_numpy(np.concatenate(
        [o, d, np.zeros((n, 2), np.float32)], axis=1).astype(np.float32))


@pytest.fixture(scope="module")
def gated_scene():
    """A random scene of _GATE_MIN_FACES + 123 faces (8,192 slots, 8
    runs) and 96 rays through it, as tests/test_dense.py gates it."""
    tv = _random_tris(jdense._GATE_MIN_FACES + 123, seed=11)
    rng = np.random.default_rng(12)
    o = rng.uniform(-4, 4, (96, 3)).astype(np.float32)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tv, _ray_rows(o, d)


@pytest.mark.parametrize("scene", ["room", "big_room", "random"])
def test_sp_boxes_match_jax(scene):
    """WoopTris.sp_boxes at margin 0 equal JAX precompute_woop's bit for
    bit; with the margin each valid box is widened, and only those."""
    tv = {"room": lambda: _scene_tris((2, 8, 16)),
          "big_room": lambda: _scene_tris((2, 16, 32)),
          "random": lambda: _random_tris(dense._GATE_MIN_FACES + 123,
                                         seed=11)}[scene]()
    jw = jax.jit(jdense.precompute_woop)(jnp.asarray(tv))
    bare = dense.precompute_woop(torch.from_numpy(tv), margin=0.0)
    assert dense.SUPER == jdense.SUPER
    assert dense._GATE_MIN_FACES == jdense._GATE_MIN_FACES
    assert np.array_equal(np.asarray(jw.sp_boxes), bare.sp_boxes.numpy())
    assert np.array_equal(jax_planes(jw), bare.planes.numpy())
    wide = dense.precompute_woop(torch.from_numpy(tv)).sp_boxes
    valid = bare.sp_boxes[6] != 0
    assert (wide[0:3, valid] < bare.sp_boxes[0:3, valid]).all()
    assert (wide[3:6, valid] > bare.sp_boxes[3:6, valid]).all()
    assert torch.equal(wide[:, ~valid], bare.sp_boxes[:, ~valid])
    assert dense.gated(bare) == (scene != "room")


def test_gated_twin_matches_jax(gated_scene):
    """The gated twin (what dense_hit runs on CPU tensors past
    _GATE_MIN_FACES) equals the ungated twin, JAX _dense_xla and JAX's
    gated Pallas kernel in interpret mode: fid and t exactly, uv where
    hit."""
    tv, rays = gated_scene
    woop = dense.precompute_woop(torch.from_numpy(tv))
    jw = jax.jit(jdense.precompute_woop)(jnp.asarray(tv))
    assert dense.gated(woop)
    got = dense.dense_hit(rays, woop)
    ungated = dense._dense_torch(rays, woop.planes)
    for g, w in zip(got, ungated):
        assert torch.equal(g, w)
    jr = jnp.asarray(rays.numpy())
    refs = {"xla": jdense._dense_xla(jr, jw.wx, jw.wy, jw.wz),
            "pallas": jdense._dense_pallas(jr, jw.wx, jw.wy, jw.wz,
                                           jw.sp_boxes, gated=True,
                                           with_uv=True, interpret=True)}
    hit = got[1].numpy() >= 0
    assert hit.mean() > 0.5
    for name, (jt, jf, juv) in refs.items():
        assert np.array_equal(np.asarray(jf), got[1].numpy()), name
        assert np.array_equal(np.asarray(jt), got[0].numpy()), name
        assert np.array_equal(np.asarray(juv)[hit], got[2].numpy()[hit]), name


def test_gated_route_matches_jax_with_mask(gated_scene):
    """closest_hit_dense on the gated scene with a mask: JAX's
    closest_hit_dense (fid, t, uv) exactly; masked lanes miss."""
    tv, rays = gated_scene
    woop = dense.precompute_woop(torch.from_numpy(tv))
    jw = jax.jit(jdense.precompute_woop)(jnp.asarray(tv))
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    mask = np.random.default_rng(3).random(o.shape[0]) < 0.6
    jf, jt, juv = jdense.closest_hit_dense(jnp.asarray(o.numpy()),
                                           jnp.asarray(d.numpy()), jw,
                                           mask=jnp.asarray(mask))
    f, t, uv = dense.closest_hit_dense(o, d, woop,
                                       mask=torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jf), f.numpy())
    assert np.array_equal(np.asarray(jt), t.numpy())
    assert np.array_equal(np.asarray(juv), uv.numpy())
    assert (f.numpy()[~mask] == -1).all()


def _wall_woop(runs=4):
    """A gated scene of `runs` runs: run r holds 1,024 copies of one
    triangle in the plane x = 1 + 2r (y, z >= -5, y + z <= 0), so the
    morton order keeps each plane in its own run."""
    tri = np.float32([[0, -5, -5], [0, 5, -5], [0, -5, 5]])
    tv = np.concatenate([np.tile(tri + np.float32([1 + 2 * r, 0, 0]),
                                 (1024, 1, 1)) for r in range(runs)])
    return dense.precompute_woop(torch.from_numpy(tv))


def _wall_rays(n, sign):
    """n rays from x = 0, y, z in [-1, -0.1], along sign * x."""
    rng = np.random.default_rng(4)
    o = np.concatenate([np.zeros((n, 1)), rng.uniform(-1, -0.1, (n, 2))],
                       axis=1).astype(np.float32)
    d = np.tile(np.float32([sign, 0, 0]), (n, 1))
    return _ray_rows(o, d)


@pytest.mark.parametrize("case", ["all", "behind", "invalid", "early"])
def test_schedule_model_units(case):
    """_dense_schedule on 300 rays (warps of 128: two full, one ragged,
    the rest of the block empty) in the four-run wall scene: every run tested when no box
    is culled; none when the boxes lie behind the rays or are invalid;
    after the first run's hit at t = 1 its best t ends the sweep, since
    every later box starts farther."""
    woop = _wall_woop()
    rays = _wall_rays(300, -1.0 if case == "behind" else 1.0)
    boxes = woop.sp_boxes.clone()
    if case == "all":
        boxes[0:3], boxes[3:6] = -100.0, 100.0
    if case == "invalid":
        boxes[6] = 0.0
    woop = dataclasses.replace(woop, sp_boxes=boxes)
    (t, slot, uv), tested, staged = dense._dense_schedule(rays, woop)
    warps = dense.DENSE_THREADS // dense.LANES
    assert tested.shape == (warps,) and staged.shape == (1,)
    want = {"all": 4, "behind": 0, "invalid": 0, "early": 1}[case]
    assert tested.tolist() == [want] * 3 + [0] * (warps - 3)
    assert staged.tolist() == [want]
    if case in ("all", "early"):
        assert (t == 1.0).all() and (slot == 0).all()
        for g, w in zip((t, slot, uv), dense._dense_torch(rays,
                                                          woop.planes)):
            assert torch.equal(g, w)
    else:
        assert (slot == -1).all() and (t == dense.REAL_MAX).all()
    for g, w in zip((t, slot, uv), dense._dense_torch(rays, woop.planes,
                                                      woop.sp_boxes)):
        assert torch.equal(g, w)


def test_box_face_rays_keep_their_hits():
    """Rays from random origins in the big room aimed at the vertices
    that set each run box's faces and at the midpoints of those faces'
    edges: the hit lies on the box face, where the slab test and the Woop
    test round differently. The widened gate keeps every hit of the
    ungated sweep; the unwidened gate (the JAX package's boxes) is
    counted, and must also agree where it does on this scene."""
    tv = _scene_tris((2, 16, 32))
    woop = dense.precompute_woop(torch.from_numpy(tv))
    bare = dense.precompute_woop(torch.from_numpy(tv), margin=0.0)
    targets = lab_dense.box_face_targets(woop, torch.from_numpy(tv))
    targets = np.tile(targets.numpy(), (4, 1))
    o = np.random.default_rng(0).uniform(-4.9, 4.9, targets.shape)
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = _ray_rows(o.astype(np.float32), d.astype(np.float32))
    want = dense._dense_torch(rays, woop.planes)
    got = dense.dense_hit(rays, woop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    unwidened = dense._dense_torch(rays, bare.planes, bare.sp_boxes)
    lost = (unwidened[1] != want[1]) | (unwidened[0] != want[0])
    assert int(lost.sum()) == 0
    assert float((want[1] >= 0).float().mean()) > 0.9


@pytest.mark.parametrize("scene", ["ungated", "gated"])
def test_masked_lanes_miss_and_leave_the_vote(gated_scene, scene):
    """Masked lanes report a miss and the live lanes' hits are the
    unmasked call's; a warp whose lanes are all masked tests no run, and
    masking never adds a run to a warp."""
    tv, _ = gated_scene
    if scene == "ungated":
        tv = tv[:1000]
    woop = dense.precompute_woop(torch.from_numpy(tv))
    assert dense.gated(woop) == (scene == "gated")
    rng = np.random.default_rng(5)
    n = 400
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = _ray_rows(o, d)
    mask = torch.from_numpy(rng.random(n) < 0.5)
    mask[128:256] = False                       # the second warp: all masked
    full = dense.dense_hit(rays, woop)
    got = dense.dense_hit(rays, woop, mask)
    assert torch.equal(got[0][mask], full[0][mask])
    assert torch.equal(got[1][mask], full[1][mask])
    assert torch.equal(got[2][mask], full[2][mask])
    assert (got[1][~mask] == -1).all() and (got[0][~mask] == dense.REAL_MAX).all()
    assert (got[2][~mask] == 0).all()
    (mt, ms, muv), tested, _ = dense._dense_schedule(rays, woop, mask)
    assert torch.equal(ms, got[1]) and torch.equal(mt, got[0])
    assert torch.equal(muv, got[2])
    _, tested_all, _ = dense._dense_schedule(rays, woop)
    assert tested[1] == 0 and (tested <= tested_all).all()


# ---- the counts behind kernel A's bounds (tools/lab_dense, common) -------

@pytest.mark.parametrize("case", ["wall", "wall_behind", "gated_masked",
                                  "ungated_masked"])
def test_tested_runs_sum_to_the_schedule_models(gated_scene, case):
    """lab_dense.tested_runs, derived from each run's hits alone and the
    gate's rule, gives per warp the runs the schedule model's warps
    test: on the wall scene (run 0 ends every sweep, or no box lies
    ahead), on the random gated scene and on an ungated one, half
    masked."""
    mask = None
    if case.startswith("wall"):
        woop = _wall_woop()
        rays = _wall_rays(300, 1 if case == "wall" else -1)
    else:
        tv, rays = gated_scene
        woop = dense.precompute_woop(torch.from_numpy(
            tv if case == "gated_masked" else tv[:1000]))
        mask = torch.from_numpy(np.random.default_rng(6).random(96) < 0.5)
    _, tested, _ = dense._dense_schedule(rays, woop, mask)
    runs = lab_dense.tested_runs(rays, woop, mask)
    assert torch.equal(runs.sum(dim=1, dtype=torch.int32),
                       tested[:runs.shape[0]])
    assert not tested[runs.shape[0]:].any()
    want = {"wall": [True, False, False, False],
            "wall_behind": [False] * 4}.get(case)
    if want is not None:
        assert runs.tolist() == [want] * 3


@pytest.mark.parametrize("masked", [False, True])
def test_dense_pairs_count_each_origin_once(masked):
    """The bound's counts on 300 rays from one origin into the wall
    scene (4 runs of 1,024 faces; each ray's sweep ends in run 0): all
    pairs, every live ray against every face with o' once a face; tested
    pairs, the live rays against run 0 with o' once for its faces, and a
    slab test per live ray and run."""
    woop = _wall_woop()
    n = 300
    rng = np.random.default_rng(7)
    d = np.concatenate([np.ones((n, 1)), rng.uniform(-0.1, 0.1, (n, 2))],
                       axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.float32([0, -0.5, -0.5]), (n, 1))
    rays = _ray_rows(o, d)
    mask = torch.from_numpy(rng.random(n) < 0.5) if masked else None
    live = n if mask is None else int(mask.sum())
    f, ops_pair = woop.n_faces, lab_dense.common.OPS_DIRECTION
    ops_o = lab_dense.common.OPS_ORIGIN
    ops, nbytes = lab_dense.dense_pairs(rays, woop, mask)
    assert (ops, nbytes) == (live * f * ops_pair + f * ops_o,
                             n * 48 + f * 48)
    tested = lab_dense.tested_runs(rays, woop, mask)
    assert tested.tolist() == [[True, False, False, False]] * 3
    ops, _ = lab_dense.dense_pairs(rays, woop, mask, tested)
    assert ops == (live * 1024 * ops_pair + 1024 * ops_o
                   + live * 4 * lab_dense.common.OPS_SLAB
                   + live * lab_dense.common.OPS_RECIPROCALS)


def test_origin_visits_take_the_furthest_walk():
    """common.origin_visits: per distinct origin the most visits of a
    ray from it; common.origin_ids numbers the distinct rows."""
    common = lab_dense.common
    origins = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 0, 0], [1, 0, 0],
                            [2, 0, 0]])
    ids, count = common.origin_ids(origins)
    assert count == 3 and ids.tolist() == [0, 1, 0, 1, 2]
    assert common.origin_visits(origins, torch.tensor([3, 1, 5, 0, 2])) == 8
    none, count = common.origin_ids(origins[:0])
    assert none.shape == (0,) and count == 0


@pytest.mark.parametrize("pairs", [1 << 12, 1 << 24])
def test_scan_does_not_depend_on_the_tile(woops, monkeypatch, pairs):
    """The plain scan's rays-per-tile (small on the CPU, large on the
    card: ops/dense._TILE_PAIRS_CUDA) leaves every ray's result as it
    is."""
    tv, _, tw = woops
    o, d = _rays(tv, 1001, seed=9)
    rays = _ray_rows(o, d)
    want = dense._dense_torch(rays, tw.planes)
    monkeypatch.setattr(dense, "_TILE_PAIRS", pairs)
    for g, w in zip(dense._dense_torch(rays, tw.planes), want):
        assert torch.equal(g, w)
