"""Kernel C's boundary and the packet route: the port's packet traversal
against the JAX package's and against the port's dense closest hit.

The port's plain twin (the CPU side of `packet_hit`; the CUDA kernel is
held to the same twin and to kernel A on the card by chip_smoke.py) must
give exactly the dense hits (fid, t, uv) -- the same arithmetic and the
lowest-slot tie rule -- while visiting only the chunks a ray needs. On a
scene above 8192 padded faces the renderer routes the modular loop to
it, as the JAX renderer does: frames agree with JAX within 1e-5 and
gradients within rtol 1e-4 (the shading is unfused in the port and
FMA-fused by XLA), and the packet frame equals the dense one bit for
bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.diff import invrender as jinv
from tinypathtracer_tpu.ops import packet as jpacket
from tinypathtracer_tpu.render import film as jfilm
from tinypathtracer_tpu.render import renderer as jrenderer
from tinypathtracer_tpu.render.integrator import TraceData as JaxTraceData
from tinypathtracer_tpu_torch import RenderConfig, Renderer, prng_key
from tinypathtracer_tpu_torch.diff import invrender as inv
from tinypathtracer_tpu_torch.ops import dense, packet
from tinypathtracer_tpu_torch.ops.mega import mega_trace
from tinypathtracer_tpu_torch.render import renderer

from _torch_scenes import jax_scene, port_scene, train_setup

torch.set_num_threads(2)

# sphere_grid_scene(grid, n_lat, n_lon): the room (132 faces, 256
# slots), 1,356 faces in 11 chunks of 128, and the smallest procedural
# scene above 8192 padded faces: 14,348 faces, 16,384 slots, 32 chunks
ROOM, CHUNKED, LARGE = (1, 6, 12), (2, 8, 12), (4, 8, 16)
FRAME = dict(width=8, height=8, spp=2, max_depth=3)
FIELDS = [f.name for f in dataclasses.fields(inv.Params)]


def _tri_verts(grid):
    flat = jax_scene(*grid)
    return np.array(jax.jit(JaxTraceData.from_scene)(flat).tri_verts)


def _rays(n, seed, lo=-4.5, hi=4.5):
    """Rays from inside the room in random directions; every 16th has a
    zero x component (parallel to the x slabs)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[::16, 0] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def large():
    tv = _tri_verts(LARGE)
    return tv, packet.precompute_packet(torch.from_numpy(tv))


@pytest.mark.parametrize("grid", [ROOM, CHUNKED, LARGE])
def test_chunk_tables_match_jax(grid):
    """Chunk boxes (without the margin), validity, slot order and chunk
    size are JAX precompute_packet's exactly; the margin, the port's own,
    strictly widens every valid box and leaves the invalid ones."""
    tv = _tri_verts(grid)
    want = jax.jit(jpacket.precompute_packet)(jnp.asarray(tv))
    bare = packet.precompute_packet(torch.from_numpy(tv), margin=0.0)
    c = bare.n_chunks
    boxes = np.asarray(want.boxes)
    assert bare.tc == want.sub * jpacket.CHUNK and c == want.n_chunks
    assert np.array_equal(boxes[:6, :c].T, bare.boxes[:, :6].numpy())
    assert np.array_equal(boxes[6, :c], bare.boxes[:, 6].numpy())
    assert np.array_equal(np.asarray(want.woop.perm), bare.woop.perm.numpy())
    got = packet.precompute_packet(torch.from_numpy(tv)).boxes
    valid = got[:, 6] > 0
    assert torch.equal(got[:, 6:], bare.boxes[:, 6:])
    assert (got[valid, :3] < bare.boxes[valid, :3]).all()
    assert (got[valid, 3:6] > bare.boxes[valid, 3:6]).all()
    assert torch.equal(got[~valid], bare.boxes[~valid])


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_hits_exact_vs_jax(monkeypatch, impl):
    """The port's closest_hit_packet equals JAX closest_hit_packet in
    fid, t and uv: against the Pallas kernel's real walk in interpret
    mode (64 rays, 11 chunks) and against JAX's CPU fallback."""
    tv = _tri_verts(CHUNKED)
    jpk = jax.jit(jpacket.precompute_packet)(jnp.asarray(tv))
    pk = packet.precompute_packet(torch.from_numpy(tv))
    o, d = _rays(64, seed=20, lo=-6.0, hi=6.0)
    monkeypatch.setenv("TPT_PACKET_IMPL", impl)
    want = jpacket.closest_hit_packet(jnp.asarray(o), jnp.asarray(d), jpk)
    got = packet.closest_hit_packet(*_t(o, d), pk)
    for g, w, name in zip(got, want, ("fid", "t", "uv")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert (got[0] >= 0).float().mean() > 0.5


@pytest.mark.parametrize("masked", [False, True])
def test_hits_exact_vs_dense(large, masked):
    """closest_hit_packet == the port's closest_hit_dense exactly, with
    and without a mask; dead lanes traverse nothing and miss."""
    tv, pk = large
    o, d = _rays(1037, seed=3)
    mask = (torch.from_numpy(np.random.default_rng(4).random(1037) < 0.5)
            if masked else None)
    want = dense.closest_hit_dense(*_t(o, d), pk.woop, mask=mask)
    fid, t, uv, visits = packet.closest_hit_packet(*_t(o, d), pk, mask=mask,
                                                   with_visits=True)
    for g, w in zip((fid, t, uv), want):
        assert torch.equal(g, w)
    live = mask if masked else torch.ones(1037, dtype=torch.bool)
    assert (fid[live] >= 0).float().mean() > 0.5
    if masked:
        assert (visits[~mask] == 0).all() and (fid[~mask] == -1).all()
        assert (visits[mask] > 0).all()


def test_kernel_outputs_equal_kernel_a(large):
    """packet_hit's (fid, t, uv) are kernel A's raw hits through
    face_hits on live lanes; dead lanes report (-1, REAL_MAX, 0) and 0
    visits."""
    _, pk = large
    o, d = _t(*_rays(300, seed=5))
    live = torch.arange(300) % 3 != 0
    fid, t, uv, visits = packet.packet_hit(o, d, live, pk)
    rays = torch.cat([o, d, torch.zeros((300, 2))], dim=1)
    want = dense.face_hits(*dense.dense_hit(rays, pk.woop), pk.woop)
    for g, w in zip((fid, t, uv), want):
        assert torch.equal(g[live], w[live])
    assert (fid[~live] == -1).all() and (t[~live] == dense.REAL_MAX).all()
    assert (uv[~live] == 0).all() and (visits[~live] == 0).all()
    assert (fid[live] >= 0).float().mean() > 0.5
    assert fid.dtype == torch.int64 and t.dtype == uv.dtype == torch.float32
    assert visits.dtype == torch.int32


# (scene, rays, mask: None / "half" / "dead", rows as strided columns of
# an [N, 8] table); rays not a multiple of PACKET_BLOCK but in
# "full_blocks" and "empty"
QUERIES = {"mask_none": (LARGE, 1037, None, False),
           "mask_partial": (LARGE, 1037, "half", False),
           "mask_all_dead": (LARGE, 300, "dead", False),
           "padding_in_last_chunk": (CHUNKED, 700, "half", False),
           "full_blocks": (LARGE, 512, None, False),
           "empty": (LARGE, 0, None, False),
           "strided_rows": (LARGE, 777, "half", True)}


@pytest.mark.parametrize("case", list(QUERIES))
def test_query_contract(large, case):
    """A query as the bounce holds it, origins and dirs [N, 3] and a bool
    mask or None: closest_hit_packet and packet_hit give (fid i64, t,
    uv, visits i32) equal to closest_hit_dense, to face_hits applied to
    kernel A's raw (t, slot, uv), and to the schedule model (visits
    included); dead lanes miss with 0 visits. CHUNKED's last chunk of
    128 slots holds 76 faces and 52 padding slots."""
    grid, n, masking, strided = QUERIES[case]
    pk = (large[1] if grid == LARGE
          else packet.precompute_packet(torch.from_numpy(_tri_verts(grid))))
    assert pk.woop.n_faces < pk.woop.n_padded
    if grid == CHUNKED:     # padding in the last chunk, real faces too
        assert 0 < pk.woop.n_padded - pk.woop.n_faces < pk.tc
    o, d = _t(*_rays(n, seed=21, lo=-6.0, hi=6.0))
    mask = {None: None, "dead": torch.zeros(n, dtype=torch.bool),
            "half": torch.from_numpy(
                np.random.default_rng(22).random(n) < 0.5)}[masking]
    if strided:
        table = torch.cat([o, torch.zeros((n, 2)), d], dim=1)   # [N, 8]
        o, d = table[:, 0:3], table[:, 5:8]
        assert not (o.is_contiguous() or d.is_contiguous())
    got = packet.closest_hit_packet(o, d, pk, mask=mask, with_visits=True)
    direct = packet.packet_hit(o.contiguous(), d.contiguous(), mask, pk)
    model, _, _ = packet._packet_schedule(o, d, mask, pk)
    rays = torch.cat([o, d, torch.zeros((n, 2))], dim=1)
    raw = dense.face_hits(*dense.dense_hit(rays, pk.woop, mask), pk.woop)
    for want in (direct, model, raw,
                 dense.closest_hit_dense(o, d, pk.woop, mask=mask)):
        for g, w, name in zip(got, want, ("fid", "t", "uv", "visits")):
            assert torch.equal(g, w), (case, name)
    fid, t, uv, visits = got
    assert (fid.dtype, t.dtype, uv.dtype, visits.dtype) == (
        torch.int64, torch.float32, torch.float32, torch.int32)
    assert fid.shape == t.shape == visits.shape == (n,) and uv.shape == (n, 2)
    dead = (torch.zeros(n, dtype=torch.bool) if mask is None else ~mask)
    assert (fid[dead] == -1).all() and (visits[dead] == 0).all()
    assert (t[fid < 0] == dense.REAL_MAX).all() and (uv[fid < 0] == 0).all()
    assert (fid < pk.woop.n_faces).all()
    if n and masking != "dead":
        assert (fid[~dead] >= 0).float().mean() > 0.3


def test_tie_across_chunks_goes_to_lowest_slot():
    """A duplicate of the face in the last slot of chunk 0 lands in chunk
    1; rays aimed at it hit both at equal t, and whichever chunk the walk
    enters first, the lower slot (the original) wins, as in kernel A."""
    tv = _tri_verts(ROOM)
    first = packet.precompute_packet(torch.from_numpy(tv), tc=128)
    face = int(first.woop.perm[127])
    tv2 = np.concatenate([tv, tv[face:face + 1]])
    pk = packet.precompute_packet(torch.from_numpy(tv2), tc=128)
    perm = pk.woop.perm.numpy()
    dup = tv.shape[0]
    assert perm[127] == face and int(np.nonzero(perm == dup)[0][0]) >= 128
    rng = np.random.default_rng(6)
    o = rng.uniform(-4.5, 4.5, (256, 3)).astype(np.float32)
    d = tv[face].mean(axis=0) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = packet.closest_hit_packet(*_t(o, d), pk)
    want = dense.closest_hit_dense(*_t(o, d), pk.woop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hit = got[0].numpy()
    assert (hit == face).sum() > 20 and not (hit == dup).any()


def test_margin_keeps_hits_on_box_faces(large):
    """Rays from random origins aimed at the vertices that set each chunk
    box's faces: the hit lies on the box face, where the slab test and
    the Woop test round differently. With the JAX package's unwidened
    boxes some of these rays lose their hit (the walk skips the chunk and
    returns a farther face); with the margins they keep the dense hit."""
    tv, pk = large
    corners = tv[pk.woop.perm.numpy()[:pk.woop.n_faces]]
    targets = []
    for c in range(-(-pk.woop.n_faces // pk.tc)):     # the valid chunks
        v = corners[c * pk.tc:(c + 1) * pk.tc].reshape(-1, 3)
        for ax in range(3):
            targets += [v[v[:, ax].argmin()], v[v[:, ax].argmax()]]
    targets = torch.from_numpy(np.tile(np.stack(targets), (16, 1)))
    o = torch.from_numpy(np.random.default_rng(0).uniform(
        -4.9, 4.9, tuple(targets.shape)).astype(np.float32))
    d = torch.nn.functional.normalize(targets - o, dim=1)
    got = packet.closest_hit_packet(o, d, pk)
    unwidened = packet.precompute_packet(torch.from_numpy(tv), margin=0.0)
    lost = packet.closest_hit_packet(o, d, unwidened)[0] != got[0]
    check = lost | (torch.arange(o.shape[0]) < 256)
    want = dense.closest_hit_dense(o[check], d[check], pk.woop)
    for g, w in zip(got, want):
        assert torch.equal(g[check], w)
    assert int(lost.sum()) >= 1


def test_visits_bounded_and_culled(large):
    """visits <= the chunk count; rays that hit a wall just ahead of
    them visit far fewer chunks than there are."""
    _, pk = large
    o, d = _rays(512, seed=7)
    _, _, _, visits = packet.closest_hit_packet(*_t(o, d), pk,
                                                with_visits=True)
    assert (visits <= pk.n_chunks).all() and (visits >= 1).all()
    rng = np.random.default_rng(8)
    o = np.stack([rng.uniform(-4.0, 4.0, 64), rng.uniform(-4.0, 4.0, 64),
                  np.full(64, 4.9)], axis=1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (64, 1))
    fid, t, _, near = packet.closest_hit_packet(*_t(o, d), pk,
                                                with_visits=True)
    assert (fid >= 0).all() and (t < 0.2).all()
    assert int(near.max()) < pk.n_chunks // 4
    assert float(near.float().mean()) < float(visits.float().mean())


@pytest.fixture(scope="module")
def large_tables(large):
    """The 14,348-face scene cut into 32 chunks of 512 and 128 of 128."""
    tv, pk = large
    return {512: pk, 128: packet.precompute_packet(torch.from_numpy(tv),
                                                   tc=128)}


def _per_block(x, block):
    """[N] -> [blocks, block], zero-padded."""
    out = torch.zeros(-(-x.shape[0] // block) * block, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out.view(-1, block)


# (rays, half of them masked)
SCHEDULE_BATCHES = {"full": (512, False), "ragged": (1037, False),
                    "half_masked": (512, True)}


@pytest.mark.parametrize("batch", list(SCHEDULE_BATCHES))
@pytest.mark.parametrize("tc", [128, 512])
@pytest.mark.parametrize("block", [32, 256])
def test_schedule_model_equals_twin(large_tables, block, tc, batch):
    """The plain model of kernel C's block schedule gives the twin's t,
    slot, uv and visits exactly. Its stagings obey the schedule's bounds:
    each staging serves at least one ray, every visit is served once, and
    a block stages at least its longest walk and at most the Σ visits of
    its rays. (Not at most C: a served chunk can be wanted again by a ray
    that reaches it later, and random rays stage more than C.)"""
    pk = large_tables[tc]
    n, half = SCHEDULE_BATCHES[batch]
    o, d = _t(*_rays(n, seed=11))
    alive = (torch.from_numpy(np.random.default_rng(12).random(n) < 0.5)
             if half else None)
    want = packet._packet_torch(o, d, alive, pk)
    got, stagings, served = packet._packet_schedule(o, d, alive, pk, block)
    for g, w, name in zip(got, want, ("fid", "t", "uv", "visits")):
        assert torch.equal(g, w), name
    if half:
        assert (got[3][~alive] == 0).all()
    visits = _per_block(got[3], block)
    assert stagings.dtype == torch.int32 and stagings.shape == (
        visits.shape[0],)
    active = torch.arange(served.shape[1])[None] < stagings[:, None]
    assert (served[active] >= 1).all() and (served[~active] == 0).all()
    assert torch.equal(served.sum(dim=1), visits.sum(dim=1))
    assert (stagings >= visits.amax(dim=1)).all()
    assert (stagings <= visits.sum(dim=1)).all()


@pytest.mark.parametrize("slot", [60, 127])
def test_schedule_model_ties_go_to_lowest_slot(slot):
    """The face in `slot` duplicated: its copy lands in the next slot of
    the same chunk (60: the warp's lane reduction decides the tie) or in
    the next chunk (127: the merge into the ray's best decides it). Rays
    aimed at it hit both at equal t, and the model takes the original,
    as kernel A and the twin do."""
    tv = _tri_verts(ROOM)
    face = int(packet.precompute_packet(torch.from_numpy(tv),
                                        tc=128).woop.perm[slot])
    pk = packet.precompute_packet(
        torch.from_numpy(np.concatenate([tv, tv[face:face + 1]])), tc=128)
    perm = pk.woop.perm.numpy()
    dup = int(np.nonzero(perm == tv.shape[0])[0][0])
    assert perm[slot] == face and (dup // 128 == slot // 128) == (slot < 127)
    rng = np.random.default_rng(6)
    o = rng.uniform(-4.5, 4.5, (256, 3)).astype(np.float32)
    d = tv[face].mean(axis=0) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got, _, _ = packet._packet_schedule(*_t(o, d), None, pk, 32)
    want = dense.closest_hit_dense(*_t(o, d), pk.woop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] == face).sum() > 20 and not (got[0] == tv.shape[0]).any()


@pytest.mark.parametrize("tc", [128, 512])
def test_coherent_block_shares_its_stagings(large_tables, tc):
    """Rays from one origin in a narrow cone, as camera rays of a few
    pixels are: a block of 256 stages at least 10x fewer chunks than its
    rays visit, so each staged chunk serves tens of rays."""
    pk = large_tables[tc]
    rng = np.random.default_rng(13)
    o = np.tile(np.float32([0.3, -0.2, -4.6]), (512, 1))
    d = np.stack([rng.uniform(-0.05, 0.05, 512),
                  rng.uniform(-0.05, 0.05, 512), np.ones(512)],
                 axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got, stagings, _ = packet._packet_schedule(*_t(o, d), None, pk)
    assert (got[0] >= 0).all()
    assert (10 * stagings <= _per_block(got[3], 256).sum(dim=1)).all()


def test_shared_memory_limit():
    """Kernel C takes 8,192 chunks at each chunk size precompute_packet
    gives (the JAX kernel stops at 2,048); a histogram that cannot fit
    beside the stage buffers is refused with the reason."""
    static = 18560      # ray state of a 256-ray block, as the H100 build has
    for tc in (128, 256, 512):
        packet.check_fits(8192, tc, static)
    with pytest.raises(ValueError, match="cannot take 60000 chunks of 512"):
        packet.check_fits(60000, 512, static)


@pytest.mark.parametrize("isect", ["bvh", "bruteforce", "packet"])
def test_config_intersectors(isect):
    """RenderConfig takes "packet", "bvh" and "bruteforce" (the LBVH walk
    and the oracle, tests/test_torch_lbvh.py); an unknown name raises."""
    assert RenderConfig(intersector=isect).intersector == isect
    with pytest.raises(ValueError, match="unknown intersector"):
        RenderConfig(intersector=isect + "x")


def test_routing():
    """"dense" resolves to "packet" above 8192 padded faces, as in JAX;
    the room keeps the megakernel."""
    cfg = RenderConfig()
    for n_faces in (132, 7692, 8192, 8193, 14348, 61452):
        want = jrenderer.resolve_intersector(JaxConfig(), n_faces)
        assert renderer.resolve_intersector(cfg, n_faces) == want
    assert renderer.resolve_intersector(cfg, 8193) == "packet"
    big = renderer.prepare_state(port_scene(jax_scene(*LARGE)), cfg)
    room = renderer.prepare_state(port_scene(jax_scene(*ROOM)), cfg)
    assert big.packet is not None and big.packet.woop is big.woop
    assert (big.woop.n_faces, big.woop.n_padded, big.packet.n_chunks,
            big.packet.tc) == (14348, 16384, 32, 512)
    assert room.packet is None


def test_large_frame_matches_jax_and_dense():
    """A tiny frame of the 14,348-face scene: the port's auto-routed
    render (packet twin) against JAX render_frame (which resolves to its
    packet route) within 1e-5, and bit-equal to the port's frame through
    the dense closest hit, forced through the pipeline state."""
    flat = jax_scene(*LARGE)
    jcfg = JaxConfig(**FRAME)
    want = np.asarray(jfilm.to_image(
        jax.jit(lambda s, k: jrenderer.render_frame(s, jcfg, k))(
            flat, jax.random.PRNGKey(3)), FRAME["spp"]))
    scene = port_scene(flat)
    cfg = RenderConfig(**FRAME)
    before = (packet.packet_hit.launches, dense.dense_hit.launches,
              mega_trace.launches)
    got = Renderer(cfg, device="cpu").render(scene, prng_key(3))
    assert (packet.packet_hit.launches, dense.dense_hit.launches,
            mega_trace.launches) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want.mean() > 0.05

    state = renderer.prepare_state(scene, cfg)
    assert state.packet is not None
    pix = torch.arange(cfg.n_pixels)
    with torch.no_grad():
        a = renderer.render_pixel_ids(state, cfg, pix, prng_key(3))
        on_a = dataclasses.replace(state.route, intersector="dense")
        b = renderer.render_pixel_ids(dataclasses.replace(state, route=on_a),
                                      cfg, pix, prng_key(3))
    assert torch.equal(a, b)


def test_forced_packet_on_the_room_matches_megakernel():
    """intersector="packet" on a small scene runs the modular loop on
    the packet traversal (lights' any-hit queries included): the image
    equals the megakernel's bit for bit."""
    scene = port_scene(jax_scene(lights=True))
    cfg = RenderConfig(width=10, height=9, spp=2, max_depth=4)
    a = Renderer(cfg, device="cpu").render(scene, prng_key(9))
    b = Renderer(dataclasses.replace(cfg, intersector="packet"),
                 device="cpu").render(scene, prng_key(9))
    assert float(a.mean()) > 0.05
    assert torch.equal(a, b)


def test_large_grads_match_jax():
    """loss_and_grads on the 14,348-face scene (the modular loop on the
    packet twin) against JAX value_and_grad(mse_loss): the loss within
    1e-6 relative, each leaf rtol 1e-4 with atol 1e-6 * max|g| (the
    camera's gradient is analytically zero without delta lights: held
    to 1e-6 of the largest gradient of any leaf)."""
    flat = jax_scene(*LARGE)
    jparams, _, params, _ = train_setup(flat)
    target = np.random.default_rng(0).random(
        (FRAME["height"], FRAME["width"], 3)).astype(np.float32)
    fn = jax.jit(lambda p, s, t, k: jax.value_and_grad(jinv.mse_loss)(
        p, s, JaxConfig(**FRAME), t, k))
    want_loss, want = fn(jparams, flat, jnp.asarray(target),
                         jax.random.PRNGKey(5))
    loss, got = inv.loss_and_grads(params, port_scene(flat),
                                   RenderConfig(**FRAME),
                                   torch.from_numpy(target), prng_key(5))
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    g_all = max(float(np.abs(np.asarray(getattr(want, f))).max())
                for f in FIELDS if np.asarray(getattr(want, f)).size)
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.isfinite(g).all(), f
        if not w.size:
            continue
        scale = g_all if f == "cam_to_world" else np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f)
    for f in ("mtl_base_color", "mtl_emission", "env_radiance"):
        assert np.abs(np.asarray(getattr(want, f))).max() > 0, f


def test_no_kernel_for_other_devices(large):
    """No silent fallback: a tensor neither on the CPU nor on CUDA
    raises."""
    _, pk = large
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        packet.packet_hit(meta, meta, None, pk)



# what kernel C cannot read in place: (origins, dirs, mask, pk) edits
REFUSED = {
    "float_mask": lambda o, d, m, pk: (o, d, m.float(), pk),
    "strided_rows": lambda o, d, m, pk: (
        torch.cat([o, d], dim=1)[:, 0:3], d, m, pk),
    "float64_rows": lambda o, d, m, pk: (o.double(), d, m, pk),
    "short_mask": lambda o, d, m, pk: (o, d, m[1:], pk),
    "int32_perm": lambda o, d, m, pk: (o, d, m, dataclasses.replace(
        pk, woop=dataclasses.replace(pk.woop, perm=pk.woop.perm.int()))),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_c_refuses_what_it_cannot_read_in_place(large, case):
    """The checks before kernel C's launch: a query it would misread (a
    float mask, strided or float64 rows, a mask of another length, an
    int32 slot -> face table) raises rather than launch; the query as
    the bounce holds it passes."""
    _, pk = large
    o, d = _t(*_rays(64, seed=23))
    mask = torch.arange(64) % 2 == 0
    packet._check_query(o, d, mask, pk)
    packet._check_query(o, d, None, pk)
    with pytest.raises(ValueError, match="kernel C takes"):
        packet._check_query(*REFUSED[case](o, d, mask, pk))
