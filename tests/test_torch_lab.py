"""The kernel lab: the plain twins of kernels D, E (tools/lab4.py) and F
(tools/lab5_diag.py) against the JAX package's Pallas kernels run in
interpret mode on the same inputs, and every lab `main` on the CPU at a
tiny size.

The CUDA kernels run on the card only; chip_smoke.py holds each to its
twin there. Kernel E's twin equals the JAX kernel exactly (the hit
test's multiply-adds are fused where XLA:CPU fuses the JAX kernel); so
does kernel F's, on every variant but `epilogue`, whose JAX kernel reads
scratch nothing wrote (NaN in interpret mode; the port fills it with
REAL_MAX). Kernel D's twin emulates the tensor cores' TF32 operands,
while the JAX kernel in interpret mode computes its dot products in
fp32 whatever `precision` says: the 3xTF32 ("highest") twin is held to
it by the share of equal face ids and a relative tolerance on t.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tinypathtracer_tpu.ops import packet as jpacket
from tinypathtracer_tpu.render.integrator import TraceData as JaxTraceData
from tinypathtracer_tpu.tools import lab4 as jlab4
from tinypathtracer_tpu.tools import lab5 as jlab5
from tinypathtracer_tpu.tools import lab5_diag as jdiag
from tinypathtracer_tpu_torch.ops import dense
from tinypathtracer_tpu_torch.tools import (kernel_lab, lab4, lab5, lab5_diag,
                                            lab6, lab_dense, lab_mega,
                                            profile_stages)

from _torch_scenes import jax_scene, port_scene

torch.set_num_threads(2)

# sphere_grid_scene(2, 10, 16): 2,316 faces, 19 chunks of 128 (walkfix
# reads chunks 0-15)
DIAG_GRID = (2, 10, 16)
# sphere_grid_scene(2, 24, 48): 17,676 faces, 160 chunks, 256 chunk boxes:
# kernel F sizes its blocks by the boxes
DIAG_GRID_256 = (2, 24, 48)


def _lab4_inputs(n=256, f=200, seed=0):
    return lab4.test_data(n, f, torch.device("cpu"), seed)


def _pallas_lab4(kernel, rays8, planes, n, tc=128):
    return pl.pallas_call(
        kernel, grid=(n // 128,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (0, i)),
                  pl.BlockSpec(tuple(planes.shape), lambda i: (0, 0))],
        out_specs=(pl.BlockSpec((1, 128), lambda i: (0, i)),
                   pl.BlockSpec((1, 128), lambda i: (0, i))),
        out_shape=(jax.ShapeDtypeStruct((1, n), jnp.float32),
                   jax.ShapeDtypeStruct((1, n), jnp.int32)),
        interpret=True)(jnp.asarray(rays8.numpy()), jnp.asarray(planes.numpy()))


def test_planes_layouts_match_jax():
    """make_planes4 / make_planesT give the JAX tools' tables of the same
    triangles."""
    tv = np.random.default_rng(0).random((200, 3, 3)).astype(np.float32)
    from tinypathtracer_tpu.ops.dense import precompute_woop as jwoop_of
    jw = jax.jit(jwoop_of)(jnp.asarray(tv))
    pw = dense.precompute_woop(torch.from_numpy(tv))
    assert np.array_equal(np.asarray(jlab4.make_planes4(jw)),
                          lab4.make_planes4(pw).numpy())
    assert np.array_equal(np.asarray(jlab4.make_planesT(jw)),
                          lab4.make_planesT(pw).numpy())


def test_kernel_e_twin_equals_jax_and_kernel_a():
    """Kernel E's twin equals lab4._vpu_rol_kernel in interpret mode and
    kernel A's twin exactly (t and slot), at 256 rays x 200 triangles."""
    woop, rays, rays8 = _lab4_inputs()
    planesT = lab4.make_planesT(woop)
    fp = woop.n_padded
    want_t, want_f = _pallas_lab4(jlab4._vpu_rol_kernel(fp, 128), rays8,
                                  planesT, 256)
    t, fid = lab4.vpu_rol_closest_hit(rays8, planesT, tc=128)
    assert np.array_equal(t.numpy(), np.asarray(want_t)[0])
    assert np.array_equal(fid.numpy(), np.asarray(want_f)[0])
    ta, sa, _ = dense.dense_hit(rays, woop)
    assert torch.equal(t, ta) and torch.equal(fid, sa)
    assert 0.3 < float((fid >= 0).float().mean()) < 1.0
    # tc tiles the work only
    assert torch.equal(lab4.vpu_rol_closest_hit(rays8, planesT, tc=256)[1],
                       fid)


def test_kernel_d_twin_matches_jax():
    """Kernel D's 3xTF32 twin against lab4._mxu_hit_kernel in interpret
    mode (fp32 dot products): face ids equal on >= 99 % of lanes, and t
    within 2e-4 where they do: the transform cancels terms of the scene's
    size (100) down to o'z, and the split operands keep ~22 bits of them
    (max |dt| measured 3.3e-5). The one-pass TF32 instance keeps most face
    ids."""
    woop, _, rays8 = _lab4_inputs()
    planes4 = lab4.make_planes4(woop)
    want_t, want_f = _pallas_lab4(
        jlab4._mxu_hit_kernel(woop.n_padded, 128, jax.lax.Precision.HIGHEST),
        rays8, planes4, 256)
    want_t, want_f = np.asarray(want_t)[0], np.asarray(want_f)[0]
    t, fid = lab4.mxu_closest_hit(rays8, planes4, tc=128, precision="highest")
    t, fid = t.numpy(), fid.numpy()
    same = fid == want_f
    assert same.mean() >= 0.99
    hit = same & (want_f >= 0)
    np.testing.assert_allclose(t[hit], want_t[hit], rtol=0, atol=2e-4)
    t1, fid1 = lab4.mxu_closest_hit(rays8, planes4, tc=128,
                                    precision="default")
    assert (fid1.numpy() == want_f).mean() >= 0.9


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_kernel_d_twin_matches_jax_at_each_precision(precision):
    """Kernel D's twin, which sums each K = 8 step of the wgmma order
    (big·small then small·big, then big·big), against
    lab4._mxu_hit_kernel in interpret mode at the same precision, on a
    ragged batch of 200 rays (the JAX kernel's padded to 256) and tc =
    16: face ids equal on >= 99 % (highest) or >= 90 % (one TF32 pass),
    t within 2e-4 at "highest" where they are; the result does not depend
    on tc."""
    woop, _, rays8 = _lab4_inputs(n=200, seed=5)
    planes4 = lab4.make_planes4(woop)
    padded = torch.nn.functional.pad(rays8, (0, 56))
    jprec = {"highest": jax.lax.Precision.HIGHEST,
             "default": jax.lax.Precision.DEFAULT}[precision]
    want_t, want_f = _pallas_lab4(
        jlab4._mxu_hit_kernel(woop.n_padded, 128, jprec), padded, planes4,
        256)
    want_t, want_f = np.asarray(want_t)[0, :200], np.asarray(want_f)[0, :200]
    t, fid = lab4.mxu_closest_hit(rays8, planes4, tc=16, precision=precision)
    assert t.shape == (200,) and fid.shape == (200,)
    same = fid.numpy() == want_f
    assert same.mean() >= (0.99 if precision == "highest" else 0.9)
    if precision == "highest":
        hit = same & (want_f >= 0)
        np.testing.assert_allclose(t.numpy()[hit], want_t[hit], rtol=0,
                                   atol=2e-4)
    t2, fid2 = lab4.mxu_closest_hit(rays8, planes4, tc=woop.n_padded,
                                    precision=precision)
    assert torch.equal(t2, t) and torch.equal(fid2, fid)


def test_kernel_d_twin_without_planes():
    """No planes: every ray misses (t REAL_MAX, fid -1)."""
    _, _, rays8 = _lab4_inputs(n=40)
    t, fid = lab4.mxu_closest_hit(rays8, torch.zeros((0, 4)), tc=16)
    assert (fid == -1).all() and (t == lab4.REAL_MAX).all()


def test_lab4_variants_edit_the_kernel_source():
    """Every design lab4 --variants builds, kernel D's and kernel E's,
    edits text that csrc/lab4.cu holds exactly once; --variants refuses
    the CPU."""
    from tinypathtracer_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC / "lab4.cu").read_text()
    assert {"e_thread_per_ray", "e_rays4_ring",
            "e_cull_branch"} <= set(lab4.E_VARIANTS)
    assert not set(lab4.VARIANTS) & set(lab4.E_VARIANTS)
    for name, edits in {**lab4.VARIANTS, **lab4.E_VARIANTS}.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert text != src, name
    with pytest.raises(ValueError, match="card only"):
        lab4.main(["--device", "cpu", "--variants"])


def test_tf32_rounding():
    """tf32_round rounds to 10 mantissa bits, ties away from zero."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11),
                      1 + 2**-12, 0.0], dtype=torch.float32)
    want = [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 0.0]
    assert lab4.tf32_round(x).tolist() == want


def test_lab4_wrappers_check_shapes():
    woop, _, rays8 = _lab4_inputs()
    with pytest.raises(ValueError, match="tc"):
        lab4.mxu_closest_hit(rays8, lab4.make_planes4(woop), tc=512)
    with pytest.raises(ValueError, match="precision"):
        lab4.mxu_closest_hit(rays8, lab4.make_planes4(woop), tc=128,
                             precision="bf16")
    with pytest.raises(ValueError, match="no kernel"):
        lab4.vpu_rol_closest_hit(rays8.to("meta"),
                                 lab4.make_planesT(woop).to("meta"), tc=128)


def _diag_inputs(grid):
    """JAX tables of sphere_grid_scene(*grid), the port's, and 256 pixel8
    rays (one TN block) from the lab's own ray streams."""
    flat = jax_scene(*grid)
    tv = np.array(jax.jit(JaxTraceData.from_scene)(flat).tri_verts)
    jpk = jax.jit(lambda t: jpacket.precompute_packet(t, tc=128))(
        jnp.asarray(tv))
    planes, boxes = lab5_diag.diag_tables(torch.from_numpy(tv))
    o, d, _ = lab5.make_rays(port_scene(flat), 256, "pixel8")
    rays = torch.cat([o, d, torch.ones((256, 1)), torch.zeros((256, 1))],
                     dim=1).contiguous()
    return jpk, planes, boxes, rays


@pytest.fixture(scope="module")
def diag_inputs():
    """The 2,316-face scene (19 chunks, 128 boxes)."""
    return _diag_inputs(DIAG_GRID)


@pytest.fixture(scope="module")
def diag_inputs_256():
    """The 17,676-face scene (160 chunks, 256 boxes)."""
    return _diag_inputs(DIAG_GRID_256)


def _jax_diag(variant, rays, planes, boxes):
    """lab5_diag.make_kernel in interpret mode on one TN block."""
    cp = boxes.shape[1]
    return np.asarray(pl.pallas_call(
        jdiag.make_kernel(cp, variant), grid=(1,),
        in_specs=[pl.BlockSpec((jdiag.TN, 8), lambda i: (i, 0)),
                  pl.BlockSpec(tuple(planes.shape), lambda i: (0, 0)),
                  pl.BlockSpec(tuple(boxes.shape), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((jdiag.TN, 1), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((256, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((jdiag.PACKET, cp), jnp.int32),
                        pltpu.VMEM((jdiag.PACKET, jdiag.CHUNK), jnp.float32)],
        interpret=True)(*(jnp.asarray(x.numpy())
                          for x in (rays, planes, boxes))))


def test_diag_tables_match_jax(diag_inputs):
    jpk, planes, boxes, _ = diag_inputs
    assert np.array_equal(np.asarray(jpk.planes), planes.numpy())
    assert np.array_equal(np.asarray(jpk.boxes), boxes.numpy())
    assert planes.shape[0] // lab5_diag.ROWS == 19 and boxes.shape[1] == 128


@pytest.mark.parametrize("variant", [v for v in lab5_diag.VARIANTS
                                     if v != "epilogue"])
def test_kernel_f_twin_equals_jax(diag_inputs, variant):
    """Each variant of kernel F's twin equals lab5_diag.make_kernel in
    interpret mode exactly, on 256 pixel8 rays of the 19-chunk scene."""
    _, planes, boxes, rays = diag_inputs
    want = _jax_diag(variant, rays, planes, boxes)
    got = lab5_diag.diag_run(variant, rays, planes, boxes)
    assert got.shape == (256, 1)
    assert np.array_equal(got.numpy(), want)
    if variant == "walk":
        best, visits = lab5_diag.walk(rays.view(32, 8, 8), planes,
                                      lab5_diag._keys(rays.view(32, 8, 8),
                                                      boxes)[2])
        assert torch.equal(best.reshape(256, 1), got)
        assert (visits >= 1).all() and (visits < 19).all()
        assert float((got < lab5_diag.REAL_MAX).float().mean()) > 0.3


@pytest.mark.parametrize("variant", [v for v in lab5_diag.VARIANTS
                                     if v != "epilogue"])
def test_kernel_f_twin_equals_jax_above_128_chunks(diag_inputs_256,
                                                   variant):
    """Each variant of kernel F's twin equals lab5_diag.make_kernel in
    interpret mode exactly on 256 pixel8 rays of a scene of 160 chunks
    (256 chunk boxes: the card sizes its blocks by the boxes)."""
    jpk, planes, boxes, rays = diag_inputs_256
    assert boxes.shape[1] == 256 and planes.shape[0] // lab5_diag.ROWS > 128
    assert np.array_equal(np.asarray(jpk.boxes), boxes.numpy())
    got = lab5_diag.diag_run(variant, rays, planes, boxes)
    assert np.array_equal(got.numpy(), _jax_diag(variant, rays, planes,
                                                  boxes))


@pytest.mark.parametrize("scene", ["19 chunks", "160 chunks",
                                   "160 chunks, random rays"])
def test_kernel_f_schedule_model_equals_walk(diag_inputs, diag_inputs_256,
                                             scene):
    """warp_schedule, the plain model of kernel F's walk (one warp a
    packet, lanes over slots and over chunk keys), visits on every packet
    the chunks `walk` visits and returns its best t; `counted` on the CPU
    is the model. Pixel8 packets share an origin (o' once a slot); random
    rays do not."""
    _, planes, boxes, rays = (diag_inputs if scene == "19 chunks"
                              else diag_inputs_256)
    if scene.endswith("random rays"):
        rng = np.random.default_rng(7)
        o = rng.uniform(-4.0, 4.0, (256, 3))
        d = rng.standard_normal((256, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = torch.from_numpy(np.concatenate(
            [o, d, np.ones((256, 1)), np.zeros((256, 1))], 1).astype(
                np.float32)).contiguous()
    r = rays.view(32, 8, 8)
    best, visits = lab5_diag.walk(r, planes, lab5_diag._keys(r, boxes)[2])
    m_best, m_visits, one = lab5_diag.warp_schedule(rays, planes, boxes)
    assert torch.equal(m_visits, visits) and torch.equal(m_best, best)
    assert bool(one.all()) != scene.endswith("random rays")
    assert (visits >= 1).any() and int(visits.max()) < planes.shape[0] // 16
    out, c_visits = lab5_diag.counted(rays, planes, boxes)
    assert torch.equal(c_visits, visits)
    assert torch.equal(out, lab5_diag.diag_run("walk", rays, planes, boxes))


def test_kernel_f_builds_edit_the_kernel_source():
    """Every design lab5_diag --variants builds edits text that
    csrc/lab5_diag.cu holds exactly once; --variants refuses the CPU."""
    from tinypathtracer_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC / "lab5_diag.cu").read_text()
    for name, edits in lab5_diag.BUILDS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert text != src, name
    with pytest.raises(ValueError, match="card only"):
        lab5_diag.main(["--device", "cpu", "--variants"])


def test_kernel_f_epilogue_and_checks(diag_inputs):
    """epilogue gives REAL_MAX + 0 on the filled scratch; the wrapper
    refuses walkfix below 16 chunks, more than 1024 chunk boxes and a
    ray count that is not a multiple of 256."""
    _, planes, boxes, rays = diag_inputs
    out = lab5_diag.diag_run("epilogue", rays, planes, boxes)
    assert (out == lab5_diag.REAL_MAX).all()
    with pytest.raises(ValueError, match="walkfix"):
        lab5_diag.diag_run("walkfix", rays, planes[:15 * 16], boxes)
    big = torch.zeros((8, 1152))
    with pytest.raises(ValueError, match="1024"):
        lab5_diag.diag_run("walk", rays, torch.zeros((1100 * 16, 128)), big)
    with pytest.raises(ValueError, match="multiple"):
        lab5_diag.diag_run("walk", rays[:128], planes, boxes)


@pytest.mark.parametrize("mode", ["camera", "pixel8", "random"])
def test_lab5_rays_match_jax(mode):
    """make_rays gives the JAX tool's numpy streams bit for bit."""
    flat = jax_scene()
    jo, jd, _ = jlab5.make_rays(flat, 512, mode)
    o, d, tv = lab5.make_rays(port_scene(flat), 512, mode)
    assert np.array_equal(o.numpy(), np.asarray(jo))
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert tv.shape == (132, 3, 3)


def test_lab5_box_scene_names_the_missing_file():
    with pytest.raises(FileNotFoundError, match="box.gltf"):
        lab5.make_scene("box", torch.device("cpu"))


MAINS = {
    "kernel_lab": (kernel_lab, ["--n", "256", "--f", "228"],
                   ["dense_1Mx2048_ms", "dense_gpairs_per_s",
                    "dense_coherent_1Mx2048_ms",
                    "dense_coherent_gpairs_per_s", "row_gather_1Mx8_ms",
                    "row_gather_melem_per_s"]),
    "lab4": (lab4, ["--n", "128", "--f", "1948"],
             ["baseline_1Mx2048_ms", "baseline_gpairs_per_s",
              "mxu_tc256_highest_ms", "mxu_tc1024_highest_gpairs_per_s",
              "mxu_tc512_default_ms", "vpu_rol_tc256_ms",
              "vpu_rol_tc512_gpairs_per_s", "vpu_rol_tc1024_ms",
              "vpu_rol_survivor_share", "vpu_rol_batch_fill"]),
    "lab5": (lab5, ["--n", "256", "--scenes", "room"], []),
    "lab5_diag": (lab5_diag, ["--n", "256", "--n-lat", "10", "--n-lon", "16"],
                  [f"{v}_{s}" for v in lab5_diag.VARIANTS
                   for s in ("ms", "ns_per_packet")]),
    "lab_dense": (lab_dense, ["--n", "256", "--large-n", "256"],
                  ["n", "large_n"]),
    "lab_mega": (lab_mega, ["--n", "64", "--scenes", "room"], ["n"]),
    "lab6": (lab6, ["--n", "256", "--width", "16", "--height", "16",
                    "--spp", "1", "--depth", "3"],
             ["mega_fwd_ms", "mega_save_ms", "replay_fwd_ms",
              "replay_vjp_ms", "full_vjp_ms", "modular_fwd_ms", "rays",
              "full_vjp_rays_per_s"]),
    "profile_stages": (profile_stages, ["--width", "8", "--height", "8",
                                        "--spp", "2", "--depth", "3"],
                       ["frame_s", "rays_per_s", "intersect_frame_s",
                        "intersect_ms_per_dispatch", "glue_frame_s",
                        "glue_ms_per_bounce", "residual_s"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_lab_main_runs_on_the_cpu(name, capsys):
    """Each lab's main runs with --device cpu at a tiny size (the plain
    twins) and prints its JSON, naming the device."""
    mod, argv, keys = MAINS[name]
    res = mod.main(["--device", "cpu", "--reps", "1"] + argv)
    out = capsys.readouterr().out
    assert res["device"] == "cpu"
    for k in keys:
        assert np.isfinite(res[k]) and f'"{k}"' in out, k
    if name == "lab5":
        cell = res["room(1804f)"]
        for mode in ("camera", "pixel8", "random"):
            for impl in ("packet", "dense", "bvh"):
                assert cell[f"{mode}.{impl}_ms"] > 0
            assert 0 < cell[f"{mode}.visits_mean"] <= cell[
                f"{mode}.chunks_total"]
        assert json.loads(out[out.index("{"):])["room(1804f)"] == cell
    if name == "lab_mega":
        for lights in (0, 3):
            cell = res[f"room.lights{lights}"]
            for k in ("fwd_ms", "save_hits_ms", "fwd_bound_ms",
                      "save_hits_bound_ms", "eff_thread", "eff_pool",
                      "eff_no_refill", "rounds_mean", "sweeps_per_path"):
                assert np.isfinite(cell[k]) and cell[k] > 0, k
            assert 0 <= cell["tile_skip_share"] < 1
            assert cell["fwd_regs"] is None and cell["blocks"] == 1
            assert 0 < cell["eff_pool"] <= 1 and 1 <= cell["rounds_max"] <= 9
        assert (res["room.lights3"]["fwd_bound_ms"]
                > res["room.lights0"]["fwd_bound_ms"])
    if name == "lab_dense":
        for cell_name in lab_dense.CELLS:
            cell = res[cell_name]
            gated = cell_name != "room.camera" and cell_name != "room.bounce"
            assert cell["gated"] == gated and cell["regs"] is None
            assert cell["ms"] > 0 and 0 < cell["tested_share"] <= 1
            assert cell["staged_share"] >= cell["tested_share"]
        for cell_name in ("room.camera", "room.bounce"):
            cell = res[cell_name]
            assert cell["tested_share"] == cell["staged_share"] == 1.0
            assert cell["tested_bound_ms"] <= cell["bound_ms"]
        assert (res["large.camera"]["tested_bound_ms"]
                < 0.5 * res["large.camera"]["bound_ms"])
        assert 0 < res["room.bounce"]["live_share"] <= 1.0
        assert res["large.camera"]["tested_share"] < 0.5


def test_lab_mega_variants_edit_the_kernel_source():
    """Every variant lab_mega --variants builds edits text that
    csrc/mega.cu holds exactly once; --variants refuses the CPU."""
    from tinypathtracer_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC / "mega.cu").read_text()
    for name, edits in lab_mega.VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert text != src, name
    with pytest.raises(ValueError, match="card only"):
        lab_mega.main(["--device", "cpu", "--variants"])


def test_lab_dense_variants_edit_the_kernel_source():
    """Every variant lab_dense --variants builds edits text that
    csrc/dense.cu holds exactly once; --variants refuses the CPU."""
    from tinypathtracer_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC / "dense.cu").read_text()
    for name, edits in lab_dense.VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert text != src, name
    with pytest.raises(ValueError, match="card only"):
        lab_dense.main(["--device", "cpu", "--variants"])


@pytest.mark.parametrize("n,blocks", [(1024, 8), (96, 96), (60, 1)])
def test_lab_mega_split_perm_maps_pools(n, blocks):
    """The scatter split's permutation puts the interleaved pool of
    block b (paths b, b + blocks, ...) in the contiguous pool of block
    b, in order, and serves every path once."""
    perm = lab_mega.split_perm(n, blocks, torch.device("cpu"))
    span = n // blocks
    assert sorted(perm.tolist()) == list(range(n))
    for b in range(blocks):
        assert perm[b * span:(b + 1) * span].tolist() == list(
            range(b, n, blocks))


@pytest.mark.parametrize("count", [0, 1, 2, 3])
def test_lab_mega_with_lights_takes_the_first(count):
    """with_lights(scene, count) adds the first `count` of its three
    lights."""
    from tinypathtracer_tpu_torch.models.procedural import sphere_grid_scene

    scene = lab_mega.with_lights(sphere_grid_scene(1, 4, 6), count)
    assert scene.light_kind.tolist() == [0, 2, 1][:count]
    assert tuple(scene.light_pos.shape) == (count, 3)
