"""SPD `tetra` (Haines' Standard Procedural Databases) on the port: the
scene builder of the benchmark's configuration `spd-tetra`
(portbench/builders/spd.tetra.py, numpy alone), the route its size
takes, and the port's frames against the benchmark's plain reference
(portbench/reference/tracer.py) on seeded keys, on the CPU at small
sizes.

The comparison is the one that decides the cell's `correct`: a pixel is
off where a channel of its mean radiance differs from the reference's
by more than `compare.PIXEL_TOL` x (1 + |reference|). The port's twins
and the reference compute the same paths in float32 with other
roundings (the reference has no fused multiply-adds and its own order
of the hit arithmetic), which moves a path's radiance by ~1e-6 of
itself; a path parts from the reference's only where a ray passes
within rounding of an edge, and moves its pixel by ~1/spp. The
frames below have no such path: every pixel is within the tolerance.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import bench, compare, scenes
from portbench.reference import tracer
from tinypathtracer_tpu_torch import FlatScene, RenderConfig, Renderer
from tinypathtracer_tpu_torch.render import renderer as rend

torch.set_num_threads(2)

CONFIG = json.loads((bench.ROOT / "portbench/configs/spd-tetra.json")
                    .read_text())


def _builder_module():
    """The builder's module, loaded by its path as `scenes.builder`
    loads it."""
    return scenes.builder("spd.tetra").__globals__


def _config(size_factor: int, width: int = 1920, height: int = 1080):
    c = json.loads(json.dumps(CONFIG))
    c["scene"]["size_factor"] = size_factor
    c.update(width=width, height=height)
    return c


def test_the_configuration_names_its_source():
    assert CONFIG["scene"]["function"] == "spd.tetra"
    assert CONFIG["scene"]["size_factor"] == 6
    assert "Haines" in CONFIG["source"] and "tetra.c" in CONFIG["source"]
    assert CONFIG["env"]["radiance"] == [0.078, 0.361, 0.753]
    assert list(CONFIG["reduced"]) == ["spp"]
    for key in ("light", "camera", "units", "view", "material"):
        assert CONFIG["assumed"][key], key


@pytest.mark.parametrize("size_factor", [0, 1, 2, 3])
def test_4_to_the_size_factor_tetrahedra(size_factor):
    mod = _builder_module()
    tets = mod["tetrahedra"](size_factor, (0.0, 0.0, 0.0), 1.0)
    assert tets.shape == (4**size_factor, 4, 3)
    arrays = scenes.build(_config(size_factor))
    assert arrays["indices"].shape == (4 * 4**size_factor, 3)
    assert arrays["vertices"].shape == (12 * 4**size_factor, 3)
    # the corner rule: every edge of a leaf is the root's over 2^sf,
    # and the leaves fill the root's corners
    edge = np.linalg.norm(tets[:, 0] - tets[:, 1], axis=1)
    assert np.allclose(edge, 2.0 * np.sqrt(2.0) / 2**size_factor)
    root = mod["tetrahedra"](0, (0.0, 0.0, 0.0), 1.0)[0]
    corners = tets.reshape(-1, 3)
    assert all(np.isclose(corners, c).all(axis=1).any() for c in root)


@pytest.mark.parametrize("size_factor", [1, 3])
def test_normals_are_unit_and_outward(size_factor):
    """Each triangle's stored normal, at its three vertices, is its unit
    geometric normal (v1 - v0) x (v2 - v0), pointing away from its
    tetrahedron's fourth corner."""
    mod = _builder_module()
    tets = mod["tetrahedra"](size_factor, (0.0, 0.0, 0.0), 1.0)
    a = scenes.build(_config(size_factor))
    tri = a["vertices"].astype(np.float64).reshape(-1, 3, 3)
    nrm = a["normals"].astype(np.float64).reshape(-1, 3, 3)
    assert np.allclose(nrm, nrm[:, :1])
    n = nrm[:, 0]
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
    geo = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    geo /= np.linalg.norm(geo, axis=1, keepdims=True)
    assert np.allclose(geo, n, atol=1e-6)
    # the corner of its tetrahedron (triangles 4i..4i+3 are tetrahedron
    # i's) that the triangle leaves out lies behind its plane
    owner = np.repeat(tets, 4, axis=0)
    dist = np.abs(owner[:, :, None, :] - tri[:, None, :, :]).sum(-1)
    fourth = owner[np.arange(len(tri)), (dist.min(axis=2) > 1e-6).argmax(1)]
    assert (np.einsum("ij,ij->i", fourth - tri[:, 0], n) < -1e-3).all()


def test_size_factor_6_takes_the_packet_route():
    arrays = scenes.build(CONFIG)
    assert arrays["indices"].shape == (16384, 3)
    assert arrays["light_kind"].shape == (0,)
    assert rend.resolve_intersector(RenderConfig(), 16384) == "packet"
    assert rend.resolve_intersector(RenderConfig(), 8192) == "dense"
    assert arrays["cam_yfov"] == pytest.approx(np.pi / 4)
    assert arrays["cam_aspect"] == pytest.approx(16 / 9)


def _within_tolerance(port, ref):
    off = compare.off_pixels(port, ref)
    assert not bool(off.any()), (
        f"{int(off.sum())} of {len(off)} pixels off the reference, "
        f"largest difference {float((port - ref).abs().max())}")


def test_size_factor_3_on_the_packet_route_equals_the_reference():
    """The whole 48x27 @4 spp d8 frame of the 256-triangle pyramid, forced
    onto the packet route (the modular loop on kernel C's twin) in
    chunks of 256 lanes, against the reference's pixels."""
    c = _config(3, 48, 27)
    arrays = scenes.build(c)
    cfg = RenderConfig(width=48, height=27, spp=4, max_depth=8,
                       intersector="packet", rays_per_dispatch=256)
    key = tracer.prng_key(3000000019)
    img = Renderer(cfg, device="cpu").render(
        FlatScene.from_numpy(arrays, "cpu"), key)
    tab = tracer.Tables.build(arrays, "cpu")
    pix = torch.arange(cfg.n_pixels)
    ref = tracer.render_pixels(tab, key, pix, cfg.width, cfg.height,
                               cfg.spp, cfg.max_depth)
    port = img.flip(0).reshape(-1, 3)          # raw rows, as pix numbers
    lit = (ref != torch.tensor(CONFIG["env"]["radiance"])).any(dim=1)
    assert 0.1 < float(lit.double().mean()) < 0.9   # pyramid and sky
    _within_tolerance(port, ref)


def test_size_factor_6_on_the_default_route_equals_the_reference():
    """256 pixels of the 16,384-triangle pyramid at 192x108 @4 spp d8, a
    16x16 block of its lower left, most of them on it, through the
    default route (which resolves to the packet traversal), in chunks
    of 64 pixels."""
    arrays = scenes.build(_config(6, 192, 108))
    cfg = RenderConfig(width=192, height=108, spp=4, max_depth=8,
                       rays_per_dispatch=256)
    state = rend.prepare_state(FlatScene.from_numpy(arrays, "cpu"), cfg)
    assert state.packet is not None and state.packet.n_chunks == 32
    rows, cols = torch.meshgrid(torch.arange(28, 44), torch.arange(72, 88),
                                indexing="ij")
    pix = (rows * cfg.width + cols).reshape(-1)
    key = tracer.prng_key(7777777777)
    with torch.inference_mode():
        port = rend.render_pixel_ids(state, cfg, pix, key) / cfg.spp
    tab = tracer.Tables.build(arrays, "cpu")
    ref = tracer.render_pixels(tab, key, pix, cfg.width, cfg.height,
                               cfg.spp, cfg.max_depth)
    lit = (ref != torch.tensor(CONFIG["env"]["radiance"])).any(dim=1)
    assert float(lit.double().mean()) > 0.8
    _within_tolerance(port, ref)


def _graph_runs(frames, cfg, monkeypatch):
    """Each (scene, key) frame's pixel sums with the bounces as CUDA
    graphs kept across the frames, and op by op, with kernel C's and
    kernel A's counted launches in each; and the graphs captured."""
    from tinypathtracer_tpu_torch.ops import dense, packet
    from tinypathtracer_tpu_torch.render import integrator

    captured = []
    real = integrator.BounceGraphs._capture

    def capture(self, fn):
        captured.append(1)
        return real(self, fn)

    monkeypatch.setattr(integrator.BounceGraphs, "_capture", capture)
    graphs = integrator.BounceGraphs(frames[0][0].device)
    out = []
    with torch.inference_mode():
        for scene, key in frames:
            state = rend.prepare_state(scene, cfg)
            bound = rend.prepare_state(scene, cfg, graphs=graphs)
            assert bound.route == dataclasses.replace(state.route,
                                                      graphs=True)
            assert bound.graphs is graphs and state.graphs is None
            pix = torch.arange(cfg.n_pixels, device=scene.device)
            runs = []
            for st in (bound, state):
                counts = (packet.packet_hit.launches,
                          dense.dense_hit.launches)
                img = rend.render_pixel_ids(st, cfg, pix, key)
                torch.cuda.synchronize()
                runs.append((img.cpu(), packet.packet_hit.launches
                             - counts[0], dense.dense_hit.launches
                             - counts[1]))
            out.append(runs)
    return out, len(captured)


@pytest.mark.parametrize("route", ["packet", "dense"])
def test_bounce_graphs_equal_the_plain_loop_on_the_card(route, monkeypatch):
    """On the card the modular loop's bounces run as CUDA graphs kept
    from frame to frame: the first chunk of a lane count op by op, the
    next captures, the rest replay, each frame's tables copied into the
    graphs' buffers. Over three frames of one scene, then one of another
    whose tables differ in shape (new buffers, new graphs), every image
    equals the op-by-op loop's bit for bit, with the same counted kernel
    launches. "packet": sf-4 and sf-3 pyramids forced onto kernel C;
    "dense": sphere rooms with an emissive panel on kernel A, the
    megakernel off; chunks of 4,096 lanes, the last one ragged.
    `Renderer.render` keeps graphs and gives the op-by-op image."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from tinypathtracer_tpu_torch import sphere_grid_scene
    from tinypathtracer_tpu_torch.render import film

    dev = torch.device("cuda", 0)
    if route == "packet":
        scene_a, scene_b = (
            FlatScene.from_numpy(scenes.build(_config(sf, 160, 90)), dev)
            for sf in (4, 3))
        cfg = RenderConfig(width=160, height=90, spp=4, max_depth=8,
                           intersector="packet", rays_per_dispatch=4096)
    else:
        scene_a, scene_b = (sphere_grid_scene(g, 8, 16, device=dev)
                            for g in (2, 1))
        cfg = RenderConfig(width=160, height=90, spp=4, max_depth=8,
                           megakernel=False, rays_per_dispatch=4096)
    keys = [tracer.prng_key(4000000007 + i, dev) for i in range(4)]
    frames = [(scene_a, k) for k in keys[:3]] + [(scene_b, keys[3])]
    out, captures = _graph_runs(frames, cfg, monkeypatch)
    assert captures >= 4
    for with_graphs, plain in out:
        assert plain[1 if route == "packet" else 2] > 0
        assert torch.equal(with_graphs[0], plain[0])
        assert with_graphs[1:] == plain[1:]
    renderer = Renderer(cfg, device=dev)
    for key in keys[:3]:
        img = renderer.render(scene_a, key)
        with torch.inference_mode():
            want = film.to_image(rend.render_frame(scene_a, cfg, key),
                                 cfg.spp)
        assert torch.equal(img, want)
