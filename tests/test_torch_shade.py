"""The modular loop's reference bounces shaded by csrc/shade.cu's two
kernels (ops/shade.py, `integrator.shaded_bounce`) against the torch
code, their plain twin.

On the CPU: the route of every caller (`renderer.decide_route`), the
torch code everywhere the route declines the kernels, the kernels'
route, run on the twins, equal to the torch loop bit for bit, and the
kernels refusing what they cannot shade. On the card (`-k card`): the
kernels' images equal the torch loop's bit for bit, op by op and as
CUDA graphs, with the same counted launches; kernel C equals its twin
on the queries the shaded bounces make, one device kernel a query. No
JAX here: the card runs this file.
"""

import dataclasses
import json

import pytest
import torch

from portbench import bench, scenes
from tinypathtracer_tpu_torch import (FlatScene, RenderConfig, prng_key,
                                      sphere_grid_scene)
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.ops import dense, packet, sampling, shade
from tinypathtracer_tpu_torch.render import integrator
from tinypathtracer_tpu_torch.render import renderer as rend
from tinypathtracer_tpu_torch.render.renderer import Route
from tinypathtracer_tpu_torch.tools.lab_mega import with_lights

torch.set_num_threads(2)

SHADE = (shade.shade_hits, shade.close_bounce)
# the other counted kernels of a bounce: the draw and the queries
QUERIES = (sampling.lane_draws, packet.packet_hit, dense.dense_hit)


def _lit_room(n_lights=3, grid=1, n_lat=6, n_lon=12, textured=False,
              device="cpu"):
    """The sphere-grid room under a gradient sky with n_lights delta
    lights, the point, spot and directional light of `with_lights` in
    turn."""
    scene = sphere_grid_scene(grid, n_lat, n_lon, device=device,
                              textured=textured,
                              env_radiance=gradient_sky(16, 32))
    three = with_lights(scene)
    idx = torch.arange(n_lights) % 3
    return dataclasses.replace(scene, **{
        f.name: getattr(three, f.name)[idx.to(device)]
        for f in dataclasses.fields(scene) if f.name.startswith("light_")})


def _counts():
    return [fn.launches for fn in SHADE + QUERIES]


def _with(state, **route):
    """The state with its route's fields replaced."""
    return dataclasses.replace(
        state, route=dataclasses.replace(state.route, **route))


def _render(state, cfg, key):
    """(pixel sums, counted launches of SHADE + QUERIES) of one frame on
    the state's route."""
    before = _counts()
    with torch.inference_mode():
        img = rend.render_pixel_ids(
            state, cfg, torch.arange(cfg.n_pixels, device=state.scene.device),
            key)
    if img.device.type == "cuda":
        torch.cuda.synchronize()
    return img.cpu(), [a - b for a, b in zip(_counts(), before)]


CFG = RenderConfig(width=12, height=10, spp=2, max_depth=5,
                   megakernel=False, rays_per_dispatch=64)
# (what declines, scene, cfg, grad): the torch code runs
DECLINED = {
    "physical": (_lit_room(), dataclasses.replace(CFG, mode="physical"),
                 False),
    "textured": (_lit_room(textured=True), CFG, False),
    "seven_lights": (_lit_room(7), CFG, False),
    "recording": (_lit_room(), CFG, True),
    "cpu_lanes": (_lit_room(), CFG, False),
}


def _recording(scene, grad):
    """The scene with its base colours a leaf that needs a gradient."""
    if not grad:
        return scene
    return dataclasses.replace(
        scene, mtl_base_color=scene.mtl_base_color.clone().requires_grad_())


@pytest.mark.parametrize("case", list(DECLINED))
def test_the_torch_code_runs_where_the_kernels_do_not(case):
    """Where the route declines the kernels, they never launch and the
    image is the torch loop's. The route is also decided with the lanes
    on a card: only "cpu_lanes" would take the kernels there."""
    scene, cfg, grad = DECLINED[case]
    scene = _recording(scene, grad)
    data = integrator.TraceData.from_scene(scene)
    on_card = rend.decide_route(data, cfg, "cuda", recording=grad)
    assert on_card.shade_kernels == (case == "cpu_lanes")
    pix = torch.arange(cfg.n_pixels)
    before = _counts()
    with torch.set_grad_enabled(grad):
        state = rend.prepare_state(scene, cfg)
        img = rend.render_pixel_ids(state, cfg, pix, prng_key(11))
        want = rend.render_pixel_ids(
            dataclasses.replace(state, route=Route(state.route.intersector)),
            cfg, pix, prng_key(11))
    assert _counts()[:2] == before[:2]
    assert state.route == Route("dense")
    assert torch.equal(img, want) and img.requires_grad == grad


def test_the_rule_engages_on_cuda_lanes_only():
    """Reference mode, untextured, 0-6 lights, no recording: the route
    takes the kernels on a card and nowhere else; on kernel B's route
    too, where the modular loop queries its hits itself (the tools), but
    replays no graphs."""
    data = integrator.TraceData.from_scene(_lit_room(6))
    assert rend.decide_route(data, CFG, "cuda").shade_kernels
    assert rend.decide_route(data, CFG, torch.device("cuda", 1)
                             ).shade_kernels
    assert not rend.decide_route(data, CFG, "cpu").shade_kernels
    assert not rend.decide_route(data, CFG, "cuda", recording=True
                                 ).shade_kernels
    assert rend.decide_route(
        data, dataclasses.replace(CFG, megakernel=True), "cuda",
        graphs=True) == Route("dense", megakernel=True, shade_kernels=True)


@pytest.mark.parametrize("isect,n_lights", [("dense", 0), ("dense", 3),
                                            ("bruteforce", 6),
                                            ("packet", 1)])
def test_the_kernels_route_equals_the_torch_loop(isect, n_lights,
                                                 monkeypatch):
    """The kernels' route run on their twins (a route that asks for them
    on the CPU): the carry as [N, 3] rows, the queries' masks, the
    ragged last chunk; the image equals the torch loop's bit for bit."""
    scene = _lit_room(n_lights)
    cfg = dataclasses.replace(CFG, intersector=isect)
    state = rend.prepare_state(scene, cfg)
    assert state.route == Route(isect)
    want, _ = _render(state, cfg, prng_key(3))
    calls = []
    real = shade._close_bounce_torch

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(shade, "_close_bounce_torch", spy)
    got, _ = _render(_with(state, shade_kernels=True), cfg, prng_key(3))
    assert calls and torch.equal(got, want)


def _scene(name, n_lights=0, textured=False):
    """A scene of the route cases: a benchmark configuration's, or the
    lit sphere room."""
    if name == "room":
        return _lit_room(n_lights, textured=textured)
    config = json.loads((bench.ROOT / f"portbench/configs/{name}.json")
                        .read_text())
    return FlatScene.from_numpy(scenes.build(config), "cpu")


TETRA = RenderConfig(width=1920, height=1080, spp=16, max_depth=8)
# case: (scene, cfg, device, recording, the caller keeps graphs, route)
ROUTES = {
    "cornell": (("cornell",), RenderConfig(), "cuda", False, True,
                Route("dense", megakernel=True, shade_kernels=True)),
    "tetra": (("spd-tetra",), TETRA, "cuda", False, True,
              Route("packet", shade_kernels=True, graphs=True)),
    "tetra_warm_up": (("spd-tetra",), TETRA, "cuda", False, False,
                      Route("packet", shade_kernels=True)),
    "room_modular": (("room",), CFG, "cuda", False, True,
                     Route("dense", shade_kernels=True, graphs=True)),
    "bvh": (("room",), RenderConfig(intersector="bvh"), "cuda", False, True,
            Route("bvh", shade_kernels=True)),
    "bruteforce": (("room",), RenderConfig(intersector="bruteforce"), "cuda",
                   False, True, Route("bruteforce", shade_kernels=True)),
    "physical": (("room", 3), RenderConfig(mode="physical"), "cuda", False,
                 True, Route("dense")),
    "textured": (("room", 0, True), CFG, "cuda", False, True,
                 Route("dense")),
    "seven_lights": (("room", 7), RenderConfig(), "cuda", False, True,
                     Route("dense", graphs=True)),
    "train_step": (("room",), RenderConfig(), "cuda", True, False,
                   Route("dense", megakernel=True)),
    "train_step_tetra": (("spd-tetra",), TETRA, "cuda", True, False,
                         Route("packet")),
    "cpu_lanes": (("room",), CFG, "cpu", False, True, Route("dense")),
    "textured_megakernel": (("room", 0, True), RenderConfig(), "cuda", False,
                            True, Route("dense", megakernel=True)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_the_route_of_each_caller(case):
    """The route `decide_route` gives each caller's frame, with the lanes
    on a card (no card needed) unless said: `Renderer.render` keeps
    graphs; the benchmark's warm-up (`prepare_state` and
    `render_pixel_ids` under inference mode), `render_frame_sharded`,
    `render_aov` and the tools keep none; a train step records. Kernel
    B's textured route runs its hits-only instance and the shading
    replay, which the shade kernels never shade."""
    (name, *args), cfg, device, recording, graphs, want = ROUTES[case]
    data = integrator.TraceData.from_scene(_scene(name, *args))
    assert rend.decide_route(data, cfg, device, recording, graphs) == want


@pytest.mark.parametrize("case", ["recording", "stored_hits", "physical",
                                  "textured", "seven_lights"])
def test_shade_kernels_refuse_what_they_cannot_shade(case):
    """Shade kernels asked for where they cannot be right raise: under
    autograd, on stored hits (kernel B's replay), in physical mode, on a
    textured scene, with more than MAX_LIGHTS lights."""
    scene = _recording(_lit_room(7 if case == "seven_lights" else 1,
                                 textured=case == "textured"),
                       case == "recording")
    cfg = dataclasses.replace(
        CFG, mode="physical" if case == "physical" else "reference")
    state = rend.prepare_state(scene, cfg)
    assert not state.route.shade_kernels
    o, d, keys = rend.lane_rays(scene, cfg, torch.arange(4), prng_key(2))
    stored = None
    if case == "stored_hits":
        n, depth = o.shape[0], cfg.max_depth
        stored = (torch.full((depth, n), -1), torch.zeros((depth, n)),
                  torch.zeros((depth, n, 2)), torch.full((depth, n), -1),
                  torch.zeros((depth, n), dtype=torch.int64))
    with pytest.raises(ValueError, match="the shade kernels shade"):
        integrator.trace_paths(state.data, cfg, rend.hit_fn(state, cfg), o,
                               d, keys, stored_hits=stored,
                               shade_kernels=True)


def _tetra(size_factor, device):
    config = json.loads((bench.ROOT / "portbench/configs/spd-tetra.json")
                        .read_text())
    config["scene"]["size_factor"] = size_factor
    config.update(width=160, height=90)
    return FlatScene.from_numpy(scenes.build(config), device)


@pytest.mark.parametrize("scene_kind", ["pyramids", "rooms", "lit_rooms"])
def test_shade_kernels_equal_the_torch_loop_on_the_card(scene_kind):
    """On the card, over three keys of one scene and one of a second:
    the kernels' frames op by op and as CUDA graphs kept across the
    frames equal the torch loop's (op by op and as graphs) bit for bit,
    with the same counted draws and queries, and the kernels launched
    where they engage only. "pyramids": the sf-4 and sf-3 SPD tetra on
    kernel C; "rooms": the sphere rooms with their emissive panel on
    kernel A, the megakernel off; "lit_rooms": the same with the point,
    spot and directional light under a gradient sky at env_scale 0.8.
    160x90 @4 spp d8 in chunks of 4,096 lanes, the last one ragged."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=160, height=90, spp=4, max_depth=8,
                       megakernel=False, rays_per_dispatch=4096)
    if scene_kind == "pyramids":
        pair = [_tetra(sf, dev) for sf in (4, 3)]
        cfg = dataclasses.replace(cfg, intersector="packet")
    elif scene_kind == "rooms":
        pair = [sphere_grid_scene(g, 8, 16, device=dev) for g in (2, 1)]
    else:
        pair = [_lit_room(3, g, 8, 16, device=dev) for g in (2, 1)]
        cfg = dataclasses.replace(cfg, env_scale=0.8)
    keys = [prng_key(4000000011 + i).to(dev) for i in range(4)]
    frames = [(pair[0], k) for k in keys[:3]] + [(pair[1], keys[3])]
    graphs = {True: integrator.BounceGraphs(dev),
              False: integrator.BounceGraphs(dev)}
    for scene, key in frames:
        runs = {}
        for fused in (True, False):
            with torch.inference_mode():
                state = rend.prepare_state(scene, cfg)
                bound = rend.prepare_state(scene, cfg, graphs=graphs[fused])
            assert state.route.shade_kernels and not state.route.graphs
            assert bound.route.graphs and bound.graphs is graphs[fused]
            for name, st in (("graphs", bound), ("plain", state)):
                runs[fused, name] = _render(
                    _with(st, shade_kernels=fused), cfg, key)
        want_img, want_n = runs[False, "plain"]
        assert want_n[:2] == [0, 0] and sum(want_n[3:]) > 0
        for (fused, name), (img, n) in runs.items():
            assert torch.equal(img, want_img), (fused, name)
            assert n[2:] == want_n[2:], (fused, name, n, want_n)
            assert (n[0] > 0 and n[0] == n[1]) if fused else n[:2] == [0, 0]


def _card_tetra():
    """The sf-4 SPD pyramid on the card at 160x90 @4 spp d8 in chunks of
    4,096 lanes on kernel C, and its state (the shade kernels' route, op
    by op)."""
    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=160, height=90, spp=4, max_depth=8,
                       intersector="packet", rays_per_dispatch=4096)
    with torch.inference_mode():
        state = rend.prepare_state(_tetra(4, dev), cfg)
    assert state.route == Route("packet", shade_kernels=True)
    return state, cfg


HITS = ("fid", "t", "uv", "visits")


def test_kernel_c_equals_its_twin_on_the_bounces_rows_on_the_card(
        monkeypatch):
    """On the card, every query kernel C is given in a tetra frame's
    bounces (the carry rows and the rows `shade_hits` writes, h and d2,
    with its bool masks alive and extra, as the bounce holds them): its
    (fid, t, uv, visits) equal its twin's on the same tensors bit for
    bit; so do the first bounce's queries unmasked and read as strided
    columns of an [N, 8] table through closest_hit_packet."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    state, cfg = _card_tetra()
    queries, real = [], packet.packet_hit

    def recording(origins, dirs, mask, pk):
        out = real(origins, dirs, mask, pk)
        queries.append(((origins.clone(), dirs.clone(), mask.clone()), out))
        return out

    recording.launches = 0      # _packet_cuda counts on the module's name
    monkeypatch.setattr(packet, "packet_hit", recording)
    _, n = _render(state, cfg, prng_key(4000000013).to(state.scene.device))
    monkeypatch.undo()
    # two queries a bounce (the pyramid has no lights), one launch each
    assert len(queries) == recording.launches == 2 * n[0] > 0
    assert all(q[2].dtype == torch.bool for q, _ in queries)
    hits = 0
    with torch.inference_mode():
        for i, (query, out) in enumerate(queries):
            want = packet._packet_torch(*query, state.packet)
            for g, w, name in zip(out, want, HITS):
                assert torch.equal(g, w), (i, name)
            hits += int((out[0] >= 0).sum())
        for (o, d, mask), _ in queries[:2]:
            k = o.shape[0]
            table = torch.cat([o, o.new_zeros((k, 2)), d], dim=1)
            for m in (None, mask):
                want = packet._packet_torch(o, d, m, state.packet)
                got = packet.closest_hit_packet(
                    table[:, 0:3], table[:, 5:8], state.packet, mask=m,
                    with_visits=True)
                for g, w, name in zip(got, want, HITS):
                    assert torch.equal(g, w), (m is None, name)
    assert hits > 0


def test_closest_hit_packet_is_one_launch_on_the_card():
    """On the card one closest_hit_packet call on contiguous rows, with
    or without a bool mask, runs one kernel on the device, kernel C:
    nothing packs the query before it or unpacks the hit after it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    state, cfg = _card_tetra()
    dev = state.scene.device
    pix = torch.arange(cfg.rays_per_dispatch // cfg.spp, device=dev)
    o, d, _ = rend.lane_rays(state.scene, cfg, pix,
                             prng_key(4000000017).to(dev))
    o, d = o.contiguous(), d.contiguous()
    alive = torch.arange(o.shape[0], device=dev) % 3 != 0
    act = torch.profiler.ProfilerActivity
    for mask in (None, alive):
        packet.closest_hit_packet(o, d, state.packet, mask=mask)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            packet.closest_hit_packet(o, d, state.packet, mask=mask)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation()]
        assert len(names) == 1 and "packet_hit_kernel" in names[0], names
