"""The modular loop's reference bounces shaded by csrc/shade.cu's two
kernels (ops/shade.py, `integrator.shaded_bounce`) against the torch
code, their plain twin.

On the CPU: the rule that picks the kernels (`integrator.fused_shading`)
and the torch code everywhere it declines, and the kernels' route, run
on the twins, equal to the torch loop bit for bit. On the card (`-k
card`): the kernels' images equal the torch loop's bit for bit, op by
op and as CUDA graphs, with the same counted launches. No JAX here: the
card runs this file.
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


def _render(state, cfg, key, fused=None, monkeypatch=None):
    """(pixel sums, counted launches of SHADE + QUERIES) of one frame;
    fused=False forces the torch code."""
    if fused is not None:
        real = integrator.fused_shading
        monkeypatch.setattr(integrator, "fused_shading",
                            lambda *a: fused and real(*a))
    before = _counts()
    with torch.inference_mode():
        img = rend.render_pixel_ids(
            state, cfg, torch.arange(cfg.n_pixels, device=state.scene.device),
            key)
    if img.device.type == "cuda":
        torch.cuda.synchronize()
    if fused is not None:
        monkeypatch.setattr(integrator, "fused_shading", real)
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


@pytest.mark.parametrize("case", list(DECLINED))
def test_the_torch_code_runs_where_the_kernels_do_not(case, monkeypatch):
    """Where the rule declines, the kernels never launch and the image is
    the torch loop's. The rule is asked, as the loop asks it, also with
    the lanes on a card: only "cpu_lanes" would engage there."""
    scene, cfg, grad = DECLINED[case]
    asked = []
    real = integrator.fused_shading

    def spy(data, cfg_, device, recording, replay):
        asked.append(real(data, cfg_, "cuda", recording, replay))
        return real(data, cfg_, device, recording, replay)

    monkeypatch.setattr(integrator, "fused_shading", spy)
    if grad:
        scene = dataclasses.replace(
            scene, mtl_base_color=scene.mtl_base_color.clone()
            .requires_grad_())
    before = _counts()
    with torch.set_grad_enabled(grad):
        img = rend.render_frame(scene, cfg, prng_key(11))
    assert _counts()[:2] == before[:2]
    assert asked and all(a == (case == "cpu_lanes") for a in asked)
    monkeypatch.setattr(integrator, "fused_shading", lambda *a: False)
    with torch.set_grad_enabled(grad):
        want = rend.render_frame(scene, cfg, prng_key(11))
    assert torch.equal(img, want)


def test_the_rule_engages_on_cuda_lanes_only():
    """Reference mode, untextured, 0-6 lights, no replay, no recording:
    the rule engages on a card and nowhere else."""
    data = integrator.TraceData.from_scene(_lit_room(6))
    assert integrator.fused_shading(data, CFG, "cuda", False, False)
    assert integrator.fused_shading(data, CFG, torch.device("cuda", 1),
                                    False, False)
    assert not integrator.fused_shading(data, CFG, "cpu", False, False)
    assert not integrator.fused_shading(data, CFG, "cuda", True, False)
    assert not integrator.fused_shading(data, CFG, "cuda", False, True)


@pytest.mark.parametrize("isect,n_lights", [("dense", 0), ("dense", 3),
                                            ("bruteforce", 6),
                                            ("packet", 1)])
def test_the_kernels_route_equals_the_torch_loop(isect, n_lights,
                                                 monkeypatch):
    """The kernels' route run on their twins (the rule forced to engage
    on the CPU): the carry as [N, 3] rows, the queries' masks, the
    ragged last chunk; the image equals the torch loop's bit for bit."""
    scene = _lit_room(n_lights)
    cfg = dataclasses.replace(CFG, intersector=isect)
    state = rend.prepare_state(scene, cfg)
    want, _ = _render(state, cfg, prng_key(3), False, monkeypatch)
    monkeypatch.setattr(integrator, "fused_shading", lambda *a: True)
    calls = []
    real = shade.close_bounce

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(integrator, "close_bounce", spy)
    got, _ = _render(state, cfg, prng_key(3))
    assert calls and torch.equal(got, want)


def _tetra(size_factor, device):
    config = json.loads((bench.ROOT / "portbench/configs/spd-tetra.json")
                        .read_text())
    config["scene"]["size_factor"] = size_factor
    config.update(width=160, height=90)
    return FlatScene.from_numpy(scenes.build(config), device)


@pytest.mark.parametrize("scene_kind", ["pyramids", "rooms", "lit_rooms"])
def test_shade_kernels_equal_the_torch_loop_on_the_card(scene_kind,
                                                        monkeypatch):
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
                bound = rend.bind_graphs(graphs[fused], state, cfg)
            assert bound.graphs is graphs[fused]
            for name, st in (("graphs", bound), ("plain", state)):
                runs[fused, name] = _render(st, cfg, key, fused, monkeypatch)
        want_img, want_n = runs[False, "plain"]
        assert want_n[:2] == [0, 0] and sum(want_n[3:]) > 0
        for (fused, name), (img, n) in runs.items():
            assert torch.equal(img, want_img), (fused, name)
            assert n[2:] == want_n[2:], (fused, name, n, want_n)
            assert (n[0] > 0 and n[0] == n[1]) if fused else n[:2] == [0, 0]
