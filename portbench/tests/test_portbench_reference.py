"""The plain reference (portbench/reference/) on hand-checked cases and
against the port's CPU twins at a tiny size."""

import json

import numpy as np
import pytest
import torch

from portbench import bench, scenes
from portbench.reference import tracer as ref

torch.set_num_threads(2)
CAMERA = {"position": [0.0, 0.0, 0.0], "direction": [0.0, 0.0, 1.0],
          "up": [0.0, 1.0, 0.0], "focal_length": 1.0, "film_height": 1.0}


def one_quad(z=2.0, emission=0.0):
    """A unit-sized quad facing -z at depth z, a camera at the origin
    looking down +z, a constant 0.25 sky."""
    quad = {"material": "m", "vertices": [[-1, -1, z], [1, -1, z],
                                          [1, 1, z], [-1, 1, z]]}
    return scenes.quad_scene(
        [quad], {"m": {"base_color": [0.5, 0.5, 0.5], "emission": emission}},
        CAMERA, "m", 1.0, scenes.constant_sky(2, 4, [0.25] * 3))


def small_quads(n=600, seed=3):
    """n small quads scattered in a 4-unit cube (clusters with boxes)."""
    rng = np.random.default_rng(seed)
    quads = []
    for c in rng.uniform(-2, 2, (n, 3)):
        e1, e2 = rng.normal(size=(2, 3)) * 0.05
        quads.append({"material": "m", "vertices": [
            list(c), list(c + e1), list(c + e1 + e2), list(c + e2)]})
    return scenes.quad_scene(
        quads, {"m": {"base_color": [0.5, 0.5, 0.5], "emission": 0.0}},
        CAMERA, "m", 1.0, scenes.constant_sky(2, 4, [0.25] * 3))


def cornell(**size):
    config = json.loads((bench.ROOT / "portbench/configs/cornell.json")
                        .read_text())
    config.update(size)
    return config, scenes.build(config)


def test_threefry_known_answer():
    # jax.random.fold_in(jax.random.PRNGKey(0), 0) and
    # jax.random.uniform(jax.random.PRNGKey(0), (2,)), read from jax 0.9
    k = ref.fold_in(ref.prng_key(0), 0)
    assert k.tolist() == [1797259609, 2579123966]
    u = ref.uniforms(ref.prng_key(0)[None], 2)
    assert u.tolist() == [[np.float32(0.947667).item(),
                           np.float32(0.9785799).item()]]


def test_hits_by_hand():
    tab = ref.Tables.build(one_quad(), "cpu")
    o = torch.tensor([[0.3, -0.2, 0.0], [0.0, 0.0, 0.0], [5.0, 0.0, 0.0],
                      [0.0, 0.0, 1.9999]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0],
                      [0.0, 0.0, 1.0]])
    (slot, t), = ref.closest_hit(tab, o, [d], [torch.ones(4, dtype=bool)])
    assert slot[0] >= 0 and float(t[0]) == pytest.approx(2.0)
    assert slot[1] == -1 and slot[2] == -1
    assert slot[3] == -1                    # t = 1e-4 < DELTA: no hit
    (masked, _), = ref.closest_hit(tab, o, [d], [torch.zeros(4, dtype=bool)])
    assert bool((masked == -1).all())


def test_lowest_slot_wins_a_tie():
    arrays = one_quad()
    # the same triangle twice: equal t, the lower slot wins
    arrays["indices"] = np.array([[0, 1, 2], [0, 1, 2]])
    tab = ref.Tables.build(arrays, "cpu")
    (slot, _), = ref.closest_hit(tab, torch.tensor([[0.5, -0.5, 0.0]]),
                                 [torch.tensor([[0.0, 0.0, 1.0]])],
                                 [torch.ones(1, dtype=bool)])
    assert slot.tolist() == [0]


def test_paths_by_hand():
    # an emissive quad filling the view: every camera path ends on it
    # with the raw emission; a diffuse one adds nothing but what its
    # bounces find, and every path that misses sees the sky
    tab = ref.Tables.build(one_quad(z=1e-3 + 1.0, emission=3.0), "cpu")
    tab.cam_to_world = torch.eye(4)
    tab.cam_to_world[0, 0] = tab.cam_to_world[2, 2] = -1.0
    tab.yfov, tab.aspect = torch.tensor(0.5), torch.tensor(1.0)
    img = ref.render_pixels(tab, ref.prng_key(5), torch.arange(16), 4, 4, 2, 3)
    assert torch.allclose(img, torch.full_like(img, 3.0))
    tab.cam_to_world = torch.eye(4)             # looks away: the sky alone
    sky = ref.render_pixels(tab, ref.prng_key(5), torch.arange(4), 2, 2, 1, 3)
    assert torch.allclose(sky, torch.full_like(sky, 0.25))


def test_cull_equals_the_full_sweep():
    arrays = small_quads()
    tab = ref.Tables.build(arrays, "cpu", cluster=16)
    full = ref.Tables.build(arrays, "cpu")
    full.clusters = [(0, full.n_faces, None)]
    g = torch.Generator().manual_seed(3)
    o = 4 * torch.rand((4000, 3), generator=g) - 2
    d = ref._unit(torch.randn((4000, 3), generator=g))
    m = torch.rand(4000, generator=g) < 0.9
    a = ref.closest_hit(tab, o, [d, -d], [m, ~m])
    b = ref.closest_hit(full, o, [d, -d], [m, ~m])
    for (sa, ta), (sb, tb) in zip(a, b):
        assert torch.equal(sa, sb) and torch.equal(ta, tb)
    assert len([c for c in tab.clusters if c[2] is not None]) > 10
    assert int((a[0][0] >= 0).sum()) > 100


@pytest.mark.parametrize("width,height,seed", [(24, 14, 987654321098),
                                               (16, 9, 2**31 + 5)])
def test_reference_equals_the_port_twin(width, height, seed):
    import tinypathtracer_tpu_torch as T

    config, arrays = cornell(width=width, height=height, spp=4)
    cfg = T.RenderConfig(**scenes.render_args(config))
    key = ref.prng_key(seed)
    img = T.Renderer(cfg, device="cpu").render(
        T.FlatScene.from_numpy(arrays, "cpu"), key)
    tab = ref.Tables.build(arrays, "cpu")
    n = width * height
    want = ref.render_pixels(tab, key, torch.arange(n), width, height, 4, 8)
    want = want.reshape(height, width, 3).flip(0)
    assert float((img - want).abs().max()) < 1e-5
    assert float(want.max()) > 1.0             # some paths reach the light


def test_cornell_box_picture():
    """The box as the source shows it, through the reference: the light
    at the top centre, the red wall on the image's left and the green on
    its right, the dark room beyond the box's sides."""
    config, arrays = cornell(width=128, height=72, spp=4)
    tab = ref.Tables.build(arrays, "cpu")
    img = ref.render_pixels(tab, ref.prng_key(9), torch.arange(128 * 72),
                            128, 72, 4, 8).reshape(72, 128, 3)  # bottom-up
    light = img[61:63, 61:67]
    assert float(light.mean()) == pytest.approx(10.933333, rel=1e-5)
    left, right = img[20:52, 32:42].sum((0, 1)), img[20:52, 86:96].sum((0, 1))
    assert left[0] > 2 * left[1] and right[1] > 2 * right[0]
    assert float(img[:, :16].abs().max()) == 0.0
    assert float(img[:, -16:].abs().max()) == 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.0e-3])
    y = ref.to_tf32(x)
    assert y[:2].tolist() == [1.0, 1.0 + 2**-10]
    assert y[2] == 1.0                          # a tie goes to even
    assert y[3] == 1.0 + 2**-9
    assert abs(float(y[4] / x[4]) - 1) < 2**-11
