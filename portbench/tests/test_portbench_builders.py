"""Scene and sky builders, and the estimator's reference, found by name:
a builder is a new file that the lookup finds with no edit to any other,
a name found nowhere exits naming the file looked for, and a cell whose
mode or scene the reference cannot compute stops before its window."""

import json
import re
import sys
import textwrap

import numpy as np
import pytest
import torch

from portbench import bench, faults, reference, scenes
from portbench.reference import tracer
from portbench.tests import _tiny

# Haines' SPD "tetra": each tetrahedron replaced by four of half its
# edge, level times; 4^level tetrahedra of 4 triangles, lit by the sky
TETRA_PY = '''
import math

import numpy as np


def _unit(v):
    return v / np.linalg.norm(v)


def build(env_radiance, aspect, level, eye, point_light=None):
    tets = [np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                     np.float64) * 0.5]
    for _ in range(level):
        tets = [(t + t[i]) / 2 for t in tets for i in range(4)]
    tris = []
    for t in tets:
        for face in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
            tri = t[list(face)]
            n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            if np.dot(n, tri.mean(0) - t.mean(0)) < 0:
                tri = tri[[0, 2, 1]]
            tris.append(tri)
    v = np.concatenate(tris).astype(np.float32)
    n = np.concatenate([np.tile(_unit(np.cross(t[1] - t[0], t[2] - t[0])),
                                (3, 1)) for t in tris]).astype(np.float32)
    f = len(tris)
    back = _unit(np.asarray(eye, np.float64))
    right = _unit(np.cross([0.0, 1.0, 0.0], back))
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(back, right), back
    c2w[:3, 3] = eye
    lights = [] if point_light is None else [point_light]
    return dict(
        vertices=v, normals=n, texcoords=np.zeros((len(v), 2), np.float32),
        indices=np.arange(3 * f, dtype=np.int64).reshape(f, 3),
        vert_mats=np.eye(4)[None], normal_mats=np.eye(4)[None],
        obj_face_begin=[0], obj_mtl_idx=[0],
        face_mtl=np.zeros(f, np.int32), vert_obj=np.zeros(len(v), np.int32),
        mtl_base_color=[[0.7, 0.6, 0.5]], mtl_emission=[0.0],
        mtl_eta=[0.0], mtl_metallic=[0.0], mtl_roughness=[0.5],
        mtl_specular=[0.5],
        light_kind=np.zeros(len(lights)),
        light_color=np.ones((len(lights), 3)),
        light_intensity=np.ones(len(lights)),
        light_pos=np.asarray(lights, np.float64).reshape(-1, 3),
        light_dir=np.zeros((len(lights), 3)),
        light_cos_outer=np.zeros(len(lights)),
        light_inv_cone=np.zeros(len(lights)),
        env_radiance=np.asarray(env_radiance, np.float32),
        cam_to_world=c2w.astype(np.float32),
        cam_yfov=2.0 * math.atan(0.5), cam_aspect=aspect, cam_znear=0.01,
        tex_atlas=np.ones((1, 1, 1, 3), np.float32), mtl_tex_id=[-1])
'''
TWO_TONE_PY = '''
import numpy as np


def build(height, width, upper, lower):
    sky = np.empty((height, width, 3), np.float32)
    sky[:height // 2], sky[height // 2:] = upper, lower
    return sky
'''
TETRA = {"function": "spd.tetra", "level": 2, "eye": [0.3, 0.5, 1.8]}
SKY = {"function": "two_tone", "height": 4, "width": 8,
       "upper": [1.5, 1.4, 1.2], "lower": [0.3, 0.3, 0.35]}


def cornell() -> dict:
    return json.loads((bench.ROOT / "portbench/configs/cornell.json")
                      .read_text())


@pytest.fixture
def builders(tmp_path, monkeypatch):
    """A tetra scene builder and a two-tone sky written as new files to a
    directory that the lookup is pointed at."""
    (tmp_path / "spd.tetra.py").write_text(textwrap.dedent(TETRA_PY))
    (tmp_path / "two_tone.py").write_text(textwrap.dedent(TWO_TONE_PY))
    monkeypatch.setattr(scenes, "BUILDERS", tmp_path)
    return tmp_path


def test_a_new_builder_and_sky_are_found(builders):
    import tinypathtracer_tpu_torch as T

    config = dict(cornell(), scene=TETRA, env=SKY)
    arrays = scenes.build(config)
    assert set(arrays) == set(scenes.build(cornell()))
    assert arrays["indices"].shape == (4 * 4**2, 3)
    assert arrays["cam_aspect"] == 1920 / 1080
    sky = arrays["env_radiance"]
    assert sky.shape == (4, 8, 3) and sky.dtype == np.float32
    assert sky[0, 0].tolist() == pytest.approx(SKY["upper"])
    assert sky[-1, -1].tolist() == pytest.approx(SKY["lower"])
    scene = T.FlatScene.from_numpy(arrays, "cpu")
    assert torch.equal(scene.vertices, torch.from_numpy(arrays["vertices"]))
    assert torch.equal(scene.env_radiance, torch.from_numpy(sky))


def test_a_configuration_of_a_new_builder_runs_correct(builders):
    """The tiny cell with its scene and sky from the new files runs
    through the port and the reference, and is correct."""
    c = _tiny.cell()
    c.config.update(scene=TETRA, env=SKY)
    out = _tiny.execute(c, frames=1)
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("part,name", [("scene", "no_such_scene"),
                                       ("env", "no_such_sky"),
                                       ("scene", "../scenes")])
def test_an_unknown_builder_exits_naming_its_file(part, name):
    config = cornell()
    config[part] = dict(config[part], function=name)
    looked = re.escape(str(scenes.BUILDERS / f"{name}.py"))
    with pytest.raises(SystemExit, match=looked):
        scenes.build(config)


def test_cornell_arrays_are_quad_scene_s_bit_for_bit():
    config = cornell()
    scene, env = dict(config["scene"]), dict(config["env"])
    assert (scene.pop("function"), env.pop("function")) == (
        "quad_scene", "constant_sky")
    want = scenes.quad_scene(env_radiance=scenes.constant_sky(**env),
                             aspect=config["width"] / config["height"],
                             **scene)
    got = scenes.build(config)
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("mode", ["reference", "tracer"])
def test_the_reference_of_a_mode(mode):
    assert reference.for_mode(mode) is tracer


@pytest.mark.parametrize("mode", ["no_such_mode", "../tracer", "__init__"])
def test_a_mode_with_no_reference_exits_naming_its_file(mode):
    looked = re.escape(str(reference.HERE / f"{mode}.py"))
    with pytest.raises(SystemExit, match=looked):
        reference.for_mode(mode)


def test_a_cell_of_an_unknown_mode_exits_before_the_port_is_imported(
        monkeypatch):
    c = _tiny.cell()
    monkeypatch.setitem(sys.modules, "tinypathtracer_tpu_torch", None)
    with pytest.raises(ImportError):       # the port cannot be imported
        _tiny.execute(c)
    c.config["mode"] = "no_such_mode"
    with pytest.raises(SystemExit, match=r"reference[/\\]no_such_mode\.py"):
        _tiny.execute(c)


def test_a_scene_the_reference_refuses_exits_before_the_window(builders):
    """A point light, which the reference does not implement: the set-up
    runs (warm-up included), then the run exits with the reference's
    message before its first frame."""
    import tinypathtracer_tpu_torch as T
    from tinypathtracer_tpu_torch.render import renderer as rend

    c = _tiny.cell()
    c.config.update(scene=dict(TETRA, point_light=[0.0, 2.0, 2.0]), env=SKY)
    calls = {"render": 0, "render_pixel_ids": 0}

    def counted(name):
        def wrap(orig):
            def call(*args, **kwargs):
                calls[name] += 1
                return orig(*args, **kwargs)
            return call
        return wrap

    with faults.patched(T.Renderer, "render", counted("render")), \
            faults.patched(rend, "render_pixel_ids",
                           counted("render_pixel_ids")), \
            pytest.raises(SystemExit, match="neither delta lights nor "
                                            "textures"):
        _tiny.execute(c)
    assert calls == {"render": 0, "render_pixel_ids": 1}
