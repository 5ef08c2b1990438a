"""The scene-file entry point: the port's glTF reader, `Scene.flatten`,
camera, host math, base64 decoder, film and environment-image loader
against the JAX package's on the same written files and seeded inputs,
and the one-shot `render` end to end.

The glTF documents are written here (chip_smoke.write_gltf, and the
hand-built documents below): the small room with its emissive panel,
the room with a point, a spot and a directional light, a node
hierarchy with TRS transforms and a matrix (which both readers ignore),
and a textured quad whose two textures differ in size (the atlas
resamples one). `flatten` must equal JAX's field for field, exactly:
the port runs the same numpy code on the same float64 values.
"""

import base64
import dataclasses
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu import load_scene as jax_load_scene
from tinypathtracer_tpu import render as jax_render
from tinypathtracer_tpu.models.camera import Camera as JaxCamera
from tinypathtracer_tpu.models.envlight import gradient_sky as jax_sky
from tinypathtracer_tpu.models.envlight import load_env_image as jax_load_env
from tinypathtracer_tpu.render import film as jfilm
from tinypathtracer_tpu.utils import math3d as jm
from tinypathtracer_tpu_torch import (Camera, RenderConfig, Renderer,
                                      load_scene, prng_key, render,
                                      sphere_grid_scene)
from tinypathtracer_tpu_torch.models import scene as scene_mod
from tinypathtracer_tpu_torch.models.envlight import (gradient_sky,
                                                      load_env_image)
from tinypathtracer_tpu_torch.render import film
from tinypathtracer_tpu_torch.utils import math3d as m
from tinypathtracer_tpu_torch.utils.native import b64_decode

from _torch_scenes import write_room

torch.set_num_threads(2)

SKY = (16, 32)
SIZE = dict(width=16, height=16, spp=2, max_depth=4)


def _png_uri(img) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((img * 255).astype(np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _tri_blob():
    """A triangle and a quad: positions, normals, uvs (float32), the
    quad's indices as uint16 and the triangle's as uint8, and an
    interleaved (position, normal) copy of the triangle."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    quad = np.array([[-1, -1, -2], [1, -1, -2], [1, 1, -2], [-1, 1, -2]],
                    np.float32)
    nrm3 = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
    nrm4 = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv4 = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    inter = np.concatenate([tri, nrm3], axis=1)            # [3, 6]
    parts = [tri, nrm3, quad, nrm4, uv4,
             np.array([0, 1, 2, 0, 2, 3], np.uint16),
             np.array([0, 1, 2, 0], np.uint8), inter]
    blob, views = b"", []
    for p in parts:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": p.nbytes})
        blob += p.tobytes()
    views[-1]["byteStride"] = 24
    return blob, views


def _doc(blob, views, accessors, **rest) -> dict:
    return {"asset": {"version": "2.0"},
            "buffers": [{"uri": "data:application/octet-stream;base64,"
                         + base64.b64encode(blob).decode(),
                         "byteLength": len(blob)}],
            "bufferViews": views, "accessors": accessors, **rest}


def _accessors():
    vec3 = dict(componentType=5126, type="VEC3")
    return [dict(bufferView=0, count=3, **vec3),
            dict(bufferView=1, count=3, **vec3),
            dict(bufferView=2, count=4, **vec3),
            dict(bufferView=3, count=4, **vec3),
            dict(bufferView=4, componentType=5126, count=4, type="VEC2"),
            dict(bufferView=5, componentType=5123, count=6, type="SCALAR"),
            dict(bufferView=6, componentType=5121, count=3, type="SCALAR"),
            dict(bufferView=7, byteOffset=0, count=3, **vec3),
            dict(bufferView=7, byteOffset=12, count=3, **vec3)]


def _hierarchy_gltf(path) -> str:
    """Meshes under a node hierarchy with TRS transforms and one node
    given by a matrix; a glass, an emissive and an unnamed material; all
    three light kinds and a camera with a transform."""
    blob, views = _tri_blob()
    doc = _doc(
        blob, views, _accessors(),
        materials=[
            {"name": "glass", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.95, 1.0, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 0.1},
             "extensions": {"KHR_materials_ior": {"ior": 1.5},
                            "KHR_materials_transmission": {
                                "transmissionFactor": 0.8}}},
            {"name": "lamp", "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 0.8, 0.6, 1.0]},
             "extensions": {"KHR_materials_emissive_strength": {
                 "emissiveStrength": 7.5}}},
            {"pbrMetallicRoughness": {"metallicFactor": 0.3}}],
        meshes=[
            {"primitives": [{"attributes": {"POSITION": 2, "NORMAL": 3,
                                            "TEXCOORD_0": 4},
                             "indices": 5, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1},
                             "indices": 6, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": 7, "NORMAL": 8},
                             "indices": 6, "material": 2}]}],
        cameras=[{"type": "perspective", "perspective": {
            "yfov": 0.7, "aspectRatio": 1.5, "znear": 0.05}}],
        nodes=[
            {"name": "root", "children": [1, 2], "translation": [1, 2, 3]},
            {"mesh": 0, "translation": [0.5, -0.25, 1.0],
             "rotation": [0.2, 0.3, 0.1, 0.927], "scale": [2.0, 1.0, 0.5]},
            {"mesh": 1, "matrix": [2, 0, 0, 0, 0, 2, 0, 0, 0, 0, 2, 0,
                                   1, 1, 1, 1]},
            {"mesh": 2, "rotation": [0.0, 0.7071068, 0.0, 0.7071068]},
            {"camera": 0, "translation": [0.0, 1.0, 5.0],
             "rotation": [-0.1, 0.0, 0.0, 0.995]},
            {"translation": [0, 4, 0], "extensions": {
                "KHR_lights_punctual": {"light": 0}}},
            {"translation": [1, 3, -1], "rotation": [0.3, 0.0, 0.0, 0.954],
             "extensions": {"KHR_lights_punctual": {"light": 1}}},
            {"rotation": [0.5, 0.1, 0.2, 0.8], "extensions": {
                "KHR_lights_punctual": {"light": 2}}}],
        extensions={"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1.0, 0.5, 0.25], "intensity": 900.0},
            {"type": "spot", "intensity": 1500.0, "spot": {
                "innerConeAngle": 0.2, "outerConeAngle": 0.6}},
            {"type": "directional", "color": [0.9, 0.9, 1.0],
             "intensity": 2.5}]}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def _textured_gltf(path) -> str:
    """The quad with a base-color texture (8x8 checker) and a triangle
    with another (4x6), so the atlas resamples one to 8x8."""
    blob, views = _tri_blob()
    checker = np.kron(np.indices((4, 4)).sum(0) % 2,
                      np.ones((2, 2)))[..., None] * [1.0, 0.5, 0.25]
    rng = np.random.default_rng(2)
    doc = _doc(
        blob, views, _accessors(),
        images=[{"uri": _png_uri(checker.astype(np.float32))},
                {"uri": _png_uri(rng.random((4, 6, 3)).astype(np.float32))}],
        textures=[{"source": 0}, {"source": 1}],
        materials=[
            {"name": "checker", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0}, "metallicFactor": 0.0}},
            {"name": "noise", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 1}, "metallicFactor": 0.0}}],
        meshes=[{"primitives": [{"attributes": {"POSITION": 2, "NORMAL": 3,
                                                "TEXCOORD_0": 4},
                                 "indices": 5, "material": 0}]},
                {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1},
                                 "indices": 6, "material": 1}]}],
        cameras=[{"type": "perspective", "perspective": {"yfov": 0.9}}],
        nodes=[{"mesh": 0}, {"mesh": 1, "translation": [0, 0, -3]},
               {"camera": 0}])
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


@pytest.fixture(scope="module")
def gltf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gltf")
    return {"room": write_room(d), "room_lights": write_room(d, lights=True),
            "hierarchy": _hierarchy_gltf(d / "hierarchy.gltf"),
            "textured": _textured_gltf(d / "textured.gltf")}


def _assert_fields_equal(port_flat, jax_flat):
    for f in dataclasses.fields(port_flat):
        got = getattr(port_flat, f.name).numpy()
        want = np.asarray(getattr(jax_flat, f.name))
        assert got.dtype == want.dtype, f.name
        assert np.array_equal(got, want), f.name


@pytest.mark.parametrize("doc", ["room", "room_lights", "hierarchy",
                                 "textured"])
def test_flatten_matches_jax(gltf_files, doc):
    """load_scene(path).flatten(env) equals the JAX package's, field for
    field and bit for bit."""
    path = gltf_files[doc]
    env = jax_sky(*SKY)
    want = jax_load_scene(path).flatten(env_radiance=env)
    got = load_scene(path).flatten(env_radiance=env, device="cpu")
    _assert_fields_equal(got, want)
    if doc == "textured":
        assert got.has_textures and got.tex_atlas.shape == (2, 8, 8, 3)
    if doc == "hierarchy":
        assert got.light_kind.tolist() == [0, 2, 1]
        assert got.vert_mats.shape[0] == 3


def test_flatten_defaults_and_env_tensor(gltf_files):
    """No env gives the JAX package's black [1, 1, 3] dome; a tensor env
    is taken like its numpy array."""
    path = gltf_files["room"]
    _assert_fields_equal(load_scene(path).flatten(device="cpu"),
                         jax_load_scene(path).flatten())
    got = load_scene(path).flatten(gradient_sky(*SKY), device="cpu")
    assert torch.equal(got.env_radiance, gradient_sky(*SKY))


@pytest.mark.parametrize("lights", [False, True])
def test_written_room_reads_back_the_procedural_arrays(tmp_path, lights):
    """The writer's round trip: the loaded room has the procedural
    room's world geometry, per-face materials, lights and camera bit for
    bit (its object tables hold a mesh per material run instead)."""
    from tinypathtracer_tpu_torch.tools import lab_mega

    room = sphere_grid_scene(1, 6, 12, env_radiance=gradient_sky(*SKY))
    if lights:
        room = lab_mega.with_lights(room)
    from chip_smoke import write_gltf

    arrays = {f.name: getattr(room, f.name).numpy()
              for f in dataclasses.fields(room)}
    loaded = load_scene(write_gltf(tmp_path / "r.gltf", arrays)).flatten(
        gradient_sky(*SKY), device="cpu")
    for a, b in zip(room.world_geometry(), loaded.world_geometry()):
        assert torch.equal(a, b)
    assert torch.equal(room.indices, loaded.indices)
    for name in ("mtl_base_color", "mtl_emission", "mtl_eta", "mtl_metallic",
                 "mtl_roughness", "mtl_specular"):
        assert torch.equal(getattr(room, name)[room.face_mtl.long()],
                           getattr(loaded, name)[loaded.face_mtl.long()]), name
    for name in ("light_kind", "light_color", "light_intensity", "light_pos",
                 "light_dir", "light_cos_outer", "light_inv_cone",
                 "cam_to_world", "cam_yfov", "cam_aspect", "cam_znear",
                 "env_radiance", "texcoords", "tex_atlas"):
        assert torch.equal(getattr(room, name), getattr(loaded, name)), name


def test_written_textured_room_reads_back(tmp_path):
    """write_gltf of a textured room: TEXCOORD_0 on every mesh and the
    atlas as an 8-bit PNG texture per layer. It loads back to the exact
    texcoords, the quantised atlas (chip_smoke.quantised_atlas), each
    face's texture layer, and renders the frame of the procedural room
    that carries the quantised atlas, bit for bit."""
    from chip_smoke import quantised_atlas, write_gltf

    room = sphere_grid_scene(1, 6, 12, env_radiance=gradient_sky(*SKY),
                             textured=True)
    arrays = {f.name: getattr(room, f.name).numpy()
              for f in dataclasses.fields(room)}
    loaded = load_scene(write_gltf(tmp_path / "t.gltf", arrays)).flatten(
        gradient_sky(*SKY), device="cpu")
    assert torch.equal(loaded.texcoords, room.texcoords)
    q = quantised_atlas(arrays["tex_atlas"])
    assert np.array_equal(loaded.tex_atlas.numpy(), q)
    assert not np.array_equal(q, arrays["tex_atlas"])
    assert float(np.abs(q - arrays["tex_atlas"]).max()) <= 0.5 / 255 + 1e-7
    assert torch.equal(room.mtl_tex_id[room.face_mtl.long()],
                       loaded.mtl_tex_id[loaded.face_mtl.long()])
    procedural = dataclasses.replace(room, tex_atlas=torch.from_numpy(q))
    r = Renderer(RenderConfig(**SIZE), device="cpu")
    assert torch.equal(r.render(loaded, prng_key(2)),
                       r.render(procedural, prng_key(2)))


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("lights", [False, True])
def test_loaded_room_reference_frame_is_bit_equal(gltf_files, lights,
                                                  megakernel):
    """The loaded glTF room renders the procedural room's reference-mode
    frame bit for bit, on the megakernel twin and the modular loop."""
    from _torch_scenes import jax_scene, port_scene

    cfg = RenderConfig(**SIZE, megakernel=megakernel)
    procedural = port_scene(jax_scene(lights=lights))
    loaded = load_scene(gltf_files["room_lights" if lights else "room"]
                        ).flatten(procedural.env_radiance, device="cpu")
    r = Renderer(cfg, device="cpu")
    assert torch.equal(r.render(loaded, prng_key(5)),
                       r.render(procedural, prng_key(5)))


@pytest.mark.parametrize("mode", ["reference", "physical"])
def test_one_shot_render_matches_jax(gltf_files, mode):
    """render(scene, cfg, key, env, device="cpu") against the JAX
    package's render on the written 3-light room (JAX on its modular
    path): within 1e-5 on every pixel (the shading is FMA-fused by XLA,
    unfused here; measured max 2.1e-6 in physical mode)."""
    path = gltf_files["room_lights"]
    env = jax_sky(64, 128)
    want = np.asarray(jax_render(
        jax_load_scene(path),
        JaxConfig(**SIZE, mode=mode, megakernel=False, mega_impl="off"),
        jax.random.PRNGKey(9), env_radiance=env))
    got = render(load_scene(path), RenderConfig(**SIZE, mode=mode),
                 prng_key(9), env_radiance=env, device="cpu")
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want.mean() > 0.05


def test_entry_points_default_to_the_card(gltf_files):
    """Without a card, the one-shot render and flatten raise rather than
    run elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    scene = load_scene(gltf_files["room"])
    with pytest.raises((RuntimeError, AssertionError)):
        render(scene, RenderConfig(**SIZE), prng_key(0))
    with pytest.raises((RuntimeError, AssertionError)):
        scene.flatten()


def test_camera_to_world_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        kw = dict(yfov=float(rng.uniform(0.3, 1.5)),
                  translation=tuple(rng.normal(size=3)),
                  rotation=tuple(rng.normal(size=4)),
                  scale=tuple(rng.uniform(0.5, 2.0, 3)))
        got = Camera(**kw).camera_to_world()
        want = JaxCamera(**kw).camera_to_world()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert np.array_equal(Camera().camera_to_world(),
                          JaxCamera().camera_to_world())


def test_host_math_matches_jax():
    """quat_to_mat3, trs_to_mat4, normal_matrix, euler_zxy_to_quat:
    the same float64 numpy arithmetic, exactly."""
    rng = np.random.default_rng(4)
    for _ in range(8):
        q, t, s = rng.normal(size=4), rng.normal(size=3), rng.uniform(
            0.2, 3.0, 3)
        ang = rng.uniform(-180, 180, 3)
        assert np.array_equal(m.quat_to_mat3(q), jm.quat_to_mat3(q))
        mat = m.trs_to_mat4(t, q, s)
        assert np.array_equal(mat, jm.trs_to_mat4(t, q, s))
        assert np.array_equal(m.normal_matrix(mat), jm.normal_matrix(mat))
        assert np.array_equal(m.euler_zxy_to_quat(ang),
                              jm.euler_zxy_to_quat(ang))
    assert np.array_equal(m.quat_to_mat3(np.zeros(4)), np.eye(3))


@pytest.mark.parametrize("fn", ["vdot", "vcross", "vnorm2", "reflect",
                                "transform_points", "transform_dirs",
                                "vnormalize", "build_onb"])
def test_tensor_math_matches_jax(fn):
    """The tensor helpers on seeded inputs against the JAX package's,
    jitted. vdot, vcross and vnorm2 reproduce XLA:CPU's fused
    multiply-adds: exact. reflect, the transforms and build_onb's
    frame differ by the rounding of an FMA or of XLA's approximate rsqrt
    (ROADMAP section 3): within 4 ulps (atol 1e-6 on unit-size values)."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(257, 3)).astype(np.float32)
    b = rng.normal(size=(257, 3)).astype(np.float32)
    n = (b / np.linalg.norm(b, axis=1, keepdims=True)).astype(np.float32)
    n[:3, 2] = 0.0          # build_onb's n.z == 0 branch
    m4 = rng.normal(size=(257, 4, 4)).astype(np.float32)
    args = {"vdot": (a, b), "vcross": (a, b), "vnorm2": (a,),
            "reflect": (a, n), "transform_points": (m4, a),
            "transform_dirs": (m4, a), "vnormalize": (a,),
            "build_onb": (n,)}[fn]
    want = jax.jit(getattr(jm, fn))(*(jnp.asarray(x) for x in args))
    got = getattr(m, fn)(*(torch.from_numpy(x) for x in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        if fn in ("vdot", "vcross", "vnorm2"):
            assert np.array_equal(g.numpy(), w), fn
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("length", [0, 1, 2, 3, 4, 100, 4099])
def test_b64_decode_matches_base64(length):
    data = np.random.default_rng(length).integers(
        0, 256, length, dtype=np.uint8).tobytes()
    text = base64.b64encode(data).decode()
    assert b64_decode(text) == data
    # whitespace inside and padding dropped, as the JAX decoder accepts
    assert b64_decode(text[:4] + "\n " + text[4:].rstrip("=")) == data
    with pytest.raises(ValueError):
        b64_decode("ab*d")


def test_tonemap_and_png_round_trip(tmp_path):
    rng = np.random.default_rng(8)
    img = (rng.normal(0.5, 0.6, size=(9, 7, 3))).astype(np.float32)
    img[0, 0] = [-1.0, 2.0, 1.0]
    want = np.asarray(jfilm.tonemap_uint8(jnp.asarray(img)))
    got = film.tonemap_uint8(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    film.write_png(str(tmp_path / "a.png"), torch.from_numpy(img))
    jfilm.write_png(str(tmp_path / "b.png"), img)
    from PIL import Image

    a = np.asarray(Image.open(tmp_path / "a.png"))
    assert np.array_equal(a, want)
    assert np.array_equal(a, np.asarray(Image.open(tmp_path / "b.png")))


@pytest.mark.parametrize("ext", ["npy", "png"])
def test_load_env_image_matches_jax(tmp_path, ext):
    rng = np.random.default_rng(9)
    path = str(tmp_path / f"env.{ext}")
    if ext == "npy":
        np.save(path, (rng.random((6, 10, 4)) * 4.0).astype(np.float64))
    else:
        from PIL import Image

        Image.fromarray(rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
                        ).save(path)
    got, want = load_env_image(path), jax_load_env(path)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    # it renders as a dome: the flatten takes it as it is
    assert got.shape == (6, 10, 3)


def test_resize_image_matches_jax():
    from tinypathtracer_tpu.models.scene import _resize_image as jax_resize

    img = np.random.default_rng(10).random((5, 7, 3)).astype(np.float32)
    for shape in ((5, 7), (8, 8), (3, 11)):
        assert np.array_equal(scene_mod._resize_image(img, *shape),
                              jax_resize(img, *shape))
