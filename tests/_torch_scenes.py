"""Scenes shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages render the same procedural room: the JAX package builds
it, and the port receives its fields as numpy arrays through
`FlatScene.from_numpy`. `write_room` writes the room as a glTF file
(chip_smoke.write_gltf, the writer the smoke run uses) for both
packages' `load_scene`; `write_textured_quad` writes a quad with a
base-color texture as a hand-built document (the JAX package's
tests/test_textured_scene.py builds its quad the same way). `train_setup` does the same for the training
state: JAX `Params` and an optax Adam state, and their port twins.
"""

import base64
import dataclasses
import io
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax

from tinypathtracer_tpu.diff.invrender import Params as JaxParams
from tinypathtracer_tpu.models.envlight import gradient_sky
from tinypathtracer_tpu.models.procedural import sphere_grid_scene
from chip_smoke import write_gltf
from tinypathtracer_tpu_torch import FlatScene
from tinypathtracer_tpu_torch.diff import Params, adam_state_from_optax

LR = 1e-2

# one point, one spot and one directional light
LIGHTS = dict(
    light_kind=np.array([0, 2, 1], np.int32),
    light_color=np.array([[1.0, 0.9, 0.8], [0.5, 0.6, 1.0], [1.0, 1.0, 1.0]],
                         np.float32),
    light_intensity=np.array([4.0, 6.0, 0.7], np.float32),
    light_pos=np.array([[0.0, 3.5, 0.0], [2.0, 2.0, -2.0], [0.0, 0.0, 0.0]],
                       np.float32),
    light_dir=np.array([[0.0, -1.0, 0.0], [-0.5, -0.7071, 0.5],
                        [0.3015, -0.9045, 0.3015]], np.float32),
    light_cos_outer=np.array([0.0, 0.8, 0.0], np.float32),
    light_inv_cone=np.array([0.0, 5.0, 0.0], np.float32),
)


def jax_scene(grid=1, n_lat=6, n_lon=12, lights=False):
    """The JAX package's sphere-grid room (132 faces at the defaults),
    with a 16x32 sky, optionally with the three delta lights."""
    flat = sphere_grid_scene(grid=grid, n_lat=n_lat, n_lon=n_lon,
                             env_radiance=gradient_sky(16, 32))
    if lights:
        flat = dataclasses.replace(
            flat, **{k: jnp.asarray(v) for k, v in LIGHTS.items()})
    return flat


def jax_planes(woop) -> np.ndarray:
    """A JAX WoopTris' component planes ([4, Fp] x 3) in the port's
    face-major [Fp, 12] layout."""
    return np.concatenate([np.asarray(woop.wx).T, np.asarray(woop.wy).T,
                           np.asarray(woop.wz).T], axis=1)


def to_numpy(flat) -> dict:
    return {f.name: np.asarray(getattr(flat, f.name))
            for f in dataclasses.fields(flat)}


def port_scene(flat, device="cpu") -> FlatScene:
    return FlatScene.from_numpy(to_numpy(flat), device)


def write_room(directory, grid=1, n_lat=6, n_lon=12, lights=False) -> str:
    """jax_scene(grid, n_lat, n_lon, lights) written as a glTF file in
    directory; returns its path."""
    flat = jax_scene(grid, n_lat, n_lon, lights=lights)
    name = f"room_{grid}_{n_lat}_{n_lon}{'_lights' if lights else ''}.gltf"
    return write_gltf(os.path.join(str(directory), name), to_numpy(flat))


def train_setup(flat, seed=0, steps=2, device="cpu"):
    """(JAX Params of flat, a mid-training optax.adam(LR) state, the port's
    Params, the port's AdamState). The state has taken `steps` updates
    with gradients drawn from numpy (seed); the params stay the scene's."""
    jparams = JaxParams.from_scene(flat)
    opt = optax.adam(LR)
    state = opt.init(jparams)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(
                rng.standard_normal(x.shape).astype(np.float32)), jparams)
        _, state = opt.update(grads, state, jparams)
    params = Params.from_numpy(to_numpy(jparams), device)
    return jparams, state, params, adam_state_from_optax(state, params)


# the quad's texture: 8x8 seeded colours (a 4-level mip chain)
QUAD_TEXTURE = np.random.default_rng(11).random((8, 8, 3)).astype(np.float32)


def _png_data_uri(img) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((img * 255).astype(np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def write_textured_quad(directory, texture=QUAD_TEXTURE) -> str:
    """A quad spanning [-1, 1]^2 at z = -2 facing the camera, its uvs
    covering the texture twice (wrap addressing), the texture a PNG data
    URI on a diffuse white material; returns the .gltf path."""
    pos = np.array([[-1, -1, -2], [1, -1, -2], [1, 1, -2], [-1, 1, -2]],
                   np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    # glTF's uv origin is top-left: v = 0 at the top of the texture
    uv = np.array([[0, 2], [2, 2], [2, 0], [0, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode(),
                     "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"}],
        "images": [{"uri": _png_data_uri(texture)}],
        "textures": [{"source": 0}],
        "materials": [{"name": "textured",
                       "pbrMetallicRoughness": {
                           "baseColorFactor": [1, 1, 1, 1],
                           "baseColorTexture": {"index": 0},
                           "metallicFactor": 0.0}}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.9, "aspectRatio": 1.0,
                                     "znear": 0.01}}],
        "nodes": [{"mesh": 0}, {"camera": 0}],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    path = os.path.join(str(directory), "quad.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
