"""The scenes and skies that configuration files describe, as the
port's FlatScene field arrays (numpy alone).

A configuration's "scene" names a function here and gives its arguments
as data: `quad_scene` builds a scene from a list of quads with named
materials and a pinhole camera, as a published scene states them, so a
later configuration of that kind is a new data file alone. The arrays
take the form of `tinypathtracer_tpu_torch/models/procedural.py`'s
scenes at commit cfca82b (one object, identity transforms, no texture,
no delta light). Imports nothing of the port: the reference reads these
arrays too.
"""

from __future__ import annotations

import math

import numpy as np


def _unit(v):
    return v / np.linalg.norm(v)


def camera_to_world(position, direction, up) -> np.ndarray:
    """The 4x4 camera-to-world matrix of a pinhole at position looking
    along direction, up towards up; the camera looks down its -Z (glTF)."""
    f = _unit(np.asarray(direction, np.float64))
    r = _unit(np.cross(f, np.asarray(up, np.float64)))
    u = np.cross(r, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = r, u, -f
    c2w[:3, 3] = position
    return c2w.astype(np.float32)


def quad_scene(quads, materials, camera, units, aspect,
               env_radiance) -> dict:
    """FlatScene field arrays of quads [{"material", "vertices" [4, 3]}],
    each split into the triangles (v0 v1 v2) and (v0 v2 v3) with its own
    vertices and geometric normal; materials {name: {"base_color",
    "emission"}} (diffuse); camera {"position", "direction", "up",
    "focal_length", "film_height"}, the image's width over height
    `aspect`; env_radiance an [H, W, 3] float32 array. Lengths are in
    metres (`units` "m"): the port's self-hit offset is absolute."""
    if units != "m":
        raise ValueError(f"quad_scene takes metres, not {units!r}")
    names = list(materials)
    verts, norms, mtl = [], [], []
    for q in quads:
        v = np.asarray(q["vertices"], np.float32)
        for tri in (v[[0, 1, 2]], v[[0, 2, 3]]):
            n = np.cross(tri[1] - tri[0], tri[2] - tri[0]).astype(np.float64)
            verts.append(tri)
            norms.append(np.tile(_unit(n).astype(np.float32), (3, 1)))
            mtl.append(names.index(q["material"]))
    f = len(mtl)
    v = np.concatenate(verts)
    yfov = 2.0 * math.atan(0.5 * camera["film_height"]
                           / camera["focal_length"])
    return dict(
        vertices=v, normals=np.concatenate(norms),
        texcoords=np.zeros((len(v), 2), np.float32),
        indices=np.arange(3 * f, dtype=np.int64).reshape(f, 3),
        vert_mats=np.eye(4)[None], normal_mats=np.eye(4)[None],
        obj_face_begin=[0], obj_mtl_idx=[0],
        face_mtl=np.asarray(mtl, np.int32),
        vert_obj=np.zeros(len(v), np.int32),
        mtl_base_color=[materials[k]["base_color"] for k in names],
        mtl_emission=[materials[k]["emission"] for k in names],
        mtl_eta=np.zeros(len(names)), mtl_metallic=np.zeros(len(names)),
        mtl_roughness=[0.5] * len(names), mtl_specular=[0.5] * len(names),
        light_kind=np.zeros(0), light_color=np.zeros((0, 3)),
        light_intensity=np.zeros(0), light_pos=np.zeros((0, 3)),
        light_dir=np.zeros((0, 3)), light_cos_outer=np.zeros(0),
        light_inv_cone=np.zeros(0),
        env_radiance=np.asarray(env_radiance, np.float32),
        cam_to_world=camera_to_world(camera["position"],
                                     camera["direction"], camera["up"]),
        cam_yfov=yfov, cam_aspect=aspect, cam_znear=0.01,
        tex_atlas=np.ones((1, 1, 1, 3), np.float32),
        mtl_tex_id=[-1] * len(names))


def constant_sky(height: int, width: int, radiance) -> np.ndarray:
    """An equirect environment [H, W, 3] of one radiance."""
    return np.ascontiguousarray(np.broadcast_to(
        np.asarray(radiance, np.float32), (height, width, 3)))


SCENES = {"quad_scene": quad_scene}
SKIES = {"constant_sky": constant_sky}


def build(config: dict) -> dict:
    """The scene arrays a configuration file describes: its "scene"
    (function and arguments) lit by its "env" (sky and arguments), the
    camera's aspect that of the image."""
    env = dict(config["env"])
    sky = SKIES[env.pop("function")](**env)
    scene = dict(config["scene"])
    return SCENES[scene.pop("function")](
        env_radiance=sky, aspect=config["width"] / config["height"], **scene)


RENDER_KEYS = ("width", "height", "spp", "max_depth", "mode",
               "rays_per_dispatch")


def render_args(config: dict) -> dict:
    """The RenderConfig arguments a configuration file states."""
    return {k: config[k] for k in RENDER_KEYS}
