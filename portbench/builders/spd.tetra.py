"""Scene builder "spd.tetra": the tetrahedral pyramid of Eric Haines'
Standard Procedural Databases (E. Haines, "A Proposal for Standard
Graphics Environments", IEEE CG&A 7(11), 1987; generator tetra.c).

The root tetrahedron has its four corners at the corners (x, y, z) of
the cube centre +- half_size whose signs multiply to +1. Each
subdivision replaces a tetrahedron by the four of half its size at its
corners (the corner rule: the child at corner c has centre (centre + c)
/ 2), size_factor times, which leaves 4^size_factor tetrahedra of four
triangles each: the Sierpinski pyramid, mostly gaps.

Each triangle has its own three vertices and its outward geometric
normal at each of them (flat shading), all of one diffuse material,
with no texture and no light: the sky lights the scene. The camera is
the generator's view (from, at, up, and the vertical angle in degrees),
at the image's aspect.

`build(env_radiance, aspect, **arguments)` returns the port's FlatScene
field arrays, the keys `scenes.quad_scene` returns. Numpy and the
standard library only: the program and the plain reference both read
them.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

# the cube corners whose signs multiply to +1: a tetrahedron's corners
CORNERS = np.array([c for c in itertools.product((-1.0, 1.0), repeat=3)
                    if c[0] * c[1] * c[2] > 0.0])
# the four faces of a tetrahedron, by its corners
FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def tetrahedra(size_factor: int, center, half_size: float) -> np.ndarray:
    """The corners [4^size_factor, 4, 3] (float64) of the pyramid's
    tetrahedra."""
    centers = np.asarray(center, np.float64)[None]
    h = float(half_size)
    for _ in range(size_factor):
        h *= 0.5
        centers = (centers[:, None, :] + h * CORNERS[None]).reshape(-1, 3)
    return centers[:, None, :] + h * CORNERS[None]


def triangles(tets: np.ndarray) -> np.ndarray:
    """The faces [4 T, 3, 3] of tetrahedra [T, 4, 3], each wound so that
    its geometric normal (v1 - v0) x (v2 - v0) points away from the
    tetrahedron's fourth corner."""
    tri = tets[:, FACES].reshape(-1, 3, 3)
    away = (tri.mean(axis=1)
            - np.repeat(tets.mean(axis=1), len(FACES), axis=0))
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("ij,ij->i", n, away) < 0.0
    tri[flip] = tri[flip][:, [0, 2, 1]]
    return tri


def camera_to_world(eye, at, up) -> np.ndarray:
    """The 4x4 camera-to-world matrix of a pinhole at eye looking at at,
    up towards up; the camera looks down its -Z (glTF)."""
    f = _unit(np.asarray(at, np.float64) - np.asarray(eye, np.float64))
    r = _unit(np.cross(f, np.asarray(up, np.float64)))
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = r, np.cross(r, f), -f
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def build(env_radiance, aspect, size_factor, center, half_size, view,
          material, units) -> dict:
    """FlatScene field arrays of the pyramid at size_factor from the
    root tetrahedron about center with half_size, seen from view
    {"from", "at", "up", "angle" (vertical, degrees)}, of one diffuse
    material {"color", "kd"} (base colour kd * color), under
    env_radiance [H, W, 3]; the image's width over height `aspect`.
    Lengths are in metres (`units` "m"): the port's self-hit offset is
    absolute."""
    if units != "m":
        raise ValueError(f"spd.tetra takes metres, not {units!r}")
    tri = triangles(tetrahedra(int(size_factor), center, half_size))
    n = _unit(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    f = tri.shape[0]
    v = tri.reshape(-1, 3).astype(np.float32)
    base = float(material["kd"]) * np.asarray(material["color"], np.float64)
    return dict(
        vertices=v,
        normals=np.repeat(n, 3, axis=0).astype(np.float32),
        texcoords=np.zeros((len(v), 2), np.float32),
        indices=np.arange(3 * f, dtype=np.int64).reshape(f, 3),
        vert_mats=np.eye(4)[None], normal_mats=np.eye(4)[None],
        obj_face_begin=[0], obj_mtl_idx=[0],
        face_mtl=np.zeros(f, np.int32),
        vert_obj=np.zeros(len(v), np.int32),
        mtl_base_color=[base.tolist()], mtl_emission=[0.0],
        mtl_eta=np.zeros(1), mtl_metallic=np.zeros(1),
        mtl_roughness=[0.5], mtl_specular=[0.5],
        light_kind=np.zeros(0), light_color=np.zeros((0, 3)),
        light_intensity=np.zeros(0), light_pos=np.zeros((0, 3)),
        light_dir=np.zeros((0, 3)), light_cos_outer=np.zeros(0),
        light_inv_cone=np.zeros(0),
        env_radiance=np.asarray(env_radiance, np.float32),
        cam_to_world=camera_to_world(view["from"], view["at"], view["up"]),
        cam_yfov=math.radians(float(view["angle"])), cam_aspect=aspect,
        cam_znear=0.01,
        tex_atlas=np.ones((1, 1, 1, 3), np.float32),
        mtl_tex_id=[-1])
