"""Procedural scenes (port of `tinypathtracer_tpu/models/procedural.py`).

`sphere_grid_scene` builds a Cornell-style room holding a grid of
UV-spheres, with numpy on the host exactly as the JAX package does
(the same seeded jitter), so both packages get identical arrays,
textured (a 64x64 checker atlas on the diffuse materials) or not.
"""

from __future__ import annotations

import numpy as np
import torch

from tinypathtracer_tpu_torch.models.scene import FlatScene


def uv_sphere(center, radius, n_lat, n_lon):
    """Vertices/normals/faces/uvs of a UV sphere (2*n_lat*n_lon-ish tris)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    ll, tt = np.meshgrid(lon, lat)              # [n_lat+1, n_lon]
    x = np.sin(tt) * np.cos(ll)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(ll)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = (normals * radius + np.asarray(center, np.float32)).astype(
        np.float32)
    uv = np.stack([ll / (2 * np.pi), tt / np.pi],
                  -1).reshape(-1, 2).astype(np.float32)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((b, d, c))
    return verts, normals, np.asarray(faces, np.int64), uv


def sphere_grid_scene(grid=4, n_lat=16, n_lon=32, env_radiance=None,
                      device="cpu", textured=False) -> FlatScene:
    """A 10x10x10 room of grid^3 spheres; ~2*grid^3*n_lat*n_lon + 12
    triangles. Materials cycle diffuse/metal by a seeded draw; one
    emissive panel under the ceiling lights the room. env_radiance:
    optional [H, W, 3] array or tensor (default a dim constant sky).

    textured=True gives the diffuse materials 0-2 a 64x64 checker atlas
    with real texcoords (the quads tile it 4x, the spheres use their
    lat/lon parametrization); the metal and emissive ones stay
    untextured."""
    rng = np.random.default_rng(7)
    verts, norms, uvs, faces, face_mtl, vert_obj = [], [], [], [], [], []
    v_off = 0

    def add(v, n, f, mtl, uv):
        nonlocal v_off
        verts.append(v)
        norms.append(n)
        uvs.append(np.asarray(uv, np.float32))
        faces.append(f + v_off)
        face_mtl.append(np.full(len(f), mtl, np.int32))
        vert_obj.append(np.full(len(v), 0, np.int32))
        v_off += len(v)

    def quad(p0, p1, p2, p3, n, mtl):
        v = np.asarray([p0, p1, p2, p3], np.float32)
        nn = np.tile(np.asarray(n, np.float32), (4, 1))
        add(v, nn, np.asarray([[0, 1, 2], [0, 2, 3]], np.int64), mtl,
            [[0, 0], [4, 0], [4, 4], [0, 4]])

    s = 5.0
    quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s], [0, 1, 0], 0)
    quad([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s], [0, -1, 0], 0)
    quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s], [1, 0, 0], 1)
    quad([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s], [-1, 0, 0], 2)
    quad([-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s], [0, 0, -1], 0)
    # emissive panel just under the ceiling
    e = 1.5
    quad([-e, s - 0.01, -e], [-e, s - 0.01, e], [e, s - 0.01, e],
         [e, s - 0.01, -e], [0, -1, 0], 4)

    pitch = 2 * s * 0.8 / grid
    r = pitch * 0.3
    base = -s * 0.8 + pitch / 2
    for ix in range(grid):
        for iy in range(grid):
            for iz in range(grid):
                c = (base + ix * pitch + rng.uniform(-0.1, 0.1) * pitch,
                     base + iy * pitch + rng.uniform(-0.1, 0.1) * pitch,
                     base + iz * pitch + rng.uniform(-0.1, 0.1) * pitch)
                v, n, f, uv = uv_sphere(c, r, n_lat, n_lon)
                add(v, n, f, int(3 * rng.random() // 1), uv)

    v = np.concatenate(verts)
    if env_radiance is None:
        env_radiance = np.full((1, 1, 3), 0.1, np.float32)
    elif torch.is_tensor(env_radiance):
        env_radiance = env_radiance.cpu().numpy()
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -4.6]
    c2w[0, 0] = -1.0     # glTF cameras look down -Z: turn to face +z
    c2w[2, 2] = -1.0
    n_mtl = 5
    if textured:
        yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        check = ((xx // 8 + yy // 8) % 2).astype(np.float32)
        atlas = np.stack([0.25 + 0.75 * check, np.full_like(check, 0.6),
                          1.0 - 0.75 * check], axis=-1)[None]
        uv = np.concatenate(uvs)
        tex_ids = [0, 0, 0, -1, -1]
    else:
        atlas = np.ones((1, 1, 1, 3), np.float32)
        uv = np.zeros((len(v), 2), np.float32)
        tex_ids = [-1] * n_mtl
    arrays = dict(
        vertices=v, normals=np.concatenate(norms), texcoords=uv,
        indices=np.concatenate(faces),
        vert_mats=np.eye(4)[None], normal_mats=np.eye(4)[None],
        obj_face_begin=[0], obj_mtl_idx=[0],
        face_mtl=np.concatenate(face_mtl), vert_obj=np.concatenate(vert_obj),
        mtl_base_color=[[0.73, 0.73, 0.73], [0.65, 0.05, 0.05],
                        [0.12, 0.15, 0.65], [0.8, 0.7, 0.2], [1.0, 1.0, 1.0]],
        mtl_emission=[0.0, 0.0, 0.0, 0.0, 6.0],
        mtl_eta=np.zeros(n_mtl), mtl_metallic=[0.0, 0.0, 0.0, 1.0, 0.0],
        mtl_roughness=[0.5] * n_mtl, mtl_specular=[0.5] * n_mtl,
        light_kind=np.zeros(0), light_color=np.zeros((0, 3)),
        light_intensity=np.zeros(0), light_pos=np.zeros((0, 3)),
        light_dir=np.zeros((0, 3)), light_cos_outer=np.zeros(0),
        light_inv_cone=np.zeros(0),
        env_radiance=np.asarray(env_radiance),
        cam_to_world=c2w, cam_yfov=1.1, cam_aspect=1.0, cam_znear=0.01,
        tex_atlas=atlas, mtl_tex_id=tex_ids)
    return FlatScene.from_numpy(arrays, device)
