"""Scene loading and the structure-of-arrays scene (port of
`tinypathtracer_tpu/models/scene.py`).

`Scene` is the host-side (numpy) view of a glTF file (`load_scene`);
`Scene.flatten` concatenates its meshes into one vertex and index
buffer with per-object transform and material tables, as the JAX
package does, and hands the arrays to `FlatScene.from_numpy`.
`FlatScene` holds the same fields as the JAX package's `FlatScene`, as
torch tensors (float32 / int32); `from_numpy` is the one way across
from numpy, for scenes built by either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinypathtracer_tpu_torch.models import gltf as gltf_mod
from tinypathtracer_tpu_torch.models.camera import Camera
from tinypathtracer_tpu_torch.utils.math3d import (normal_matrix, rsqrt,
                                                   trs_to_mat4, vdot)

# Light kind codes (order matches reference delta_light.h:9-14)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_SPOT = 2

_INT_FIELDS = ("indices", "obj_face_begin", "obj_mtl_idx", "face_mtl",
               "vert_obj", "light_kind", "mtl_tex_id")


@dataclasses.dataclass
class FlatScene:
    """Device-side SoA scene; every field is a tensor on one device."""

    # Geometry (local space)
    vertices: torch.Tensor       # [V, 3] f32
    normals: torch.Tensor        # [V, 3] f32
    texcoords: torch.Tensor      # [V, 2] f32
    indices: torch.Tensor        # [F, 3] i32 (into the shared vertex buffer)
    # Per-object tables
    vert_mats: torch.Tensor      # [O, 4, 4] f32 local->world
    normal_mats: torch.Tensor    # [O, 4, 4] f32 inverse-transpose
    obj_face_begin: torch.Tensor  # [O] i32
    obj_mtl_idx: torch.Tensor    # [O] i32
    # Dense per-element maps
    face_mtl: torch.Tensor       # [F] i32 material id per face
    vert_obj: torch.Tensor       # [V] i32 object id per vertex
    # Materials
    mtl_base_color: torch.Tensor  # [M, 3] f32
    mtl_emission: torch.Tensor   # [M] f32 (scalar emission)
    mtl_eta: torch.Tensor        # [M] f32 (0 = non-dielectric)
    mtl_metallic: torch.Tensor   # [M] f32
    mtl_roughness: torch.Tensor  # [M] f32
    mtl_specular: torch.Tensor   # [M] f32
    # Delta lights
    light_kind: torch.Tensor     # [L] i32: 0 point, 1 directional, 2 spot
    light_color: torch.Tensor    # [L, 3] f32
    light_intensity: torch.Tensor  # [L] f32
    light_pos: torch.Tensor      # [L, 3] f32
    light_dir: torch.Tensor      # [L, 3] f32
    light_cos_outer: torch.Tensor  # [L] f32
    light_inv_cone: torch.Tensor  # [L] f32
    # Equirect environment map, row 0 = zenith side
    env_radiance: torch.Tensor   # [He, We, 3] f32
    # Camera
    cam_to_world: torch.Tensor   # [4, 4] f32
    cam_yfov: torch.Tensor       # [] f32 radians
    cam_aspect: torch.Tensor     # [] f32
    cam_znear: torch.Tensor      # [] f32
    # Base-color texture atlas ([1, 1, 1, 3] = no textures)
    tex_atlas: torch.Tensor      # [T, Ht, Wt, 3] f32
    mtl_tex_id: torch.Tensor     # [M] i32, -1 = none

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "FlatScene":
        """Build from a dict of the JAX FlatScene's fields as numpy arrays."""
        fields = {}
        for f in dataclasses.fields(cls):
            dtype = np.int32 if f.name in _INT_FIELDS else np.float32
            a = np.array(arrays[f.name], dtype=dtype, order="C")
            fields[f.name] = torch.from_numpy(a).to(device)
        return cls(**fields)

    def to(self, device) -> "FlatScene":
        return FlatScene(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def has_textures(self) -> bool:
        return self.tex_atlas.shape[0] > 1 or self.tex_atlas.shape[1] > 1 \
            or self.tex_atlas.shape[2] > 1

    def world_geometry(self):
        """Per-object local->world transform of vertices and normals, as
        per-row dot products (utils/math3d.vdot): no matmul, so no matmul
        precision setting enters, and the roundings are the JAX package's."""
        vm = self.vert_mats[self.vert_obj.long()]       # [V, 4, 4]
        nm = self.normal_mats[self.vert_obj.long()]
        wv = vdot(vm[:, :3, :3], self.vertices[:, None, :]) + vm[:, :3, 3]
        wn = vdot(nm[:, :3, :3], self.normals[:, None, :])
        return wv, wn * rsqrt(vdot(wn, wn))[:, None]


def _resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear-resample [H, W, 3] f32 to [h, w, 3] (atlas layers must
    share one shape), through 8-bit PIL as the JAX package does."""
    if img.shape[0] == h and img.shape[1] == w:
        return img.astype(np.float32)
    from PIL import Image

    pil = Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h), Image.BILINEAR),
                      dtype=np.float32) / 255.0


@dataclasses.dataclass
class Scene:
    """Host-side scene: the parsed glTF document and its camera."""

    doc: gltf_mod.GltfDocument
    camera: Camera

    def flatten(self, env_radiance=None, device="cuda") -> FlatScene:
        """The FlatScene of this scene on `device` (the card unless the
        caller asks for "cpu"). env_radiance: an [He, We, 3] array or
        tensor, the equirect dome (default black, [1, 1, 3])."""
        doc = self.doc
        if not doc.meshes:
            raise ValueError("scene has no meshes")
        # material name -> index in sorted name order (the reference's
        # std::map iteration order, mesh.cu:326-333)
        mtl_names = sorted(doc.materials)
        materials = doc.materials
        if not mtl_names:
            mtl_names = [""]
            materials = {"": gltf_mod.GltfMaterial(
                name="", base_color=np.array([0.82, 0.67, 0.16]))}
        mtl_index = {n: i for i, n in enumerate(mtl_names)}

        verts, norms, uvs, faces = [], [], [], []
        vert_obj, face_mtl, obj_face_begin, obj_mtl_idx = [], [], [], []
        vert_mats, normal_mats = [], []
        v_off = f_off = 0
        for oi, mesh in enumerate(doc.meshes):
            nv = mesh.positions.shape[0]
            nf = mesh.indices.shape[0] // 3
            verts.append(mesh.positions)
            norms.append(mesh.normals)
            uvs.append(mesh.texcoords)
            faces.append(mesh.indices.reshape(-1, 3).astype(np.int64) + v_off)
            vert_obj.append(np.full(nv, oi, dtype=np.int32))
            mi = mtl_index.get(mesh.material, 0)
            face_mtl.append(np.full(nf, mi, dtype=np.int32))
            obj_face_begin.append(f_off)
            obj_mtl_idx.append(mi)
            l2w = trs_to_mat4(mesh.translation, mesh.rotation, mesh.scale)
            nm = np.eye(4)
            nm[:3, :3] = normal_matrix(l2w)
            vert_mats.append(l2w)
            normal_mats.append(nm)
            v_off += nv
            f_off += nf

        mtls = [materials[n] for n in mtl_names]
        lights = doc.lights
        # base-color atlas: the layers some material references, all
        # resampled to the largest shape; [1, 1, 1, 3] white = untextured
        tex_ids = sorted({m.base_color_texture for m in mtls
                          if m.base_color_texture is not None
                          and m.base_color_texture < len(doc.images)})
        if tex_ids:
            imgs = [doc.images[t] for t in tex_ids]
            ah = max(i.shape[0] for i in imgs)
            aw = max(i.shape[1] for i in imgs)
            atlas = np.stack([_resize_image(i, ah, aw) for i in imgs])
            remap = {t: k for k, t in enumerate(tex_ids)}
            mtl_tex_id = [remap.get(m.base_color_texture, -1)
                          if m.base_color_texture is not None else -1
                          for m in mtls]
        else:
            atlas = np.ones((1, 1, 1, 3), np.float32)
            mtl_tex_id = [-1] * len(mtls)
        if env_radiance is None:
            env_radiance = np.zeros((1, 1, 3), dtype=np.float32)
        elif torch.is_tensor(env_radiance):
            env_radiance = env_radiance.detach().cpu().numpy()
        kind_code = {"point": LIGHT_POINT, "directional": LIGHT_DIRECTIONAL,
                     "spot": LIGHT_SPOT}

        def per_light(fn, shape=()):
            return (np.stack([fn(li) for li in lights]) if lights
                    else np.zeros((0,) + shape))

        cam = self.camera
        return FlatScene.from_numpy(dict(
            vertices=np.concatenate(verts), normals=np.concatenate(norms),
            texcoords=np.concatenate(uvs), indices=np.concatenate(faces),
            vert_mats=np.stack(vert_mats), normal_mats=np.stack(normal_mats),
            obj_face_begin=obj_face_begin, obj_mtl_idx=obj_mtl_idx,
            face_mtl=np.concatenate(face_mtl),
            vert_obj=np.concatenate(vert_obj),
            mtl_base_color=np.stack([m.base_color for m in mtls]),
            mtl_emission=[m.emission_factor for m in mtls],
            mtl_eta=[m.eta for m in mtls],
            mtl_metallic=[m.metallic for m in mtls],
            mtl_roughness=[m.roughness for m in mtls],
            mtl_specular=[m.specular for m in mtls],
            light_kind=per_light(lambda li: kind_code[li.kind]),
            light_color=per_light(lambda li: li.color, (3,)),
            light_intensity=per_light(lambda li: li.intensity),
            light_pos=per_light(lambda li: li.position, (3,)),
            light_dir=per_light(lambda li: li.direction, (3,)),
            light_cos_outer=per_light(lambda li: li.cos_outer),
            light_inv_cone=per_light(lambda li: li.inv_cos_cone_diff),
            env_radiance=env_radiance,
            cam_to_world=cam.camera_to_world(), cam_yfov=cam.yfov,
            cam_aspect=cam.aspect, cam_znear=cam.znear,
            tex_atlas=atlas, mtl_tex_id=mtl_tex_id), device)


def load_scene(path: str) -> Scene:
    """Load a .gltf file into a host-side Scene (reference Scene::Scene)."""
    doc = gltf_mod.read_gltf(path)
    cam = Camera()
    if doc.camera is not None:
        cam = Camera(yfov=doc.camera.yfov, aspect=doc.camera.aspect,
                     znear=doc.camera.znear,
                     translation=tuple(doc.camera.translation),
                     rotation=tuple(doc.camera.rotation),
                     scale=tuple(doc.camera.scale))
    return Scene(doc=doc, camera=cam)
